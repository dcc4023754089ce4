"""Host-side plans of the kernels, on the CPU: how `matmul_plan` splits a
row's words into the segments of one cluster, what `coo_plan` asks of
shared memory, the per-tile windows `tile_windows` reports for queries in
occupancy-build order and shuffled, the float32 flash kernel's tiles and
shared memory, and the bytes `volume_render` reads; and that every Python
mirror equals the kernel source's constant. The kernels themselves run
only on the card (tests/test_torch_cuda.py).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.configs.rtnerf import demo_config
from repro_torch.core import field as tfield
from repro_torch.core import occupancy as tocc
from repro_torch.core import sparse as tsparse
from repro_torch.core import tensorf as ttensorf
from repro_torch.kernels import _build, bitmap_decode, coo_gather, ops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import volume_render as tvr

torch.set_num_threads(1)
H100_SMS = 132


# ------------------------------------------------------ bitmap_matmul ---
def _segments(plan, nwords):
    return [(s * plan.seg_words, min((s + 1) * plan.seg_words, nwords))
            for s in range(plan.segments)]


@pytest.mark.parametrize("rows", [1, 3, 48, 50, 300])
@pytest.mark.parametrize("nwords", [0, 1, 3, 9, 100, 800])
def test_matmul_segments_cover_every_word_once(rows, nwords):
    plan = bitmap_decode.matmul_plan(rows, nwords, 8, H100_SMS)
    assert 1 <= plan.segments <= bitmap_decode.MAX_SEGMENTS
    segs = _segments(plan, nwords)
    covered = [w for a, b in segs for w in range(a, b)]
    assert covered == list(range(nwords))
    if nwords:
        assert all(b > a for a, b in segs), segs        # none empty


def test_matmul_plan_of_the_fig14_operand():
    """48 rows of 800 words: 8 segments of 100 words, 384 CTAs."""
    plan = bitmap_decode.matmul_plan(48, 800, 8, H100_SMS)
    assert plan == bitmap_decode.MatmulPlan(8, 100, 4 * 8 * 9)


@pytest.mark.parametrize("rows,sms", [(1, 132), (48, 132), (66, 132),
                                      (132, 132), (264, 132), (10, 16)])
def test_matmul_plan_fills_the_sms_about_twice(rows, sms):
    plan = bitmap_decode.matmul_plan(rows, 10000, 8, sms)
    ctas = rows * plan.segments
    if plan.segments < bitmap_decode.MAX_SEGMENTS:
        assert ctas >= 2 * sms
    if plan.segments > 1:
        assert rows * (plan.segments // 2) < 2 * sms


@pytest.mark.parametrize("n", [1, 8, 100, 5000, 20000])
def test_matmul_plan_fits_the_partial_rows_in_shared_memory(n):
    """S + 1 partial rows of n floats: wide x gets fewer segments."""
    room = _build.MAX_SMEM_BYTES - bitmap_decode.MATMUL_STATIC_SMEM_BYTES
    plan = bitmap_decode.matmul_plan(1, 800, n, H100_SMS)
    assert plan.smem_bytes == 4 * n * (plan.segments + 1) <= room
    if plan.segments < bitmap_decode.MAX_SEGMENTS:
        assert 4 * n * (2 * plan.segments + 1) > room


def test_matmul_plan_raises_when_two_partial_rows_do_not_fit():
    room = _build.MAX_SMEM_BYTES - bitmap_decode.MATMUL_STATIC_SMEM_BYTES
    plan = bitmap_decode.matmul_plan(4, 10, room // 8, H100_SMS)
    assert plan.segments == 1 and plan.smem_bytes <= room
    with pytest.raises(ValueError, match="232448 bytes"):
        bitmap_decode.matmul_plan(4, 10, room // 8 + 1, H100_SMS)


# ---------------------------------------------------------- coo_gather ---
def test_coo_plan_fits_shared_memory_and_tiles_the_queries():
    plan = coo_gather.coo_plan(4_194_304)
    assert plan.tile == coo_gather.THREADS * coo_gather.PER_THREAD == 2048
    assert plan.blocks == 2048 and plan.capacity == 1024
    # the staged window (an int32 coordinate and a float32 value an entry)
    # and the reduction scratch are static shared memory: under a block's
    # static limit of 48 KB, and eight CTAs (an SM's 2,048 threads) leave
    # over half of its 256 KB of L1 and shared memory to the stream that
    # wide tiles search
    smem = 8 * plan.capacity + 4 * (2 * 8 + 2)
    assert smem <= 48 * 1024 and 8 * smem <= 128 * 1024
    assert coo_gather.coo_plan(2049).blocks == 2
    assert coo_gather.coo_plan(0).blocks == 0
    with pytest.raises(ValueError):
        coo_gather.coo_plan(-1)


def test_coo_gather_staged_count_needs_the_kernel():
    """The staged-tile count is read from the kernel, never modelled on
    the CPU."""
    coords = torch.tensor([1, 5, tsparse.PAD_COORD], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        coo_gather.coo_gather_staged(coords, torch.ones(3),
                                     torch.tensor([5], dtype=torch.int32))


def _cu_constants(name):
    """The file-scope `constexpr int` values of a kernel source (those at
    the start of a line), in order, each evaluated over the earlier ones."""
    text = (_build.CSRC / name).read_text()
    consts = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                re.M):
        consts[key] = eval(expr.replace("/", "//"), {}, dict(consts))
    return consts


@pytest.mark.parametrize("source,key,mirror", [
    ("coo_gather.cu", "kThreads", lambda: coo_gather.THREADS),
    ("coo_gather.cu", "kPer", lambda: coo_gather.PER_THREAD),
    ("coo_gather.cu", "kTile", lambda: coo_gather.TILE),
    ("coo_gather.cu", "kCapacity", lambda: coo_gather.CAPACITY),
    ("bitmap_matmul.cu", "kThreads", lambda: bitmap_decode.MATMUL_THREADS),
    ("bitmap_matmul.cu", "kChunkWords",
     lambda: bitmap_decode.MATMUL_THREADS),
    ("volume_render.cu", "kRaysPerBlock", lambda: tvr.RAYS_PER_BLOCK),
    ("volume_render.cu", "kRun", lambda: tvr.RUN),
    ("volume_render.cu", "kSegment", lambda: tvr.SEGMENT),
    ("flash_attention.cu", "kF32BQ", lambda: tflash.F32_BQ),
    ("flash_attention.cu", "kF32BK64", lambda: tflash.F32_TILES[64][0]),
    ("flash_attention.cu", "kF32Raw64", lambda: tflash.F32_TILES[64][1]),
    ("flash_attention.cu", "kF32BK128", lambda: tflash.F32_TILES[128][0]),
    ("flash_attention.cu", "kF32Raw128", lambda: tflash.F32_TILES[128][1]),
    ("flash_attention.cu", "kF32Bars", lambda: tflash.F32_BARRIER_BYTES),
    ("flash_attention.cu", "kF32Vt64", lambda: tflash.F32_TILES[64][2]),
    ("flash_attention.cu", "kF32Vt128", lambda: tflash.F32_TILES[128][2]),
])
def test_plan_constants_mirror_the_kernel_sources(source, key, mirror):
    """The pure-Python plans size the launches with the kernels' own
    constants: a change in a .cu file shows here, before any card run."""
    assert _cu_constants(source)[key] == mirror()


def test_matmul_static_shared_memory_fits_the_plans_room():
    """The kernel's static arrays: the uint16 set-bit list of kChunkWords
    words, two int counts and the 8-float partial sums of each warp."""
    k = _cu_constants("bitmap_matmul.cu")
    static = (k["kChunkWords"] * 32 * 2 + 2 * 4 * k["kWarps"]
              + 4 * k["kWarps"] * k["kTileN"])
    assert static <= bitmap_decode.MATMUL_STATIC_SMEM_BYTES


@pytest.mark.parametrize("nq", [1, 5, 2048, 2049, 7000])
def test_tile_windows_match_a_direct_count(nq):
    rng = np.random.RandomState(nq)
    coords = np.sort(rng.choice(100000, 3000, replace=False)).astype(np.int32)
    coords = np.concatenate([coords, np.full(8, tsparse.PAD_COORD,
                                             np.int32)])
    q = rng.randint(-10, 100010, nq).astype(np.int32)
    got = coo_gather.tile_windows(torch.from_numpy(coords),
                                  torch.from_numpy(q)).numpy()
    want = []
    for t in range(0, nq, coo_gather.TILE):
        tile = q[t:t + coo_gather.TILE]
        want.append(int(((coords >= tile.min()) & (coords <= tile.max()))
                        .sum()))
    np.testing.assert_array_equal(got, want)


def occupancy_coo_calls(monkeypatch, grid=96, chunk=16384, start=0):
    """(coords, values, queries) of every COO gather that one occupancy
    chunk (grid points start .. start + chunk in meshgrid order) issues
    through `tensorf.gather_factor`, for a field pruned to 90% zeros."""
    cfg = dataclasses.replace(demo_config(), grid_res=grid, occ_res=grid)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    cf = tfield.DenseField(params, cfg).prune(sparsity=0.9).encode(0.8)
    xs = tocc.grid_coords(cfg, "cpu")
    pts = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"),
                      dim=-1).reshape(-1, 3)[start:start + chunk]
    calls, orig = [], ops.coo_gather

    def spy(coords, values, queries, **kw):
        calls.append((coords, values, queries))
        return orig(coords, values, queries, **kw)
    monkeypatch.setattr(ops, "coo_gather", spy)
    cf.sigma(pts)
    monkeypatch.setattr(ops, "coo_gather", orig)
    assert calls, "the field has no COO sigma slice"
    return calls


@pytest.mark.parametrize("start", [0, 442368])
def test_occupancy_order_tiles_are_staged_and_shuffled_ones_wide(
        monkeypatch, start):
    """The serving path's queries (row * ncols + stencil column, points in
    meshgrid order) give narrow windows; a shuffled copy of the plane
    queries spans the whole stream."""
    cap = coo_gather.CAPACITY
    planes = 0
    for coords, _values, q in occupancy_coo_calls(monkeypatch, start=start):
        win = coo_gather.tile_windows(coords, q)
        assert float((win <= cap).double().mean()) > 0.9
        assert int(win.max()) <= cap
        nnz = int((coords != tsparse.PAD_COORD).sum())
        if nnz > 1.5 * cap:
            planes += 1
            perm = torch.randperm(q.shape[0],
                                  generator=torch.Generator().manual_seed(1))
            shuffled = coo_gather.tile_windows(coords, q[perm])
            assert bool((shuffled > cap).all())
    assert planes > 0


# ------------------------------------------------------ flash (fp32) ---
@pytest.mark.parametrize("dp", [64, 128])
def test_flash_f32_shared_memory_fits_the_card(dp):
    """Q hi + lo, the K tile and each V^T buffer hi + lo and the raw K/V
    ring, computed from the .cu constants, equal the Python mirror and
    stay within a block's 232,448 bytes; the raw ring has at least one
    stage and V^T one or two buffers."""
    k = _cu_constants("flash_attention.cu")
    bk, stages, vt = (k[f"kF32BK{dp}"], k[f"kF32Raw{dp}"],
                      k[f"kF32Vt{dp}"])
    smem = (2 * k["kF32BQ"] * dp * 4 + (2 + 2 * vt) * bk * dp * 4
            + stages * 2 * bk * dp * 4 + k["kF32Bars"] + 1024)
    assert tflash.f32_smem_bytes(dp) == smem
    assert smem <= _build.MAX_SMEM_BYTES == 232448
    assert stages >= 1 and vt in (1, 2) and k["kF32Bars"] >= 8 * stages


@pytest.mark.parametrize("dp", [64, 128])
def test_flash_f32_tiles_suit_tf32_wgmma(dp):
    """Every swizzled tile is whole 1024-byte groups of 8 rows of 128
    bytes (32 fp32 a row), the key tile is a k8 multiple and a legal wgmma
    N (8 to 256), and two warpgroups of 64 rows cover the q block."""
    bk = tflash.F32_TILES[dp][0]
    assert bk % 8 == 0 and 8 <= bk <= 256
    assert dp % 32 == 0 and bk % 32 == 0
    for rows in (tflash.F32_BQ, bk, dp):
        assert (rows * 128) % 1024 == 0
    assert tflash.F32_BQ == 2 * 64


def _tf32(t):
    """t cut to TF32's 10 mantissa bits, as one TF32 product reads it."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_flash_f32_input_breaks_one_tf32_product():
    """The card test's input (q and k at scale 2.0): operands cut to TF32
    once, the product alone is off by more than the (1e-4, 1e-4) limit,
    so only a kernel holding fp32's precision passes there."""
    rng = np.random.RandomState(3)
    q, k = (torch.from_numpy((rng.randn(1, 2, 256, 64) * 2.0).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32))
    want = tflash.flash_attention_ref(q.double(), k.double(), v.double())
    one = tflash.flash_attention_ref(_tf32(q), _tf32(k), _tf32(v)).double()
    full = tflash.flash_attention_ref(q, k, v).double()
    limit = 1e-4 + 1e-4 * want.abs()
    assert float(((one - want).abs() / limit).max()) > 2.0
    assert float(((full - want).abs() / limit).max()) < 0.1


# ------------------------------------------------------- volume_render ---
def _direct_read_bytes(alive, n, vec):
    """The kernel's reads, segment by segment: the sigma of each segment
    it enters (the next one only while the ray is alive at this one's
    end), and each segment's rgb up to its last alive sample."""
    total = 0
    for a in alive.tolist():
        for base in range(0, n, tvr.SEGMENT):
            if base and a <= base:
                break
            total += 4 * (min(base + tvr.SEGMENT, n) - base)
            floats = 3 * max(0, min(a - base, tvr.SEGMENT))
            total += 4 * (4 * -(-floats // 4) if vec else floats)
    return total


@pytest.mark.parametrize("n", [1, 3, 7, 100, 256, 257, 512, 1500])
@pytest.mark.parametrize("vec", [True, False])
def test_volume_read_bytes_match_a_segment_by_segment_count(n, vec):
    rng = np.random.RandomState(n)
    alive = torch.from_numpy(rng.randint(1, n + 1, 40))
    alive[0], alive[-1] = 1, n
    assert tvr.read_bytes(alive, n, vec) == _direct_read_bytes(alive, n, vec)


def test_volume_read_count_needs_the_kernel():
    """The bytes read are counted by the kernel, never modelled on the
    CPU."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        tvr.volume_render_read(torch.ones((2, 4)), torch.ones((2, 4, 3)),
                               delta=0.1)


def test_volume_read_bytes_of_rays_that_never_terminate():
    """No ray terminates: every byte of sigma and rgb is read once."""
    r, n = 64, 512
    alive = torch.full((r,), n)
    assert tvr.read_bytes(alive, n) == r * n * 16


@pytest.mark.parametrize("n,offset,want", [(512, 0, True), (1500, 0, True),
                                           (7, 0, False), (3, 0, False),
                                           (512, 1, False)])
def test_volume_vector_loads_need_whole_aligned_rows(n, offset, want):
    """16-byte loads need N % 4 == 0 and 16-byte aligned sigma and rgb; a
    storage offset of one float takes the scalar loads."""
    sigma = torch.zeros((4, n))
    store = torch.zeros(4 * n * 3 + 4)
    rgb = store[offset:offset + 4 * n * 3].view(4, n, 3)
    assert sigma.data_ptr() % 16 == 0 and store.data_ptr() % 16 == 0
    assert tvr.vector_loads(sigma, rgb) is want
