"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked `gpu`: each test skips without a CUDA device (decided in the
fixture, never at import). Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports no jax: the card's machine need not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.rtnerf import NeRFConfig, demo_config
from repro_torch.core import field as tfield
from repro_torch.core import occupancy as tocc
from repro_torch.core import rendering as trender
from repro_torch.core import sparse as tsparse
from repro_torch.core import tensorf as ttensorf
from repro_torch.kernels import _build, bitmap_decode, coo_gather, fused_sample
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import volume_render as tvr
from repro_torch.serving import RenderEngine
from _train_bounds import adamw_first_step_excess
from test_torch_kernel_plans import occupancy_coo_calls

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    return torch.device("cuda")


def _matrix(rows, cols, density, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, cols).astype(np.float32)
    w[rng.rand(rows, cols) >= density] = 0
    return w


@pytest.mark.parametrize("rows,cols,nq", [(8, 32, 1000), (40, 70, 4096),
                                          (16, 25600, 1 << 20)])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_bitmap_gather_kernel_is_bit_exact(cuda, rows, cols, nq, density):
    w = _matrix(rows, cols, density, rows + cols)
    enc = tsparse.encode_bitmap(w, device=cuda)
    q = torch.from_numpy(np.random.RandomState(nq).randint(
        0, rows * cols, nq).astype(np.int32)).to(cuda)
    want = bitmap_decode.bitmap_gather_ref(enc.words, enc.rowptr,
                                           enc.values, q, cols, rank=enc.rank)
    for rank in (enc.rank, None):
        before = bitmap_decode.bitmap_gather.launches
        got = bitmap_decode.bitmap_gather(enc.words, enc.rowptr, enc.values,
                                          q, cols=cols, rank=rank)
        torch.cuda.synchronize()
        assert bitmap_decode.bitmap_gather.launches == before + 1
        assert torch.equal(got, want)
    np.testing.assert_array_equal(want.cpu().numpy(),
                                  w.reshape(-1)[q.cpu().numpy()])


@pytest.mark.parametrize("size,nq", [(5, 128), (1000, 4096),
                                     (409600, 1 << 20)])
@pytest.mark.parametrize("sparsity", [0.5, 0.95, 1.0])
def test_coo_gather_kernel_is_bit_exact(cuda, size, nq, sparsity):
    rng = np.random.RandomState(size)
    flat = rng.randn(size).astype(np.float32)
    flat[rng.rand(size) < sparsity] = 0
    enc = tsparse.encode_coo(flat.reshape(1, -1), device=cuda)
    q = torch.from_numpy(rng.randint(0, size, nq).astype(np.int32)).to(cuda)
    before = coo_gather.coo_gather.launches
    got = coo_gather.coo_gather(enc.coords, enc.values, q)
    torch.cuda.synchronize()
    assert coo_gather.coo_gather.launches == before + 1
    assert torch.equal(got, coo_gather.coo_gather_ref(enc.coords, enc.values,
                                                      q))
    np.testing.assert_array_equal(got.cpu().numpy(), flat[q.cpu().numpy()])


def _assert_coo_exact(coords, values, q):
    """Bit-exact against the plain version, and the kernel stages exactly
    the tiles whose window `tile_windows` finds within the capacity.
    Returns the kernel's count of staged tiles."""
    before = coo_gather.coo_gather.launches
    got, staged = coo_gather.coo_gather_staged(coords, values, q)
    assert coo_gather.coo_gather.launches == before + 1
    assert torch.equal(got, coo_gather.coo_gather_ref(coords, values, q))
    win = coo_gather.tile_windows(coords, q)
    assert staged == int((win <= coo_gather.CAPACITY).sum())
    return staged


@pytest.mark.parametrize("order", ["occupancy", "shuffled"])
def test_coo_gather_kernel_on_occupancy_queries(cuda, monkeypatch, order):
    """Occupancy-order tiles span a narrow band of the stream and are
    staged in shared memory; a shuffled copy makes every tile wide."""
    cap = coo_gather.CAPACITY
    wide_streams = 0
    for call in occupancy_coo_calls(monkeypatch):
        coords, values, q = (t.to(cuda) for t in call)
        if order == "shuffled":
            g = torch.Generator(device="cpu").manual_seed(q.shape[0])
            q = q[torch.randperm(q.shape[0], generator=g).to(cuda)]
        staged = _assert_coo_exact(coords, values, q) / coo_gather.coo_plan(
            q.shape[0]).blocks
        nnz = int((coords != tsparse.PAD_COORD).sum())
        if order == "occupancy":
            assert staged > 0.9, staged
        elif nnz > 1.5 * cap:
            assert staged == 0.0, staged
            wide_streams += 1
    assert order == "occupancy" or wide_streams > 0


def test_coo_gather_adds_staged_tiles_to_a_counter_without_waiting(cuda):
    """`staged=` accumulates the kernel's staged-tile count across calls,
    the same count `coo_gather_staged` reads back for each."""
    rng = np.random.RandomState(11)
    flat = rng.randn(50000).astype(np.float32)
    flat[rng.rand(50000) < 0.9] = 0
    enc = tsparse.encode_coo(flat.reshape(1, -1), device=cuda)
    qs = [torch.from_numpy(np.sort(rng.randint(0, 50000, nq)).astype(
        np.int32)).to(cuda) for nq in (10000, 4096 * 3 + 1)]
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    want = 0
    for q in qs:
        got = coo_gather.coo_gather(enc.coords, enc.values, q,
                                    staged=counter)
        ref, staged = coo_gather.coo_gather_staged(enc.coords, enc.values, q)
        assert torch.equal(got, ref)
        want += staged
    assert int(counter.item()) == want > 0


def _gapped_stream(device, n=20000, first=1000):
    """Coordinates first, first + 3, ... (n entries) padded to a multiple
    of 8 with PAD_COORD, values 1, 2, ..."""
    coords = first + 3 * np.arange(n, dtype=np.int64)
    pad = -n % 8 + 8
    coords = np.concatenate([coords, np.full(pad, tsparse.PAD_COORD)])
    values = np.concatenate([np.arange(1, n + 1, dtype=np.float32),
                             np.zeros(pad, np.float32)])
    return (torch.from_numpy(coords.astype(np.int32)).to(device),
            torch.from_numpy(values).to(device))


@pytest.mark.parametrize("extra", [0, 1])
def test_coo_gather_window_at_and_over_capacity(cuda, extra):
    """One tile whose window holds exactly the capacity (staged) and one
    whose window holds one entry more (searched in device memory)."""
    coords, values = _gapped_stream(cuda)
    cap = coo_gather.CAPACITY
    c = coords.cpu().numpy().astype(np.int64)
    a = 37
    lo_q, hi_q = int(c[a]), int(c[a + cap - 1 + extra])
    rng = np.random.RandomState(cap + extra)
    q = rng.randint(lo_q, hi_q + 1, coo_gather.TILE)
    q[:2] = lo_q, hi_q
    q = torch.from_numpy(q.astype(np.int32)).to(cuda)
    assert int(coo_gather.tile_windows(coords, q)[0]) == cap + extra
    assert _assert_coo_exact(coords, values, q) == 1 - extra


def test_coo_gather_below_the_stream_pad_region_and_empty_windows(cuda):
    coords, values = _gapped_stream(cuda)
    last = int(coords[19999])
    T = coo_gather.TILE
    tiles = [
        np.arange(-T // 2, T // 2),                        # below the first
        last - 5 + np.arange(T),                           # into the pad
        np.full(T, tsparse.PAD_COORD - 1),                 # pad region only
        np.concatenate([np.full(T - 1, last + 1), [tsparse.PAD_COORD]]),
        np.full(T, 1001),                                  # empty window
        1001 + (np.arange(T) % 2),                         # in one gap
        np.full(T, 1000),                                  # one entry
    ]
    q = torch.from_numpy(np.concatenate(tiles).astype(np.int32)).to(cuda)
    win = coo_gather.tile_windows(coords, q).cpu().numpy()
    assert win[4] == 0 and win[5] == 0 and win[6] == 1
    _assert_coo_exact(coords, values, q)


@pytest.mark.parametrize("nq", [1, 3, 2047, 2049, 3 * 2048 + 5])
def test_coo_gather_ragged_query_count(cuda, nq):
    coords, values = _gapped_stream(cuda)
    q = torch.from_numpy(np.random.RandomState(nq).randint(
        900, 70000, nq).astype(np.int32)).to(cuda)
    _assert_coo_exact(coords, values, torch.sort(q).values)
    _assert_coo_exact(coords, values, q)


def test_coo_gather_unaligned_query_pointer(cuda):
    """A slice q[1:] is 4 bytes off 16-byte alignment: scalar loads."""
    coords, values = _gapped_stream(cuda)
    q = torch.arange(900, 900 + 4 * 2048 + 1, dtype=torch.int32,
                     device=cuda)
    sub = q[1:]
    assert sub.data_ptr() % 16 == 4
    _assert_coo_exact(coords, values, sub)
    _assert_coo_exact(coords, values, q[4:])


def _field(case, device):
    cfg = demo_config(tiny=True)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    sparsity, threshold = {"bitmap": (0.6, 0.99), "coo": (0.9, 0.8),
                           "dense": (0.0, 0.8)}[case]
    f = tfield.DenseField(params, cfg)
    if sparsity:
        f = f.prune(sparsity=sparsity)
    return cfg, f.encode(threshold).to(device)


@pytest.mark.parametrize("case", ["bitmap", "coo", "dense"])
def test_fused_kernel_matches_plain(cuda, case):
    cfg, cf = _field(case, cuda)
    rng = np.random.RandomState(1)
    C, N = 8, 20000
    ci = rng.randint(0, cfg.cube_grid_res, size=(C, 3))
    centers = torch.from_numpy((-cfg.scene_bound + (ci + 0.5)
                                * cfg.cube_world()).astype(np.float32))
    cid = torch.from_numpy(np.sort(rng.randint(0, C, N)).astype(np.int32))
    off = torch.from_numpy(rng.uniform(-cfg.cube_world(), cfg.cube_world(),
                                       (N, 3)).astype(np.float32))
    pts = (centers[cid.long()] + off).to(cuda)
    centers, cid = centers.to(cuda), cid.to(cuda)
    spec, streams = ttensorf.fused_field_inputs(cf)
    base = ttensorf.window_base(cfg, centers)
    kw = dict(grid_res=cfg.grid_res, scene_bound=cfg.scene_bound,
              window=ttensorf.fused_window(cfg), app_dim=cfg.app_dim)
    before = fused_sample.fused_sigma_app.launches
    sig, feat = fused_sample.fused_sigma_app(spec, streams, cf.extras["basis"],
                                             pts, base, cid, **kw)
    torch.cuda.synchronize()
    assert fused_sample.fused_sigma_app.launches == before + 1
    want_sig, want_feat = fused_sample.fused_sigma_app_ref(
        spec, streams, cf.extras["basis"], pts, base, cid, **kw)
    torch.testing.assert_close(sig, want_sig, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(feat, want_feat, rtol=1e-4, atol=1e-4)


def test_fused_plain_on_card_divides_like_the_kernel(cuda):
    """At grid 160 the world coordinate 0.82075465 maps to 122.99999 by a
    true division but to 123.0 by a product with the reciprocal (PyTorch's
    CUDA `tensor / scalar`); for a point outside its cube's window that
    floor moves the clamped stencil. The plain version must divide as the
    kernel (and the reference) do."""
    cfg = NeRFConfig(r_sigma=4, r_color=8, app_dim=8)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    cf = tfield.DenseField(params, cfg).prune(sparsity=0.9).encode().to(cuda)
    vals = torch.tensor([0.82075465, -0.9150944, 0.1], dtype=torch.float32)
    pts = torch.cartesian_prod(vals, vals, vals).to(cuda)
    assert torch.equal(torch.floor(ttensorf.to_grid(cfg, pts[:1])).cpu(),
                       torch.tensor([[122.0, 122.0, 122.0]]))
    centers = torch.zeros((2, 3), device=cuda)
    cid = torch.zeros(pts.shape[0], dtype=torch.int32, device=cuda)
    spec, streams = ttensorf.fused_field_inputs(cf)
    base = ttensorf.window_base(cfg, centers)
    kw = dict(grid_res=cfg.grid_res, scene_bound=cfg.scene_bound,
              window=ttensorf.fused_window(cfg), app_dim=cfg.app_dim)
    got = fused_sample.fused_sigma_app(spec, streams, cf.extras["basis"],
                                       pts, base, cid, **kw)
    want = fused_sample.fused_sigma_app_ref(
        spec, streams, cf.extras["basis"], pts, base, cid, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def _fused_case(cfg, cf, device, order, n_points=20000, n_cubes=8, seed=1):
    """Points in `n_cubes` random cubes with `cube_id` in the serve step's
    order (two ascending runs: the hitting pairs, then the misses) or
    shuffled; returns the kernel's arguments and keywords."""
    rng = np.random.RandomState(seed)
    ci = rng.randint(0, cfg.cube_grid_res, size=(n_cubes, 3))
    centers = torch.from_numpy((-cfg.scene_bound + (ci + 0.5)
                                * cfg.cube_world()).astype(np.float32))
    cid = rng.randint(0, n_cubes, n_points)
    if order == "two_runs":
        half = n_points // 3
        cid = np.concatenate([np.sort(cid[:half]), np.sort(cid[half:])])
    cid = torch.from_numpy(cid.astype(np.int32))
    off = torch.from_numpy(rng.uniform(-cfg.cube_world(), cfg.cube_world(),
                                       (n_points, 3)).astype(np.float32))
    pts = (centers[cid.long()] + off).to(device)
    spec, streams = ttensorf.fused_field_inputs(cf)
    base = ttensorf.window_base(cfg, centers.to(device))
    kw = dict(grid_res=cfg.grid_res, scene_bound=cfg.scene_bound,
              window=ttensorf.fused_window(cfg), app_dim=cfg.app_dim)
    return (spec, streams, cf.extras["basis"], pts, base, cid.to(device)), kw


def _assert_fused_matches_plain(args, kw):
    sig, feat = fused_sample.fused_sigma_app(*args, **kw)
    torch.cuda.synchronize()
    want_sig, want_feat = fused_sample.fused_sigma_app_ref(*args, **kw)
    torch.testing.assert_close(sig, want_sig, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(feat, want_feat, rtol=1e-4, atol=1e-4)
    return sig, feat


@pytest.mark.parametrize("case", ["bitmap", "coo", "dense"])
@pytest.mark.parametrize("order", ["two_runs", "shuffled"])
def test_fused_kernel_any_cube_order(cuda, case, order):
    """A tile of points spans one or two cubes in the serve step's order
    and up to all eight when shuffled; both must be right."""
    cfg, cf = _field(case, cuda)
    args, kw = _fused_case(cfg, cf, cuda, order)
    runs = 1 + int((args[5][1:] < args[5][:-1]).sum())
    assert runs == 2 if order == "two_runs" else runs > 1000
    _assert_fused_matches_plain(args, kw)


def _full_width_field(device):
    cfg = NeRFConfig()
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(4),
                                 device="cpu")
    cf = tfield.DenseField(params, cfg).prune(sparsity=0.9).encode()
    return cfg, cf.to(device)


def test_fused_kernel_at_full_width(cuda):
    """NeRFConfig(): W 10, R 16 + 48, app_dim 27, in both orders."""
    cfg, cf = _full_width_field(cuda)
    assert (ttensorf.fused_window(cfg), cfg.r_sigma + cfg.r_color,
            cfg.app_dim) == (10, 64, 27)
    for order in ("two_runs", "shuffled"):
        args, kw = _fused_case(cfg, cf, cuda, order, n_points=30000)
        _assert_fused_matches_plain(args, kw)


@pytest.mark.parametrize("r_sigma,r_color,app_dim", [(3, 5, 8), (16, 64, 27)])
def test_fused_kernel_off_the_cached_path(cuda, r_sigma, r_color, app_dim):
    """Channel counts off the kernel's 4-channel runs (Rs not a multiple
    of 4; R above 64) take its channel-by-channel interpolation, and Rc
    off a multiple of 8 pads the mma depth."""
    cfg = NeRFConfig(grid_res=40, occ_res=40, cube_size=4, max_cubes=768,
                     r_sigma=r_sigma, r_color=r_color, app_dim=app_dim)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(5),
                                 device="cpu")
    cf = tfield.DenseField(params, cfg).prune(sparsity=0.6).encode(0.99)
    for order in ("two_runs", "shuffled"):
        args, kw = _fused_case(cfg, cf.to(cuda), cuda, order, n_points=6000)
        _assert_fused_matches_plain(args, kw)


def test_fused_wrapper_raises_when_a_window_exceeds_shared_memory(cuda):
    cfg, cf = _full_width_field(cuda)
    args, kw = _fused_case(cfg, cf, cuda, "two_runs", n_points=1000)
    before = fused_sample.fused_sigma_app.launches
    with pytest.raises(ValueError, match="232448 bytes"):
        fused_sample.fused_sigma_app(*args, **{**kw, "window": 40})
    assert fused_sample.fused_sigma_app.launches == before


def test_fused_replaced_stream_is_not_served_from_the_cache(cuda):
    """The wrapper caches a field's checks and descriptor; a stream
    tensor replaced between two calls must be read through its own
    pointer."""
    cfg, cf = _field("bitmap", cuda)
    args, kw = _fused_case(cfg, cf, cuda, "two_runs", n_points=5000)
    first = _assert_fused_matches_plain(args, kw)
    spec, streams = args[0], list(args[1])
    # the last stream of app_planes[0] (slice 6): its values or matrix
    i = sum(fused_sample.STREAMS_PER_FMT[fs[0]] for fs in spec[:7]) - 1
    streams[i] = streams[i] * 2.0 + 0.5
    args2 = (spec, tuple(streams), *args[2:])
    second = _assert_fused_matches_plain(args2, kw)
    assert not torch.allclose(first[1], second[1])


def test_wrappers_validate_cuda_inputs(cuda):
    w = _matrix(8, 64, 0.5, 0)
    enc = tsparse.encode_bitmap(w, device=cuda)
    q = torch.arange(0, 512, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bitmap_decode.bitmap_gather(enc.words.t().contiguous().t(),
                                    enc.rowptr, enc.values, q, cols=64)
    with pytest.raises(ValueError, match="int32"):
        bitmap_decode.bitmap_gather(enc.words, enc.rowptr, enc.values,
                                    q.long(), cols=64)
    with pytest.raises(ValueError):
        bitmap_decode.bitmap_gather(enc.words, enc.rowptr, enc.values, q,
                                    cols=200)
    coo = tsparse.encode_coo(w, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        coo_gather.coo_gather(coo.coords, coo.values.double(), q)


def test_engine_on_card_matches_cpu_and_launches_every_kernel(cuda):
    cfg = demo_config(tiny=True)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(2),
                                 device="cpu")
    field = tfield.DenseField(params, cfg).prune(sparsity=0.9)
    cam = trender.look_at_camera([3.0, 2.0, 1.5], [0, 0, 0], 19.2, 16, 16,
                                 device="cpu")
    cpu = RenderEngine(cfg, field, device="cpu", ray_chunk=256)
    counts = {k: k.launches for k in (fused_sample.fused_sigma_app,
                                      bitmap_decode.bitmap_gather,
                                      coo_gather.coo_gather)}
    gpu = RenderEngine(cfg, field, device=cuda, ray_chunk=256)
    assert gpu.cubes.count == cpu.cubes.count
    assert torch.equal(gpu.cubes.occ.cpu(), cpu.cubes.occ)
    want = cpu.submit(cam).result()
    got = gpu.submit(cam).result()
    assert got.stats["dispatch_path"] == "fused"
    np.testing.assert_allclose(got.img, want.img, atol=1e-4)
    assert got.stats["active_pairs_max"] == want.stats["active_pairs_max"]
    assert fused_sample.fused_sigma_app.launches > \
        counts[fused_sample.fused_sigma_app]
    assert any(k.launches > v for k, v in counts.items()
               if k is not fused_sample.fused_sigma_app)
    occ = tocc.build_occupancy(gpu.field, cfg)
    assert torch.equal(occ.cpu(), cpu.cubes.occ)


# ------------------------------------------- bitmap matmul, volume, flash ---
@pytest.mark.parametrize("rows,cols,n_cols", [(8, 32, 4), (5, 70, 3),
                                              (3, 1000, 20), (48, 25600, 8)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float16, 2e-2)])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_bitmap_matmul_kernel_matches_plain(cuda, rows, cols, n_cols, dtype,
                                            tol, density):
    """Rows off the Pallas 8-row block, ragged last words, n over the
    kernel's 8-column register tile."""
    w = _matrix(rows, cols, density, rows + cols).astype(dtype)
    enc = tsparse.encode_bitmap(w, device=cuda)
    x = torch.from_numpy(np.random.RandomState(n_cols).randn(
        cols, n_cols).astype(dtype)).to(cuda)
    want = bitmap_decode.bitmap_matmul_ref(enc.words, enc.rowptr, enc.values,
                                           x, cols)
    before = bitmap_decode.bitmap_matmul.launches
    got = bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values, x,
                                      cols=cols)
    torch.cuda.synchronize()
    assert bitmap_decode.bitmap_matmul.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (rows, n_cols)
    _assert_matmul_close(got, want, enc, x, tol)


def _assert_matmul_close(got, want, enc, x, tol):
    """float32: |got - want| <= tol * (1 + |W| @ |x|) elementwise, since a
    row sums up to 25,600 products in another order than the plain
    version's GEMM and the error scales with the summed magnitudes, not
    with the result (which may cancel). float16: both round the same fp32
    sum once, so the result itself is held to rtol = atol = tol."""
    if got.dtype == torch.float16:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        return
    scale = bitmap_decode.bitmap_matmul_ref(
        enc.words, enc.rowptr, enc.values.abs(), x.abs(), x.shape[0]).float()
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol * (1.0 + scale)).all()), float(err.max())


def test_bitmap_matmul_mixed_value_and_x_dtypes(cuda):
    w = _matrix(16, 300, 0.4, 9)
    x = torch.from_numpy(np.random.RandomState(9).randn(300, 5).astype(
        np.float32)).to(cuda)
    for vdt, xdt in ((np.float32, torch.float16), (np.float16, torch.float32)):
        enc = tsparse.encode_bitmap(w.astype(vdt), device=cuda)
        xx = x.to(xdt)
        got = bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values,
                                          xx, cols=300)
        want = bitmap_decode.bitmap_matmul_ref(enc.words, enc.rowptr,
                                               enc.values, xx, 300)
        assert got.dtype == xdt
        _assert_matmul_close(got, want, enc, xx,
                             2e-2 if xdt == torch.float16 else 1e-5)


@pytest.mark.parametrize("rows,cols", [(1, 3000), (3, 70), (48, 25600),
                                       (50, 1000)])
@pytest.mark.parametrize("n_cols", [1, 8, 9, 16])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float16, 2e-2)])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_bitmap_matmul_split_rows(cuda, rows, cols, n_cols, dtype, tol,
                                  density):
    """Rows 1 to 50 (1 to 8 segments a row), a ragged last word, fewer
    words than segments (cols 70: 3 words), n on and off the 8-column
    tile (n 8 and 16 take 16-byte loads of x, n 1 and 9 scalar ones)."""
    plan = bitmap_decode.matmul_plan(rows, (cols + 31) // 32, n_cols,
                                     bitmap_decode.sm_count(cuda))
    assert 1 <= plan.segments <= 8
    w = _matrix(rows, cols, density, rows * cols + n_cols).astype(dtype)
    enc = tsparse.encode_bitmap(w, device=cuda)
    x = torch.from_numpy(np.random.RandomState(n_cols + 1).randn(
        cols, n_cols).astype(dtype)).to(cuda)
    want = bitmap_decode.bitmap_matmul_ref(enc.words, enc.rowptr, enc.values,
                                           x, cols)
    got = bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values, x,
                                      cols=cols)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (rows, n_cols)
    _assert_matmul_close(got, want, enc, x, tol)


@pytest.mark.parametrize("vdt,xdt", [(np.float32, torch.float16),
                                     (np.float16, torch.float32)])
@pytest.mark.parametrize("n_cols", [8, 9])
def test_bitmap_matmul_split_rows_mixed_dtypes(cuda, vdt, xdt, n_cols):
    w = _matrix(48, 25600, 0.3, n_cols).astype(vdt)
    enc = tsparse.encode_bitmap(w, device=cuda)
    x = torch.from_numpy(np.random.RandomState(n_cols).randn(
        25600, n_cols).astype(np.float32)).to(cuda).to(xdt)
    got = bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values, x,
                                      cols=25600)
    want = bitmap_decode.bitmap_matmul_ref(enc.words, enc.rowptr, enc.values,
                                           x, 25600)
    assert got.dtype == xdt
    _assert_matmul_close(got, want, enc, x,
                         2e-2 if xdt == torch.float16 else 1e-5)


@pytest.mark.parametrize("n_cols,dtype,tol", [(8, np.float32, 1e-5),
                                              (9, np.float16, 2e-2)])
def test_bitmap_matmul_segments_of_several_chunks(cuda, n_cols, dtype, tol):
    """300 rows fill the SMs with one segment a row: 800 words, which the
    CTA compacts and sweeps in four chunks of 256 words."""
    plan = bitmap_decode.matmul_plan(300, 800, n_cols,
                                     bitmap_decode.sm_count(cuda))
    assert plan.segments == 1 and plan.seg_words == 800
    w = _matrix(300, 25600, 0.3, 7).astype(dtype)
    enc = tsparse.encode_bitmap(w, device=cuda)
    x = torch.from_numpy(np.random.RandomState(7).randn(
        25600, n_cols).astype(dtype)).to(cuda)
    got = bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values, x,
                                      cols=25600)
    want = bitmap_decode.bitmap_matmul_ref(enc.words, enc.rowptr, enc.values,
                                           x, 25600)
    _assert_matmul_close(got, want, enc, x, tol)


def test_bitmap_matmul_wide_x_takes_fewer_segments(cuda):
    """n = 8000: nine partial rows would not fit shared memory, so the
    plan takes 4 segments (5 partial rows) and the kernel loops over 1000
    column tiles."""
    plan = bitmap_decode.matmul_plan(2, 94, 8000, bitmap_decode.sm_count(cuda))
    assert plan.segments == 4
    w = _matrix(2, 3000, 0.3, 5)
    enc = tsparse.encode_bitmap(w, device=cuda)
    x = torch.from_numpy(np.random.RandomState(5).randn(3000, 8000).astype(
        np.float32)).to(cuda)
    got = bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values, x,
                                      cols=3000)
    want = bitmap_decode.bitmap_matmul_ref(enc.words, enc.rowptr, enc.values,
                                           x, 3000)
    _assert_matmul_close(got, want, enc, x, 1e-5)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float16, 2e-2)])
def test_bitmap_matmul_unaligned_x_takes_scalar_loads(cuda, dtype, tol):
    """x at n = 8 but 4 (fp32) or 2 (fp16) bytes off 16-byte alignment."""
    w = _matrix(48, 2000, 0.5, 3).astype(dtype)
    enc = tsparse.encode_bitmap(w, device=cuda)
    flat = torch.from_numpy(np.random.RandomState(3).randn(
        2000 * 8 + 1).astype(dtype)).to(cuda)
    x = flat[1:].view(2000, 8)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values, x,
                                      cols=2000)
    want = bitmap_decode.bitmap_matmul_ref(enc.words, enc.rowptr, enc.values,
                                           x, 2000)
    _assert_matmul_close(got, want, enc, x, tol)


def _assert_nproc_close(got, want, t_before, term_eps):
    """nproc exact, or within 1e-4 relative with every differing sample
    at term_eps: the kernel's warp scans sum in another order than the
    plain version's cumsum."""
    diff = abs(float(got) - float(want))
    if diff == 0:
        return
    near = int(((t_before - term_eps).abs() <= 1e-4 * term_eps).sum())
    assert diff <= 1e-4 * float(want) and diff <= near, (got, want, near)


def _t_before(sigma, delta):
    tau = sigma * delta
    return torch.exp(-(torch.cumsum(tau, dim=-1) - tau))


@pytest.mark.parametrize("r,n_samples", [(4096, 512), (37, 50), (1000, 100),
                                         (128, 64), (5, 1)])
@pytest.mark.parametrize("scale", [0.1, 3.0, 50.0])
def test_volume_render_kernel_matches_plain(cuda, r, n_samples, scale):
    rng = np.random.RandomState(r + n_samples)
    sigma = torch.from_numpy((np.abs(rng.randn(r, n_samples)) * scale).astype(
        np.float32)).to(cuda)
    rgb = torch.from_numpy(rng.rand(r, n_samples, 3).astype(np.float32)).to(
        cuda)
    before = tvr.volume_render.launches
    color, t_final, nproc = tvr.volume_render(sigma, rgb, delta=0.02,
                                              term_eps=1e-4)
    torch.cuda.synchronize()
    assert tvr.volume_render.launches == before + 1
    assert nproc.shape == () and nproc.dtype == torch.float32
    w_color, w_t, w_n = tvr.volume_render_ref(sigma, rgb, 0.02, 1e-4)
    torch.testing.assert_close(color, w_color, rtol=0, atol=1e-5)
    torch.testing.assert_close(t_final, w_t, rtol=0, atol=1e-5)
    _assert_nproc_close(nproc, w_n, _t_before(sigma, 0.02), 1e-4)


def test_volume_render_kernel_opaque_wall(cuda):
    sigma = torch.zeros((100, 300), device=cuda)
    sigma[:, 40] = 1e4
    rgb = torch.full((100, 300, 3), 0.5, device=cuda)
    color, t_final, nproc = tvr.volume_render(sigma, rgb, delta=0.1,
                                              term_eps=1e-4)
    assert float(nproc) == 100 * 41
    torch.testing.assert_close(t_final, torch.zeros_like(t_final), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(color, torch.full_like(color, 0.5), rtol=0,
                               atol=1e-4)


def _assert_volume_matches_plain(sigma, rgb, delta=0.02, term_eps=1e-4,
                                 rgb_plain=None):
    before = tvr.volume_render.launches
    color, t_final, nproc = tvr.volume_render(sigma, rgb, delta=delta,
                                              term_eps=term_eps)
    torch.cuda.synchronize()
    assert tvr.volume_render.launches == before + 1
    w_color, w_t, w_n = tvr.volume_render_ref(
        sigma, rgb if rgb_plain is None else rgb_plain, delta, term_eps)
    torch.testing.assert_close(color, w_color, rtol=0, atol=1e-5)
    torch.testing.assert_close(t_final, w_t, rtol=0, atol=1e-5)
    _assert_nproc_close(nproc, w_n, _t_before(sigma, delta), term_eps)
    _assert_read_bytes(sigma, rgb, delta, term_eps, (color, t_final, nproc))
    return color, t_final, nproc


def _assert_read_bytes(sigma, rgb, delta, term_eps, result):
    """The bytes the kernel's copies read, as the kernel counts them,
    equal the design's (`read_bytes` on the plain version's alive counts)
    up to the samples at term_eps, each of which may move its rgb and the
    next segment's sigma; the counting launch gives the same result."""
    counted, read = tvr.volume_render_read(sigma, rgb, delta=delta,
                                           term_eps=term_eps)
    t_before = _t_before(sigma, delta)
    want = tvr.read_bytes((t_before > term_eps).sum(-1), sigma.shape[1],
                          tvr.vector_loads(sigma, rgb))
    near = int(((t_before - term_eps).abs() <= 1e-4 * term_eps).sum())
    assert abs(read - want) <= near * (4 * tvr.SEGMENT + 16), (read, want)
    for g, w in zip(counted, result):
        assert torch.equal(g, w)


def _volume_inputs(device, r, n, scale, seed):
    rng = np.random.RandomState(seed)
    sigma = (np.abs(rng.randn(r, n)) * scale).astype(np.float32)
    rgb = rng.rand(r, n, 3).astype(np.float32)
    return torch.from_numpy(sigma).to(device), torch.from_numpy(rgb).to(device)


@pytest.mark.parametrize("n", [1500, 3, 7, 1, 516])
@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_volume_render_ragged_segments(cuda, n, scale):
    """N over one 256-sample segment and off it (1500: six segments, the
    last ragged; 516), and N off the 16-byte vector (3, 7, 1: scalar
    loads). Scale 0.05 keeps most rays alive to the end of 1500 samples;
    3.0 stops them in the first segment."""
    sigma, rgb = _volume_inputs(cuda, 300, n, scale, n)
    assert tvr.vector_loads(sigma, rgb) is (n % 4 == 0)
    _assert_volume_matches_plain(sigma, rgb)


@pytest.mark.parametrize("which", ["rgb", "sigma", "both"])
def test_volume_render_off_16_bytes_takes_scalar_loads(cuda, which):
    """rgb (or sigma) at a storage offset of one float: not 16-byte
    aligned, so the launch reads both by scalar loads, with the same
    result."""
    sigma, rgb = _volume_inputs(cuda, 200, 512, 0.5, 17)
    shifted = []
    for name, t in (("sigma", sigma), ("rgb", rgb)):
        if which in (name, "both"):
            store = torch.empty(t.numel() + 1, device=cuda)
            view = store[1:].view(t.shape)
            view.copy_(t)
            assert view.is_contiguous() and view.data_ptr() % 16 != 0
            t = view
        shifted.append(t)
    assert not tvr.vector_loads(*shifted)
    _assert_volume_matches_plain(*shifted)


@pytest.mark.parametrize("n", [512, 1500, 7])
def test_volume_render_every_ray_dead_from_sample_1(cuda, n):
    """sigma 1e4 at sample 0: only sample 0 is alive on every ray; its
    weight is 1 to fp32, so color is its rgb and T after it is 0."""
    sigma, rgb = _volume_inputs(cuda, 100, n, 1.0, 3)
    sigma[:, 0] = 1e4
    color, t_final, nproc = _assert_volume_matches_plain(sigma, rgb)
    assert float(nproc) == 100
    torch.testing.assert_close(t_final, torch.zeros_like(t_final), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(color, rgb[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,scale", [(512, 2.0), (1500, 0.5), (7, 200.0)])
def test_volume_render_ignores_rgb_behind_termination(cuda, n, scale):
    """rgb is NaN on every dead sample: the color stays finite and equals
    the plain version's on rgb zeroed there, so the kernel uses no rgb
    behind a ray's termination."""
    sigma, rgb = _volume_inputs(cuda, 256, n, scale, n + 1)
    tau = sigma * 0.02
    alive = torch.exp(-(torch.cumsum(tau, dim=-1) - tau)) > 1e-4
    assert int((~alive).sum()) > 0
    nan = rgb.masked_fill(~alive[..., None], float("nan"))
    zeroed = rgb.masked_fill(~alive[..., None], 0.0)
    color, _t, _n = _assert_volume_matches_plain(sigma, nan,
                                                 rgb_plain=zeroed)
    assert bool(torch.isfinite(color).all())


def test_volume_render_reads_only_up_to_termination(cuda):
    """Rays that stop at sample 10, 300 or never: the kernel reads one
    segment's sigma and 10 samples' rgb, two segments' sigma and 300
    samples' rgb, or the whole row, as it counts its copies."""
    sigma, rgb = _volume_inputs(cuda, 3, 512, 0.0, 5)
    sigma[0, 9], sigma[1, 299] = 1e4, 1e4
    (_c, _t, nproc), read = tvr.volume_render_read(sigma, rgb, delta=0.02)
    assert float(nproc) == 10 + 300 + 512
    assert read == (4 * 256 + 4 * 32) + (4 * 512 + 12 * 300) + 16 * 512


def test_volume_render_calls_on_two_streams_keep_their_own_counts(cuda):
    """Each call has its own nproc counters: calls in flight on two
    streams at once each count their own rays."""
    inputs = [_volume_inputs(cuda, 2000, 512, scale, 7)
              for scale in (0.05, 3.0)]
    want = [tvr.volume_render_ref(s, c, 0.02, 1e-4)[2] for s, c in inputs]
    streams = [torch.cuda.Stream(cuda) for _ in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, ((s, c), st) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(st):
                got[i].append(tvr.volume_render(s, c, delta=0.02)[2])
    torch.cuda.synchronize()
    for g, w, (s, _c) in zip(got, want, inputs):
        assert len({float(x) for x in g}) == 1
        _assert_nproc_close(g[0], w, _t_before(s, 0.02), 1e-4)


def _qkv_cuda(device, b, h, sq, sk, d, dtype, seed):
    rng = np.random.RandomState(seed)

    def make(s, scale):
        a = (rng.randn(b, h, s, d) * scale).astype(np.float32)
        return torch.from_numpy(a).to(device, dtype)
    return make(sq, 0.5), make(sk, 0.5), make(sk, 1.0)


@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 2, 128, 128, 64),
                                         (2, 3, 100, 100, 64),
                                         (1, 2, 200, 200, 128),
                                         (1, 1, 128, 256, 64),
                                         (1, 2, 130, 70, 80),
                                         (1, 32, 1024, 1024, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 1e-2, 1e-3)])
def test_flash_kernel_matches_plain(cuda, b, h, sq, sk, d, causal, dtype,
                                    rtol, atol):
    """S off the 64-row block, Sq != Sk (causal from the top left), D = 128
    and a D padded inside the kernel (80). bf16: both round the same fp32
    result once, at most one ulp (2^-7 of |o|) apart."""
    q, k, v = _qkv_cuda(cuda, b, h, sq, sk, d, dtype, sq + sk + d)
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = tflash.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if causal:           # query 0 sees key 0 alone
        torch.testing.assert_close(got[:, :, 0].float(), v[:, :, 0].float(),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 2, 130, 130, 72),
                                         (1, 3, 200, 150, 20),
                                         (1, 2, 100, 100, 33),
                                         (1, 32, 4096, 4096, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_tensor_core_shapes(cuda, b, h, sq, sk, d, causal):
    """The bf16 wgmma kernel off its TMA path's alignment: D 72 (TMA,
    padded to 128), D 20 (rows not 16-byte aligned: cp.async), D 33 (odd:
    plain loads), and the smoke's shape, Llama 3.2 1B's heads over 4096
    tokens. Held to the bf16 limit of test_flash_kernel_matches_plain."""
    q, k, v = _qkv_cuda(cuda, b, h, sq, sk, d, torch.bfloat16, sq + d)
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = tflash.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)


def test_flash_bf16_unaligned_pointer_is_staged_by_threads(cuda):
    """A contiguous view 2 bytes into its storage cannot be a TMA source:
    the same kernel stages it by cp.async and must agree."""
    q, k, v = _qkv_cuda(cuda, 1, 2, 200, 200, 64, torch.bfloat16, 5)
    shifted = []
    for t in (q, k, v):
        store = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = store[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        shifted.append(view)
    got = tflash.flash_attention(*shifted, causal=True)
    want = tflash.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)


def test_new_wrappers_validate_cuda_inputs(cuda):
    w = _matrix(8, 64, 0.5, 0)
    enc = tsparse.encode_bitmap(w, device=cuda)
    x = torch.ones((64, 4), device=cuda)
    with pytest.raises(ValueError, match="CPU"):
        bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values,
                                    x.cpu(), cols=64)
    with pytest.raises(ValueError, match="float32 or float16"):
        bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values,
                                    x.double(), cols=64)
    with pytest.raises(ValueError, match="contiguous"):
        bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values,
                                    torch.ones((4, 64), device=cuda).t(),
                                    cols=64)
    with pytest.raises(ValueError):
        bitmap_decode.bitmap_matmul(enc.words, enc.rowptr, enc.values,
                                    torch.ones((63, 4), device=cuda), cols=64)

    sigma = torch.ones((8, 16), device=cuda)
    rgb = torch.ones((8, 16, 3), device=cuda)
    with pytest.raises(ValueError, match="CPU"):
        tvr.volume_render(sigma, rgb.cpu(), delta=0.1)
    with pytest.raises(ValueError, match="float32"):
        tvr.volume_render(sigma.double(), rgb.double(), delta=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tvr.volume_render(torch.ones((16, 8), device=cuda).t(), rgb,
                          delta=0.1)
    with pytest.raises(ValueError):
        tvr.volume_render(sigma, rgb[:, :8].contiguous(), delta=0.1)

    q = torch.ones((1, 2, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="CPU"):
        tflash.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bfloat16"):
        tflash.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q, q.transpose(2, 3), q)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.ones((1, 1, 8, 160), device=cuda)
        tflash.flash_attention(big, big, big)


def _tf32(t):
    """t cut to TF32's 10 mantissa bits, as one TF32 product reads it."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _over_limit(got, want, rtol, atol):
    return float(((got.double() - want.double()).abs()
                  / (atol + rtol * want.double().abs())).max())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_three_tf32_products_hold_where_one_does_not(cuda, causal):
    """q and k at scale 2.0: operands cut to TF32 once (one TF32 product)
    land above the (1e-4, 1e-4) limit; the kernel's three products stay
    within it. The message gives both errors as shares of the limit."""
    rng = np.random.RandomState(3)
    q, k = (torch.from_numpy((rng.randn(1, 4, 512, 64) * 2.0).astype(
        np.float32)).to(cuda) for _ in range(2))
    v = torch.from_numpy(rng.randn(1, 4, 512, 64).astype(np.float32)).to(
        cuda)
    want = tflash.flash_attention_ref(q.double(), k.double(), v.double(),
                                      causal=causal)
    got = tflash.flash_attention(q, k, v, causal=causal)
    one = tflash.flash_attention_ref(_tf32(q), _tf32(k), _tf32(v),
                                     causal=causal)
    torch.cuda.synchronize()
    e_kernel = _over_limit(got, want, 1e-4, 1e-4)
    e_one = _over_limit(one, want, 1e-4, 1e-4)
    assert e_one > 1.0 and e_kernel <= 1.0, (
        f"1xTF32 {e_one:.3g} of the limit, kernel {e_kernel:.3g}")


@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 2, 100, 300, 80),
                                         (1, 2, 300, 100, 128),
                                         (1, 3, 77, 1, 64),
                                         (2, 2, 64, 1, 128),
                                         (1, 2, 150, 150, 20),
                                         (1, 2, 130, 90, 33),
                                         (1, 2, 70, 200, 66),
                                         (1, 1, 1, 5, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_tensor_core_shapes(cuda, b, h, sq, sk, d, causal):
    """The fp32 3xTF32 kernel at D 80 and 128 (DP 128: 32-key tiles, one
    raw stage), Sq != Sk both ways, Sk = 1, Sq = 1, D 20 (TMA, one partial
    panel), D 33 and 66 (rows not 16-byte aligned: cp.async by the
    threads). Held to (1e-4, 1e-4)."""
    q, k, v = _qkv_cuda(cuda, b, h, sq, sk, d, torch.float32, sq + sk + d)
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = tflash.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_flash_f32_at_the_smoke_shape(cuda):
    """Llama 3.2 1B's heads over 4096 tokens, causal: the smoke's shape."""
    q, k, v = _qkv_cuda(cuda, 1, 32, 4096, 4096, 64, torch.float32, 4096)
    got = tflash.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = tflash.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_flash_f32_unaligned_pointer_is_staged_by_threads(cuda):
    """A contiguous view one float into its storage cannot be a TMA
    source: the same kernel stages K and V by cp.async and must agree."""
    q, k, v = _qkv_cuda(cuda, 1, 2, 200, 200, 64, torch.float32, 5)
    shifted = []
    for t in (q, k, v):
        store = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = store[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        shifted.append(view)
    got = tflash.flash_attention(*shifted, causal=True)
    want = tflash.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------ the serving tier on card ---
def _oversized_cfg():
    """A small config whose fused window (30 at R 16 + 48) is past the
    sample kernel's shared memory: 2 x 2 x 2 cubes of 4 voxels."""
    cfg = NeRFConfig(grid_res=32, occ_res=8, cube_size=4, max_cubes=8,
                     mlp_hidden=16)
    assert not fused_sample.fused_fits(ttensorf.fused_window(cfg),
                                       cfg.r_sigma, cfg.r_color, cfg.app_dim)
    return cfg


def test_oversized_window_renders_through_the_per_op_gathers(cuda):
    """The card serves a field whose fused window does not fit through the
    per-op gather kernels (no fused launch), as the CPU serves it through
    the plain fused version."""
    cfg = _oversized_cfg()
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    field = tfield.DenseField(params, cfg).prune(sparsity=0.85).encode()
    cam = trender.look_at_camera([3.0, 2.0, 1.5], [0, 0, 0], 9.6, 8, 8,
                                 device="cpu")
    cpu = RenderEngine(cfg, field, device="cpu", ray_chunk=64)
    kernels = (fused_sample.fused_sigma_app, bitmap_decode.bitmap_gather,
               coo_gather.coo_gather)
    before = [k.launches for k in kernels]
    gpu = RenderEngine(cfg, field, device=cuda, ray_chunk=64)
    assert gpu.field.dispatch_path() == "per-op"
    got = gpu.submit(cam).result(timeout=120)
    torch.cuda.synchronize()
    after = [k.launches for k in kernels]
    want = cpu.submit(cam).result(timeout=120)
    assert got.stats["dispatch_path"] == "per-op"
    assert want.stats["dispatch_path"] == "fused_ref"
    assert after[0] == before[0]
    fmts = {f for fs in field.formats().values() for f in fs}
    for k, fmt, b, a in zip(kernels[1:], ("bitmap", "coo"), before[1:],
                            after[1:]):
        assert (a > b) == (fmt in fmts), (k.__name__, fmts)
    assert got.stats["active_pairs_max"] == want.stats["active_pairs_max"] > 0
    assert got.stats["processed_samples"] == want.stats["processed_samples"]
    np.testing.assert_allclose(got.img, want.img, atol=1e-4)
    with pytest.raises(ValueError, match="shared memory"):
        spec, streams = ttensorf.fused_field_inputs(gpu.field)
        pts = torch.zeros(4, 3, device=cuda)
        fused_sample.fused_sigma_app(
            spec, streams, gpu.field.extras["basis"], pts,
            torch.zeros(1, 3, dtype=torch.int32, device=cuda),
            torch.zeros(4, dtype=torch.int32, device=cuda),
            grid_res=cfg.grid_res, scene_bound=cfg.scene_bound,
            window=ttensorf.fused_window(cfg), app_dim=cfg.app_dim)


def test_occupancy_and_rays_on_card_equal_the_cpus(cuda):
    """Grid coordinates, occupancy and cube set built on the card equal
    the CPU's bit for bit (the divisions are by 0-dim device tensors);
    so do camera rays (dots and norms through `dot3` / `sqrt_rn`), and no
    hit or sample count moves."""
    cfg = demo_config()
    assert torch.equal(tocc.grid_coords(cfg, cuda).cpu(),
                       tocc.grid_coords(cfg, "cpu"))
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(4),
                                 device="cpu")
    field = tfield.DenseField(params, cfg).prune(sparsity=0.9).encode()
    occ_c = tocc.build_occupancy(field, cfg)
    occ_g = tocc.build_occupancy(field.to(cuda), cfg)
    assert torch.equal(occ_g.cpu(), occ_c)
    cubes_c = tocc.extract_cubes(occ_c, cfg)
    cubes_g = tocc.extract_cubes(occ_g, cfg)
    assert cubes_g.count == cubes_c.count > 0
    assert torch.equal(cubes_g.centers.cpu(), cubes_c.centers)
    cpu = RenderEngine(cfg, field, cubes_c, device="cpu", ray_chunk=256)
    gpu = RenderEngine(cfg, field, cubes_g, device=cuda, ray_chunk=256)
    for i, origin in enumerate(([3.0, 2.0, 1.5], [-2.5, 3.0, 0.7])):
        cams = [trender.look_at_camera(origin, [0, 0, 0], 19.2, 16, 16,
                                       device=d) for d in ("cpu", cuda)]
        (oc, dc), (og, dg) = (trender.camera_rays(c) for c in cams)
        assert torch.equal(og.cpu(), oc)
        assert torch.equal(dg.cpu(), dc)
        want = cpu.submit(cams[0]).result(timeout=120)
        got = gpu.submit(cams[1]).result(timeout=120)
        assert got.stats["processed_samples"] == \
            want.stats["processed_samples"]
        assert got.stats["active_pairs_max"] == \
            want.stats["active_pairs_max"]


def test_store_evict_frees_card_memory_and_revives_bitwise(cuda, tmp_path):
    """Evicting a scene drops every device reference to it (the card's
    allocated bytes fall by at least its factor bytes); revival rebuilds
    equal streams and cube set, and the same image."""
    import gc

    from repro_torch.serving import SceneStore
    cfg = demo_config()
    store = SceneStore(cfg, device=cuda, spill_dir=str(tmp_path))
    for s in ("a", "b"):
        params = ttensorf.init_field(cfg, torch.Generator().manual_seed(
            ord(s)), device="cpu")
        store.register(s, tfield.DenseField(params, cfg).prune(
            sparsity=0.9))
    eng = RenderEngine(cfg, store=store, ray_chunk=256)
    cam = trender.look_at_camera([3.0, 2.0, 1.5], [0, 0, 0], 19.2, 16, 16,
                                 device=cuda)
    img = eng.submit(cam, scene="a").result(timeout=120).img
    spec, arrays = tfield.field_state(store.get_field("a"))
    cubes = store.snapshot("a").cubes
    cubes = [t.cpu() for t in (cubes.centers, cubes.valid, cubes.occ)]
    nbytes = store.stats("a")["factor_bytes"]
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    store.evict("a")
    gc.collect()
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    assert m0 - m1 >= nbytes, (m0, m1, nbytes)
    assert store.resident_scenes() == ["b"]
    spec2, arrays2 = tfield.field_state(store.get_field("a"))
    assert spec2 == spec and sorted(arrays2) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(arrays2[k], arrays[k])
    back = store.snapshot("a").cubes
    for a, b in zip((back.centers, back.valid, back.occ), cubes):
        assert torch.equal(a.cpu(), b)
    again = eng.submit(cam, scene="a").result(timeout=120).img
    np.testing.assert_allclose(again, img, atol=1e-6)


def test_auto_flush_result_timeout_on_card(cuda):
    cfg = demo_config(tiny=True)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(5),
                                 device="cpu")
    field = tfield.DenseField(params, cfg).prune(sparsity=0.9)
    cam = trender.look_at_camera([3.0, 2.0, 1.5], [0, 0, 0], 19.2, 16, 16,
                                 device=cuda)
    import threading

    eng = RenderEngine(cfg, field, scene_name="a", device=cuda,
                       ray_chunk=256, max_batch_views=3,
                       auto_flush_interval=0.01)
    try:
        eng.register_scene("b", field)
        futs = []

        def producer():
            for s in ("a", "b"):
                futs.append(eng.submit(cam, scene=s))

        threads = [threading.Thread(target=producer) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        results = [f.result(timeout=60) for f in futs]
        flusher = eng._flusher
    finally:
        eng.close(timeout=60)
    assert not flusher.is_alive()
    assert len(results) == 4 and not any(r.timed_out for r in results)
    for r in results[1:]:       # index_add_ on the card is atomic: 1e-6
        np.testing.assert_allclose(r.img, results[0].img, atol=1e-6)


# ---------------------------------------------------- the evaluation path ---
def _eval_inputs(cfg, seed, device):
    """(CPU field, its cube set on the CPU, the same on `device`): a
    pruned field with its sigma planes and appearance lines encoded as
    bitmaps and the rest as COO."""
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")
    dense = tfield.DenseField(params, cfg).prune(sparsity=0.75)
    bm, co = dense.encode(0.99), dense.encode(0.0)
    field = tfield.CompressedField(
        {k: (bm if k in ("sigma_planes", "app_lines") else co).factors[k]
         for k in tsparse.FACTOR_KEYS}, bm.extras, cfg, bm.threshold)
    cubes = tocc.extract_cubes(tocc.build_occupancy(field, cfg), cfg)
    assert cubes.count > 0
    on_dev = tocc.cubes_from_arrays(cubes.centers, cubes.valid, cubes.count,
                                    cubes.radius, cubes.occ, device=device)
    return field, cubes, field.to(device), on_dev


def _camera_on(cam, device):
    return trender.Camera(cam.c2w.to(device), cam.origin.to(device),
                          cam.focal, cam.h, cam.w)


def _launches():
    return {k.__name__: k.launches for k in (
        fused_sample.fused_sigma_app, bitmap_decode.bitmap_gather,
        coo_gather.coo_gather)}


def _grown(before, after):
    return {k: after[k] - before[k] for k in before}


@pytest.mark.parametrize("chunk,intersect,order_mode", [
    (8, "box", "octant"), (1, "ball", "distance")])
def test_render_rtnerf_on_card_matches_cpu(cuda, chunk, intersect,
                                           order_mode):
    """render_rtnerf on the card launches the fused kernel once a scan
    step and no gather; image within 1e-4 of the CPU's plain path, every
    count equal."""
    from repro_torch.core import pipeline as tpipe
    cfg = demo_config(tiny=True)
    field, cubes, gfield, gcubes = _eval_inputs(cfg, 5, cuda)
    cam = trender.look_at_camera([3.0, 2.0, 1.5], [0, 0, 0], 19.2, 16, 16,
                                 device="cpu")
    kw = dict(chunk=chunk, intersect=intersect, order_mode=order_mode)
    want_img, want = tpipe.render_rtnerf(field, cfg, cubes, cam, **kw)
    before = _launches()
    got_img, got = tpipe.render_rtnerf(gfield, cfg, gcubes,
                                       _camera_on(cam, cuda), **kw)
    torch.cuda.synchronize()
    grown = _grown(before, _launches())
    assert grown == {"fused_sigma_app": -(-cubes.count // chunk),
                     "bitmap_gather": 0, "coo_gather": 0}
    assert got_img.device.type == "cuda"
    np.testing.assert_allclose(got_img.cpu().numpy(), want_img.numpy(),
                               atol=1e-4)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert float(want["processed_samples"]) > 0
    with pytest.raises(ValueError, match="one device"):
        tpipe.render_rtnerf(gfield, cfg, gcubes, cam, **kw)


def test_render_uniform_on_card_matches_cpu(cuda, monkeypatch):
    """render_uniform on an encoded field gathers every sample through
    the bitmap and COO kernels (no fused launch), in several passes;
    colours within 1e-4 of the CPU's, counts equal."""
    cfg = demo_config(tiny=True)
    field, cubes, gfield, gcubes = _eval_inputs(cfg, 6, cuda)
    fmts = {f for fs in field.formats().values() for f in fs}
    assert {"bitmap", "coo"} <= fmts
    cam = trender.look_at_camera([-2.5, 3.0, 0.7], [0, 0, 0], 19.2, 16, 16,
                                 device="cpu")
    o, d = trender.camera_rays(cam)
    monkeypatch.setattr(trender, "UNIFORM_PASS_SAMPLES",
                        100 * cfg.max_samples_per_ray)
    want_img, want = trender.render_uniform(field, cfg, cubes, o, d)
    before = _launches()
    got_img, got = trender.render_uniform(gfield, cfg, gcubes, o.to(cuda),
                                          d.to(cuda))
    torch.cuda.synchronize()
    grown = _grown(before, _launches())
    assert grown["fused_sigma_app"] == 0
    assert grown["bitmap_gather"] > 0 and grown["coo_gather"] > 0
    np.testing.assert_allclose(got_img.cpu().numpy(), want_img.numpy(),
                               atol=1e-4)
    for k in want:
        assert float(got[k]) == float(want[k]), k


def test_eval_view_on_card_matches_cpu(cuda):
    from repro_torch.core import train as ttrain
    from repro_torch.data import rays as trays
    cfg = demo_config(tiny=True)
    field, cubes, gfield, gcubes = _eval_inputs(cfg, 7, cuda)
    cam = trays.make_cameras(3, 16, 16, device="cpu")[1]
    gt = trays.render_gt(trays.make_scene("lego"), cam)
    for pipeline in ("rtnerf", "uniform"):
        want = ttrain.eval_view(field, cfg, cubes, cam, gt, pipeline=pipeline,
                                chunk=8)
        got = ttrain.eval_view(gfield, cfg, gcubes, _camera_on(cam, cuda),
                               gt.to(cuda), pipeline=pipeline, chunk=8)
        assert abs(got[0] - want[0]) < 1e-3
        assert got[1] == want[1]


@pytest.mark.parametrize("name", ["lego", "ficus", "drums"])
def test_render_gt_on_card_equals_cpu(cuda, name):
    """The ground truth's camera, rays and sphere trace are elementwise
    ops that round alike on both devices: the same bits on the card."""
    from repro_torch.data import rays as trays
    scene = trays.make_scene(name)
    cams = [trays.make_cameras(4, 32, 40, device=d)[1] for d in ("cpu", cuda)]
    assert torch.equal(cams[1].c2w.cpu(), cams[0].c2w)
    want = trays.render_gt(scene, cams[0])
    got = trays.render_gt(scene, cams[1])
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert float(want.min()) < 0.95


def test_render_rtnerf_oversized_window_takes_the_per_op_gathers(cuda):
    """A field whose fused window does not fit the kernel's shared memory
    renders through the bitmap / COO gathers on the card (no fused
    launch), as the CPU renders it through the plain fused version."""
    from repro_torch.core import pipeline as tpipe
    cfg = _oversized_cfg()
    field, cubes, gfield, gcubes = _eval_inputs(cfg, 8, cuda)
    assert gfield.dispatch_path() == "per-op"
    cam = trender.look_at_camera([3.0, 2.0, 1.5], [0, 0, 0], 9.6, 8, 8,
                                 device="cpu")
    want_img, want = tpipe.render_rtnerf(field, cfg, cubes, cam, chunk=2)
    before = _launches()
    got_img, got = tpipe.render_rtnerf(gfield, cfg, gcubes,
                                       _camera_on(cam, cuda), chunk=2)
    torch.cuda.synchronize()
    grown = _grown(before, _launches())
    assert grown["fused_sigma_app"] == 0
    fmts = {f for fs in field.formats().values() for f in fs}
    for k, fmt in (("bitmap_gather", "bitmap"), ("coo_gather", "coo")):
        assert (grown[k] > 0) == (fmt in fmts), (k, fmts)
    np.testing.assert_allclose(got_img.cpu().numpy(), want_img.numpy(),
                               atol=1e-4)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert float(want["processed_samples"]) > 0


# -- the gathers' backward kernels and a training step ------------------

def _bwd_tol(slot, found, grad, nvalues):
    """Per value slot, the bound on the difference of two fp32 sums of the
    same k terms in different orders (the kernel's atomics against the
    plain version's index_add_): 2 k 2^-24 times the sum of their |g|.
    Slots no query reads must be exactly 0 on both."""
    dev = grad.device
    k = torch.zeros(nvalues, dtype=torch.float64, device=dev).index_add_(
        0, slot[found], torch.ones_like(grad[found], dtype=torch.float64))
    s = torch.zeros(nvalues, dtype=torch.float64, device=dev).index_add_(
        0, slot[found], grad[found].abs().double())
    return 2.0 * k * 2.0 ** -24 * s, k


def _check_bwd(got, want, tol, k):
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= tol).all()), float((diff - tol).max())
    assert bool((got[k == 0] == 0).all()) and bool((want[k == 0] == 0).all())


def _bwd_queries(rows, cols, nq, seed, repeat):
    """nq int32 queries: runs of `repeat` equal queries (a warp's atomics
    on one slot), the rest uniform over the matrix."""
    rng = np.random.RandomState(seed)
    q = rng.randint(0, rows * cols, nq).astype(np.int32)
    if repeat > 1:
        q = np.repeat(q[: -(-nq // repeat)], repeat)[:nq]
    return q


@pytest.mark.parametrize("rows,cols,nq", [(8, 32, 1000), (40, 70, 4096),
                                          (16, 25600, 1 << 20)])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("repeat", [1, 64])
def test_bitmap_gather_bwd_kernel_matches_plain(cuda, rows, cols, nq,
                                                density, repeat):
    """Pad slots (nnz below the padded length), queries on zeros and runs
    of queries on one slot: the kernel's sums within the reordering bound
    of the plain version's, exact zeros where no query reads."""
    w = _matrix(rows, cols, density, rows + cols + repeat)
    enc = tsparse.encode_bitmap(w, device=cuda)
    q = torch.from_numpy(_bwd_queries(rows, cols, nq, nq, repeat)).to(cuda)
    g = torch.from_numpy(np.random.RandomState(7).randn(nq).astype(
        np.float32)).to(cuda)
    g[::5] = 0.0
    n = enc.values.shape[0]
    want = bitmap_decode.bitmap_gather_bwd_ref(enc.words, enc.rowptr, q, g,
                                               n, cols, rank=enc.rank)
    slot, bit = bitmap_decode.bitmap_slots(enc.words, enc.rowptr, n, q, cols,
                                           enc.rank)
    tol, k = _bwd_tol(slot, bit, g, n)
    for rank in (enc.rank, None):
        before = bitmap_decode.bitmap_gather_bwd.launches
        got = bitmap_decode.bitmap_gather_bwd(enc.words, enc.rowptr, q, g,
                                              nvalues=n, cols=cols,
                                              rank=rank)
        torch.cuda.synchronize()
        assert bitmap_decode.bitmap_gather_bwd.launches == before + 1
        _check_bwd(got, want, tol, k)
    assert bool((got[enc.nnz:] == 0).all())


@pytest.mark.parametrize("size,nq", [(5, 128), (1000, 4096),
                                     (409600, 1 << 20)])
@pytest.mark.parametrize("sparsity", [0.5, 0.95, 1.0])
@pytest.mark.parametrize("repeat", [1, 64])
def test_coo_gather_bwd_kernel_matches_plain(cuda, size, nq, sparsity,
                                             repeat):
    """As the bitmap backward: pad entries, absent queries, repeated
    slots; an all-zero stream (sparsity 1) gets an all-zero gradient."""
    rng = np.random.RandomState(size + repeat)
    flat = rng.randn(size).astype(np.float32)
    flat[rng.rand(size) < sparsity] = 0
    enc = tsparse.encode_coo(flat.reshape(1, -1), device=cuda)
    q = torch.from_numpy(_bwd_queries(1, size, nq, nq, repeat)).to(cuda)
    g = torch.from_numpy(rng.randn(nq).astype(np.float32)).to(cuda)
    want = coo_gather.coo_gather_bwd_ref(enc.coords, q, g)
    slot, found = coo_gather.coo_slots(enc.coords, q)
    tol, k = _bwd_tol(slot, found, g, enc.coords.shape[0])
    before = coo_gather.coo_gather_bwd.launches
    got = coo_gather.coo_gather_bwd(enc.coords, q, g)
    torch.cuda.synchronize()
    assert coo_gather.coo_gather_bwd.launches == before + 1
    _check_bwd(got, want, tol, k)
    assert bool((got[enc.nnz:] == 0).all())
    if sparsity == 1.0:
        assert not bool(got.any())


def test_gather_bwd_wrappers_validate_cuda_inputs(cuda):
    w = _matrix(8, 64, 0.5, 3)
    enc = tsparse.encode_bitmap(w, device=cuda)
    q = torch.zeros(16, dtype=torch.int32, device=cuda)
    g = torch.zeros(16, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        bitmap_decode.bitmap_gather_bwd(enc.words, enc.rowptr, q, g.double(),
                                        nvalues=enc.values.shape[0], cols=64)
    with pytest.raises(ValueError, match="shape"):
        bitmap_decode.bitmap_gather_bwd(enc.words, enc.rowptr, q, g[:8],
                                        nvalues=enc.values.shape[0], cols=64)
    with pytest.raises(ValueError, match="CPU and on"):
        bitmap_decode.bitmap_gather_bwd(enc.words, enc.rowptr, q, g.cpu(),
                                        nvalues=enc.values.shape[0], cols=64)
    coo = tsparse.encode_coo(w, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        coo_gather.coo_gather_bwd(coo.coords, q.long(), g)
    with pytest.raises(ValueError, match="contiguous"):
        coo_gather.coo_gather_bwd(coo.coords, q, torch.zeros(
            32, device=cuda)[::2])


def _bwd_launches():
    return {k.__name__: k.launches for k in (
        bitmap_decode.bitmap_gather, coo_gather.coo_gather,
        bitmap_decode.bitmap_gather_bwd, coo_gather.coo_gather_bwd)}


def test_training_step_on_card_matches_cpu(cuda):
    """One loss and gradient of every trainable leaf of a bitmap + COO
    field, on the card (forward and backward kernels) against the CPU's
    plain path: loss within 1e-5 relative, each gradient within 1e-4 of
    its leaf's largest |gradient| (sums in another order: GEMM blocking,
    atomics, the card's exp and log); then three adamw steps on the same
    gradients within 1e-6 relative and 1e-5 of lr."""
    from repro_torch.core import train as ttrain
    from repro_torch.data import rays as trays
    from repro_torch.optim import adamw
    cfg = demo_config(tiny=True)
    field, _, gfield, _ = _eval_inputs(cfg, 9, cuda)
    ds = trays.build_dataset(trays.make_scene("lego"), 2, 16, 16,
                             device="cpu")
    ro, rd, tgt = next(ds.batches(cfg.train_rays, seed=0))
    want = ttrain.loss_and_grads(field, cfg, ro, rd, tgt)
    before = _bwd_launches()
    got = ttrain.loss_and_grads(gfield, cfg, ro.to(cuda), rd.to(cuda),
                                tgt.to(cuda))
    torch.cuda.synchronize()
    grown = _grown(before, _bwd_launches())
    assert all(n > 0 for n in grown.values()), grown
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * float(want[0])
    assert got[2].keys() == want[2].keys()
    for k, w in want[2].items():
        scale = float(w.abs().max())
        assert float((got[2][k].cpu() - w).abs().max()) <= 1e-4 * scale, k
    # adamw on the same gradients: elementwise, rounded alike but for the
    # card's pow (1 - b2 ** step), within a few ulps of the bias correction
    opt = adamw(lr=cfg.lr_grid, b2=0.99)
    tv = field.trainable()
    state = opt.init(tv)
    tv_gpu = {k: v.to(cuda) for k, v in tv.items()}
    state_gpu = opt.init(tv_gpu)
    for _ in range(3):
        tv, state = opt.update(want[2], state, tv)
        tv_gpu, state_gpu = opt.update(
            {k: g.to(cuda) for k, g in want[2].items()}, state_gpu, tv_gpu)
    for k in tv:
        np.testing.assert_allclose(tv_gpu[k].cpu().numpy(), tv[k].numpy(),
                                   rtol=1e-6, atol=1e-5 * cfg.lr_grid,
                                   err_msg=k)


def test_fleet_workers_serve_on_the_card(cuda, tmp_path):
    """A 2-worker router on the card at demo_config(tiny=True): each worker
    reports device cuda, the fused path and fused launches; the replicas'
    images agree with the in-process card engine's within 1e-4, and
    close() leaves no worker alive."""
    import multiprocessing as mp

    from repro_torch.serving import FleetRouter, export_scene
    cfg = demo_config(tiny=True)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(2),
                                 device="cpu")
    field = tfield.DenseField(params, cfg).prune(sparsity=0.9).encode()
    cam = trender.look_at_camera([3.0, 2.0, 1.5], [0, 0, 0], 19.2, 16, 16,
                                 device="cpu")
    want = RenderEngine(cfg, field, device=cuda, ray_chunk=256).submit(
        cam).result(timeout=120)
    assert want.stats["dispatch_path"] == "fused"
    paths = {name: export_scene(str(tmp_path / name), field.to(cuda),
                                cfg=cfg, scene=name) for name in ("a", "b")}
    router = FleetRouter(cfg, paths, n_workers=2,
                         engine_kwargs={"device": "cuda", "ray_chunk": 256})
    try:
        router.set_replicas("a", 2)
        replicas = router.replica_workers("a")
        assert sorted(replicas) == ["w0", "w1"]
        for w in replicas:
            r = router.submit(cam, scene="a", prefer_worker=w).result(
                timeout=300)
            assert r.worker == w and not r.timed_out
            np.testing.assert_allclose(r.img, want.img, atol=1e-4)
        stats = router.stats()["workers"]
        assert sorted(stats) == ["w0", "w1"]
        for w, s in stats.items():
            assert s["device"] == "cuda"
            assert s["scene_dispatch_path"]["a"] == "fused"
            assert s["launches"]["fused_sigma_app"] > 0
    finally:
        router.close()
    assert not mp.active_children()


# -- language-model serving (plain PyTorch ops; no kernel of the port) ------

LM_DENSE = ("llama3.2-1b", "granite-3-8b", "qwen1.5-32b", "granite-34b",
            "internvl2-76b")


def _lm_logits(cfg, params, tokens, frontend, teacher, dev,
               enc_frames=None):
    """Prefill, then decode `teacher`'s tokens; every step's logits."""
    from repro_torch.models import transformer as tf
    B, P = tokens.shape
    nf = 0 if frontend is None else frontend.shape[1]
    batch = {"tokens": tokens.to(dev)}
    if frontend is not None:
        batch["frontend"] = frontend.to(dev)
    if enc_frames is not None:
        batch["enc_frames"] = enc_frames.to(dev)
    with torch.no_grad():
        logits, cache = tf.model_prefill(params, cfg, batch)
        shapes, _ = tf.serve_cache_spec(
            cfg, B, nf + P + teacher.shape[1],
            enc_len=0 if enc_frames is None else enc_frames.shape[1])
        cache = tf.grow_cache(cache, shapes)
        out = [logits]
        for i in range(teacher.shape[1]):
            logits, cache = tf.model_decode(
                params, cfg, teacher[:, i:i + 1].to(dev), nf + P + i, cache,
                seq_len=nf + P + teacher.shape[1])
            out.append(logits)
    return torch.cat(out, dim=1).float().cpu()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("name", LM_DENSE)
def test_lm_prefill_and_decode_on_card_equal_the_cpus(cuda, name, dtype,
                                                      tol):
    """The reduced config's params drawn on the CPU and copied over; the
    same prompt and teacher tokens. float32 to 1e-4 (cuBLAS sums in
    another order), bfloat16 to 3e-2 (the two devices round bf16 sums
    apart; the reference's decode-parity bound)."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import split_pl, tree_map
    cfg = reduced(ARCHS[name])
    gen = torch.Generator().manual_seed(3)
    params, _ = split_pl(tf.init_model(cfg, gen, dtype=dtype, device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, 10), generator=gen)
    teacher = torch.randint(0, cfg.vocab, (2, 3), generator=gen)
    frontend = (torch.randn(2, cfg.n_frontend_tokens, cfg.d_model,
                            generator=gen) if cfg.frontend else None)
    want = _lm_logits(cfg, params, tokens, frontend, teacher, "cpu")
    got = _lm_logits(cfg, tree_map(lambda a: a.to(cuda), params), tokens,
                     frontend, teacher, cuda)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


LM_OTHER = ("deepseek-v3-671b", "grok-1-314b", "zamba2-7b", "rwkv6-1.6b",
            "seamless-m4t-large-v2")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("name", LM_OTHER)
def test_lm_other_families_on_card_equal_the_cpus(cuda, name, dtype, tol):
    """MLA + MoE (bitmap dispatch at the reduced config), GQA + MoE (COO),
    the Mamba2 hybrid, RWKV6 and the encoder-decoder: the reduced
    config's params drawn on the CPU and copied over, the same prompt,
    encoder frames and teacher tokens, every step's logits, to the
    tolerances of the dense archs."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import split_pl, tree_map
    cfg = reduced(ARCHS[name])
    gen = torch.Generator().manual_seed(4)
    params, _ = split_pl(tf.init_model(cfg, gen, dtype=dtype, device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, 10), generator=gen)
    teacher = torch.randint(0, cfg.vocab, (2, 3), generator=gen)
    frames = (torch.randn(2, 10, cfg.d_model, generator=gen).to(
        torch.bfloat16) if cfg.enc_dec else None)
    want = _lm_logits(cfg, params, tokens, None, teacher, "cpu", frames)
    got = _lm_logits(cfg, tree_map(lambda a: a.to(cuda), params), tokens,
                     None, teacher, cuda, frames)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_lm_launcher_runs_on_the_card(cuda, capsys):
    from repro_torch.launch import serve as tserve
    toks = tserve.serve_lm(tserve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"]))
    out = capsys.readouterr().out
    assert toks.device.type == "cuda" and tuple(toks.shape) == (2, 4)
    assert f"[serve] device: {torch.cuda.get_device_name(cuda)}" in out


def test_lm_train_step_on_card_equals_the_cpus(cuda):
    """One `build_train_step` step of reduced llama3.2-1b in float32
    (AdamW with the launcher's schedule, the clip), the same params and
    TokenStream batch on both devices: loss 1e-5 relative, every gradient
    leaf within 1e-4 of its largest, the params to AdamW's first-step
    rule at 1e-4 (`_train_bounds`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import elastic, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import split_pl, tree_map
    from repro_torch.models.sharding import make_rules
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.optim.optimizers import tree_leaves
    cfg = reduced(ARCHS["llama3.2-1b"])
    gen = torch.Generator().manual_seed(5)
    params, _ = split_pl(tf.init_model(cfg, gen, dtype=torch.float32,
                                       device="cpu"))
    stream = TokenStream(cfg, ShapeConfig("t", 16, 4, "train"), device="cpu")
    runs = []
    for dev in (torch.device("cpu"), cuda):
        p = tree_map(lambda a: a.to(dev), params)
        batch = {k: v.to(dev) for k, v in stream.batch(0).items()}
        loss, _, grads = steps.loss_and_grads(cfg, p, batch)
        opt = adamw(lr=3e-4, schedule=cosine_schedule(1, 20))
        step = steps.build_train_step(
            cfg, make_rules(elastic.make_mesh_from([dev], 1)), opt)
        new, state, metrics = step(p, opt.init(p), batch)
        runs.append((loss, grads, new, state, metrics))
    (l0, g0, p0, s0, m0), (l1, g1, p1, _, m1) = runs
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    assert abs(float(m1["grad_norm"]) - float(m0["grad_norm"])) <= \
        1e-5 * float(m0["grad_norm"])
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    for a, b, m in zip(tree_leaves(p1), tree_leaves(p0),
                       tree_leaves(s0["m"])):
        assert adamw_first_step_excess(
            a.float().cpu().numpy(), b.float().numpy(), m.numpy(), 3e-4,
            0.9, 1e-8, 1e-4) <= 1.0


def test_token_stream_is_the_same_on_card(cuda):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.data.tokens import TokenStream
    for name in ("internvl2-76b", "seamless-m4t-large-v2"):
        cfg = reduced(ARCHS[name])
        shape = ShapeConfig("t", 24, 4, "train")
        on_card = TokenStream(cfg, shape, seed=2).batch(7)
        on_cpu = TokenStream(cfg, shape, seed=2, device="cpu").batch(7)
        assert list(on_card) == list(on_cpu)
        for k in on_cpu:
            assert on_card[k].device.type == "cuda"
            assert torch.equal(on_card[k].cpu(), on_cpu[k]), (name, k)


def test_bf16_checkpoint_round_trip_from_the_card(cuda, tmp_path):
    """bf16 params and their AdamW state saved from the card through the
    manager's async save, restored onto the card and onto the CPU bit for
    bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import tree_leaves
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = {"w": torch.randn(64, 48, generator=gen, device=cuda).to(
        torch.bfloat16), "b": {"c": torch.randn(7, generator=gen,
                                                device=cuda).to(
        torch.bfloat16)}}
    opt = adamw(lr=1e-2)
    params, state = opt.update(params, opt.init(params), params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(0, (params, state))
    mgr.wait(timeout=60)
    for dev in (cuda, torch.device("cpu")):
        step, got = mgr.restore_latest((params, opt.init(params)),
                                       device=dev)
        assert step == 0
        for a, b in zip(tree_leaves(got[0]) + tree_leaves(got[1]),
                        tree_leaves(params) + tree_leaves(state)):
            assert a.device.type == dev.type and a.dtype == b.dtype
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a.cpu(), b.cpu())
