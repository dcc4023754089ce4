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
from repro_torch.serving import RenderEngine

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
