"""Host-side logic of the fused kernel's wrapper, on the CPU: the shared
memory the sample kernel needs (against the configs the port ships), the
padded scratch blocks, the key that guards the cached field checks and
descriptor, and the validation helpers that build messages only on
failure. The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import pytest
import torch

from repro_torch.configs.rtnerf import NeRFConfig, demo_config
from repro_torch.core import field as tfield
from repro_torch.core import tensorf as ttensorf
from repro_torch.kernels import _build, fused_sample

CONFIGS = {"full": NeRFConfig, "demo": demo_config,
           "tiny": lambda: demo_config(tiny=True)}


def _field(cfg):
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    cf = tfield.DenseField(params, cfg).prune(sparsity=0.6).encode(0.99)
    spec, streams = ttensorf.fused_field_inputs(cf)
    return spec, list(streams), cf.extras["basis"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_shipped_config_fits_shared_memory(name):
    cfg = CONFIGS[name]()
    w = ttensorf.fused_window(cfg)
    need = fused_sample.fused_smem_bytes(w, cfg.r_sigma, cfg.r_color)
    assert fused_sample.check_smem_fit(w, cfg.r_sigma, cfg.r_color) == need
    # two CTAs of the sample kernel share an SM's 228 KB
    assert 2 * (need + 1024) <= 228 * 1024


def test_smem_bytes_of_the_full_width_config_by_hand():
    # window 10 x 10 x 64 and 10 x 64 floats, comp 256 points x (48 + 4),
    # basis 3 x 48 x 40, points 5 x 256 + 8; then the 8-byte mbarrier
    floats = 6400 + 640 + 256 * 52 + 3 * 48 * 40 + 5 * 256 + 8
    assert fused_sample.fused_smem_bytes(10, 16, 48) == 4 * floats + 8
    # a narrow field: comp is the (256, 32) output staging, Rc pads to 8
    floats = 52 + 28 + 256 * 32 + 3 * 8 * 40 + 5 * 256 + 8
    assert fused_sample.fused_smem_bytes(2, 12, 1) == 4 * floats + 8


@pytest.mark.parametrize("rc", [1, 8, 13, 16, 24, 48, 50])
def test_comp_rows_spread_over_banks(rc):
    """A row holds the channels padded to the mma depth, and its stride is
    4 mod 8 floats, so an A-fragment load (8 points x 4 channels) touches
    32 distinct banks."""
    cs = fused_sample.comp_stride(rc)
    assert cs >= rc and (cs - 4) % 8 == 0 and cs - 4 >= rc
    assert len({(g * cs + t) % 32 for g in range(8) for t in range(4)}) == 32


def test_window_past_shared_memory_raises_naming_the_limit():
    with pytest.raises(ValueError, match="232448 bytes"):
        fused_sample.check_smem_fit(40, 16, 48)
    sizes = [fused_sample.fused_smem_bytes(w, 16, 48) for w in range(2, 40)]
    assert sizes == sorted(sizes)
    largest = max(w for w in range(2, 40)
                  if fused_sample.fused_smem_bytes(w, 16, 48)
                  <= fused_sample.MAX_SMEM_BYTES)
    assert 10 < largest < 40
    fused_sample.check_smem_fit(largest, 16, 48)
    with pytest.raises(ValueError, match="shared memory"):
        fused_sample.check_smem_fit(largest + 1, 16, 48)


@pytest.mark.parametrize("w,r", [(2, 1), (3, 3), (7, 12), (10, 64), (5, 5)])
def test_window_blocks_are_padded_to_16_bytes(w, r):
    pb, lb = fused_sample.window_block_floats(w, r)
    for got, need in ((pb, w * w * r), (lb, w * r)):
        assert got % 4 == 0 and need <= got < need + 4


def test_field_key_changes_with_any_stream_tensor():
    spec, streams, basis = _field(demo_config(tiny=True))
    kw = dict(app_dim=8, window=10, grid_res=24)
    key = fused_sample.field_key(spec, streams, basis, **kw)
    assert fused_sample.field_key(spec, list(streams), basis, **kw) == key
    i = next(j for j, s in enumerate(streams) if s.dim() == 1 and s.numel() > 2)
    for changed in (streams[i].clone(),                 # pointer
                    streams[i][:-1],                    # shape, same pointer
                    streams[i].view(torch.int32)        # dtype, same bytes
                    if streams[i].dtype == torch.float32
                    else streams[i].view(torch.float32)):
        other = list(streams)
        other[i] = changed
        assert fused_sample.field_key(spec, other, basis, **kw) != key
    j = next(j for j, s in enumerate(streams)
             if s.dim() == 2 and min(s.shape) > 1)
    x = streams[j]
    other = list(streams)
    other[j] = x.as_strided(x.shape, (1, x.shape[0]))   # strides only
    assert other[j].data_ptr() == x.data_ptr()
    assert fused_sample.field_key(spec, other, basis, **kw) != key
    assert fused_sample.field_key(spec, streams, basis.clone(), **kw) != key
    for k, v in (("app_dim", 7), ("window", 9), ("grid_res", 25)):
        assert fused_sample.field_key(spec, streams, basis,
                                      **{**kw, k: v}) != key


def test_field_plan_checks_once_per_key(monkeypatch):
    spec, streams, basis = _field(demo_config(tiny=True))
    calls = []
    monkeypatch.setattr(fused_sample, "_PLANS", {})
    monkeypatch.setattr(fused_sample, "_check_field",
                        lambda sp, groups, b, a: calls.append(1) or (4, 8))
    monkeypatch.setattr(fused_sample, "_descriptor", lambda groups: "desc")
    kw = dict(app_dim=8, window=10, grid_res=24)
    assert fused_sample._field_plan(spec, streams, basis, **kw) == \
        (4, 8, "desc")
    fused_sample._field_plan(spec, streams, basis, **kw)
    assert len(calls) == 1
    other = list(streams)
    other[0] = streams[0].clone()          # a replaced tensor: checked anew
    fused_sample._field_plan(spec, other, basis, **kw)
    assert len(calls) == 2
    for w in range(2, 2 + 2 * fused_sample.PLAN_CACHE_SIZE):
        fused_sample._field_plan(spec, streams, basis,
                                 **{**kw, "window": w})
    assert len(fused_sample._PLANS) == fused_sample.PLAN_CACHE_SIZE


def test_field_plan_keeps_no_failed_field(monkeypatch):
    spec, streams, basis = _field(demo_config(tiny=True))
    monkeypatch.setattr(fused_sample, "_PLANS", {})
    with pytest.raises(ValueError, match="CUDA"):      # CPU streams
        fused_sample._field_plan(spec, streams, basis, app_dim=8, window=10,
                                 grid_res=24)
    assert fused_sample._PLANS == {}
    monkeypatch.setattr(fused_sample, "_check_field",
                        lambda sp, groups, b, a: (4, 8))
    with pytest.raises(ValueError, match="shared memory"):
        fused_sample._field_plan(spec, streams, basis, app_dim=8, window=80,
                                 grid_res=100)
    assert fused_sample._PLANS == {}


class _Unprintable:
    def __format__(self, spec):
        raise AssertionError("message built for a check that passed")


def test_validation_builds_messages_only_on_failure():
    _build.require(True, "never {}", _Unprintable())
    with pytest.raises(ValueError, match="^x 3 y$"):
        _build.require(False, "x {} y", 3)
    with pytest.raises(ValueError, match="^as {is}$"):
        _build.require(False, "as {is}")          # no args: taken as is
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _build.require_cuda("t", torch.ones(2), torch.float32)


@pytest.mark.parametrize("window,app_dim,fits", [
    (10, 27, True), (23, 27, True), (24, 27, False), (31, 27, False),
    (10, 32, True), (10, 33, False)])
def test_fused_fits_is_the_smem_and_app_dim_limit(window, app_dim, fits):
    """The predicate the dispatch consults: shared memory within the
    limit (W 23 needs 222,760 bytes, W 24 235,048 at R 16 + 48) and
    app_dim within MAX_APP_DIM."""
    assert fused_sample.fused_fits(window, 16, 48, app_dim) is fits
    assert fits == (app_dim <= fused_sample.MAX_APP_DIM and
                    fused_sample.fused_smem_bytes(window, 16, 48)
                    <= fused_sample.MAX_SMEM_BYTES)


@pytest.mark.parametrize("cube_size,route", [(4, "fused"), (16, "per-op")])
def test_dispatch_routes_oversized_windows_to_per_op_on_the_card(
        monkeypatch, cube_size, route):
    """On the card (mode "fused") a field whose window does not fit takes
    the per-op gathers, which `dispatch_path` reports; the CPU keeps the
    plain fused version, which has no such limit; "per-op" and "ref"
    forces still win."""
    cfg = NeRFConfig(cube_size=cube_size)
    W = ttensorf.fused_window(cfg)
    assert fused_sample.fused_fits(W, cfg.r_sigma, cfg.r_color,
                                   cfg.app_dim) is (route == "fused")
    spec = ((("bitmap", cfg.r_sigma, 1),) * 6
            + (("coo", cfg.r_color, 1),) * 6)
    cuda = torch.device("cuda")
    assert ttensorf._route(cfg, spec, None, cuda) == route
    assert ttensorf._route(cfg, spec, "fused", cuda) == route
    assert ttensorf._route(cfg, spec, None, "cpu") == "fused_ref"
    assert ttensorf._route(cfg, spec, "per-op", "cpu") == "per-op"
    assert ttensorf._route(cfg, spec, "ref", cuda) == "fused_ref"
    assert ttensorf._route(cfg, None, None, cuda) == "per-op"


def test_hybrid_dispatch_and_eval_take_the_route(monkeypatch):
    """hybrid_dispatch reports the route, and eval_sigma_app_hybrid takes
    the per-op gathers for a field the kernel cannot hold (the kernel
    route and the limit faked on the CPU): the same values as the fused
    plain version, within 1e-5."""
    cfg = demo_config(tiny=True)
    params = ttensorf.init_field(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    cf = tfield.DenseField(params, cfg).prune(sparsity=0.6).encode(0.99)
    assert cf.dispatch_path() == "fused_ref"
    g = torch.Generator().manual_seed(1)
    pts = (torch.rand(200, 3, generator=g) - 0.5) * 0.4
    centers = torch.zeros(1, 3)
    cid = torch.zeros(200, dtype=torch.int32)
    base = ttensorf.window_base(cfg, centers)
    want = ttensorf.eval_sigma_app_hybrid(cf, cfg, pts, base, cid)
    calls = []
    real_gather = ttensorf.gather_factor

    def spy(ef, cols, force=None):
        calls.append(force)
        return real_gather(ef, cols, force)

    monkeypatch.setattr(ttensorf, "gather_factor", spy)
    monkeypatch.setattr(fused_sample, "fused_fits", lambda *a: False)
    monkeypatch.setattr(ttensorf.ops, "fused_mode",
                        lambda force=None, device=None: "fused")
    assert ttensorf.hybrid_dispatch(cf) == "per-op"
    got = ttensorf.eval_sigma_app_hybrid(cf, cfg, pts, base, cid)
    assert len(calls) == 12 and set(calls) == {None}
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
