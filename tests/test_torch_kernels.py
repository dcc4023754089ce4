"""The port's kernel modules against the reference on the CPU: the plain
versions of the fused decode-sample-accumulate, bitmap gather and COO
gather kernels, and the dispatch contract (CPU tensors take the plain
versions and launch nothing; "per-op" forces the gather composition)."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import FUSED_CASES, FUSED_FORMATS, carry_field, n, t
from repro.core import sparse as jsparse
from repro.core import tensorf as jtensorf
from repro.kernels import fused_sample as jfused
from repro.kernels import ref as jref
from repro_torch.core import field as tfield
from repro_torch.core import sparse as tsparse
from repro_torch.core import tensorf as ttensorf
from repro_torch.kernels import bitmap_decode, coo_gather, fused_sample, ops


def _launch_counts():
    return (fused_sample.fused_sigma_app.launches,
            bitmap_decode.bitmap_gather.launches,
            coo_gather.coo_gather.launches)


# ---------------------------------------------------------------- fused ---
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_plain_matches_reference_and_pallas(case):
    """fused_sigma_app_ref on the reference's four fused-parity fields vs
    the reference's jnp twin and its Pallas kernel in interpret mode."""
    cfg, jcf, centers, cid, pts = FUSED_CASES[case]()
    assert {ef.fmt for efs in jcf.factors.values() for ef in efs} == \
        FUSED_FORMATS[case]
    jspec, jstreams = jtensorf.fused_field_inputs(jcf)
    base = jtensorf.window_base(cfg, centers)
    kw = dict(grid_res=cfg.grid_res, scene_bound=cfg.scene_bound,
              window=jtensorf.fused_window(cfg), app_dim=cfg.app_dim)
    want_sig, want_feat = jax.jit(
        lambda *a: jfused.fused_sigma_app_ref(jspec, *a, **kw))(
        jstreams, jcf.extras["basis"], pts, base, cid)
    pal_sig, pal_feat = jax.jit(
        lambda *a: jfused.fused_sigma_app(jspec, *a, interpret=True, **kw))(
        jstreams, jcf.extras["basis"], pts, base, cid)

    tcf = carry_field(jcf, cfg)
    spec, streams = ttensorf.fused_field_inputs(tcf)
    assert spec == jspec
    tbase = ttensorf.window_base(tcf.cfg, t(centers))
    np.testing.assert_array_equal(n(tbase), np.asarray(base))
    before = _launch_counts()
    sig, feat = fused_sample.fused_sigma_app(
        spec, streams, tcf.extras["basis"], t(pts), tbase, t(cid), **kw)
    assert _launch_counts() == before          # CPU tensors: plain version
    for want_s, want_f in ((want_sig, want_feat), (pal_sig, pal_feat)):
        np.testing.assert_allclose(n(sig), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(n(feat), np.asarray(want_f),
                                   rtol=1e-5, atol=1e-5)


def test_fused_out_of_window_points_are_finite():
    cfg, jcf, centers, cid, pts = FUSED_CASES["coo"]()
    tcf = carry_field(jcf, cfg)
    far = t(pts) + 10.0 * cfg.cube_world()
    base = ttensorf.window_base(tcf.cfg, t(centers))
    sig, feat = ttensorf.eval_sigma_app_hybrid(tcf, tcf.cfg, far, base, t(cid))
    assert torch.isfinite(sig).all() and torch.isfinite(feat).all()


# --------------------------------------------------------------- gathers ---
@pytest.mark.parametrize("rows,cols,nq", [(8, 32, 128), (16, 96, 512),
                                          (40, 70, 256), (4, 576, 300)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_bitmap_gather_plain_matches_reference(rows, cols, nq, density):
    """Both forms (with the rank table and without) equal the reference's
    bitmap_gather_ref exactly, and so equal the dense matrix."""
    rng = np.random.RandomState(rows + cols + nq)
    w = rng.randn(rows, cols).astype(np.float32)
    w[rng.rand(rows, cols) >= density] = 0
    enc = tsparse.encode_bitmap(w, device="cpu")
    jenc = jsparse.encode_bitmap(w)
    q = rng.randint(0, rows * cols, nq).astype(np.int32)
    want = np.asarray(jref.bitmap_gather_ref(jenc.words, jenc.rowptr,
                                             jenc.values, q, cols))
    np.testing.assert_array_equal(want, w.reshape(-1)[q])
    before = _launch_counts()
    for rank in (enc.rank, None):
        got = bitmap_decode.bitmap_gather(enc.words, enc.rowptr, enc.values,
                                          torch.from_numpy(q), cols=cols,
                                          rank=rank)
        np.testing.assert_array_equal(n(got), want)
    assert _launch_counts() == before


@pytest.mark.parametrize("size,nq", [(64, 128), (1000, 512), (5, 128),
                                     (25600, 2048)])
@pytest.mark.parametrize("sparsity", [0.5, 0.9, 1.0])
def test_coo_gather_plain_matches_reference(size, nq, sparsity):
    rng = np.random.RandomState(size + nq)
    flat = rng.randn(size).astype(np.float32)
    flat[rng.rand(size) < sparsity] = 0
    enc = tsparse.encode_coo(flat.reshape(1, -1), device="cpu")
    jenc = jsparse.encode_coo(flat.reshape(1, -1))
    q = rng.randint(0, size, nq).astype(np.int32)
    want = np.asarray(jref.coo_gather_ref(jenc.coords, jenc.values, q))
    before = _launch_counts()
    got = coo_gather.coo_gather(enc.coords, enc.values, torch.from_numpy(q))
    assert _launch_counts() == before
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(got), flat[q])


@pytest.mark.parametrize("order", ["occupancy", "shuffled"])
def test_coo_gather_plain_matches_pallas_on_occupancy_queries(monkeypatch,
                                                             order):
    """The serving path's queries (tensorf.gather_factor over an occupancy
    chunk, meshgrid order) and a shuffled copy: the plain version equals
    the reference's Pallas kernel in interpret mode and its jnp oracle."""
    from repro.kernels.coo_gather import coo_gather as pallas_coo_gather
    from test_torch_kernel_plans import occupancy_coo_calls

    calls = occupancy_coo_calls(monkeypatch, grid=64, chunk=4096)
    rng = np.random.RandomState(7)
    for coords, values, q in calls:
        if order == "occupancy":
            start = rng.randint(0, q.shape[0] // 8192) * 8192
            q = q[start:start + 8192]
        else:
            q = q[torch.from_numpy(rng.choice(q.shape[0], 8192,
                                              replace=False))]
        want = np.asarray(pallas_coo_gather(n(coords), n(values), n(q),
                                            block_q=4096, interpret=True))
        np.testing.assert_array_equal(
            want, np.asarray(jref.coo_gather_ref(n(coords), n(values),
                                                 n(q))))
        got = coo_gather.coo_gather(coords, values, q)
        np.testing.assert_array_equal(n(got), want)


def test_coo_search_steps_match_reference():
    for size in (1, 2, 128, 129, 256, 409600):
        assert coo_gather.search_steps(size) == \
            max(int(np.ceil(np.log2(size))), 1) + 1


# -------------------------------------------------------------- dispatch ---
def test_fused_dispatch_contract():
    """CPU tensors: dispatch names the plain version, nothing launches;
    "per-op" routes sigma_app through the gather composition with the
    same numbers; an unsupported spec falls back to per-op."""
    cfg, jcf, centers, cid, pts = FUSED_CASES["mixed"]()
    tcf = carry_field(jcf, cfg)
    assert ops.fused_mode("pallas") == "fused"
    assert ops.fused_mode("kernel") == "fused"
    assert ops.fused_mode("ref") == "fused_ref"
    assert ops.fused_mode("per-op") == "per-op"
    assert ops.fused_mode(None, torch.device("cpu")) == "fused_ref"
    assert ops.fused_mode(None, torch.device("cuda")) == "fused"
    assert tcf.dispatch_path() == "fused_ref"
    assert ttensorf.hybrid_dispatch(tcf, "per-op") == "per-op"
    spec, _ = ttensorf.fused_field_inputs(tcf)
    assert ops.fused_supported(spec) and not ops.fused_supported(spec[:3])

    calls = {"bitmap": 0, "coo": 0}
    orig_b, orig_c = ops.bitmap_gather, ops.coo_gather

    def count_b(*a, **k):
        calls["bitmap"] += 1
        return orig_b(*a, **k)

    def count_c(*a, **k):
        calls["coo"] += 1
        return orig_c(*a, **k)

    base = ttensorf.window_base(tcf.cfg, t(centers))
    before = _launch_counts()
    want = ttensorf.eval_sigma_app_hybrid(tcf, tcf.cfg, t(pts), base, t(cid))
    assert calls == {"bitmap": 0, "coo": 0}
    ops.bitmap_gather, ops.coo_gather = count_b, count_c
    try:
        got = ttensorf.eval_sigma_app_hybrid(tcf, tcf.cfg, t(pts), base,
                                             t(cid), force="per-op")
    finally:
        ops.bitmap_gather, ops.coo_gather = orig_b, orig_c
    assert calls["bitmap"] > 0 and calls["coo"] > 0
    assert _launch_counts() == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-5)


def test_rank_table_is_derived_on_restore():
    """Rank tables are never serialized: a field carried across gets them
    recomputed, equal to the encoder's."""
    cfg, jcf, *_ = FUSED_CASES["bitmap"]()
    tcf = carry_field(jcf, cfg)
    for k, efs in tcf.factors.items():
        for ef, jef in zip(efs, jcf.factors[k]):
            if ef.fmt == "bitmap":
                np.testing.assert_array_equal(n(ef.bitmap.rank),
                                              np.asarray(jef.bitmap.rank))


@pytest.mark.parametrize("which", ["bitmap", "coo", "fused"])
def test_wrappers_refuse_tensors_off_cpu_and_cuda(which):
    """A wrapper takes the plain version only for CPU tensors; anything
    that is not CUDA is refused, never run on the CPU behind the
    caller's back."""
    meta = torch.device("meta")
    q = torch.zeros(8, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        if which == "bitmap":
            w = torch.zeros((2, 1), dtype=torch.int32, device=meta)
            bitmap_decode.bitmap_gather(
                w, torch.zeros(2, dtype=torch.int32, device=meta),
                torch.zeros(128, device=meta), q, cols=32)
        elif which == "coo":
            coo_gather.coo_gather(
                torch.zeros(128, dtype=torch.int32, device=meta),
                torch.zeros(128, device=meta), q)
        else:
            cfg, jcf, centers, cid, pts = FUSED_CASES["coo"]()
            tcf = carry_field(jcf, cfg, device=meta)
            spec, streams = ttensorf.fused_field_inputs(tcf)
            fused_sample.fused_sigma_app(
                spec, streams, tcf.extras["basis"],
                torch.zeros((8, 3), device=meta),
                torch.zeros((4, 3), dtype=torch.int32, device=meta), q,
                grid_res=cfg.grid_res, scene_bound=cfg.scene_bound,
                window=ttensorf.fused_window(tcf.cfg), app_dim=cfg.app_dim)


def test_compressed_field_sigma_app_without_grouping_is_per_op():
    cfg, jcf, centers, cid, pts = FUSED_CASES["coo"]()
    tcf = carry_field(jcf, cfg)
    assert isinstance(tcf, tfield.CompressedField)
    sig, feat = tcf.sigma_app(t(pts))
    np.testing.assert_allclose(n(sig), np.asarray(jcf.sigma(pts)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(feat), np.asarray(jcf.app_features(pts)),
                               rtol=1e-5, atol=1e-5)
