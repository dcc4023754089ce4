"""A field carried from the reference into the port (`field_state` ->
`field_from_state`), dense and compressed, evaluates like the reference:
sigma, app_features, color and sigma_app at 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, carry_field, jax_case, n, numpy_params, t,
                           tiny_cfg, torch_cfg)
from repro.core import field as jfield
from repro.core import tensorf as jtensorf
from repro_torch.core import field as tfield
from repro_torch.core import tensorf as ttensorf

TOL = dict(rtol=1e-5, atol=1e-5)


def _points(cfg, m, seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-cfg.scene_bound, cfg.scene_bound, (m, 3))
    dirs = rng.randn(m, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts.astype(np.float32), dirs.astype(np.float32)


@pytest.fixture(scope="module")
def fields():
    """(cfg, {name: reference field}) over the representation space."""
    cfg, cf, *_ = jax_case(0.9, threshold=0.80)
    _, bm, *_ = jax_case(0.6, threshold=0.99)
    return cfg, {"dense": cf.decode(), "coo": cf, "bitmap": bm,
                 "dense-encoded": cf.decode().encode(1.1)}


@pytest.mark.parametrize("name", ["dense", "coo", "bitmap", "dense-encoded"])
def test_carried_field_matches_reference(fields, name):
    cfg, fs = fields
    jf = fs[name]
    tf = carry_field(jf, cfg)
    assert tf.kind == jf.kind
    if jf.kind == "compressed":
        assert tf.formats() == {k: tuple(ef.fmt for ef in efs)
                                for k, efs in jf.factors.items()}
        assert tf.factor_bytes() == jf.factor_bytes()
        assert tf.dense_factor_bytes() == jf.dense_factor_bytes()
    pts, dirs = _points(cfg, 257, 1)
    np.testing.assert_allclose(n(tf.sigma(t(pts))),
                               np.asarray(jf.sigma(pts)), **TOL)
    feats = tf.app_features(t(pts))
    np.testing.assert_allclose(n(feats), np.asarray(jf.app_features(pts)),
                               **TOL)
    np.testing.assert_allclose(
        n(tf.color(feats, t(dirs))),
        np.asarray(jf.color(jnp.asarray(n(feats)), dirs)), **TOL)
    # cube-grouped sigma_app (the fused path for encoded fields)
    rng = np.random.RandomState(2)
    ci = rng.randint(0, cfg.cube_grid_res, size=(4, 3))
    centers = (-cfg.scene_bound + (ci + 0.5) * cfg.cube_world()).astype(
        np.float32)
    cid = rng.randint(0, 4, 257).astype(np.int32)
    gp = centers[cid] + rng.uniform(-cfg.cube_world() / 2,
                                    cfg.cube_world() / 2,
                                    (257, 3)).astype(np.float32)
    want = jf.sigma_app(jnp.asarray(gp), jnp.asarray(centers),
                        jnp.asarray(cid))
    got = tf.sigma_app(t(gp), t(centers), t(cid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), **TOL)
    assert tf.dispatch_path() == ("dense" if jf.kind == "dense"
                                  else "fused_ref")


@pytest.mark.parametrize("name", ["dense", "coo", "bitmap"])
def test_field_state_round_trips_into_reference(fields, name):
    """The port's field_state loads back in the reference unchanged."""
    cfg, fs = fields
    tf = carry_field(fs[name], cfg)
    spec, arrays = tfield.field_state(tf)
    back = jfield.field_from_state(spec, arrays, cfg)
    pts, _ = _points(cfg, 64, 3)
    np.testing.assert_array_equal(np.asarray(back.sigma(pts)),
                                  np.asarray(fs[name].sigma(pts)))


def test_encode_decode_round_trip(fields):
    cfg, fs = fields
    tf = carry_field(fs["dense"], cfg)
    enc = tf.encode()
    assert enc.kind == "compressed"
    dec = enc.decode()
    for k, v in tf.params.items():
        np.testing.assert_array_equal(n(dec.params[k]), n(v))
    assert enc.encode() is enc and dec.decode() is dec
    assert enc.compression_ratio() >= 3.0


@pytest.mark.parametrize("target", [0.5, 0.9])
def test_prune_to_sparsity_matches_reference(target):
    """The pruning threshold is computed in float32 as jnp.quantile does,
    so the pruned supports are identical."""
    cfg = tiny_cfg()
    params = numpy_params(cfg, 5)
    want = jtensorf.prune_to_sparsity({k: jnp.asarray(v) for k, v in
                                       params.items()}, target)
    got = ttensorf.prune_to_sparsity({k: torch.from_numpy(v) for k, v in
                                      params.items()}, target)
    for k in want:
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]))
    tf = tfield.DenseField({k: torch.from_numpy(v) for k, v in
                            params.items()}, torch_cfg(cfg))
    jf = jfield.DenseField({k: jnp.asarray(v) for k, v in params.items()},
                           cfg)
    assert tf.prune(sparsity=target).encode().factor_bytes() == \
        jf.prune(sparsity=target).encode().factor_bytes()
    assert tf.prune(tol=0.05).encode().factor_bytes() == \
        jf.prune(tol=0.05).encode().factor_bytes()


def test_init_field_shapes_and_generator():
    cfg = torch_cfg(tiny_cfg())
    a = ttensorf.init_field(cfg, torch.Generator().manual_seed(0), device=CPU)
    b = ttensorf.init_field(cfg, torch.Generator().manual_seed(0), device=CPU)
    c = ttensorf.init_field(cfg, torch.Generator().manual_seed(1), device=CPU)
    ref = numpy_params(tiny_cfg(), 0)
    assert set(a) == set(ref)
    for k in a:
        assert tuple(a[k].shape) == ref[k].shape
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["sigma_planes"], c["sigma_planes"])
    assert torch.all(a["mlp_b1"] == 0)
