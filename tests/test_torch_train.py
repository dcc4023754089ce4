"""Training in the port (`repro_torch.core.train`, the FieldBackend
training surface, the gathers' backward passes) against the reference
(`repro.core.train`) on the CPU at `demo_config(tiny=True)`: the same
fields (carried over with `field_state`), rays and gradients, made from
seeds with numpy.

Tolerances, with their reasons:
  * gathers' backward, plain version against `jax.grad` of the
    reference's jnp oracles: 1e-6 relative (both sum each slot's
    gradients in fp32, maybe in other orders), exact zeros at pad slots
    and at slots no query reads;
  * loss 1e-6 relative, l1 and tv 1e-5 relative (means over up to
    13,824 entries, summed in other orders); gradients 1e-5 of each
    leaf's largest |gradient| (reductions and GEMMs sum in other orders);
  * training: per-step loss 1e-5 relative, payloads 1e-4 absolute after
    the run (adamw moves an entry whose gradient is near its eps, 1e-8,
    by up to lr x (last-bit change of the gradient) / eps); formats and
    nnz after a re-encode exactly;
  * revival on the same gradients: exactly (numpy on both sides).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, carry_field, jax_case, n, t, tiny_cfg,
                           torch_cfg)
from repro.ckpt import checkpoint as jckpt
from repro.core import field as jfield
from repro.core import tensorf as jtensorf
from repro.core import train as jtrain
from repro.data import rays as jrays
from repro.kernels import ref as jref
from repro.serving import engine as jengine
from repro_torch.core import field as tfield
from repro_torch.core import sparse as tsparse
from repro_torch.core import tensorf as ttensorf
from repro_torch.core import train as ttrain
from repro_torch.kernels import bitmap_decode, coo_gather, ops
from repro_torch.serving import RenderEngine
from repro_torch.serving import engine as tengine

DATA = dict(n_views=2, image_hw=16, seed=0)


def _matrix(rows, cols, density, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, cols).astype(np.float32)
    w[rng.rand(rows, cols) >= density] = 0
    return w


def _queries_and_grad(rows, cols, nq, seed):
    """Queries over the whole matrix with runs of repeats (slots read many
    times), and an output gradient with exact zeros."""
    rng = np.random.RandomState(seed)
    q = np.repeat(rng.randint(0, rows * cols, nq // 4), 4).astype(np.int32)
    g = rng.randn(q.size).astype(np.float32)
    g[rng.rand(q.size) < 0.2] = 0
    return q, g


# -- the gathers' backward -----------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_bitmap_gather_bwd_matches_jax_grad(density):
    rows, cols = 6, 70
    w = _matrix(rows, cols, density, 1)
    enc = tsparse.encode_bitmap(w, device=CPU)
    q, g = _queries_and_grad(rows, cols, 2000, 2)
    words = n(enc.words).view(np.uint32)

    def f(v):
        return jnp.vdot(jref.bitmap_gather_ref(words, n(enc.rowptr), v, q,
                                               cols), g)
    want = np.asarray(jax.grad(f)(n(enc.values)))
    nvalues = enc.values.shape[0]
    plain = bitmap_decode.bitmap_gather_bwd_ref(
        enc.words, enc.rowptr, t(q), t(g), nvalues, cols, rank=enc.rank)
    wrapped = bitmap_decode.bitmap_gather_bwd(
        enc.words, enc.rowptr, t(q), t(g), nvalues=nvalues, cols=cols)
    v = enc.values.clone().requires_grad_(True)
    ops.bitmap_gather(enc.words, enc.rowptr, v, t(q), cols=cols,
                      rank=enc.rank).backward(t(g))
    for got in (plain, wrapped, v.grad):
        np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-7)
        assert not n(got)[enc.nnz:].any()        # pad slots
    read = set(int(s) for s, b in zip(*map(n, bitmap_decode.bitmap_slots(
        enc.words, enc.rowptr, nvalues, t(q), cols))) if b)
    unread = [i for i in range(nvalues) if i not in read]
    assert not n(plain)[unread].any()
    if density == 0.0:
        assert not want.any() and not n(plain).any()


@pytest.mark.parametrize("sparsity", [0.5, 0.95, 1.0])
def test_coo_gather_bwd_matches_jax_grad(sparsity):
    rows, cols = 4, 300
    w = _matrix(rows, cols, 1.0 - sparsity, 3)
    enc = tsparse.encode_coo(w, device=CPU)
    q, g = _queries_and_grad(rows, cols, 3000, 4)

    def f(v):
        return jnp.vdot(jref.coo_gather_ref(n(enc.coords), v, q), g)
    want = np.asarray(jax.grad(f)(n(enc.values)))
    plain = coo_gather.coo_gather_bwd_ref(enc.coords, t(q), t(g))
    wrapped = coo_gather.coo_gather_bwd(enc.coords, t(q), t(g))
    v = enc.values.clone().requires_grad_(True)
    ops.coo_gather(enc.coords, v, t(q)).backward(t(g))
    for got in (plain, wrapped, v.grad):
        np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-7)
        assert not n(got)[enc.nnz:].any()        # pad entries
    if sparsity == 1.0:
        assert not want.any()


def test_gather_grads_go_only_to_the_values():
    """The streams and queries are integer tensors: no gradient path."""
    enc = tsparse.encode_bitmap(_matrix(4, 40, 0.5, 5), device=CPU)
    v = enc.values.clone().requires_grad_(True)
    out = ops.bitmap_gather(enc.words, enc.rowptr, v,
                            torch.arange(160, dtype=torch.int32), cols=40)
    assert out.grad_fn is not None
    (gv,) = torch.autograd.grad(out.sum(), [v])
    assert gv.shape == v.shape
    with torch.no_grad():
        assert ops.coo_gather(
            tsparse.encode_coo(_matrix(4, 40, 0.5, 5), device=CPU).coords,
            v[:4], torch.zeros(3, dtype=torch.int32)).grad_fn is None


@pytest.mark.parametrize("fmt_threshold", [("bitmap", 0.99), ("coo", 0.0),
                                           ("dense", None)])
def test_gather_factor_carries_the_gradient_to_values(fmt_threshold):
    fmt, thr = fmt_threshold
    w = _matrix(8, 24 * 24, 0.4, 6)
    if fmt == "dense":
        w = np.asarray(np.random.RandomState(6).randn(8, 576), np.float32)
    jef = jfield.sparse.encode_factor(w, 0.80 if thr is None else thr)
    tef = tsparse.encode_factor(w, 0.80 if thr is None else thr, device=CPU)
    assert jef.fmt == tef.fmt == fmt
    rng = np.random.RandomState(7)
    cols = rng.randint(0, 576, 500).astype(np.int32)
    g = rng.randn(8, 500).astype(np.float32)
    want = jax.grad(lambda v: jnp.vdot(jtensorf.gather_factor(
        jef.with_value_array(v), jnp.asarray(cols)), g))(jef.value_array)
    v = tef.value_array.clone().requires_grad_(True)
    out = ttensorf.gather_factor(tef.with_value_array(v), t(cols))
    (got,) = torch.autograd.grad(out, [v], t(g))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert np.abs(n(got)).max() > 0


# -- the FieldBackend training surface ------------------------------------------

@functools.lru_cache(maxsize=None)
def _encoded(sparsity, threshold):
    return jax_case(sparsity, threshold=threshold)[:2]


def _mixed():
    """mixed_case's field (its bitmap slices from the 0.6 case, its COO
    slices that case re-encoded), from the cached encoding."""
    cfg, bm = _encoded(0.6, 0.99)
    co = bm.decode().encode(0.0)
    return cfg, jfield.CompressedField(
        {"sigma_planes": bm.factors["sigma_planes"],
         "sigma_lines": co.factors["sigma_lines"],
         "app_planes": co.factors["app_planes"],
         "app_lines": bm.factors["app_lines"]}, bm.extras, cfg, bm.threshold)


CASES = {
    "dense": lambda: (_encoded(0.6, 0.99)[0], _encoded(0.6, 0.99)[1].decode()),
    "bitmap": lambda: _encoded(0.6, 0.99),
    "coo": lambda: _encoded(0.9, 0.80),
    "mixed": _mixed,
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cfg, jf = CASES[request.param]()
    return request.param, cfg, jf, carry_field(jf, cfg)


def test_trainable_keys_round_trip_l1_tv(case):
    name, cfg, jf, tf = case
    jt, tt = jf.trainable(), tf.trainable()
    assert sorted(jt) == sorted(tt)
    if name != "dense":
        assert all(k.startswith(("extras/", "factors/")) for k in tt)
    for k in jt:
        np.testing.assert_array_equal(n(tt[k]), np.asarray(jt[k]), err_msg=k)
    back = tf.with_trainable(tt)
    assert type(back) is type(tf)
    for k, v in back.trainable().items():
        assert v is tt[k]
    if name != "dense":
        assert back.formats() == tf.formats()
        for k, efs in tf.factors.items():
            for a, b in zip(efs, back.factors[k]):
                if a.fmt == "bitmap":
                    assert b.bitmap.rank is a.bitmap.rank   # structure kept
    jl1, jtv = jax.jit(lambda f: (f.l1(), f.tv()))(jf)
    np.testing.assert_allclose(float(tf.l1()), float(jl1), rtol=1e-5)
    np.testing.assert_allclose(float(tf.tv()), float(jtv), rtol=1e-5)


@pytest.fixture(scope="module")
def batch():
    ds = jrays.build_dataset(jrays.make_scene("lego"), 2, 16, 16)
    return tuple(np.asarray(a) for a in next(ds.batches(256, seed=0)))


def test_nerf_loss_and_gradients_match(case, batch):
    """Every trainable leaf's gradient, the packed factor values'
    included: a gather that dropped its gradient would fail here."""
    name, cfg, jf, tf = case
    ro, rd, tgt = batch

    def jloss(v):
        return jtrain.nerf_loss(jf.with_trainable(v), cfg, ro, rd, tgt)
    (jl, jmse), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jf.trainable())
    loss, mse, grads = ttrain.loss_and_grads(tf, torch_cfg(cfg), t(ro),
                                             t(rd), t(tgt))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-6)
    assert sorted(grads) == sorted(jg)
    for k, w in jg.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(n(grads[k]) - w).max())
        assert err <= 1e-5 * scale, (k, err, scale)
        if k.startswith("factors/") or k in ttensorf.sparse.FACTOR_KEYS:
            assert scale > 0, k
    # the encoded path's factor leaves are the packed values
    if name != "dense":
        assert any(ef.fmt in ("bitmap", "coo")
                   for efs in tf.factors.values() for ef in efs)


def test_revive_picks_the_same_entries_exactly():
    cfg = tiny_cfg()
    rng = np.random.RandomState(8)
    params = jtensorf.init_field(cfg, jax.random.PRNGKey(3))
    params = jtensorf.prune_to_sparsity(params, 0.7)
    jd = jfield.DenseField(params, cfg)
    td = carry_field(jd, cfg)
    grads = {k: rng.randn(*np.shape(v)).astype(np.float32)
             for k, v in params.items()}
    for k in tsparse.FACTOR_KEYS:                 # zero and tied scores
        g = grads[k].reshape(-1)
        g[::7] = 0.0
        g[1::11] = 0.5
    for frac in (0.05, 0.3):
        want = jd.revive({k: jnp.asarray(v) for k, v in grads.items()},
                         frac=frac, eps=2e-3)
        got = td.revive({k: t(v) for k, v in grads.items()}, frac=frac,
                        eps=2e-3)
        for k in params:
            np.testing.assert_array_equal(n(got.params[k]),
                                          np.asarray(want.params[k]),
                                          err_msg=k)
        changed = sum(int((n(got.params[k]) != np.asarray(params[k])).sum())
                      for k in tsparse.FACTOR_KEYS)
        assert changed > 0
    assert td.revive(grads, frac=0.0, eps=2e-3) is td


# -- NerfTrainer, train_nerf ----------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """Both trainers from the mixed field (bitmap + COO slices), 5 steps
    across one re-encode (occ_every 3)."""
    cfg, jf = _mixed()
    tcfg = torch_cfg(cfg)
    kw = dict(occ_every=3, **DATA)
    jt = jtrain.NerfTrainer(cfg, "lego", field=jf, **kw)
    tt = ttrain.NerfTrainer(tcfg, "lego", field=carry_field(jf, cfg), **kw)
    recs = [(jt.step(), tt.step()) for _ in range(5)]
    return jt, tt, recs


def test_trainer_matches_across_a_reencode(trained):
    jt, tt, recs = trained
    for a, b in recs:
        assert a["step"] == b["step"]
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["psnr"], a["psnr"], rtol=1e-5)
    assert tt.step_count == jt.step_count == 5
    jf, tf = jt.field, tt.field
    assert isinstance(tf, tfield.CompressedField)
    got = {k: [(ef.fmt, ef.nnz) for ef in efs] for k, efs in tf.factors.items()}
    want = {k: [(ef.fmt, ef.nnz) for ef in efs]
            for k, efs in jf.factors.items()}
    assert got == want
    fmts = {f for v in got.values() for f, _ in v}
    assert fmts & {"bitmap", "coo"}
    js, ts = jt.snapshot(), tt.snapshot()
    for k, v in js.trainable().items():
        np.testing.assert_allclose(n(ts.trainable()[k]), np.asarray(v),
                                   atol=1e-4, err_msg=k)


def test_trainer_final_builds_cubes_like_the_reference(trained):
    jt, tt, _ = trained
    jres, tres = jt.final(), tt.final()
    assert tres.field.formats() == {k: tuple(ef.fmt for ef in efs)
                                    for k, efs in jres.field.factors.items()}
    jocc, tocc = np.asarray(jres.cubes.occ), n(tres.cubes.occ)
    assert (jocc != tocc).mean() <= 1e-3
    assert abs(tres.cubes.count - jres.cubes.count) <= 2


def test_snapshot_matches_train_nerf_from_the_same_init(monkeypatch):
    """The reference's train_nerf draws its field from jax.random, the
    port's from a torch.Generator: the port is given the reference's
    initial parameters (carried over) in place of its own draw."""
    cfg = tiny_cfg()
    kw = dict(steps=4, occ_every=2, log_every=1, verbose=False, **DATA)
    want = jtrain.train_nerf(cfg, "lego", **kw)
    init = jfield.DenseField(jtensorf.init_field(cfg, jax.random.PRNGKey(0)),
                             cfg)
    trainer = ttrain.NerfTrainer(torch_cfg(cfg), "lego",
                                 field=carry_field(init, cfg), occ_every=2,
                                 **DATA)
    hist = [trainer.step() for _ in range(4)]
    for a, b in zip(want.history, hist):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    monkeypatch.setattr(ttrain.tensorf, "init_field",
                        lambda *a, **k: carry_field(init, cfg).params)
    got = ttrain.train_nerf(torch_cfg(cfg), "lego", device=CPU, **kw)
    assert [r["step"] for r in got.history] == [0, 1, 2, 3]
    for a, b in zip(want.history, got.history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    wd, gd = want.field.decode(), got.field.decode()
    for k, v in wd.params.items():
        np.testing.assert_allclose(n(gd.params[k]), np.asarray(v), atol=1e-4,
                                   err_msg=k)
    snap = trainer.snapshot().prune(tol=trainer.prune_tol).encode()
    assert snap.formats() == got.field.formats()


def test_dense_train_nerf_matches_the_reference(monkeypatch):
    """compressed=False keeps the dense loop end to end, as the
    reference's (its own tests train both ways): no re-encode at the
    occ_every boundaries, a dense final field, the same per-step losses
    and payloads from the reference's initial parameters."""
    cfg = tiny_cfg()
    kw = dict(steps=4, occ_every=2, log_every=1, verbose=False,
              compressed=False, **DATA)
    want = jtrain.train_nerf(cfg, "lego", **kw)
    init = jfield.DenseField(jtensorf.init_field(cfg, jax.random.PRNGKey(0)),
                             cfg)
    monkeypatch.setattr(ttrain.tensorf, "init_field",
                        lambda *a, **k: carry_field(init, cfg).params)
    got = ttrain.train_nerf(torch_cfg(cfg), "lego", device=CPU, **kw)
    assert want.field.kind == got.field.kind == "dense"
    assert [r["step"] for r in got.history] == [0, 1, 2, 3]
    for a, b in zip(want.history, got.history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for k, v in want.field.params.items():
        np.testing.assert_allclose(n(got.field.params[k]), np.asarray(v),
                                   atol=1e-4, err_msg=k)
    assert abs(got.cubes.count - want.cubes.count) <= 2


def test_trainer_without_field_draws_on_the_device_given():
    cfg = torch_cfg(tiny_cfg())
    a = ttrain.NerfTrainer(cfg, "lego", device=CPU, occ_every=2, **DATA)
    b = ttrain.NerfTrainer(cfg, "lego", device=CPU, occ_every=2, **DATA)
    assert a.field.kind == "dense" and a.device == CPU
    for k, v in a.field.params.items():
        assert torch.equal(v, b.field.params[k])
    recs = [a.step() for _ in range(3)]
    assert a.field.kind == "compressed"           # re-encoded at step 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    with pytest.raises(ValueError, match="lies on"):
        ttrain.NerfTrainer(cfg, "lego", field=a.snapshot(), device="meta",
                           **DATA)


# -- prepare_field / from_scene train where no checkpoint exists ----------------

def test_prepare_field_trains_checkpoints_and_restores(tmp_path,
                                                       monkeypatch):
    cfg = tiny_cfg()
    tcfg = torch_cfg(cfg)
    d = str(tmp_path / "lego")
    kw = dict(train_steps=2, n_views=2, image_hw=16, seed=0, verbose=False)
    trained = tengine.prepare_field(tcfg, "lego", ckpt_dir=d, device=CPU,
                                    **kw)
    assert os.path.exists(os.path.join(d, tengine.FIELD_META))
    # the reference restores the port's checkpoint: the same field
    restored = jengine.prepare_field(cfg, "lego", ckpt_dir=d, verbose=False)
    sa, aa = tfield.field_state(trained)
    sb, ab = jfield.field_state(restored)
    assert sa == sb and sorted(aa) == sorted(ab)
    for k in aa:
        np.testing.assert_array_equal(aa[k], np.asarray(ab[k]), err_msg=k)
    assert jckpt.latest_step(d) == 2

    def no_training(*a, **k):
        raise AssertionError("trained again instead of restoring")
    monkeypatch.setattr(tengine.train_lib, "train_nerf", no_training)
    again = tengine.prepare_field(tcfg, "lego", ckpt_dir=d, device=CPU,
                                  **kw)
    for k, v in tfield.field_state(again)[1].items():
        np.testing.assert_array_equal(v, aa[k], err_msg=k)


def test_from_scene_trains_where_no_checkpoint_exists():
    tcfg = torch_cfg(dataclasses.replace(tiny_cfg()))
    eng = RenderEngine.from_scene(tcfg, "lego", train_steps=2, n_views=2,
                                  image_hw=16, device=CPU, verbose=False,
                                  ray_chunk=256)
    assert eng.store.scenes() == ["lego"]
    assert eng.store.get_field("lego").kind == "compressed"
