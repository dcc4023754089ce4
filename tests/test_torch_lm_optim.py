"""The port's optimizers, schedules and gradient compression
(`repro_torch.optim`) against the reference's (`repro.optim`) on the same
seeded numpy inputs, and the reference's own optimizer tests
(tests/test_optim.py) run against the port.

Float tolerance 1e-6 relative (XLA's and PyTorch's float32 pow, cos and
rsqrt may differ in the last bit; the leaf reductions sum in another
order); top-k indices and the int8 codes exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread per process)
from repro import optim as joptim
from repro_torch import optim as toptim

TOL = 1e-6
# a factored (4, 3, 6) leaf, a factored (6, 5), an unfactored (5,) and
# (7, 1) (last dim < 2), and a scalar
SHAPES = {"w": (4, 3, 6), "m": {"k": (6, 5), "b": (5,)}, "col": (7, 1),
          "s": ()}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _rand(rng, scale=1.0):
    return lambda s: np.asarray(scale * rng.randn(*s), np.float32)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL, atol=0.0):
    """Two trees (the port's tensors against the reference's arrays)."""
    gl, wl = toptim.optimizers.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=atol)


def _run(jopt, topt, steps, seed=0, loss=False):
    """`steps` updates of both optimizers on the same params and gradient
    sequence; after each, the params and the state compared."""
    rng = np.random.RandomState(seed)
    p0 = _tree(_rand(rng))
    jp, tp = _j(p0), _t(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _tree(_rand(rng, 0.1 + i))
        kw = ({"_loss": float(i)} if loss else {})
        jp, js = jopt.update(_j(g), js, jp, **kw)
        tp, ts = topt.update(_t(g), ts, tp, **kw)
        _close(tp, jp, atol=TOL * 1e-2)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        _close({k: v for k, v in ts.items() if k != "step"},
               {k: v for k, v in js.items() if k != "step"}, atol=1e-30)
    return ts


@pytest.mark.parametrize("schedule", [None, (2, 6)])
def test_adafactor_matches_reference_over_steps(schedule):
    """Factored and unfactored leaves over 5 steps, with the RMS clip, with
    and without a cosine schedule; the row and column statistics too."""
    jkw, tkw = {"lr": 1e-2}, {"lr": 1e-2}
    if schedule:
        jkw["schedule"] = joptim.cosine_schedule(*schedule)
        tkw["schedule"] = toptim.cosine_schedule(*schedule)
    ts = _run(joptim.adafactor(**jkw), toptim.adafactor(**tkw), 5)
    assert set(ts["v"]["w"]) == {"vr", "vc"}
    assert set(ts["v"]["col"]) == set(ts["v"]["m"]["b"]) == {"v"}


def test_adamw_with_schedule_and_loss_matches_reference():
    sched = (3, 10)
    _run(joptim.adamw(lr=5e-2, wd=0.01,
                      schedule=joptim.linear_warmup(sched[0])),
         toptim.adamw(lr=5e-2, wd=0.01,
                      schedule=toptim.linear_warmup(sched[0])),
         6, seed=1, loss=True)


def test_sgd_matches_reference():
    _run(joptim.sgd(lr=0.3), toptim.sgd(lr=0.3), 3, seed=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(dtype, scale):
    """Each leaf scaled in float32 and cast back to its dtype (bf16 leaves
    come back bf16); the norm summed leaf by leaf in the reference's leaf
    order."""
    rng = np.random.RandomState(3)
    g = _tree(_rand(rng, scale))
    jdt = getattr(jnp, dtype)
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
    tg = jax.tree.map(lambda a: torch.from_numpy(np.array(
        jnp.asarray(a).astype(jdt).astype(jnp.float32))).to(
            getattr(torch, dtype)), g)
    jc, jn = joptim.clip_by_global_norm(jg, 1.0)
    tc, tn = toptim.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    for a in toptim.optimizers.tree_leaves(tc):
        assert a.dtype == getattr(torch, dtype)
    # a bf16 leaf may round its scaled value to a neighbouring bf16
    _close(tc, jc, tol=TOL if dtype == "float32" else 2 ** -8)


def test_clip_by_global_norm_floor():
    """All-zero gradients: norm 0, the divisor floored at 1e-9, the scale
    min(1, max_norm / 1e-9) = 1, gradients unchanged."""
    g = {"a": torch.zeros(3), "b": {"c": torch.zeros(2, 2)}}
    c, n = toptim.clip_by_global_norm(g, 1.0)
    jc, jn = joptim.clip_by_global_norm(jax.tree.map(
        lambda t: jnp.zeros(t.shape), g), 1.0)
    assert float(n) == float(jn) == 0.0
    _close(c, jc)
    tiny = {"a": torch.full((4,), 1e-12)}
    c, n = toptim.clip_by_global_norm(tiny, 1e-12)
    jc, jn = joptim.clip_by_global_norm({"a": jnp.full((4,), 1e-12)}, 1e-12)
    np.testing.assert_allclose(float(n), float(jn), rtol=TOL)
    _close(c, jc)


def test_pick_optimizer_at_the_threshold():
    th = toptim.ADAFACTOR_PARAM_THRESHOLD
    assert th == joptim.optimizers.ADAFACTOR_PARAM_THRESHOLD == 30 * 10 ** 9
    for n in (1, th - 1, th, 10 * th):
        assert toptim.pick_optimizer(n).name == \
            joptim.pick_optimizer(n).name
    assert toptim.pick_optimizer(th - 1).name == "adamw"
    assert toptim.pick_optimizer(th).name == "adafactor"
    # lr and schedule reach the update
    sched = (2, 8)
    for n in (th - 1, th):
        _run(joptim.pick_optimizer(n, lr=3e-2,
                                   schedule=joptim.cosine_schedule(*sched)),
             toptim.pick_optimizer(n, lr=3e-2,
                                   schedule=toptim.cosine_schedule(*sched)),
             3, seed=4)


@pytest.mark.parametrize("which", ["cosine", "cosine_no_warmup", "warmup",
                                   "warmup_zero"])
def test_schedules_match_reference_over_steps(which):
    make = {"cosine": lambda m: m.cosine_schedule(10, 100),
            "cosine_no_warmup": lambda m: m.cosine_schedule(0, 50, 0.2),
            "warmup": lambda m: m.linear_warmup(5),
            "warmup_zero": lambda m: m.linear_warmup(0)}[which]
    jf, tf = make(joptim), make(toptim)
    for s in range(121):
        got = tf(torch.tensor(s, dtype=torch.int32))
        want = jf(jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=TOL,
                                   atol=1e-12)


def test_compress_topk_ties_take_the_lower_index_first():
    """Ties among magnitudes (equal values, and +x against -x) are kept
    lower index first, as jax.lax.top_k keeps them: the indices equal the
    reference's exactly, the values and residual too."""
    g = np.zeros(40, np.float32)
    g[[3, 7, 11, 30]] = 2.0
    g[[5, 9]] = -2.0
    g[[1, 20, 25]] = 0.5
    g[[2, 33]] = -0.5
    for frac in (0.1, 0.15, 0.25, 0.5):
        ji, jv, jr = joptim.compress_topk(jnp.asarray(g.reshape(5, 8)), frac)
        ti, tv, tr = toptim.compress_topk(torch.from_numpy(g.reshape(5, 8)),
                                          frac)
        assert ti.dtype == torch.int32 and tuple(tr.shape) == (5, 8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        back = toptim.decompress_topk(ti, tv, (5, 8))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(joptim.decompress_topk(ji, jv, (5, 8))))


def test_compress_topk_matches_reference_on_random_bf16():
    """bf16 gradients (many equal magnitudes) compressed at 1%, 5%, 30%."""
    rng = np.random.RandomState(5)
    g = jnp.asarray(rng.randn(1000).astype(np.float32)).astype(jnp.bfloat16)
    tg = torch.from_numpy(np.array(g.astype(jnp.float32))).to(
        torch.bfloat16)
    for frac in (0.01, 0.05, 0.3):
        ji, jv, jr = joptim.compress_topk(g, frac)
        ti, tv, tr = toptim.compress_topk(tg, frac)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("case", ["randn", "halves", "zeros"])
def test_int8_pair_matches_reference_exactly(case):
    """The codes (round half to even) and the scale exactly; values on the
    .5 boundaries of the grid included."""
    rng = np.random.RandomState(6)
    if case == "randn":
        g = rng.randn(64, 4).astype(np.float32)
    elif case == "halves":
        g = (np.arange(-127, 128, 0.5, dtype=np.float32) / 127.0 * 3.0)
    else:
        g = np.zeros((3, 3), np.float32)
    jq, js = joptim.quantize_int8(jnp.asarray(g))
    tq, ts = toptim.quantize_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        toptim.dequantize_int8(tq, ts).numpy(),
        np.asarray(joptim.dequantize_int8(jq, js)))


# -- the reference's own tests (tests/test_optim.py), on the port ------------


def _quad_loss(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)


@pytest.mark.parametrize("make", [lambda: toptim.adamw(lr=0.1),
                                  lambda: toptim.adafactor(lr=0.3),
                                  lambda: toptim.sgd(lr=0.1)])
def test_optimizer_converges_on_quadratic(make):
    opt = make()
    params = {"w": torch.ones((4, 8)), "b": torch.zeros((8,))}
    state = opt.init(params)
    loss0 = float(_quad_loss(params))
    for _ in range(60):
        tracked = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(tracked, torch.autograd.grad(
            _quad_loss(tracked), list(tracked.values()))))
        params, state = opt.update(grads, state, params)
    assert float(_quad_loss(params)) < loss0 * 0.05


def test_adamw_state_shapes_match_params():
    s = toptim.adamw().init({"a": torch.ones((3, 5)),
                             "nested": {"b": torch.ones((7,))}})
    assert s["m"]["a"].shape == (3, 5)
    assert s["v"]["nested"]["b"].shape == (7,)


def test_adafactor_factored_stats():
    s = toptim.adafactor().init({"w": torch.ones((16, 32)),
                                 "b": torch.ones((16,))})
    assert s["v"]["w"]["vr"].shape == (16,)
    assert s["v"]["w"]["vc"].shape == (32,)
    assert s["v"]["b"]["v"].shape == (16,)


def test_pick_optimizer_size_rule():
    assert toptim.pick_optimizer(1_000_000).name == "adamw"
    assert toptim.pick_optimizer(100_000_000_000).name == "adafactor"


def test_clip_by_global_norm():
    clipped, gn = toptim.clip_by_global_norm({"a": torch.ones((10,)) * 100.0},
                                             1.0)
    assert float(gn) > 100
    total = torch.sqrt(torch.sum(torch.square(clipped["a"])))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)


def test_schedules():
    s = toptim.cosine_schedule(10, 100)
    assert float(s(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(s(torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0)
    assert float(s(torch.tensor(100, dtype=torch.int32))) == \
        pytest.approx(0.1, abs=1e-3)
    w = toptim.linear_warmup(5)
    assert float(w(torch.tensor(2, dtype=torch.int32))) == pytest.approx(0.4)


def test_topk_compression_roundtrip_with_error_feedback():
    rng = np.random.RandomState(0)
    g = torch.from_numpy(rng.randn(1000).astype(np.float32))
    idx, vals, residual = toptim.compress_topk(g, frac=0.1)
    dec = toptim.decompress_topk(idx, vals, (1000,))
    np.testing.assert_allclose((dec + residual.reshape(-1)).numpy(),
                               g.numpy(), atol=1e-6)
    kept = np.abs(g.numpy())[idx.numpy()]
    assert kept.min() >= np.sort(np.abs(g.numpy()))[-100:].min() - 1e-6


def test_int8_quantization_error_bounded():
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(256, 4).astype(np.float32))
    q, scale = toptim.quantize_int8(g)
    back = toptim.dequantize_int8(q, scale)
    assert q.dtype == torch.int8
    assert float((back - g).abs().max()) <= float(scale) * 0.5 + 1e-6
