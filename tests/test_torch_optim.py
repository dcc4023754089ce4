"""The port's `optim.adamw` against the reference's (`repro.optim`), from
the same seeded numpy parameters and gradient sequences."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread per process)
from repro.optim.optimizers import adamw as jadamw
from repro_torch.optim import adamw as tadamw

SHAPES = {"w": (6, 5), "b": (5,), "s": ()}


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*s), np.float32)
            for k, s in SHAPES.items()}


def _grads(rng, tiny):
    """Gradients of every scale: near adamw's eps (1e-8) where `tiny`,
    exact zeros in a few entries, and ordinary ones."""
    out = {}
    for k, s in SHAPES.items():
        g = np.asarray(rng.randn(*s), np.float32)
        if tiny:
            g = np.asarray(g * 1e-8, np.float32)
        out[k] = np.asarray(np.where(rng.rand(*s) < 0.1, 0, g), np.float32)
    return out


@pytest.mark.parametrize("kw", [dict(lr=2e-2, b2=0.99),
                                dict(lr=1e-3, b1=0.8, b2=0.95, wd=0.01)])
@pytest.mark.parametrize("tiny", [False, True])
def test_adamw_matches_reference_over_steps(kw, tiny):
    """k = 12 steps on the same gradients: each step within 1e-6
    relative and 1e-6 x lr absolute of the reference (the bias
    corrections 1 - b ** step go through XLA's and PyTorch's float32
    pow, which may differ in the last bit), and so after all of them;
    the step counter and moments alike."""
    jopt, topt = jadamw(**kw), tadamw(**kw)
    p0 = _params(3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.RandomState(11)
    for _ in range(12):
        g = _grads(rng, tiny)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                             js, jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6 * kw["lr"])
    assert int(ts["step"]) == int(js["step"]) == 12
    for k in SHAPES:
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]),
                                   rtol=1e-6, atol=1e-20)


def test_adamw_state_shapes_and_types():
    opt = tadamw()
    p = {k: torch.zeros(s) for k, s in SHAPES.items()}
    s = opt.init(p)
    assert s["step"].dtype == torch.int32 and s["step"].shape == ()
    for k, shape in SHAPES.items():
        assert tuple(s["m"][k].shape) == shape == tuple(s["v"][k].shape)
        assert s["m"][k].dtype == s["v"][k].dtype == torch.float32
    p2, s2 = opt.update({k: torch.ones(sh) for k, sh in SHAPES.items()}, s,
                        p)
    assert int(s2["step"]) == 1 and int(s["step"]) == 0     # not in place
    assert all(float(p[k].abs().sum()) == 0 for k in p)
    assert all(p2[k].dtype == p[k].dtype for k in p)


def test_adamw_converges_on_quadratic():
    """The reference's quadratic (tests/test_optim.py): 60 steps of lr 0.1
    cut the loss below 5% of its start, as the reference's do."""
    def loss(p):
        return ((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1.0) ** 2).sum()
    opt = tadamw(lr=0.1)
    p = {"w": torch.ones(4, 8), "b": torch.zeros(8)}
    s = opt.init(p)
    loss0 = float(loss(p))
    for _ in range(60):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        g = torch.autograd.grad(loss(q), list(q.values()))
        p, s = opt.update(dict(zip(q, g)), s, p)
    assert float(loss(p)) < loss0 * 0.05
