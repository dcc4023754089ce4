"""Parity of the port's Mixture-of-Experts (`repro_torch.models.moe`) with
the reference's (`repro.models.moe`): the router's gates, expert indices
(ties included) and aux loss, the COO routing tables and the tokens they
drop, both dispatch modes, the paper's 80% rule, one-token decode and the
shared experts. The port counterparts of tests/test_moe.py.

Params and inputs are drawn with numpy from a seed. Tolerances: float32
to 1e-5 (rtol and atol; the two packages sum in other orders), bf16 to
3e-2 against the reference run op by op (`jax.disable_jit`: its jitted
bf16 rounds apart, ROADMAP.md Queue 3 item 16); indices, routing tables
and dropped tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

F32_TOL = 1e-5
BF16_TOL = 3e-2
BASE = dict(name="test-moe", family="moe", n_layers=1, d_model=32,
            n_heads=4, n_kv_heads=4, d_ff=64, vocab=128, n_experts=8,
            top_k=2, d_ff_expert=64, capacity_factor=8.0)   # no drops


def cfgs(**kw):
    """The same config in both packages."""
    return JaxConfig(**dict(BASE, **kw)), ModelConfig(**dict(BASE, **kw))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def moe_params(cfg, seed):
    """init_moe's leaves at its shapes and fan-in scales, with numpy."""
    rng = np.random.RandomState(seed)
    d, e = cfg.d_model, cfg.n_experts
    dff = cfg.d_ff_expert or cfg.d_ff

    def w(*shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    p = {"router": w(d, e, fan_in=d), "w1": w(e, d, dff, fan_in=d),
         "w2": w(e, dff, d, fan_in=dff)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = w(e, d, dff, fan_in=d)
    if cfg.n_shared_experts:
        sdff = dff * cfg.n_shared_experts
        p["sw1"] = w(d, sdff, fan_in=d)
        p["sw2"] = w(sdff, d, fan_in=sdff)
        if cfg.act in ("swiglu", "geglu"):
            p["sw3"] = w(d, sdff, fan_in=d)
    return p


def both(p, dtype="float32"):
    """numpy params as the reference's and the port's, in `dtype`."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    return ({k: jnp.asarray(v).astype(jdt) for k, v in p.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in p.items()})


def inputs(seed, *shape, dtype="float32"):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("shared,act", [(0, "swiglu"), (1, "swiglu"),
                                        (2, "gelu")])
def test_init_moe_and_capacity_match_reference(shared, act):
    """init_moe's tree, shapes and logical axes; the capacity rule."""
    jc, tc = cfgs(n_shared_experts=shared, act=act)
    want_p, want_log = jcommon.split_pl(jmoe.init_moe(
        jcommon.Maker(jax.random.PRNGKey(0), dtype=jnp.float32), jc))
    got_p, got_log = tcommon.split_pl(tmoe.init_moe(tcommon.Maker(
        torch.Generator().manual_seed(0), dtype=torch.float32), tc))
    assert got_log == want_log
    assert {k: tuple(v.shape) for k, v in got_p.items()} == \
        {k: tuple(v.shape) for k, v in want_p.items()}
    assert tmoe.BITMAP_CHUNK == jmoe.BITMAP_CHUNK
    for S in (1, 8, 16, 64, 300):
        want = max(int(S * jc.top_k / jc.n_experts * jc.capacity_factor),
                   jc.top_k)
        assert tmoe.capacity(tc, S) == want


@pytest.mark.parametrize("name", ["test-moe", "deepseek-test"])
def test_router_scores_match_reference(name):
    """Softmax gates, and DeepSeek's sigmoid gates (by the config's
    name): vals, idx and the switch aux loss."""
    jc, tc = cfgs(name=name, n_experts=16, top_k=4)
    jp, tp = both(moe_params(jc, 1))
    jx, tx = inputs(2, 3, 10, jc.d_model)
    wv, wi, wa = jmoe._router_scores(jp, jc, jx)
    gv, gi, ga = tmoe._router_scores(tp, tc, tx)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    close(gv, wv, F32_TOL)
    close(ga, wa, F32_TOL)
    close(gv.sum(-1), np.ones((3, 10)), F32_TOL)       # renormalised
    assert float(ga) > 0


def test_router_ties_take_the_lower_index_first():
    """Equal scores are ordered by expert index, as `jax.lax.top_k` does:
    a zero router (every score equal) gives experts 0..k-1, and a router
    whose columns tie in two groups gives JAX's order, where `torch.topk`
    would not."""
    jc, tc = cfgs(n_experts=16, top_k=6)
    p = moe_params(jc, 3)
    p["router"] = np.zeros_like(p["router"])
    jp, tp = both(p)
    jx, tx = inputs(4, 2, 5, jc.d_model)
    wv, wi, _ = jmoe._router_scores(jp, jc, jx)
    gv, gi, _ = tmoe._router_scores(tp, tc, tx)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gi.numpy()[0, 0], np.arange(6))
    close(gv, wv, F32_TOL)

    router = np.zeros_like(p["router"])
    router[0, [3, 5, 9, 12]] = 1.0                     # four tie high
    p["router"] = router
    jp, tp = both(p)
    x = np.zeros((1, 1, jc.d_model), np.float32)
    x[..., 0] = 1.0
    _, wi, _ = jmoe._router_scores(jp, jc, jnp.asarray(x))
    _, gi, _ = tmoe._router_scores(tp, tc, torch.from_numpy(x))
    assert np.asarray(wi)[0, 0].tolist() == [3, 5, 9, 12, 0, 1]
    assert gi.numpy()[0, 0].tolist() == [3, 5, 9, 12, 0, 1]
    logits = torch.from_numpy(x) @ tp["router"]
    assert torch.topk(torch.softmax(logits, -1), 6).indices[0, 0].tolist() \
        != [3, 5, 9, 12, 0, 1]


@pytest.mark.parametrize("S,E,k,C", [(16, 8, 2, 8), (16, 8, 2, 3),
                                     (40, 4, 3, 5), (7, 16, 4, 4)])
def test_route_one_group_matches_reference_exactly(S, E, k, C):
    """The routing tables (token index per expert slot, S = empty, and its
    gate), drops included, for one group and for a batch of groups."""
    rng = np.random.RandomState(S + E + C)
    # skewed choices so that some experts overflow their C slots
    idx = np.stack([np.stack([rng.choice(E, k, replace=False,
                                         p=np.linspace(1, 3, E) / (2 * E))
                              for _ in range(S)]) for _ in range(3)])
    vals = rng.rand(3, S, k).astype(np.float32)
    for g in range(3):
        wb, ww = jmoe._route_one_group(jnp.asarray(idx[g], jnp.int32),
                                       jnp.asarray(vals[g]), S, E, C)
        gb, gw = tmoe._route_one_group(torch.from_numpy(idx[g]),
                                       torch.from_numpy(vals[g]), S, E, C)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    gb, gw = tmoe._route_one_group(torch.from_numpy(idx),
                                   torch.from_numpy(vals), S, E, C)
    wb, ww = jax.vmap(lambda i, v: jmoe._route_one_group(i, v, S, E, C))(
        jnp.asarray(idx, jnp.int32), jnp.asarray(vals))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    dropped = 3 * S * k - int((gb.numpy() < S).sum())
    assert dropped >= 0
    if C * E < S * k:                                  # capacity binds
        assert dropped > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,cf,S", [("coo", 8.0, 16), ("coo", 0.25, 64),
                                       ("bitmap", 8.0, 16),
                                       ("bitmap", 8.0, 300)])
def test_dispatch_modes_match_reference(mode, cf, S, dtype):
    """Each mode against the reference's: COO with capacity headroom and
    with drops (cf 0.25: the same tokens dropped, so the same output),
    the bitmap mode in one chunk and over two (S > BITMAP_CHUNK)."""
    jc, tc = cfgs(capacity_factor=cf)
    jp, tp = both(moe_params(jc, 5), dtype)
    jx, tx = inputs(6, 2, S, jc.d_model, dtype=dtype)
    jfn = getattr(jmoe, f"moe_forward_{mode}")
    tfn = getattr(tmoe, f"moe_forward_{mode}")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    if dtype == "bfloat16":
        with jax.disable_jit():
            want, waux = jfn(jp, jc, jx)
    else:
        want, waux = jax.jit(lambda p, x: jfn(p, jc, x))(jp, jx)
    got, gaux = tfn(tp, tc, tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    close(got, want, tol)
    close(gaux, waux, F32_TOL)


def test_dispatch_modes_equivalent_without_drops():
    """tests/test_moe.py::test_dispatch_modes_equivalent on the port."""
    _, tc = cfgs()
    _, tp = both(moe_params(tc, 7))
    _, tx = inputs(8, 2, 16, tc.d_model)
    y_coo, a1 = tmoe.moe_forward_coo(tp, tc, tx)
    y_bm, a2 = tmoe.moe_forward_bitmap(tp, tc, tx)
    close(y_coo, y_bm, 2e-4)
    close(a1, a2, F32_TOL)


def test_auto_rule_follows_paper_threshold():
    """moe_forward takes the mode of `resolved_dispatch`: bitmap under 80%
    sparsity, COO at or over it, and the config's own choice where it
    names one (grok's "coo" at 75%); the output equals that mode's and
    the reference's moe_forward."""
    jc, tc = cfgs(capacity_factor=0.5)                   # drops in COO
    assert tc.dispatch_sparsity == 0.75 and tc.resolved_dispatch() == "bitmap"
    fine_j, fine_t = cfgs(n_experts=64, top_k=2, capacity_factor=0.5)
    assert fine_t.dispatch_sparsity > 0.96
    assert fine_t.resolved_dispatch() == "coo"
    named_j, named_t = cfgs(moe_dispatch="coo", capacity_factor=0.5)
    assert named_t.resolved_dispatch() == "coo"
    for (j, t), mode in (((jc, tc), "bitmap"), ((fine_j, fine_t), "coo"),
                         ((named_j, named_t), "coo")):
        jp, tp = both(moe_params(t, 9))
        jx, tx = inputs(10, 2, 32, t.d_model)
        got, _ = tmoe.moe_forward(tp, t, tx)
        want, _ = jmoe.moe_forward(jp, j, jx)
        close(got, want, F32_TOL)
        np.testing.assert_array_equal(
            got.numpy(), getattr(tmoe, f"moe_forward_{mode}")(tp, t,
                                                              tx)[0].numpy())
    # capacity binds here: the two modes do differ
    _, tp = both(moe_params(tc, 9))
    _, tx = inputs(10, 2, 32, tc.d_model)
    assert float((tmoe.moe_forward_coo(tp, tc, tx)[0]
                  - tmoe.moe_forward_bitmap(tp, tc, tx)[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_decode_path_single_token(cf):
    """S == 1: the B tokens form one group of their own (capacity from
    B), against the reference's, and against the bitmap mode when no
    token is dropped."""
    jc, tc = cfgs(capacity_factor=cf)
    jp, tp = both(moe_params(jc, 11))
    jx, tx = inputs(12, 8, 1, jc.d_model)
    want, _ = jmoe.moe_forward_coo(jp, jc, jx)
    got, _ = tmoe.moe_forward_coo(tp, tc, tx)
    assert tuple(got.shape) == (8, 1, tc.d_model)
    close(got, want, F32_TOL)
    if cf == 8.0:
        close(got, tmoe.moe_forward_bitmap(tp, tc, tx)[0], 2e-4)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_shared_expert_added(act):
    """Shared experts (gated, or the tanh-gelu MLP without w3) against the
    reference, and they change the output."""
    jc, tc = cfgs(n_shared_experts=1, act=act)
    p = moe_params(jc, 13)
    jp, tp = both(p)
    jx, tx = inputs(14, 2, 8, jc.d_model)
    got, _ = tmoe.moe_forward(tp, tc, tx)
    want, _ = jmoe.moe_forward(jp, jc, jx)
    close(got, want, F32_TOL)
    _, tc_no = cfgs(n_shared_experts=0, act=act)
    tp_no = {k: v for k, v in tp.items() if not k.startswith("sw")}
    y_wo, _ = tmoe.moe_forward(tp_no, tc_no, tx)
    assert float((got - y_wo).abs().max()) > 1e-6
    assert ("w3" in tp) == (act == "swiglu")
