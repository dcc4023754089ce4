"""The port's language-model train step across ranks against the
reference's single-device step: on CPU worlds of 2 x 2, 1 x 2 and 2 x 1
gloo ranks, reduced llama3.2-1b, granite-34b, qwen1.5-32b, deepseek-v3
(MLA, MTP, bitmap dispatch) and grok-1 (COO dispatch) take
`loss_and_grads` and one `build_train_step` step with their params,
optimizer state and batch each placed by its resolved spec, against
`jax.value_and_grad(model_loss)` and the reference's jitted
`build_train_step` on `make_mesh_from(jax.devices()[:1], 1)`.

Tolerances: float32 loss, metrics and grad_norm within 1e-4 (relative
where above 1), every gradient leaf within 1e-4 of that leaf's largest
magnitude, params after AdamW's first step by
`_lm_parity.close_adamw_first_step` (ROADMAP.md Queue 3 item 25), and
after adafactor, sgd or grad_accum=2 within 1e-4 of each leaf's largest
(2 x 2 only; adafactor on granite-34b, deepseek-v3 and grok-1, sgd on
llama3.2-1b and qwen1.5-32b, grad_accum on llama3.2-1b with sgd). bf16
llama3.2-1b: the loss within the reference's own 5e-2
(`tests/test_sharding.py:126`), and each gradient leaf no farther from
the float32 gradient of the same (bf16-rounded) params than the port's
one-process bf16 gradient is, x1.25 in max and in mean. MoE runs at
capacity E / top_k. qwen1.5-32b's key bias has no gradient in exact
arithmetic (a shift of every key moves no softmax), so adafactor, which
divides a gradient by its own scale, is not run on it.

The params and batches are `tests/test_torch_lm_mesh.py`'s: llama3.2-1b
is the reference test's own case (`tests/test_sharding.py:96`, its
PRNGKey(0) params and `TokenStream` batch of (4, 16)). Each world is
spawned once (`_torch_mesh_ranks.lm_train_job`) while this process
computes the reference's results."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
import test_torch_lm_mesh as lm_mesh
from _lm_parity import (RWKV_F32_GRAD_TOL, carry_batch,
                        close_adamw_first_step, close_leaves, f32, leaf_items,
                        train_batch)
from repro import optim as joptim
from repro.launch import elastic as jelastic
from repro.launch import steps as jsteps
from repro.models import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttf

ARCHS = lm_mesh.ARCHS
WORLDS = lm_mesh.WORLDS
B, S = lm_mesh.B, lm_mesh.P
TOL = 1e-4
BF16_LOSS_TOL = 5e-2
BF16_NOISE_RATIO = 1.25
ADAMW_B1, ADAMW_EPS = 0.9, 1e-8        # adamw's defaults
ADAFACTOR = ("granite-34b", "deepseek-v3-671b", "grok-1-314b")
SGD = ("llama3.2-1b", "qwen1.5-32b")
ACCUM = ("llama3.2-1b", 2)


def _cases(world):
    """The cases a world runs: every arch's float32 gradients and AdamW
    step; on 2 x 2 also adafactor, sgd, grad_accum=2 and bf16."""
    cases = {f"{n}/adamw": {"arch": n, "dtype": "float32", "grads": True,
                            "opt": "adamw"} for n in ARCHS}
    cases["llama3.2-1b/bf16"] = {"arch": "llama3.2-1b", "dtype": "bfloat16",
                                 "grads": True}
    if world == "2x2":
        cases.update({f"{n}/adafactor": {"arch": n, "dtype": "float32",
                                         "opt": "adafactor"}
                      for n in ADAFACTOR})
        cases.update({f"{n}/sgd": {"arch": n, "dtype": "float32",
                                   "opt": "sgd"} for n in SGD})
        cases[f"{ACCUM[0]}/accum"] = {"arch": ACCUM[0], "dtype": "float32",
                                      "opt": "sgd", "accum": ACCUM[1]}
    return cases


def _arch(name):
    """Float32 numpy params and the TokenStream batch of (B, S)."""
    jcfg, _ = lm_mesh._cfgs(name)
    batch = {k: np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                         else v) for k, v in train_batch(jcfg, B, S).items()}
    return {"params": lm_mesh._params(name, *lm_mesh._cfgs(name)),
            "batch": batch, "capacity_factor": jcfg.capacity_factor}


def _jrules():
    return jsharding.make_rules(jelastic.make_mesh_from(jax.devices()[:1], 1))


def _ref_step(jcfg, which, jp, jb, accum=1):
    """The reference's jitted train step of optimizer `which` (the
    enc-dec's op by op: ROADMAP.md Queue 3 item 18)."""
    jcfg = dataclasses.replace(jcfg, grad_accum=accum)
    opt = ranks.train_opt(joptim, which)
    with lm_mesh._eager(jcfg):
        return jax.jit(jsteps.build_train_step(jcfg, _jrules(), opt))(
            jp, opt.init(jp), jb)


def reference(name, arch, adafactor=None, sgd=None, accum=None):
    """The reference's float32 loss, metrics, gradients and AdamW step on
    the arch's params and batch (the enc-dec's op by op), the extra
    optimizers of the 2 x 2 world (default: as this file's archs take
    them; `accum`: grad_accum=2 with sgd), and its specs of the params and
    AdamW / adafactor state on shape-only meshes of each world."""
    jcfg, _ = lm_mesh._cfgs(name)
    jp = jax.tree.map(jnp.asarray, arch["params"])
    jb = {k: jnp.asarray(v) for k, v in arch["batch"].items()}
    with lm_mesh._eager(jcfg):
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jtf.model_loss(p, jcfg, jb), has_aux=True))(jp)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": grads, "adamw": _ref_step(jcfg, "adamw", jp, jb)}
    if name in ADAFACTOR if adafactor is None else adafactor:
        out["adafactor"] = _ref_step(jcfg, "adafactor", jp, jb)
    if name in SGD if sgd is None else sgd:
        out["sgd"] = _ref_step(jcfg, "sgd", jp, jb)
    if name == ACCUM[0] if accum is None else accum:
        out["accum"] = _ref_step(jcfg, "sgd", jp, jb, accum=ACCUM[1])
    out["shapes"] = {w: _state_shapes(jcfg, dict(zip(("data", "model"), s)))
                     for w, s in WORLDS.items()}
    return out


def bf16_reference(name, arch):
    """An arch in bf16: the reference's jitted bf16 loss (the enc-dec's op
    by op), the reference's float32 gradients of the bf16-rounded params
    (the truth of the noise rule) and the port's one-process bf16
    gradients."""
    jcfg, tcfg = lm_mesh._cfgs(name)
    jb = {k: jnp.asarray(v) for k, v in arch["batch"].items()}
    bf = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                      arch["params"])
    with lm_mesh._eager(jcfg):
        loss = float(jax.jit(lambda p: jtf.model_loss(p, jcfg, jb)[0])(bf))
        truth = jax.jit(jax.grad(lambda p: jtf.model_loss(p, jcfg, jb)[0]))(
            jax.tree.map(lambda a: a.astype(jnp.float32), bf))
    _, _, one = tsteps.loss_and_grads(
        tcfg, ttf.params_from_numpy(arch["params"], device="cpu",
                                    dtype=torch.bfloat16),
        carry_batch(jb))
    return {"loss": loss, "truth": truth, "one": one}


def _state_shapes(jcfg, shape):
    """{optimizer: {path: (global shape, local shape)}} of the reference's
    params ("params") and its `opt_state_sharding` of AdamW and adafactor
    on a shape-only mesh of `shape`."""
    fake = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsharding, jsteps):
            mp.setattr(mod, "NamedSharding", lm_mesh._Sharding)
        rules = jsharding.make_rules(fake)
        sds, logical = jsteps.abstract_params(jcfg)
        p_sh = jsharding.param_sharding(sds, logical, rules)
        out = {"params": _local_shapes(sds, p_sh, shape)}
        for which in ("adamw", "adafactor"):
            state, sh = jsteps.opt_state_sharding(
                ranks.train_opt(joptim, which), sds, p_sh, rules)
            state = {k: v for k, v in state.items() if k != "step"}
            sh = {k: v for k, v in sh.items() if k != "step"}
            out[which] = _local_shapes(state, sh, shape)
    return out


def _local_shapes(sds, sh, shape):
    leaves = jax.tree_util.tree_flatten_with_path(sds)[0]
    shard = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(
        x, lm_mesh._Sharding))
    out = {}
    for (path, s), spec in zip(leaves, shard):
        local = []
        for n, e in zip(s.shape, tuple(spec.spec) + (None,) * len(s.shape)):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            local.append(n // int(np.prod([shape[a] for a in axes])))
        out[jax.tree_util.keystr(path)] = (tuple(s.shape), tuple(local))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world runs while this process computes the reference's
    results."""
    tmp = tmp_path_factory.mktemp("lm_mesh_train")
    archs = {name: _arch(name) for name in ARCHS}
    started = {}
    for key, shape in WORLDS.items():
        wdir = tmp / key
        wdir.mkdir()
        started[key] = ranks.start(ranks.lm_train_job, shape[0] * shape[1],
                                   wdir, {"mesh": shape, "archs": archs,
                                          "cases": _cases(key)})
    try:
        want = {name: reference(name, archs[name]) for name in ARCHS}
        bf16 = {"llama3.2-1b": bf16_reference("llama3.2-1b",
                                              archs["llama3.2-1b"])}
    finally:
        out = {k: ranks.join(s, timeout_s=400.0) for k, s in started.items()}
    return {"ranks": out, "want": want, "bf16": bf16}


CASES = [(w, n) for w in WORLDS for n in ARCHS]
IDS = [f"{w}-{n}" for w, n in CASES]


def _got(runs, world, key):
    return [r["cases"][key] for r in runs["ranks"][world]]


def _close_metric(got, want, what):
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (what, got, want)


def grad_tol(name):
    """(a gradient leaf's tolerance of the arch, the leaves held to one
    bf16 ulp instead): RWKV6's float32 gradients at Queue 3 item 23's
    5e-4, the enc-dec encoder's first norm gain (differentiated through
    the frames' bf16 cast) at item 24's bf16 ulp, 1e-4 otherwise."""
    cfg = lm_mesh._cfgs(name)[0]
    return (RWKV_F32_GRAD_TOL if cfg.family == "ssm" else TOL,
            {"['enc']['ln1']"} if cfg.enc_dec else ())


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_loss_and_grad_norm_match_the_reference(runs, world, name):
    """`loss_and_grads`' loss and metrics, and the step's loss and
    grad_norm, within 1e-4 of the reference's on every rank; the loss a
    plain tensor equal on every rank."""
    want = runs["want"][name]
    step_metrics = {k: float(v) for k, v in want["adamw"][2].items()}
    got_all = _got(runs, world, f"{name}/adamw")
    for got in got_all:
        assert set(got["metrics"]) == set(want["metrics"])
        for k, w in want["metrics"].items():
            _close_metric(got["metrics"][k], w, k)
        assert got["loss"] == got["metrics"]["loss"]
        assert set(got["step_metrics"]) == set(step_metrics)
        for k, w in step_metrics.items():
            _close_metric(got["step_metrics"][k], w, k)
    assert len({g["loss"] for g in got_all}) == 1
    assert len({g["step_metrics"]["grad_norm"] for g in got_all}) == 1


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_gradients_match_the_reference(runs, world, name):
    """Every gradient leaf, made whole, within 1e-4 of that leaf's largest
    magnitude against `jax.value_and_grad`, on every rank; each a DTensor
    placed as its param."""
    tol, loose = grad_tol(name)
    for got in _got(runs, world, f"{name}/adamw"):
        assert not got["plain"]
        close_leaves(got["grads"], runs["want"][name]["grads"], tol, loose)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_adamw_step_matches_the_reference(runs, world, name):
    """The params after one AdamW step (launcher schedule, clip) against
    the reference's step by the first-step rule; AdamW's m within 1e-4;
    the step counter 1; each new leaf keeps its param's placements."""
    jp, js, _ = runs["want"][name]["adamw"]
    tol, loose = grad_tol(name)
    for got in _got(runs, world, f"{name}/adamw"):
        close_adamw_first_step(got["params"], jp, js["m"],
                               ranks.TRAIN_OPTS["adamw"]["lr"], ADAMW_B1,
                               ADAMW_EPS, tol)
        close_leaves(got["state"]["m"], js["m"], tol, loose)
        assert got["step"] == int(js["step"]) == 1
        assert got["placements_kept"]


def _shapes(tree):
    """{path: (global shape, local shape)} of a rank's
    `_torch_mesh_ranks._local_shapes` tree."""
    return {k: v[:2] for k, v in lm_mesh._flat("", tree).items()}


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_shards_have_the_resolved_shapes(runs, world, name):
    """Each rank's local gradient shard has its param's shape under the
    reference's `param_sharding`, and each AdamW state leaf (before and
    after the step) the shape that the reference's `opt_state_sharding`
    gives, on a shape-only mesh of the world's axes; every world splits
    some leaf."""
    want = runs["want"][name]["shapes"][world]
    for got in _got(runs, world, f"{name}/adamw"):
        assert _shapes(got["grad_shapes"]) == want["params"]
        for key in ("state_shapes", "new_state_shapes"):
            assert _shapes(got[key]) == want["adamw"]
    assert any(g != l for g, l in want["params"].values())


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_no_functional_collectives(runs, world, name):
    """The forward, backward and update move data only through gloo's own
    collectives (`sharding.redistribute` and its transposes): no
    `_c10d_functional::` op, which DTensor would issue inside an op."""
    for got in _got(runs, world, f"{name}/adamw"):
        for key in ("grad_collectives", "step_collectives"):
            assert not [k for k in got[key]
                        if k.startswith("_c10d_functional::")], got[key]
            assert any(k.startswith("gloo:") for k in got[key])


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_share_of_params_and_state(runs, world):
    """The bytes of a rank's params and AdamW state: about its share of
    the whole (1 / ranks, plus the few leaves that no mesh axis splits)."""
    n = WORLDS[world][0] * WORLDS[world][1]
    for name in ARCHS:
        for got in _got(runs, world, f"{name}/adamw"):
            held, whole = got["bytes"]
            assert held <= whole * (1.0 / n + 0.1), (name, held, whole)


@pytest.mark.parametrize("name", ADAFACTOR)
def test_adafactor_step_matches_the_reference_on_2x2(runs, name):
    """One adafactor step on 2 x 2: metrics within 1e-4, every param and
    state leaf (vr, vc, v) within 1e-4 of its largest; each state shard
    of the shape that `opt_state_sharding` gives."""
    jp, js, jm = runs["want"][name]["adafactor"]
    shapes = runs["want"][name]["shapes"]["2x2"]["adafactor"]
    for got in _got(runs, "2x2", f"{name}/adafactor"):
        for k, w in jm.items():
            _close_metric(got["step_metrics"][k], float(w), k)
        close_leaves(got["params"], jp, TOL)
        close_leaves(got["state"]["v"], js["v"], TOL)
        for key in ("state_shapes", "new_state_shapes"):
            assert _shapes(got[key]) == shapes


@pytest.mark.parametrize("name", SGD)
def test_sgd_step_matches_the_reference_on_2x2(runs, name):
    jp, _, jm = runs["want"][name]["sgd"]
    for got in _got(runs, "2x2", f"{name}/sgd"):
        for k, w in jm.items():
            _close_metric(got["step_metrics"][k], float(w), k)
        close_leaves(got["params"], jp, TOL)


def test_grad_accum_matches_the_reference_on_2x2(runs, name=ACCUM[0]):
    """grad_accum=2 on 2 x 2 (microbatches of rows [0, 2) and [2, 4),
    each placed by `batch_spec`; the bf16 accumulator placed as the
    params) against the reference's grad_accum=2 on one device, with
    sgd."""
    jp, _, jm = runs["want"][name]["accum"]
    assert set(jm) == {"loss", "grad_norm"}
    for got in _got(runs, "2x2", f"{name}/accum"):
        assert set(got["step_metrics"]) == set(jm)
        for k, w in jm.items():
            _close_metric(got["step_metrics"][k], float(w), k)
        close_leaves(got["params"], jp, TOL)


def _noise(got, one, truth):
    e_got, e_one = np.abs(got - truth), np.abs(one - truth)
    return ((float(e_got.max()), float(e_got.mean())),
            (float(e_one.max()), float(e_one.mean())))


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_within_the_noise_of_one_process(runs, world,
                                              name="llama3.2-1b"):
    """bf16 llama3.2-1b: the loss within 5e-2 of the reference's bf16
    loss; every gradient leaf no farther from the reference's float32
    gradient of the same bf16 params than the port's one-process bf16
    gradient is, x1.25 in max and in mean."""
    ref = runs["bf16"][name]
    one = dict((p, f32(g)) for p, _, g in leaf_items(ref["truth"],
                                                       ref["one"]))
    for got in _got(runs, world, f"{name}/bf16"):
        assert abs(got["loss"] - ref["loss"]) < BF16_LOSS_TOL
        for path, truth, g in leaf_items(ref["truth"], got["grads"]):
            g, t = f32(g), f32(truth)
            assert np.isfinite(g).all(), path
            (g_max, g_mean), (o_max, o_mean) = _noise(g, one[path], t)
            assert g_max <= BF16_NOISE_RATIO * o_max, (path, g_max, o_max)
            assert g_mean <= BF16_NOISE_RATIO * o_mean, (path, g_mean,
                                                         o_mean)


def test_worlds_are_the_meshes_asked_for(runs):
    for key, (data, model) in WORLDS.items():
        for r in runs["ranks"][key]:
            assert r["mesh"] == {"data": data, "model": model}


TRUNKS = ("seamless-m4t-large-v2", "zamba2-7b", "rwkv6-1.6b")


@pytest.mark.parametrize("name", TRUNKS + ARCHS + (
    "granite-3-8b", "internvl2-76b"))
def test_train_step_builds_across_ranks_for_every_trunk(name):
    """On a (2, 1) mesh `build_train_step` builds for every trunk (dense,
    MoE, enc-dec, hybrid and RWKV6), before any rank is needed (a mesh
    of shapes only); the enc-dec, hybrid and RWKV6 trunks' steps run in
    `tests/test_torch_lm_mesh_trunks.py`'s worlds."""
    from repro_torch import optim as toptim
    from repro_torch.configs import registry as treg
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import sharding as tsharding
    cfg = treg.reduced(treg.ARCHS[name])
    rules = tsharding.make_rules(HostMesh({"data": 2, "model": 1},
                                          ("data", "model"), None))
    assert callable(tsteps.build_train_step(cfg, rules, toptim.adamw(1e-3)))


def test_mesh_context_nests():
    """`sharding.mesh_context` on a mesh of several ranks (shapes only
    here) keeps DTensor's implicit replication on until its outermost
    level exits: DTensor's own context switches it off when any level
    exits, which left a train step's backward after `model_loss`
    without it (ROADMAP.md Queue 3 item 31)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import sharding as tsharding
    rules = tsharding.make_rules(HostMesh({"data": 2, "model": 1},
                                          ("data", "model"), None))
    flag = lambda: DTensor._op_dispatcher._allow_implicit_replication  # noqa: E731
    with tsharding.mesh_context(rules):
        with tsharding.mesh_context(rules):
            assert flag()
        assert flag()
    assert not flag()
