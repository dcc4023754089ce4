"""LM training in the port against the reference, dense archs and the
train step: `model_loss` and its gradients (autograd against
`jax.value_and_grad`) on the reduced dense archs in float32 (and
llama3.2-1b in bf16 against the reference op by op, 3e-2); one
`build_train_step` step (AdamW, and adafactor on an MoE arch, with the
launcher's schedule and the clip) against the reference's jitted step on
a `make_mesh_from` mesh; the `grad_accum` branch; `abstract_params`,
`count_params` and `pick_optimizer` at full size; `batch_spec` and
`opt_state_spec` against the reference's PartitionSpecs.

Tolerances: float32 losses and metrics 1e-5 relative, every gradient,
param and state leaf within 1e-5 of that leaf's largest magnitude;
grad_accum in bf16 at the reference's own test's rtol 5e-2, atol 5e-3
(`tests/test_ssm_rwkv.py:104`)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread per process)
from _lm_parity import (CPU, F32_TOL, carry_batch, check_loss_and_grads,
                        close_adamw_first_step, close_leaves, f32,
                        family_params, train_batch)
from repro import optim as joptim
from repro.configs import registry as jreg
from repro.launch import elastic as jelastic
from repro.launch import steps as jsteps
from repro.models import sharding as jsharding
from repro_torch import optim as toptim
from repro_torch.configs import registry as treg
from repro_torch.launch import elastic as telastic
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as ttf
from repro_torch.models.common import split_pl

DENSE = ["llama3.2-1b", "granite-3-8b", "qwen1.5-32b", "granite-34b",
         "internvl2-76b"]
ACCUM_TOL = {"rtol": 5e-2, "atol": 5e-3}
STEPS = 20          # the launcher's schedule: cosine(max(steps // 20, 1), steps)
ADAMW = {"lr": 1e-3, "b1": 0.9, "eps": 1e-8}    # b1 and eps: adamw's defaults


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name, "float32")


def test_bf16_loss_and_grads_match_reference_op_by_op():
    """bf16 params and gradients against the reference run op by op
    (`jax.disable_jit`, ROADMAP.md Queue 3 item 16), within 3e-2."""
    check_loss_and_grads("llama3.2-1b", "bfloat16")


def _make_opt(m, which):
    sched = m.cosine_schedule(max(STEPS // 20, 1), STEPS)
    if which == "adamw":
        return m.adamw(lr=ADAMW["lr"], schedule=sched)
    if which == "adafactor":
        return m.adafactor(lr=1e-2, schedule=sched)
    return m.sgd(0.1)


def _steps(name, which, dtype="float32", accum=1, batch=2, seed=0):
    """One train step of both packages on the same params and batch: the
    reference's jitted on `make_mesh_from(jax.devices()[:1], 1)`, the
    port's on `make_mesh_from([cpu], 1)`. Returns both (params, state,
    metrics)."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg = dataclasses.replace(jreg.reduced(jreg.ARCHS[name]),
                               grad_accum=accum)
    tcfg = dataclasses.replace(treg.reduced(treg.ARCHS[name]),
                               grad_accum=accum)
    np_params = family_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), np_params)
    tp = ttf.params_from_numpy(np_params, device=CPU, dtype=tdt)
    jbatch = train_batch(jcfg, batch=batch)
    jopt, topt = _make_opt(joptim, which), _make_opt(toptim, which)
    jrules = jsharding.make_rules(jelastic.make_mesh_from(
        jax.devices()[:1], 1))
    trules = tsharding.make_rules(telastic.make_mesh_from([CPU], 1))
    want = jax.jit(jsteps.build_train_step(jcfg, jrules, jopt))(
        jp, jopt.init(jp), jbatch)
    got = tsteps.build_train_step(tcfg, trules, topt)(
        tp, topt.init(tp), carry_batch(jbatch))
    return got, want


@pytest.mark.parametrize("name,which", [("llama3.2-1b", "adamw"),
                                        ("grok-1-314b", "adafactor")])
def test_train_step_matches_reference(name, which):
    """Loss, metrics and grad_norm; every updated param (after AdamW's
    first step, to the reach of the gradients' tolerance: the schedule's
    step 1 is at full lr) and every leaf of the optimizer state."""
    (tp, ts, tm), (jp, js, jm) = _steps(name, which)
    assert set(tm) == set(jm) and "grad_norm" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=F32_TOL, atol=1e-7, err_msg=k)
    if which == "adamw":
        close_adamw_first_step(tp, jp, js["m"], ADAMW["lr"], ADAMW["b1"],
                               ADAMW["eps"], F32_TOL)
    else:
        close_leaves(tp, jp, F32_TOL)
    assert int(ts["step"]) == int(js["step"]) == 1
    close_leaves({k: v for k, v in ts.items() if k != "step"},
                 {k: v for k, v in js.items() if k != "step"}, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_accum_matches_reference(dtype):
    """grad_accum=4 over a batch of 8 (the reference's test, on a mesh it
    runs on here): the port's step against the reference's, in bf16 at
    that test's tolerance and in float32 at 1e-5 of each leaf's largest;
    and in bf16 the port's accumulated step against its full-batch step,
    the claim of the reference's test."""
    (tp, _, tm), (jp, _, jm) = _steps("llama3.2-1b", "sgd", dtype, accum=4,
                                      batch=8)
    assert set(tm) == set(jm) == {"loss", "grad_norm"}
    if dtype == "float32":
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=F32_TOL)
        close_leaves(tp, jp, F32_TOL)
        return
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **ACCUM_TOL)
    for a, b in zip(jax.tree.leaves(jp), toptim.optimizers.tree_leaves(tp)):
        np.testing.assert_allclose(f32(b), f32(a), **ACCUM_TOL)
    (fp, _, fm), _ = _steps("llama3.2-1b", "sgd", dtype, accum=1, batch=8)
    np.testing.assert_allclose(float(tm["loss"]), float(fm["loss"]),
                               **ACCUM_TOL)
    for a, b in zip(toptim.optimizers.tree_leaves(fp),
                    toptim.optimizers.tree_leaves(tp)):
        np.testing.assert_allclose(f32(b), f32(a), **ACCUM_TOL)


def test_grad_accum_must_divide_the_batch():
    cfg = dataclasses.replace(treg.reduced(treg.ARCHS["llama3.2-1b"]),
                              grad_accum=3)
    gen = torch.Generator().manual_seed(0)
    params, _ = split_pl(ttf.init_model(cfg, gen, device=CPU))
    opt = toptim.sgd(0.1)
    step = tsteps.build_train_step(cfg, tsharding.make_rules(
        telastic.make_mesh_from([CPU], 1)), opt)
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "labels": torch.zeros((4, 8), dtype=torch.int32),
             "loss_mask": torch.ones((4, 8))}
    with pytest.raises(ValueError, match="grad_accum=3"):
        step(params, opt.init(params), batch)


def _specs(tree):
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


@pytest.mark.parametrize("name", sorted(treg.ARCHS))
def test_abstract_params_count_and_optimizer_at_full_size(name):
    """The published config's param tree without a number drawn: shapes,
    dtypes and logical axes exactly the reference's `eval_shape`, the
    count and the optimizer the size rule picks too."""
    js, jl = jsteps.abstract_params(jreg.ARCHS[name])
    ts, tl = tsteps.abstract_params(treg.ARCHS[name])
    want = _specs(js)
    got = jax.tree.map(lambda s: (s.shape, str(s.dtype).replace(
        "torch.", "")), ts, is_leaf=lambda x: isinstance(x, tsteps.TensorSpec))
    assert got == want
    assert tl == jl
    n = tsteps.count_params(ts)
    assert n == jsteps.count_params(js)
    assert toptim.pick_optimizer(n).name == joptim.pick_optimizer(n).name


class _Sharding:
    """Stands in for NamedSharding on a mesh that has no devices here."""

    def __init__(self, mesh, spec):
        self.spec = spec


def _fake_mesh(shape):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 1},
                                  {"data": 2, "model": 4},
                                  {"data": 16, "model": 16}])
def test_batch_and_opt_state_specs_are_the_references(mesh, monkeypatch):
    """Every arch at full size and train_4k: `batch_spec` and, for AdamW,
    adafactor and SGD, `opt_state_spec` (adafactor's vr and vc drop an
    axis of their param's spec) equal the reference's PartitionSpecs,
    resolved on a mesh of that shape (NamedSharding stubbed: the test
    process has one device)."""
    monkeypatch.setattr(jsteps, "NamedSharding", _Sharding)
    monkeypatch.setattr(jsharding, "NamedSharding", _Sharding)
    jrules = jsharding.make_rules(_fake_mesh(mesh))
    trules = tsharding.make_rules(HostMesh(dict(mesh), tuple(mesh), CPU))
    for name in sorted(treg.ARCHS):
        jcfg, tcfg = jreg.ARCHS[name], treg.ARCHS[name]
        _, jb = jsteps.batch_sharding(jcfg, jreg.get_shape("train_4k"),
                                      jrules)
        _, tb = tsteps.batch_spec(tcfg, treg.get_shape("train_4k"), trules)
        assert tb == {k: tuple(v.spec) for k, v in jb.items()}
        jsds, jlog = jsteps.abstract_params(jcfg)
        tspecs, tlog = tsteps.abstract_params(tcfg)
        jpsh = jsharding.param_sharding(jsds, jlog, jrules)
        tpsp = tsharding.param_spec(tspecs, tlog, trules)
        assert tpsp == jax.tree.map(lambda s: tuple(s.spec), jpsh,
                                    is_leaf=lambda x: isinstance(x,
                                                                 _Sharding))
        for which in ("adamw", "adafactor", "sgd"):
            jopt, topt = _make_opt(joptim, which), _make_opt(toptim, which)
            jst, jsh = jsteps.opt_state_sharding(jopt, jsds, jpsh, jrules)
            tst, tsh = tsteps.opt_state_spec(topt, tspecs, tpsp, trules)
            assert tsh == jax.tree.map(
                lambda s: tuple(s.spec), jsh,
                is_leaf=lambda x: isinstance(x, _Sharding)), (name, which)
            assert jax.tree.map(lambda s: (s.shape, str(s.dtype).replace(
                "torch.", "")), tst, is_leaf=lambda x: isinstance(
                    x, tsteps.TensorSpec)) == _specs(jst)
