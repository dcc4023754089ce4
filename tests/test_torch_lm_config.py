"""Parity of the port's language-model configs and sharding rules with the
reference's: the ten `ModelConfig`s and their `reduced` forms field by
field, their counts, the 40 cells, `resolve_spec` on
tests/test_sharding.py's cases (a spec is the tuple of the reference's
PartitionSpec entries), and the decode cache's specs of every family.
All exact."""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import sharding as jsh
from repro.models import transformer as jtf
from repro.models.common import log_parse
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as ttf

ARCH_NAMES = list(jreg.ARCHS)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def assert_same_cache_spec(j, t, B, S, enc_len=0):
    """serve_cache_spec's shapes, dtypes and logical strings equal the
    reference's, leaf for leaf (None subtrees on both sides)."""
    want, want_log = jtf.serve_cache_spec(j, B, S, enc_len=enc_len)
    got, got_log = ttf.serve_cache_spec(t, B, S, enc_len=enc_len)
    assert got_log == want_log
    assert jax.tree.structure(want) == jax.tree.structure(
        got, is_leaf=lambda x: isinstance(x, tcommon.TensorSpec))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, tcommon.TensorSpec))):
        assert g.shape == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def _pair(name, small):
    j, t = jreg.ARCHS[name], treg.ARCHS[name]
    return (jreg.reduced(j), treg.reduced(t)) if small else (j, t)


@pytest.mark.parametrize("small", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_model_config_matches_reference(name, small):
    j, t = _pair(name, small)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("resolved_head_dim", "vocab_padded", "is_moe",
                 "dispatch_sparsity"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.resolved_dispatch() == j.resolved_dispatch()
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert treg.get_arch(name) == tbase.ModelConfig(
        **dataclasses.asdict(jreg.get_arch(name)))
    # every arch is served: its decode cache's specs are the reference's
    assert_same_cache_spec(j, t, 2, 16, enc_len=8)


def test_registry_shapes_and_cells_match_reference():
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in tbase.LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.LM_SHAPES.items()}
    got = [(c.name, s.name, skip) for c, s, skip in treg.all_cells()]
    want = [(c.name, s.name, skip) for c, s, skip in jreg.all_cells()]
    assert got == want and len(got) == 40
    for name in tbase.LM_SHAPES:
        assert dataclasses.asdict(treg.get_shape(name)) == \
            dataclasses.asdict(jreg.get_shape(name))
        assert treg.get_shape(name).is_train == jreg.get_shape(name).is_train
    for cfg in treg.ARCHS.values():
        assert tbase.long_context_ok(cfg) == jbase.long_context_ok(
            jreg.ARCHS[cfg.name])
    assert dataclasses.asdict(treg.NERF) == dataclasses.asdict(jreg.NERF)
    assert [tbase.round_up(x, 16) for x in (1, 16, 49155)] == \
        [jbase.round_up(x, 16) for x in (1, 16, 49155)]
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("gpt-5")


def _rules(mod, shape):
    return mod.AxisRules(mesh=FakeMesh(shape),
                         param_rules=dict(mod.DEFAULT_PARAM_RULES),
                         act_rules=dict(mod.DEFAULT_ACT_RULES))


# tests/test_sharding.py:31-65, plus the act rules and a pod axis
SPEC_CASES = [
    ((5120, 40, 128), ("embed", "heads", "head_dim"), "param"),
    ((6144, 48, 128), ("embed", "heads", "head_dim"), "param"),
    ((256, 7168, 2048), ("experts", "embed", "mlp"), "param"),
    ((8, 6144, 32768), ("experts", "embed", "mlp"), "param"),
    ((4, 128, 8, 4, 64), ("batch", "seq_model", "kv_heads", "heads",
                          "head_dim"), "act"),
    ((32, 4096, 49168), ("batch", "seq", "vocab"), "act"),
    ((16, 16), (None, "mlp"), "act"),
]


@pytest.mark.parametrize("mesh_shape", [
    {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
    {"data": 1, "model": 1}])
@pytest.mark.parametrize("shape,logical,which", SPEC_CASES)
def test_resolve_spec_matches_reference(mesh_shape, shape, logical, which):
    jr = jsh.make_rules(FakeMesh(mesh_shape))
    tr = tsh.make_rules(FakeMesh(mesh_shape))
    assert tr.param_rules == jr.param_rules and tr.act_rules == jr.act_rules
    rules = "param_rules" if which == "param" else "act_rules"
    want = jsh.resolve_spec(shape, logical, getattr(jr, rules), jr)
    got = tsh.resolve_spec(shape, logical, getattr(tr, rules), tr)
    assert isinstance(got, tuple) and got == tuple(want)


def test_sharding_cases_of_the_reference_tests():
    """The literal expectations of tests/test_sharding.py, on the port."""
    ar = _rules(tsh, {"data": 16, "model": 16})
    pr = ar.param_rules
    assert tsh.resolve_spec((5120, 40, 128), ("embed", "heads", "head_dim"),
                            pr, ar) == tuple(P("data", None, None))
    assert tsh.resolve_spec((256, 7168, 2048), ("experts", "embed", "mlp"),
                            pr, ar) == tuple(P("model", "data", None))
    assert tsh.resolve_spec((8, 6144, 32768), ("experts", "embed", "mlp"),
                            pr, ar) == tuple(P(None, "data", "model"))
    for cfg in treg.ARCHS.values():
        assert tsh.resolve_spec((cfg.vocab_padded, cfg.d_model),
                                ("vocab", "embed"), pr, ar) == \
            ("model", "data"), cfg.name
        assert tattn.heads_shardable(cfg) == jattn.heads_shardable(
            jreg.ARCHS[cfg.name])
        assert tattn.heads_shardable(cfg, 8) == jattn.heads_shardable(
            jreg.ARCHS[cfg.name], 8)
    assert ar.axis_size(("data", "model")) == 256


def test_rules_context_and_one_device_shard_act():
    rules = tsh.make_rules(tmesh.make_host_mesh("cpu"))
    x = torch.zeros(2, 3)
    assert tsh.current_rules() is None
    assert tsh.shard_act(x, "batch") is x          # no rules: no check
    with tsh.use_rules(rules) as r:
        assert tsh.current_rules() is r is rules
        assert tsh.shard_act(x, "batch", None) is x
        with pytest.raises(ValueError, match="logical"):
            tsh.shard_act(x, "batch")
    assert tsh.current_rules() is None
    with tsh.use_rules(_rules(tsh, {"data": 16, "model": 16})):
        # a mesh of several ranks that carries a shape only cannot place
        with pytest.raises(ValueError, match="shape only"):
            tsh.shard_act(x, "batch", None)


@pytest.mark.parametrize("small", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serve_cache_spec_matches_reference(name, small):
    """Every family's cache tree (K/V, MLA latents, RWKV and Mamba states,
    cross K/V at the true encoder length, zamba2's window past 131,072
    positions) at the reference's shapes, dtypes and logical axes."""
    j, t = _pair(name, small)
    for B, S in ((2, 16), (128, 32_768), (1, 524_288)):
        for enc_len in (0, 24):
            assert_same_cache_spec(j, t, B, S, enc_len=enc_len)
        got, _ = ttf.serve_cache_spec(t, B, S)
        assert got["memory"] is None


def _spec_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_spec_matches_the_references_cache_sharding(name):
    """`steps.cache_spec` against the reference's `cache_sharding` on its
    host mesh (one CPU device), and against `resolve_spec` over the
    reference's logical tree on a 16 x 16 mesh, leaf for leaf."""
    j, t = _pair(name, True)
    want_shapes, want_sh = jsteps.cache_sharding(
        j, 2, 16, jsh.make_rules(jmesh.make_host_mesh()))
    got_shapes, got_sh = tsteps.cache_spec(
        t, 2, 16, tsh.make_rules(tmesh.make_host_mesh("cpu")))
    assert [tuple(s.spec) for s in jax.tree.leaves(want_sh)] == \
        _spec_leaves(got_sh)
    assert [tuple(s.shape) for s in jax.tree.leaves(want_shapes)] == \
        [s.shape for s in jax.tree.leaves(
            got_shapes, is_leaf=lambda x: isinstance(x, tcommon.TensorSpec))]
    big = FakeMesh({"data": 16, "model": 16})
    jr, tr = jsh.make_rules(big), tsh.make_rules(big)
    full_j, full_t = _pair(name, False)
    shapes, logical = jtf.serve_cache_spec(full_j, 128, 32_768)
    _, got = tsteps.cache_spec(full_t, 128, 32_768, tr)
    want = jax.tree.map(lambda s, log: tuple(jsh.resolve_spec(
        s.shape, log_parse(log), jr.act_rules, jr)), shapes, logical)
    assert _spec_leaves(want) == _spec_leaves(got)


def test_host_mesh_is_one_device():
    m = tmesh.make_host_mesh("cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert m.axis_names == ("data", "model")
    assert tsh.mesh_size(m) == 1
    assert len(jax.devices()) == 1                  # the reference's, here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_host_mesh()                  # None: the card
