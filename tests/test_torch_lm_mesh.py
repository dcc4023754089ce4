"""The port's language models across ranks against the reference's
single-device results: on CPU worlds of 2 x 2, 1 x 2 and 2 x 1 gloo
ranks (the square through `make_mesh_from`'s live mesh, the (world, 1)
through the launcher's `make_host_mesh`), reduced llama3.2-1b,
granite-34b, qwen1.5-32b, deepseek-v3 (MLA, bitmap dispatch) and grok-1
(COO dispatch) run `model_loss`, prefill, teacher-forced decode steps
and `serve_lm` with each param, batch and cache placed by its resolved
spec.

Tolerances: float32 logits and losses within 1e-4 of the reference's
jitted single-device run, greedy tokens exactly; bf16 losses within the
reference's own 5e-2 (`tests/test_sharding.py:126`), and bf16 logits no
farther from the float32 logits of the same (bf16-rounded) params than
the port's one-rank bf16 logits are, x1.25 in max and in mean. Each
rank's local shard of every param and cache has the shape that the
reference's `param_sharding` / `cache_sharding` give on a shape-only
mesh of the same axes, in storage of its own size. MoE runs at capacity
E / top_k: random weights overflow the published 1.25.

The params cross as float32 numpy: for llama3.2-1b the reference
test's own case, its PRNGKey(0) params unperturbed and the `TokenStream`
batch of (4, 16); for the others the port's seeded init (the
reference's tree, shapes and fan-in scales), constant leaves moved as
`_lm_parity.family_params` moves them, with the reference's
`TokenStream` batch. That reference test
(`tests/test_sharding.py::test_multidevice_train_step_matches_single`)
fails here under jax 0.9 (ROADMAP.md Queue 3 item 27); the last test
pins how. The reference on a mesh cannot run here, so its single-device
results are the oracle: they are what GSPMD must compute.

Each world is spawned once (`_torch_mesh_ranks.lm_job`) while this
process computes the reference's results (`run_worlds`, which
`tests/test_torch_lm_mesh_trunks.py` runs for the enc-dec, hybrid and
RWKV trunks, with their train steps). Every world also builds a train
step for reduced rwkv6-1.6b: it must build on the mesh."""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from _lm_parity import perturb_constants, train_batch
from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as tcommon
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as ttf

ARCHS = ("llama3.2-1b", "granite-34b", "qwen1.5-32b", "deepseek-v3-671b",
         "grok-1-314b")
WORLDS = {"2x2": (2, 2), "1x2": (1, 2), "2x1": (2, 1)}
DTYPES = ("float32", "bfloat16")
B, P, N_DECODE = 4, 16, 4        # the prompt is the loss batch's tokens
F32_TOL = 1e-4
BF16_LOSS_TOL = 5e-2
BF16_NOISE_RATIO = 1.25


def _cfgs(name):
    """(reference, port) reduced configs; MoE at capacity E / top_k."""
    j, t = jreg.reduced(jreg.ARCHS[name]), treg.reduced(treg.ARCHS[name])
    if j.is_moe:
        cap = j.n_experts / j.top_k
        j = dataclasses.replace(j, capacity_factor=cap)
        t = dataclasses.replace(t, capacity_factor=cap)
    return j, t


def _params(name, jcfg, tcfg):
    """Float32 numpy params: the reference test's own for llama3.2-1b (its
    PRNGKey(0) init, jitted: eager it takes seconds); for the rest the
    port's init from a seeded generator (the reference's tree, shapes and
    fan-in scales; its own eager init takes seconds an arch), with the
    constant leaves moved as `family_params` moves them (seed: the name's
    length)."""
    if name == "llama3.2-1b":
        params = jax.jit(lambda k: jcommon.split_pl(jtf.init_model(
            jcfg, k))[0])(jax.random.PRNGKey(0))
        return jax.tree.map(lambda a: np.array(a, np.float32), params)
    params, _ = tcommon.split_pl(ttf.init_model(
        tcfg, torch.Generator().manual_seed(len(name)), dtype=torch.float32,
        device="cpu"))
    return perturb_constants(tcommon.tree_map(lambda t: t.numpy(), params),
                             len(name))


def _bf16_rounded(tree):
    return jax.tree.map(lambda a: np.array(jnp.asarray(a).astype(
        jnp.bfloat16).astype(jnp.float32)), tree)


def _case(name):
    """The arch's params, prompt (the loss batch's tokens, and an enc-dec
    arch's encoder frames: its bf16 frames as float32, exact), decode
    tokens and loss batch."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.RandomState(len(name) + 100)
    loss_batch = {k: np.array(v.astype(jnp.float32) if v.dtype
                              == jnp.bfloat16 else v)
                  for k, v in train_batch(jcfg, B, P).items()}
    case = {"params": _params(name, jcfg, tcfg), "dtypes": DTYPES,
            "tokens": loss_batch["tokens"].astype(np.int32),
            "decode_tokens": rng.randint(0, jcfg.vocab, (B, N_DECODE))
            .astype(np.int32),
            "loss_batch": loss_batch,
            "capacity_factor": jcfg.capacity_factor}
    if jcfg.enc_dec:
        case["enc_frames"] = loss_batch["enc_frames"]
    return case


def _enc_len(case) -> int:
    """The encoder memory's length (0: not an enc-dec arch)."""
    return case["enc_frames"].shape[1] if "enc_frames" in case else 0


def _prompt(case, to):
    """The prefill batch: tokens, and the encoder frames in bf16."""
    batch = {"tokens": to(case["tokens"])}
    if "enc_frames" in case:
        batch["enc_frames"] = to(case["enc_frames"])
    return batch


def _eager(jcfg):
    """The reference's enc-dec runs op by op: jitted, its encoder scan
    refuses the float32 carry that its bf16 frames promote to (ROADMAP.md
    Queue 3 item 18)."""
    return jax.disable_jit() if jcfg.enc_dec else contextlib.nullcontext()


def _jitted(jcfg):
    """The reference's jitted prefill, decode (horizon P + N_DECODE) and
    loss of `jcfg`, compiled once for each dtype they see (run under
    `_eager`)."""
    return (jax.jit(lambda p, b: jtf.model_prefill(p, jcfg, b)),
            jax.jit(lambda p, t, pos, c: jtf.model_decode(
                p, jcfg, t, pos, c, seq_len=P + N_DECODE)),
            jax.jit(lambda p, b: jtf.model_loss(p, jcfg, b)))


def _reference_f32(jcfg, fns, params, case):
    """The reference's single-device run on float32 `params` (jitted;
    the enc-dec op by op): prefill's last logits, the teacher-forced
    decode logits over a cache padded to P + N_DECODE, the greedy tokens
    of its launcher's loop on the same horizon (`serve_lm`: the prompt's
    argmax, then N_DECODE - 1 greedy steps), and `model_loss`."""
    with _eager(jcfg):
        return _reference_f32_run(jcfg, fns, params, case)


def _reference_f32_run(jcfg, fns, params, case):
    prefill, decode, loss_fn = fns
    jp = jax.tree.map(jnp.asarray, params)
    shapes, _ = jtf.serve_cache_spec(jcfg, B, P + N_DECODE,
                                     enc_len=_enc_len(case))

    def grown(cache):
        return jax.tree.map(lambda c, s: jnp.pad(c, [
            (0, a - b) for a, b in zip(s.shape, c.shape)]), cache, shapes)

    logits, cache0 = prefill(jp, _prompt(case, jnp.asarray))
    out = {"prefill": np.asarray(logits, np.float32), "decode": []}
    cache = grown(cache0)
    for i in range(N_DECODE):
        lg, cache = decode(jp, jnp.asarray(case["decode_tokens"][:, i:i + 1]),
                           jnp.int32(P + i), cache)
        out["decode"].append(np.asarray(lg, np.float32))
    cache = grown(cache0)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, out["greedy_logits"] = [tok], [out["prefill"]]
    for i in range(N_DECODE - 1):
        lg, cache = decode(jp, tok, jnp.int32(P + i), cache)
        out["greedy_logits"].append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(tok)
    out["greedy"] = np.asarray(jnp.concatenate(toks, axis=1))
    batch = {k: jnp.asarray(v) for k, v in case["loss_batch"].items()}
    loss, metrics = loss_fn(jp, batch)
    out["loss"] = float(loss)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    return out


def _port_one_rank_bf16(tcfg, params, case):
    """The port's one-rank bf16 prefill and teacher-forced decode logits
    (no rules), the baseline of the bf16 noise rule."""
    tp = ttf.params_from_numpy(params, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        logits, cache = ttf.model_prefill(tp, tcfg,
                                          _prompt(case, torch.from_numpy))
        out = {"prefill": logits.float().numpy(), "decode": []}
        cache = ttf.grow_cache(cache, ttf.serve_cache_spec(
            tcfg, B, P + N_DECODE, enc_len=_enc_len(case))[0])
        for i in range(N_DECODE):
            lg, cache = ttf.model_decode(
                tp, tcfg, torch.from_numpy(case["decode_tokens"][:, i:i + 1]),
                P + i, cache, seq_len=P + N_DECODE)
            out["decode"].append(lg.float().numpy())
    return out


def _reference_bf16_loss(jcfg, fns, params, case):
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    batch = {k: jnp.asarray(v) for k, v in case["loss_batch"].items()}
    with _eager(jcfg):
        return float(fns[2](jp, batch)[0])


class _Sharding:
    """Stands in for NamedSharding on a mesh that has no devices here."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def _want_shapes(jcfg, shape, enc_len=0):
    """The reference's param and cache specs on a shape-only mesh of
    `shape`, as {path: (global shape, local shape)}; an enc-dec arch's
    cache at the encoder memory's length `enc_len` (its `cache_sharding`
    specs, on `serve_cache_spec`'s shapes at that length)."""
    fake = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsharding, jsteps):
            mp.setattr(mod, "NamedSharding", _Sharding)
        rules = jsharding.make_rules(fake)
        sds, logical = jsteps.abstract_params(jcfg)
        p_sh = jsharding.param_sharding(sds, logical, rules)
        _, c_sh = jsteps.cache_sharding(jcfg, B, P + N_DECODE, rules)
        c_shapes, _ = jtf.serve_cache_spec(jcfg, B, P + N_DECODE,
                                           enc_len=enc_len)
    out = {}
    for tag, specs, sh in (("params", sds, p_sh), ("cache", c_shapes, c_sh)):
        leaves = jax.tree_util.tree_flatten_with_path(specs)[0]
        shard = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(
            x, _Sharding))
        for (path, s), spec in zip(leaves, shard):
            local = []
            for n, e in zip(s.shape, spec.spec + (None,) * len(s.shape)):
                axes = () if e is None else (e,) if isinstance(e, str) else e
                k = int(np.prod([shape[a] for a in axes]))
                local.append(n // k)
            out[tag + jax.tree_util.keystr(path)] = (tuple(s.shape),
                                                     tuple(local))
    return out


def _flat(tag, tree):
    """{path: leaf} of the ranks' nested-dict trees, keyed as
    `_want_shapes` keys the reference's."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}['{k}']", v)
        elif t is not None:
            out[prefix] = t
    walk(tag, tree)
    return out


REFERENCE_TEST = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, {src!r})
    import jax
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import ARCHS, reduced
    from repro.data.tokens import TokenStream
    from repro.launch.steps import batch_sharding
    from repro.models import transformer as tf
    from repro.models.common import split_pl
    from repro.models.sharding import make_rules, param_sharding, use_rules
    cfg = reduced(ARCHS["llama3.2-1b"])
    shape = ShapeConfig("t", 16, 4, "train")
    params, logical = split_pl(tf.init_model(cfg, jax.random.PRNGKey(0)))
    batch = TokenStream(cfg, shape).batch(0)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    rules = make_rules(mesh)
    p_sh = param_sharding(params, logical, rules)
    _, b_sh = batch_sharding(cfg, shape, rules)
    pp = jax.device_put(params, p_sh)
    bb = jax.device_put(batch, b_sh)
    print("PLACED", pp["embed"].sharding.spec, bb["tokens"].sharding.spec,
          flush=True)

    def f(p, b):
        with use_rules(rules):
            return tf.model_loss(p, cfg, b)
    try:
        jax.jit(f, in_shardings=(p_sh, b_sh))(pp, bb)
    except Exception as e:
        print("RAISED", type(e).__name__, str(e).splitlines()[0])
""")


def _reference(name, case):
    """Everything the tests hold the ranks of one arch against."""
    jcfg, tcfg = _cfgs(name)
    fns = _jitted(jcfg)
    return {"float32": _reference_f32(jcfg, fns, case["params"], case),
            "truth": _reference_f32(jcfg, fns, _bf16_rounded(case["params"]),
                                    case),
            "one_rank_bf16": _port_one_rank_bf16(tcfg, case["params"], case),
            "bf16_loss": _reference_bf16_loss(jcfg, fns, case["params"],
                                              case),
            "shapes": {k: _want_shapes(jcfg, dict(zip(("data", "model"), s)),
                                       _enc_len(case))
                       for k, s in WORLDS.items()}}


def _one_process(name, case) -> str:
    """What float32 `serve_lm` prints in one process."""
    args = tserve.build_parser().parse_args(
        ["--arch", name, "--device", "cpu", "--batch", str(B),
         "--prompt-len", str(P), "--gen", str(N_DECODE)])
    frames = case.get("enc_frames")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.serve_lm(args, params=ttf.params_from_numpy(
            case["params"], device="cpu", dtype=torch.float32),
            tokens=torch.from_numpy(case["tokens"]),
            enc_frames=None if frames is None else torch.from_numpy(
                frames).to(torch.bfloat16), cfg=_cfgs(name)[1])
    return buf.getvalue()


def run_worlds(tmp, archs, during=None, train=None):
    """Start every world on `archs` (and, with `train`, the train cases
    `train(world)` after the serving runs: `_torch_mesh_ranks.train_cases`
    on the archs' params and loss batches), compute the reference's
    results (and call `during(cases)`, whose result is kept under
    "during") while they run, then collect the ranks."""
    cases = {name: _case(name) for name in archs}
    started = {}
    for key, shape in WORLDS.items():
        wdir = tmp / key
        wdir.mkdir()
        started[key] = ranks.start(ranks.lm_job, shape[0] * shape[1], wdir,
                                   {"mesh": shape, "B": B, "P": P,
                                    "n_decode": N_DECODE, "gen": N_DECODE,
                                    "archs": cases,
                                    "train": train(key) if train else {}})
    try:
        want = {name: _reference(name, cases[name]) for name in archs}
        one = {name: _one_process(name, cases[name]) for name in archs}
        extra = during(cases) if during is not None else None
    finally:
        out = {k: ranks.join(s, timeout_s=400.0) for k, s in started.items()}
    return {"ranks": out, "want": want, "one_process": one,
            "during": extra}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world runs while this process computes the reference's
    results (and runs the reference test's body on 8 virtual devices)."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    sub = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_TEST.format(
            src=os.path.abspath(src))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        out = run_worlds(tmp, ARCHS)
    finally:
        try:
            ref_out, ref_err = sub.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            sub.kill()
            ref_out, ref_err = sub.communicate()
    out["reference_test"] = (sub.returncode, ref_out, ref_err)
    return out


CASES = [(w, n) for w in WORLDS for n in ARCHS]
IDS = [f"{w}-{n}" for w, n in CASES]


def _results(worlds, world, name, dtype):
    return [r["archs"][f"{name}/{dtype}"] for r in worlds["ranks"][world]]


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_float32_matches_the_reference(worlds, world, name):
    """Prefill's last logits, each teacher-forced decode step's logits and
    `model_loss` (with its metrics) within 1e-4 of the reference's
    single-device run, on every rank."""
    want = worlds["want"][name]["float32"]
    for got in _results(worlds, world, name, "float32"):
        np.testing.assert_allclose(got["prefill"], want["prefill"],
                                   rtol=F32_TOL, atol=F32_TOL)
        assert len(got["decode"]) == N_DECODE
        for g, w in zip(got["decode"], want["decode"]):
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        assert set(got["metrics"]) == set(want["metrics"])
        for k, w in want["metrics"].items():
            assert abs(got["metrics"][k] - w) <= F32_TOL * max(1, abs(w)), k
        assert got["loss"] == got["metrics"]["loss"]


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_serve_lm_gives_the_references_greedy_tokens(worlds, world, name):
    """`serve_lm` on the world's mesh, float32: the reference launcher
    loop's greedy tokens exactly on every rank, the logits each was read
    from (`logits_out`) within 1e-4, and rank 0 prints the sample line
    that one process prints."""
    ref = worlds["want"][name]["float32"]
    want = ref["greedy"]
    one = worlds["one_process"][name]
    sample = [line for line in one.splitlines() if line.startswith("sample")]
    assert sample == [f"sample: {want[0, :12].tolist()}"]
    for got in _results(worlds, world, name, "float32"):
        np.testing.assert_array_equal(got["serve"], want)
        assert len(got["serve_logits"]) == N_DECODE
        for g, w in zip(got["serve_logits"], ref["greedy_logits"]):
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        assert sample[0] in got["serve_out"].splitlines()
        assert "[serve] mesh: " in got["serve_out"]


def _noise(got, want, truth):
    e_got, e_want = np.abs(got - truth), np.abs(want - truth)
    return ((float(e_got.max()), float(e_got.mean())),
            (float(e_want.max()), float(e_want.mean())))


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_bf16_within_the_noise_of_one_rank(worlds, world, name):
    """bf16: the loss within 5e-2 of the reference's; prefill and each
    decode step's logits no farther from the float32 logits of the same
    params than the port's one-rank bf16 logits, x1.25 in max and mean
    (split reductions sum partial products in bf16)."""
    w = worlds["want"][name]
    one, truth = w["one_rank_bf16"], w["truth"]
    for got in _results(worlds, world, name, "bfloat16"):
        assert abs(got["loss"] - w["bf16_loss"]) < BF16_LOSS_TOL
        pairs = [(got["prefill"], one["prefill"], truth["prefill"])] + list(
            zip(got["decode"], one["decode"], truth["decode"]))
        for g, o, t in pairs:
            assert np.isfinite(g).all()
            (g_max, g_mean), (o_max, o_mean) = _noise(g, o, t)
            assert g_max <= BF16_NOISE_RATIO * o_max, (g_max, o_max)
            assert g_mean <= BF16_NOISE_RATIO * o_mean, (g_mean, o_mean)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_local_shards_have_the_resolved_shapes(worlds, world, name):
    """Each rank's local shard of every param (after `place_params`) and
    of every cache leaf (after the decode steps) has the shape that the
    reference's `param_sharding` / `cache_sharding` resolve on a
    shape-only mesh of the world's axes, in storage of its own size: no
    rank holds a whole copy of a sharded leaf. Rule (b) leaves some dims
    whole on some meshes; every world shards some leaf."""
    want = worlds["want"][name]["shapes"][world]
    for dtype in DTYPES:
        for got in _results(worlds, world, name, dtype):
            flat = {**_flat("params", got["params"]),
                    **_flat("cache", got["cache"])}
            assert set(flat) == set(want)
            for path, (shape, local, nbytes) in flat.items():
                assert (shape, local) == want[path], path
                size = torch.empty((), dtype=getattr(torch, dtype)
                                   ).element_size()
                assert nbytes <= int(np.prod(local)) * max(size, 4), path
            assert any(w[0] != w[1] for w in want.values())


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_init_model_places_each_leaf_as_it_is_drawn(worlds, world, name):
    """`init_model(rules=)` on every rank: each leaf a DTensor with the
    placements and the local shard that `place_params` gives the whole
    tree drawn from the same seed (the stacked layers too, stacked shard
    by shard)."""
    for r in worlds["ranks"][world]:
        leaves, differ, plain = r["drawn"][name]
        assert leaves > 5
        assert not plain and not differ, (plain, differ)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_collectives_are_gloos_own(worlds, world, name):
    """Prefill and a decode step issue their collectives through
    `sharding.redistribute` (gloo's all-gather and all-reduce), never
    through the functional collectives DTensor issues inside an op: over
    gloo on CUDA tensors those read device memory as host memory."""
    for dtype in DTYPES:
        for got in _results(worlds, world, name, dtype):
            assert not [k for k in got["collectives"]
                        if k.startswith("_c10d_functional::")], got[
                            "collectives"]
            assert any(k.startswith("gloo:") for k in got["collectives"])


def test_worlds_are_the_meshes_asked_for(worlds):
    for key, (data, model) in WORLDS.items():
        for r in worlds["ranks"][key]:
            assert r["mesh"] == {"data": data, "model": model}


def test_launcher_refuses_fleet_workers_under_torchrun_naming_item_10g(
        monkeypatch, capsys):
    """Under a torchrun environment the serving launcher refuses
    `--fleet-workers` before it starts a rank, naming ROADMAP.md Queue 1
    item 10g (fleet workers each on their own card)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "rtnerf", "--fleet-workers", "2"])
    assert e.value.code == 2
    assert "Queue 1 item 10g" in capsys.readouterr().err


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_builds_on_several_ranks_for_rwkv6(worlds, world):
    """`build_train_step` for reduced rwkv6-1.6b builds on a mesh of
    several ranks, on every rank: every trunk trains across ranks (the
    dense and MoE trunks: `tests/test_torch_lm_mesh_train.py`; the
    enc-dec, hybrid and RWKV6 trunks:
    `tests/test_torch_lm_mesh_trunks.py`)."""
    for r in worlds["ranks"][world]:
        assert r["train_step"] is True


def test_shard_act_keeps_a_free_dims_placement():
    """`shard_act`'s placements: a named dim takes its axis; an axis the
    spec does not name keeps a shard of an UNCONSTRAINED dim (GSPMD lets
    it propagate), and replicates a dim the spec pins to None or a
    partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = tmesh.HostMesh({"data": 2, "model": 2}, ("data", "model"), None)
    U = tsharding.UNCONSTRAINED
    x = types.SimpleNamespace(placements=(Shard(1), Shard(2)))
    assert tsharding._act_placements(x, ("data", U, None), mesh) == (
        Shard(0), Replicate())
    assert tsharding._act_placements(x, (None, U, "model"), mesh) == (
        Shard(1), Shard(2))
    assert tsharding._act_placements(x, (None, None, U), mesh) == (
        Replicate(), Shard(2))
    x = types.SimpleNamespace(placements=(Partial(), Shard(0)))
    assert tsharding._act_placements(x, (U, None, U), mesh) == (
        Replicate(), Shard(0))


def test_reference_multidevice_test_fails_at_its_embedding_here(worlds):
    """Pins ROADMAP.md Queue 3 item 27: the body of the reference's
    `test_multidevice_train_step_matches_single` places params and batch
    on its (2, 2) mesh, then under jax 0.9 its jitted `model_loss` raises
    a ShardingTypeError at `_embed`'s `jnp.take` of the vocab- and
    FSDP-sharded table by the batch-sharded tokens."""
    rc, out, err = worlds["reference_test"]
    assert rc == 0, err
    assert "PLACED PartitionSpec('model', 'data') PartitionSpec('data'," in out
    assert "RAISED ShardingTypeError" in out
    assert "gather" in out and "out_sharding" in out
