"""Gradients through the port's mesh primitives against the same
functions' gradients in one process: on CPU worlds of 1 x 2, 2 x 1 and
2 x 2 gloo ranks (each spawned once, `_torch_mesh_ranks.mesh_grads_job`),

- `sharding.redistribute` from every input placement (Shard(0),
  Shard(1), Replicate or Partial on each mesh dim; a Partial input made
  by `from_local_like` from one piece a rank) to every output placement
  it may take, a tensor of (4, 6) (Shard(1) on 2 x 2 leaves an empty
  piece);
- `sharding.contract` for the trunk's equations (MLP, GQA, MLA, the
  logits, the MTP projection), each operand placed by its logical axes;
- `sharding.pick_last`, `transformer._embed_shards` with and without the
  tied head, `attention._attn_shards` with the query rows split over
  "model", and the MoE `_Shards` combine and load-balance aux through
  both dispatches.

Each loss is sum(whole(y) * w) for fixed random w (plus the MoE aux
times 0.5), so that every input gets a gradient; the gradients, made
whole, are held within 1e-6 of the one-process gradients (relative, and
absolute times the largest, in float32). Each case also fails on any
`_c10d_functional::` op under the profiler: every byte moves through
gloo's own collectives."""
import itertools

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.models.common import Maker, split_pl, tree_map

WORLDS = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
TOL = 1e-6
CODES = ("S0", "S1", "R", "P")
B, S, D, F, K, G, H, V, R = 4, 8, 16, 32, 4, 2, 8, 64, 8
ACT = ("batch", "seq", None)
EQS = {
    "mlp_up": ("bsd,df->bsf", [ACT, ("embed", "mlp")], [(B, S, D), (D, F)]),
    "mlp_down": ("bsf,fd->bsd", [("batch", "seq", "mlp"), ("mlp", "embed")],
                 [(B, S, F), (F, D)]),
    "gqa_q": ("bsd,dkgh->bskgh",
              [ACT, ("embed", "kv_heads", "heads", "head_dim")],
              [(B, S, D), (D, K, G, H)]),
    "gqa_kv": ("bsd,dkh->bskh", [ACT, ("embed", "kv_heads", "head_dim")],
               [(B, S, D), (D, K, H)]),
    "gqa_o": ("bskgh,kghd->bsd",
              [("batch", "seq", "kv_heads", "heads", "head_dim"),
               ("kv_heads", "heads", "head_dim", "embed")],
              [(B, S, K, G, H), (K, G, H, D)]),
    "logits": ("bsd,dv->bsv", [ACT, ("embed", "vocab")], [(B, S, D), (D, V)]),
    "mtp_proj": ("bsd,de->bse", [ACT, ("embed", "embed")],
                 [(B, S, 2 * D), (2 * D, D)]),
    "mla_down": ("bsd,dr->bsr", [ACT, ("embed", "q_lora")],
                 [(B, S, D), (D, R)]),
    "mla_up": ("bsr,rhe->bshe", [ACT, ("q_lora", "heads", "head_dim")],
               [(B, S, R), (R, K, H)]),
    "mla_o": ("bshv,hvd->bsd", [("batch", "seq", "heads", None),
                                ("heads", "head_dim", "embed")],
              [(B, S, K, H), (K, H, D)]),
}
MOE = {"grok-1-314b": "coo", "deepseek-v3-671b": "bitmap"}


def _rand(rng, shape):
    return (0.5 * rng.randn(*shape)).astype(np.float32)


def _pouts(pin):
    """Every placement `redistribute` may move `pin` to: a Partial mesh
    dim may stay partial, the others may not become one."""
    return [p for p in itertools.product(
        *[CODES if c == "P" else CODES[:3] for c in pin])]


def _cases(world):
    shape = WORLDS[world]
    rng = np.random.RandomState(sum(shape) * 7 + shape[0])
    cases = {}
    for pin in itertools.product(CODES, repeat=2):
        n = [shape[i] if c == "P" else 1 for i, c in enumerate(pin)]
        cases["redistribute/" + "_".join(pin)] = {
            "kind": "redistribute", "pin": pin, "pouts": _pouts(pin),
            "pieces": _rand(rng, n + [4, 6]), "w": _rand(rng, (4, 6))}
    for name, (eq, logical, shapes) in EQS.items():
        out = eq.split("->")[1]
        size = {c: n for letters, s in zip(eq.split("->")[0].split(","),
                                           shapes) for c, n in zip(letters, s)}
        cases["contract/" + name] = {
            "kind": "contract", "eq": eq, "logical": logical,
            "param": [False, True], "ops": [_rand(rng, s) for s in shapes],
            "w": _rand(rng, tuple(size[c] for c in out))}
    cases["pick_last"] = {"kind": "pick_last", "x": _rand(rng, (B, S, V)),
                          "idx": rng.randint(0, V, (B, S)).astype(np.int32),
                          "w": _rand(rng, (B, S))}
    for tied in (False, True):
        cases[f"embed/{'tied' if tied else 'untied'}"] = {
            "kind": "embed", "tied": tied, "table": _rand(rng, (V, D)),
            "tokens": rng.randint(0, V, (B, S)).astype(np.int32),
            "w": _rand(rng, (B, S, D)), "w2": _rand(rng, (B, S, V))}
    cases["attn_rows_split"] = {
        "kind": "attn", "q": _rand(rng, (B, S, K, G, H)),
        "k": _rand(rng, (B, S, K, H)), "v": _rand(rng, (B, S, K, H)),
        "w": _rand(rng, (B, S, K, G, H))}
    for arch, dispatch in MOE.items():
        cfg = treg.reduced(treg.ARCHS[arch])
        params, logical = split_pl(tmoe.init_moe(Maker(
            torch.Generator().manual_seed(len(arch)), dtype=torch.float32),
            cfg))
        cases[f"moe/{dispatch}"] = {
            "kind": "moe", "arch": arch, "dispatch": dispatch,
            "capacity": cfg.n_experts / cfg.top_k,
            "params": tree_map(lambda t: t.numpy(), params),
            "logical": logical, "x": _rand(rng, (B, S, cfg.d_model)),
            "w": _rand(rng, (B, S, cfg.d_model)), "aux_weight": 0.5}
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world runs while this process computes the one-process
    gradients of the same cases."""
    tmp = tmp_path_factory.mktemp("mesh_grads")
    cases = {w: _cases(w) for w in WORLDS}
    started = {}
    for key, shape in WORLDS.items():
        wdir = tmp / key
        wdir.mkdir()
        started[key] = ranks.start(ranks.mesh_grads_job, shape[0] * shape[1],
                                   wdir, {"mesh": shape, "cases": cases[key]})
    try:
        want = {w: ranks.grad_cases(cases[w], None) for w in WORLDS}
    finally:
        out = {k: ranks.join(s, timeout_s=300.0) for k, s in started.items()}
    return {"ranks": out, "want": want}


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _check(runs, world, key):
    """Every rank's gradients of case `key` against one process's, and no
    functional collective."""
    want, _ = runs["want"][world][key]
    for rank, r in enumerate(runs["ranks"][world]):
        got, keys = r["cases"][key]
        assert not [k for k in keys if k.startswith("_c10d_functional::")], \
            keys
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            if key.startswith("redistribute/"):
                # this rank's piece and its slice of it
                idx, sl, g = g
                w = w[idx][tuple(slice(a, b) for a, b in sl)]
            _close(g, w, f"{key} {name} rank {rank}")
    return want


PINS = ["_".join(p) for p in itertools.product(CODES, repeat=2)]


@pytest.mark.parametrize("world,pin", [(w, p) for w in WORLDS for p in PINS],
                         ids=[f"{w}-{p}" for w in WORLDS for p in PINS])
def test_redistribute_transposes(runs, world, pin):
    """Each output placement's backward gives every rank the gradient of
    the piece it held: the whole gradient of the sum for a partial
    input, its shard's for a split one."""
    want = _check(runs, world, f"redistribute/{pin}")
    assert len(want) == len(_pouts(tuple(pin.split("_"))))


@pytest.mark.parametrize("world,eq", [(w, e) for w in WORLDS for e in EQS],
                         ids=[f"{w}-{e}" for w in WORLDS for e in EQS])
def test_contract_gradients(runs, world, eq):
    _check(runs, world, f"contract/{eq}")


@pytest.mark.parametrize("world", WORLDS)
def test_pick_last_gradient_lands_on_the_labels_rank(runs, world):
    _check(runs, world, "pick_last")


@pytest.mark.parametrize("world,tied", [(w, t) for w in WORLDS
                                        for t in ("untied", "tied")],
                         ids=[f"{w}-{t}" for w in WORLDS
                              for t in ("untied", "tied")])
def test_embedding_gradient(runs, world, tied):
    """The table's gradient from the lookup (each token into its rank's
    rows) and, tied, from the head too: both into the one leaf."""
    _check(runs, world, f"embed/{tied}")


@pytest.mark.parametrize("world", WORLDS)
def test_attention_with_query_rows_split(runs, world):
    """q split by rows over "model", k and v whole along the rows: their
    gradients are summed over the rows' ranks."""
    _check(runs, world, "attn_rows_split")


@pytest.mark.parametrize("world,dispatch",
                         [(w, d) for w in WORLDS for d in MOE.values()],
                         ids=[f"{w}-{d}" for w in WORLDS
                              for d in MOE.values()])
def test_moe_combine_and_aux(runs, world, dispatch):
    """The experts', router's and input's gradients through the combine
    (a partial sum over the expert axes) and the load-balance aux (its
    statistics counted once over those axes)."""
    want = _check(runs, world, f"moe/{dispatch}")
    assert {"x", "p/router", "p/w1", "p/w2"} <= set(want)
