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
  both dispatches;
- a Mamba2 block (`ssm._Shards`, scan and chunked SSD), the WKV core
  (`rwkv._wkv_shards` with its head leaves) and a whole RWKV6 layer,
  the enc-dec encoder from its bf16 frames (`transformer._encode`), and
  `attention.cross_forward` with the decoder's query rows split over
  "model" (reduced zamba2, rwkv6 and seamless-m4t, float32).

Each loss is sum(whole(y) * w) for fixed random w (plus the MoE aux
times 0.5), so that every input gets a gradient; the gradients, made
whole, are held within 1e-6 of the one-process gradients (relative, and
absolute times the largest, in float32); a whole block's within 1e-5
(`BLOCK_TOL`), and the encoder's first norm gain, differentiated through
the frames' bf16 cast, within one bf16 ulp (ROADMAP.md Queue 3 item
24). Each case also fails on any
`_c10d_functional::` op under the profiler: every byte moves through
gloo's own collectives."""
import itertools

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
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
SSM_IMPLS = ("scan", "chunked")
RWKV_CASES = ("wkv", "rwkv_layer")
M = 12                  # encoder memory rows (cross-attention), != S
# the seamless encoder's first norm gain is differentiated through the
# bf16 frames' cast (ROADMAP.md Queue 3 item 24): the cotangent of its
# bf16 output rounds to bf16, where the last bits of the float32 sums
# before it differ between the mesh and one process
BF16_ULP = 2.0 ** -8
LOOSE = {"encode": {"p/enc/ln1"}}
# a whole block's float32 gradients round more than one primitive's: in one
# process they lie past TOL from the same gradients in float64, within a
# quarter of BLOCK_TOL (`test_block_tolerance_is_float32s_own_rounding`),
# so the mesh is held to BLOCK_TOL there (a partial sum dropped or counted
# twice is off by the order of the gradient itself)
BLOCK_TOL = 1e-5
BLOCKS = ("mamba", "rwkv", "encode", "cross")


def _rand(rng, shape):
    return (0.5 * rng.randn(*shape)).astype(np.float32)


def _pouts(pin):
    """Every placement `redistribute` may move `pin` to: a Partial mesh
    dim may stay partial, the others may not become one."""
    return [p for p in itertools.product(
        *[CODES if c == "P" else CODES[:3] for c in pin])]


def _tree_case(rng, kind, arch, init, **arrays):
    """A case of `kind` on the params `init(maker, cfg)` of `arch`'s
    reduced config (float32, seeded by the arch's name, every leaf moved
    by 0.1 N(0, 1) so that constant leaves are exercised) and `arrays`."""
    cfg = treg.reduced(treg.ARCHS[arch])
    params, logical = split_pl(init(Maker(
        torch.Generator().manual_seed(len(arch)), dtype=torch.float32), cfg))
    params = tree_map(lambda t: t.numpy() + _rand(rng, t.shape) / 5, params)
    return {"kind": kind, "arch": arch, "params": params,
            "logical": logical, **arrays}


def _encoder(mk, cfg):
    """The encoder's params of the enc-dec arch (its stack and final
    norm), as `transformer.init_with` draws them."""
    tree = ttf.init_with(mk, cfg)
    return {"enc": tree["enc"], "enc_norm": tree["enc_norm"]}


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
    hybrid = treg.reduced(treg.ARCHS["zamba2-7b"])
    for impl in SSM_IMPLS:
        cases[f"mamba/{impl}"] = _tree_case(
            rng, "mamba", "zamba2-7b", tssm.init_mamba2, impl=impl,
            x=_rand(rng, (B, S, hybrid.d_model)),
            w=_rand(rng, (B, S, hybrid.d_model)))
    rw = treg.reduced(treg.ARCHS["rwkv6-1.6b"])
    heads = (B, S, rw.n_heads, rw.resolved_head_dim)
    cases["rwkv/wkv"] = _tree_case(
        rng, "wkv", "rwkv6-1.6b", lambda mk, cfg: {
            k: v for k, v in trwkv.init_rwkv6(mk, cfg).items()
            if k in ("u", "gn_g", "gn_b")},
        **{n: _rand(rng, heads) for n in "rkvg"},
        decay=rng.uniform(0.5, 0.99, heads).astype(np.float32),
        w=_rand(rng, heads))
    cases["rwkv/rwkv_layer"] = _tree_case(
        rng, "rwkv_layer", "rwkv6-1.6b", trwkv.init_rwkv6,
        x=_rand(rng, (B, S, rw.d_model)), w=_rand(rng, (B, S, rw.d_model)))
    ed = treg.reduced(treg.ARCHS["seamless-m4t-large-v2"])
    cases["encode"] = _tree_case(
        rng, "encode", "seamless-m4t-large-v2", _encoder,
        frames=_rand(rng, (B, M, ed.d_model)) * 2,
        w=_rand(rng, (B, M, ed.d_model)))
    cases["cross"] = _tree_case(
        rng, "cross", "seamless-m4t-large-v2", tattn.init_gqa,
        x=_rand(rng, (B, S, ed.d_model)),
        memory=_rand(rng, (B, M, ed.d_model)),
        w=_rand(rng, (B, S, ed.d_model)))
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


def _close(got, want, what, tol=TOL):
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
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
            tol = (BF16_ULP if name in LOOSE.get(key, ()) else BLOCK_TOL
                   if key.split("/")[0] in BLOCKS else TOL)
            _close(g, w, f"{key} {name} rank {rank}", tol)
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


@pytest.mark.parametrize("world,impl", [(w, i) for w in WORLDS
                                        for i in SSM_IMPLS],
                         ids=[f"{w}-{i}" for w in WORLDS for i in SSM_IMPLS])
def test_mamba2_block_gradients(runs, world, impl):
    """A Mamba2 block (reduced zamba2, scan or chunked SSD): the
    in-projection gathered whole over "model" before its segments, the
    conv on the rank's channels and its output gathered, the per-head
    leaves whole, the gated norm on the rank's columns of the
    out-projection. Every rank's gradient there is a partial sum over
    the norm's column axes and its rows' axes (`_Shards.out`)."""
    want = _check(runs, world, f"mamba/{impl}")
    assert {"x", "p/in_proj", "p/conv_w", "p/conv_b", "p/a_log",
            "p/d_skip", "p/dt_bias", "p/norm", "p/out_proj"} == set(want)


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS
                                        for c in RWKV_CASES],
                         ids=[f"{w}-{c}" for w in WORLDS for c in RWKV_CASES])
def test_rwkv6_gradients(runs, world, case):
    """The WKV recurrence on each rank's batch rows and heads with its
    heads of u and the group norm (their gradients summed over the
    rows' ranks), and a whole RWKV6 layer: the ("embed",)-split mixes
    and decay made whole, `cwr` whole over "model" on 1 x 2."""
    want = _check(runs, world, f"rwkv/{case}")
    assert {"p/u", "p/gn_g", "p/gn_b"} <= set(want)


@pytest.mark.parametrize("world", WORLDS)
def test_encoder_from_bf16_frames(runs, world):
    """The enc-dec encoder (`transformer._encode`: the frames cast to
    bf16, float32 params promoting the first layer) and its final norm;
    the first norm gain within one bf16 ulp of its largest."""
    want = _check(runs, world, "encode")
    assert {"p/enc/ln1", "p/enc/attn/wq", "p/enc_norm"} <= set(want)


@pytest.mark.parametrize("world", WORLDS)
def test_cross_attention_with_decoder_rows_split(runs, world):
    """`attention.cross_forward` of a decoder query split by rows over
    "model" on the encoder memory: memory's k and v whole along the
    rows, their gradients summed over the rows' ranks."""
    want = _check(runs, world, "cross")
    assert {"x", "memory", "p/wq", "p/wk", "p/wv", "p/wo"} == set(want)


BLOCK_CASES = ([f"mamba/{i}" for i in SSM_IMPLS]
               + [f"rwkv/{c}" for c in RWKV_CASES] + ["encode", "cross"])


def _float64(case):
    """The case with every float32 array (its params too) in float64."""
    def wide(a):
        return a.astype(np.float64) if a.dtype == np.float32 else a
    out = {k: wide(v) if isinstance(v, np.ndarray) else v
           for k, v in case.items()}
    out["params"] = tree_map(wide, case["params"])
    return out


def test_block_tolerance_is_float32s_own_rounding():
    """BLOCK_TOL's ground: in one process the blocks' float32 gradients
    lie past TOL from their float64 gradients (some block), and within a
    quarter of BLOCK_TOL (every block; the encoder's first norm gain,
    read through the bf16 frames either way, left out)."""
    cases = _cases("1x2")
    worst = {}
    for key in BLOCK_CASES:
        g32 = ranks._grad_case(cases[key], None)
        g64 = ranks._grad_case(_float64(cases[key]), None)
        worst[key] = max(
            float(np.abs(g32[n] - g64[n]).max())
            / max(1.0, float(np.abs(g64[n]).max()))
            for n in g32 if n not in LOOSE.get(key, ()))
    assert max(worst.values()) > TOL, worst
    assert max(worst.values()) <= BLOCK_TOL / 4, worst
