"""Model assembly for the ten language-model archs: the port of the
serving part of `repro/models/transformer.py`. The dense GQA trunk
(llama3.2-1b, granite-3-8b, qwen1.5-32b, granite-34b, internvl2-76b
behind its stub vision frontend), MoE with MLA (deepseek-v3-671b) or GQA
(grok-1-314b), the encoder-decoder (seamless-m4t-large-v2), the Mamba2
hybrid with one shared attention layer (zamba2-7b) and RWKV6
(rwkv6-1.6b).

Layer params are stacked on a leading "stack" axis, as in the reference;
where the reference scans a stack, the port loops over it in Python and
indexes each layer's slice. Param trees are nested dicts keyed as the
reference's `split_pl` trees (`params_from_numpy` carries those across).
Entry points:

  init_model(cfg, generator, device=)           -> PL tree
  init_with(maker, cfg)                         -> PL tree
  model_prefill(params, cfg, batch)             -> (last_logits, cache)
  model_decode(params, cfg, token, pos, cache, seq_len=) -> (logits, cache)
  serve_cache_spec(cfg, batch, seq, enc_len=)   -> (spec tree, logical tree)

  model_loss(params, cfg, batch)                -> (loss, metrics)

Decode writes the cache's tensors in place (K/V rows, latent rows and
recurrent states) and returns the same tree; the training path
(`model_loss`, differentiated by autograd) writes nothing in place that
autograd saved. Tokens index the embedding directly: every token must be
< cfg.vocab (PyTorch raises on an index past the table, where the
reference's `jnp.take` clamps). The MTP head of deepseek-v3 is read by
`model_loss` only.

On a mesh of several ranks (`models.sharding.use_rules` over a live
mesh) the entry points take params placed by `sharding.place_params`
and run on DTensors, for every trunk: dense, MoE (GQA or MLA),
encoder-decoder, the Mamba2 hybrid and RWKV6. Logits and caches come
back as DTensors; the recurrent states are written into each rank's own
shard of the cache (`_put`, decode only: the training forward writes
nothing in place). `model_loss` is differentiated there too, for every
trunk (the train step): its backward moves gradients only through
`models.sharding`'s collectives, and its loss and metrics are plain
tensors, equal on every rank.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (PL, Maker, TensorSpec, cross_entropy,
                                       gelu, geglu, rms_norm, swiglu,
                                       tree_map)
from repro_torch.models.sharding import (PlacingMaker, contract,
                                         from_local_like, is_dtensor,
                                         local_of, local_slices,
                                         mesh_context, on_ranks,
                                         redistribute, require_placed,
                                         shard_act, stack)

# window kicks in only for long-context decode (the zamba2 deviation)
WINDOW_MIN_SEQ = 131_072


def tree_index(tree, i: int):
    """Layer i's params (or cache) from a stacked tree."""
    return tree_map(lambda a: a[i], tree)


def _seq_whole(x):
    """`x` (B, S, ...) with its sequence dim whole on every rank before a
    slice of it (a slice of a split dim makes DTensor gather it with its
    own collectives); on one rank `x` itself."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, tuple(
        Replicate() if p.is_shard() and p.dim == 1 else p
        for p in x.placements))


def tree_stack(trees):
    """A stacked tree from per-layer trees of one structure. On a mesh the
    layers' DTensors are first laid out as the first layer's (layers may
    leave their caches split along different dims), so the stack is a
    local one."""
    def stack(*xs):
        if is_dtensor(xs[0]):
            xs = [redistribute(x, xs[0].placements) for x in xs]
        return torch.stack(xs)
    return tree_map(stack, *trees)


def _put(stack, i: int, tree) -> None:
    """Write `tree` into layer i of the stacked tree `stack`, in place. On
    a mesh each leaf goes into this rank's shard of the stack (its layer
    dim is whole), laid out first as the stack's layer (DTensor has no
    strategy for an indexed write into a sharded tensor)."""
    def put(dst, src):
        if dst.dtype != src.dtype:
            raise TypeError(f"cache dtype {dst.dtype} differs from the new "
                            f"state's {src.dtype}")
        if not is_dtensor(dst):
            dst[i].copy_(src)
            return
        from torch.distributed.tensor import Shard
        if any(p.is_shard() and p.dim == 0 for p in dst.placements):
            raise ValueError("a stacked state split along its layer dim")
        dst.to_local()[i].copy_(local_of(src, tuple(
            Shard(p.dim - 1) if p.is_shard() else p
            for p in dst.placements)))
    tree_map(put, stack, tree)


def _depth(stack) -> int:
    """The number of layers of a stacked tree."""
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


# --------------------------------------------------------------------------
# layer init
# --------------------------------------------------------------------------


def _init_mlp(mk: Maker, cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    p = {"w1": mk.w((d, d_ff), ("embed", "mlp"), fan_in=d),
         "w2": mk.w((d_ff, d), ("mlp", "embed"), fan_in=d_ff)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = mk.w((d, d_ff), ("embed", "mlp"), fan_in=d)
    return p


def _init_dense_layer(mk: Maker, cfg: ModelConfig, *, cross: bool = False):
    p = {"ln1": mk.ones((cfg.d_model,), ("embed",)),
         "attn": attn_lib.init_attention(mk, cfg),
         "ln2": mk.ones((cfg.d_model,), ("embed",)),
         "mlp": _init_mlp(mk, cfg, cfg.d_ff)}
    if cross:
        p["lnx"] = mk.ones((cfg.d_model,), ("embed",))
        p["xattn"] = attn_lib.init_gqa(mk, cfg)
    return p


def _init_moe_layer(mk: Maker, cfg: ModelConfig):
    return {"ln1": mk.ones((cfg.d_model,), ("embed",)),
            "attn": attn_lib.init_attention(mk, cfg),
            "ln2": mk.ones((cfg.d_model,), ("embed",)),
            "moe": moe_lib.init_moe(mk, cfg)}


def _init_mamba_layer(mk: Maker, cfg: ModelConfig):
    return {"ln": mk.ones((cfg.d_model,), ("embed",)),
            "mamba": ssm_lib.init_mamba2(mk, cfg)}


def _init_stack(mk: Maker, cfg, layer_init, n: int):
    """n layers drawn one after another and stacked; the logical axes get
    a leading 'stack' axis."""
    layers = [layer_init(mk, cfg) for _ in range(n)]
    return tree_map(lambda *ls: PL(stack([l.arr for l in ls]),
                                   ("stack",) + ls[0].logical), *layers)


def init_model(cfg: ModelConfig, generator: torch.Generator, *,
               dtype=torch.bfloat16, device: DeviceLike = None,
               rules=None) -> Dict[str, Any]:
    """Random params (a PL tree) with the reference's tree, shapes and
    logical axes: normal draws from `generator` with the reference's
    fan-in scales, in `dtype` (the reference's params are always
    bfloat16) on `device` (None: the card). A CUDA generator draws on the
    card (the full-width models). The numbers are PyTorch's, not the
    reference's: parity tests carry the reference's params across
    (`params_from_numpy`). With `rules` over a mesh of several ranks,
    every rank draws the same numbers and each leaf is placed by its
    param spec as it is drawn (`sharding.PlacingMaker`): the tree that
    `place_params` gives from the whole one, without the whole one."""
    dev = resolve_device(device)
    mk = (PlacingMaker(rules, generator, dtype=dtype, device=dev)
          if on_ranks(rules) else Maker(generator, dtype=dtype, device=dev))
    return init_with(mk, cfg)


def init_with(mk: Maker, cfg: ModelConfig) -> Dict[str, Any]:
    """The PL tree of `cfg` with every leaf made by `mk` (a `MetaMaker`
    gives the shapes without drawing a number)."""
    d, Vp = cfg.d_model, cfg.vocab_padded
    p: Dict[str, Any] = {
        "embed": mk.w((Vp, d), ("vocab", "embed"), fan_in=d),
        "final_norm": mk.ones((d,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        p["head"] = mk.w((d, Vp), ("embed", "vocab"), fan_in=d)
    if cfg.family == "ssm":
        p["layers"] = _init_stack(mk, cfg, rwkv_lib.init_rwkv6, cfg.n_layers)
    elif cfg.family == "hybrid":
        p["mamba"] = _init_stack(mk, cfg, _init_mamba_layer, cfg.n_layers)
        p["shared"] = _init_dense_layer(mk, cfg)
    elif cfg.enc_dec:
        p["enc"] = _init_stack(mk, cfg, _init_dense_layer, cfg.n_enc_layers)
        p["enc_norm"] = mk.ones((d,), ("embed",))
        p["dec"] = _init_stack(mk, cfg, functools.partial(
            _init_dense_layer, cross=True), cfg.n_layers)
    elif cfg.is_moe:
        nd = cfg.n_dense_layers
        if nd:
            p["dense_layers"] = _init_stack(mk, cfg, _init_dense_layer, nd)
        p["moe_layers"] = _init_stack(mk, cfg, _init_moe_layer,
                                      cfg.n_layers - nd)
    else:
        p["layers"] = _init_stack(mk, cfg, _init_dense_layer, cfg.n_layers)
    if cfg.mtp:
        p["mtp"] = {"norm_h": mk.ones((d,), ("embed",)),
                    "norm_e": mk.ones((d,), ("embed",)),
                    "proj": mk.w((2 * d, d), ("embed", "embed"),
                                 fan_in=2 * d),
                    "layer": _init_dense_layer(mk, cfg)}
    return p


def params_from_numpy(tree, *, device: DeviceLike = None,
                      dtype=torch.bfloat16):
    """The reference's param tree (`split_pl(init_model(cfg, key))[0]`,
    its leaves as numpy arrays, bf16 ones included) as the port's, leaf
    for leaf and for every family: each leaf through float32 (exact for
    bf16) to `dtype` on `device`."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dtype).to(dev), tree)


# --------------------------------------------------------------------------
# layer forward
# --------------------------------------------------------------------------


def _mlp_fwd(p, cfg: ModelConfig, x):
    h1 = contract("bsd,df->bsf", x, p["w1"])
    h1 = shard_act(h1, "batch", "seq", "mlp")
    if "w3" in p:
        act = geglu if cfg.act == "geglu" else swiglu
        # the up projection laid out as the gate (on one rank a check): the
        # gate's product with it is elementwise
        h3 = shard_act(contract("bsd,df->bsf", x, p["w3"]), "batch", "seq",
                       "mlp")
        h = act(h1, h3)
    else:
        h = gelu(h1.float()).to(h1.dtype)
    return contract("bsf,fd->bsd", h, p["w2"])


def _dense_layer_fwd(lp, cfg, x, positions, *, causal=True, window=0,
                     memory=None, return_cache=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, cache = attn_lib.attention_forward(
        lp["attn"], cfg, h, positions, causal=causal, window=window,
        return_cache=return_cache)
    x = x + a
    if memory is not None:
        xh = rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = x + attn_lib.cross_forward(lp["xattn"], cfg, xh, memory)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + _mlp_fwd(lp["mlp"], cfg, h)
    x = shard_act(x, "batch", "seq", None)
    return x, cache


def _moe_layer_fwd(lp, cfg, x, positions, *, return_cache=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, cache = attn_lib.attention_forward(lp["attn"], cfg, h, positions,
                                          return_cache=return_cache)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    m, aux = moe_lib.moe_forward(lp["moe"], cfg, h)
    x = x + m
    x = shard_act(x, "batch", "seq", None)
    return x, aux, cache


# --------------------------------------------------------------------------
# trunks (train / prefill)
# --------------------------------------------------------------------------


def _scan_dense(stack, cfg, x, positions, *, memory=None, window=0,
                collect_cache=False):
    """The layer stack over x; with collect_cache, each layer's cache
    stacked on a leading layer axis (the reference's scan output)."""
    caches = []
    for i in range(_depth(stack)):
        x, cache = _dense_layer_fwd(tree_index(stack, i), cfg, x, positions,
                                    window=window, memory=memory,
                                    return_cache=collect_cache)
        caches.append(cache)
    return x, (tree_stack(caches) if collect_cache else None)


def _scan_moe(stack, cfg, x, positions, *, collect_cache=False):
    """The MoE layers over x; returns (x, the layers' aux losses summed,
    caches or None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i in range(_depth(stack)):
        x, a, cache = _moe_layer_fwd(tree_index(stack, i), cfg, x, positions,
                                     return_cache=collect_cache)
        aux = aux + a
        caches.append(cache)
    return x, aux, (tree_stack(caches) if collect_cache else None)


def _scan_encoder(stack, cfg, x, positions):
    """The encoder: non-causal GQA layers, no cache."""
    for i in range(_depth(stack)):
        lp = tree_index(stack, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn_lib.gqa_forward(lp["attn"], cfg, h, positions,
                                    causal=False)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp_fwd(lp["mlp"], cfg, h)
    return x


def _encode(params, cfg, enc_frames):
    """The encoder memory of `enc_frames` (B, M, D), cast to bf16 whatever
    the params' dtype, as the reference does (with float32 params the
    first layer then promotes to float32: `sharding.contract`)."""
    frames = shard_act(enc_frames.to(torch.bfloat16), "batch", "seq", None)
    memory = _scan_encoder(params["enc"], cfg, frames,
                           torch.arange(frames.shape[1],
                                        device=frames.device))
    return rms_norm(memory, params["enc_norm"], cfg.norm_eps)


def _hybrid_groups(cfg: ModelConfig):
    g = cfg.attn_every
    n_groups = cfg.n_layers // g
    trailing = cfg.n_layers - n_groups * g
    return g, n_groups, trailing


def _hybrid_spans(cfg: ModelConfig):
    """The Mamba stack's layer indices of each group, then of the trailing
    blocks (empty without them): the reference's (n_groups, g) reshape of
    the stack and its tail, as indices (no view of a split stack)."""
    g, n_groups, _ = _hybrid_groups(cfg)
    return ([range(gi * g, (gi + 1) * g) for gi in range(n_groups)],
            range(n_groups * g, cfg.n_layers))


def _mamba_block(lp, cfg, x, impl):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, state = ssm_lib.mamba2_forward(lp["mamba"], cfg, h, impl=impl)
    return x + y, state


def _mamba_stack(stack, layers, cfg, x, impl):
    """The Mamba blocks `layers` of the stack over x; returns (x, their
    final states stacked)."""
    states = []
    for j in layers:
        x, st = _mamba_block(tree_index(stack, j), cfg, x, impl)
        states.append(st)
    return x, tree_stack(states)


def _hybrid_trunk(params, cfg, x, positions, impl=None, *,
                  collect_cache=False):
    """zamba2: each group of attn_every Mamba blocks ends in the one shared
    attention + MLP layer; the trailing blocks follow. With collect_cache
    (prefill) also returns the cache {"mamba_g", "attn", "mamba_t"}."""
    impl = impl or cfg.ssm_impl
    groups, tail = _hybrid_spans(cfg)
    shared = params["shared"]
    m_states, a_kv = [], []
    for layers in groups:
        x, sts = _mamba_stack(params["mamba"], layers, cfg, x, impl)
        x, kv = _dense_layer_fwd(shared, cfg, x, positions,
                                 return_cache=collect_cache)
        m_states.append(sts)
        a_kv.append(kv)
    t_states = None
    if tail:
        x, t_states = _mamba_stack(params["mamba"], tail, cfg, x, impl)
    if not collect_cache:
        return x
    return x, {"mamba_g": tree_stack(m_states), "attn": tree_stack(a_kv),
               "mamba_t": t_states, "memory": None}


def _rwkv_trunk(params, cfg, x, *, collect_cache=False):
    """The RWKV6 layers over x; with collect_cache also their final states
    stacked."""
    states = []
    for i in range(_depth(params["layers"])):
        x, st = rwkv_lib.rwkv6_forward(tree_index(params["layers"], i), cfg,
                                       x)
        states.append(st)
    return (x, tree_stack(states)) if collect_cache else x


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------


def _embed(params, cfg, tokens):
    table = params["embed"]
    e = _embed_shards(table, tokens) if is_dtensor(table) else table[tokens]
    return shard_act(e, "batch", "seq", None)


def _embed_shards(table, tokens):
    """The row lookup on a mesh: each rank reads its shard of the table
    (its rows of the "vocab" split, its columns of FSDP's "embed" split)
    for the tokens it needs: its own tokens, but every token along the
    axes that split the table. A token outside its rows reads zeros, so
    the result is a partial sum over the row axes (which the caller's
    `shard_act` reduces) and split by columns over the column axes: the
    table itself never moves. DTensor's own embedding strategy fails on
    a table split by rows under indices split by batch. The backward adds
    each token's gradient into the rank's own rows (a token outside them
    adds nothing), a partial sum over the axes that split the tokens but
    not the table, reduced to the table's placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    t_pls = tuple(table.placements)
    k_pls = tuple(q if (q.is_shard() and p.is_replicate()) else Replicate()
                  for p, q in zip(t_pls, tokens.placements))
    out_pls = tuple(Partial() if p.is_shard() and p.dim == 0 else
                    Shard(tokens.dim()) if p.is_shard() else q
                    for p, q in zip(t_pls, k_pls))
    tl = local_of(table, t_pls, out=out_pls)
    v0 = local_slices(table.shape, t_pls, table.device_mesh)[0].start
    idx = local_of(tokens, k_pls).long() - v0
    hit = (idx >= 0) & (idx < tl.shape[0])
    e = torch.where(hit[..., None], tl[idx.clamp(0, tl.shape[0] - 1)],
                    torch.zeros((), dtype=tl.dtype, device=tl.device))
    return from_local_like(e, out_pls,
                           tuple(tokens.shape) + (table.shape[1],),
                           table.device_mesh)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = contract("bsd,dv->bsv", h, w) if on_ranks() else h @ w
    return shard_act(logits, "batch", "seq", "vocab")


def _assemble_input(params, cfg, batch):
    """tokens (+ stub frontend embeddings, prepended) -> (x, positions)."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.frontend and "frontend" in batch:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    S = x.shape[1]
    return x, torch.arange(S, device=x.device)


def _trunk(params, cfg, x, positions, *, memory=None, window=0):
    """Train/prefill trunk dispatch. Returns (h, aux loss, caches or None)
    as the reference's (the enc-dec and MoE trunks return their caches;
    `memory` is the enc-dec archs' encoder output, `_encode`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = None
    if cfg.family == "ssm":
        h = _rwkv_trunk(params, cfg, x)
    elif cfg.family == "hybrid":
        h = _hybrid_trunk(params, cfg, x, positions)
    elif cfg.enc_dec:
        h, caches = _scan_dense(params["dec"], cfg, x, positions,
                                memory=memory)
    elif cfg.is_moe:
        if cfg.n_dense_layers:
            x, _ = _scan_dense(params["dense_layers"], cfg, x, positions)
        h, aux, caches = _scan_moe(params["moe_layers"], cfg, x, positions)
    else:
        h, caches = _scan_dense(params["layers"], cfg, x, positions,
                                window=window)
    return h, aux, caches


# --------------------------------------------------------------------------
# entry points on a mesh
# --------------------------------------------------------------------------


def on_mesh(fn):
    """An entry point (params, cfg, ...) that runs on a mesh of several
    ranks as on one: its params must be placed (a plain leaf raises, so
    nothing runs whole on every rank by mistake), and the constants it
    builds combine with DTensors as replicated
    (`sharding.mesh_context`)."""
    @functools.wraps(fn)
    def run(params, cfg, *args, **kwargs):
        if on_ranks():
            require_placed(params, f"{cfg.name} params")
        with mesh_context():
            return fn(params, cfg, *args, **kwargs)
    return run


# --------------------------------------------------------------------------
# training loss
# --------------------------------------------------------------------------

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3


@on_mesh
def model_loss(params, cfg: ModelConfig, batch):
    """(loss, metrics) of one batch: the mean next-token cross-entropy over
    `loss_mask`, plus MOE_AUX_WEIGHT x the MoE layers' load-balance loss,
    plus (deepseek-v3) MTP_WEIGHT x the MTP head's cross-entropy, where
    the head predicts token t + 2 from the trunk's state at t and token
    t + 1's embedding. Metrics: ce, aux, loss (and mtp_ce)."""
    memory = (_encode(params, cfg, batch["enc_frames"]) if cfg.enc_dec
              else None)
    x, positions = _assemble_input(params, cfg, batch)
    h, aux, _ = _trunk(params, cfg, x, positions, memory=memory)
    logits = _logits(params, cfg, h)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    ce = cross_entropy(logits, labels, mask)
    del logits
    loss = ce + MOE_AUX_WEIGHT * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        mtp = params["mtp"]
        hn = rms_norm(h[:, :-1], mtp["norm_h"], cfg.norm_eps)
        nxt = _embed(params, cfg, batch["tokens"][:, 1:])
        if cfg.frontend and "frontend" in batch:     # align to h positions
            nxt = torch.cat([batch["frontend"].to(nxt.dtype), nxt],
                            dim=1)[:, :hn.shape[1]]
        en = rms_norm(nxt[:, :hn.shape[1]], mtp["norm_e"], cfg.norm_eps)
        hm = contract("bsd,de->bse", torch.cat([hn, en], dim=-1),
                          mtp["proj"])
        hm, _ = _dense_layer_fwd(mtp["layer"], cfg, hm, positions[:-1])
        mtp_ce = cross_entropy(_logits(params, cfg, hm), labels[:, 1:],
                               mask[:, 1:] if mask is not None else None)
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------


@on_mesh
def model_prefill(params, cfg: ModelConfig, batch):
    """Full-prompt forward; returns (last-position logits (B,1,Vp), cache).
    The cache's tree is the reference's for the family: {"layers"} (dense:
    K/V; ssm: RWKV states), {"layers", "xkv"} (enc-dec: self K/V and the
    encoder memory's cross K/V), {"dense", "moe"} (K/V or MLA latents),
    {"mamba_g", "attn", "mamba_t"} (hybrid), each with "memory": None."""
    memory = (_encode(params, cfg, batch["enc_frames"]) if cfg.enc_dec
              else None)
    x, positions = _assemble_input(params, cfg, batch)
    if cfg.family == "ssm":
        h, states = _rwkv_trunk(params, cfg, x, collect_cache=True)
        cache = {"layers": states, "memory": None}
    elif cfg.family == "hybrid":
        # prefill runs the per-step scan whatever cfg.ssm_impl says, as
        # the reference's does
        h, cache = _hybrid_trunk(params, cfg, x, positions, "scan",
                                 collect_cache=True)
    elif cfg.enc_dec:
        stack = params["dec"]
        kvs, xks, xvs = [], [], []
        h = x
        for i in range(_depth(stack)):
            lp = tree_index(stack, i)
            h, kv = _dense_layer_fwd(lp, cfg, h, positions, memory=memory,
                                     return_cache=True)
            xk, xv = attn_lib.cross_kv(lp["xattn"], memory)
            kvs.append(kv)
            xks.append(xk)
            xvs.append(xv)
        cache = {"layers": tree_stack(kvs),
                 "xkv": tree_stack([{"k": k, "v": v}
                                    for k, v in zip(xks, xvs)]),
                 "memory": None}
    elif cfg.is_moe:
        dkv = None
        if cfg.n_dense_layers:
            x, dkv = _scan_dense(params["dense_layers"], cfg, x, positions,
                                 collect_cache=True)
        h, _, mkv = _scan_moe(params["moe_layers"], cfg, x, positions,
                              collect_cache=True)
        cache = {"dense": dkv, "moe": mkv, "memory": None}
    else:
        h, kv = _scan_dense(params["layers"], cfg, x, positions,
                            collect_cache=True)
        cache = {"layers": kv, "memory": None}
    logits = _logits(params, cfg, _seq_whole(h)[:, -1:])
    return logits, cache


def _decode_window(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.window and seq_len > WINDOW_MIN_SEQ:
        return cfg.window
    return 0


def _decode_attn(lp, cfg, x, pos, kv, window=0):
    """A layer's self-attention residual at decode; kv is written in
    place."""
    hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _ = attn_lib.attention_decode(lp["attn"], cfg, hh, pos, kv,
                                     window=window)
    return x + a


def _decode_mlp(lp, cfg, x):
    return x + _mlp_fwd(lp["mlp"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))


@on_mesh
def model_decode(params, cfg: ModelConfig, token, pos: int, cache, *,
                 seq_len: int):
    """One-token step. token (B,1) integer; pos its absolute position (a
    Python int). The cache's tensors are written in place (K/V and latent
    rows, recurrent states); returns (logits (B,1,Vp), cache)."""
    x = _embed(params, cfg, token)
    window = _decode_window(cfg, seq_len)
    if cfg.family == "ssm":
        stack, states = params["layers"], cache["layers"]
        for i in range(_depth(stack)):
            x, st = rwkv_lib.rwkv6_forward(tree_index(stack, i), cfg, x,
                                           state=tree_index(states, i))
            _put(states, i, st)
        new_cache = {"layers": states, "memory": None}
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, x, pos, cache, window)
        new_cache = cache
    elif cfg.enc_dec:
        stack, kv = params["dec"], cache["layers"]
        for i in range(_depth(stack)):
            lp = tree_index(stack, i)
            x = _decode_attn(lp, cfg, x, pos, tree_index(kv, i))
            xh = rms_norm(x, lp["lnx"], cfg.norm_eps)
            x = x + attn_lib.cross_forward(
                lp["xattn"], cfg, xh,
                kv=(cache["xkv"]["k"][i], cache["xkv"]["v"][i]))
            x = _decode_mlp(lp, cfg, x)
        new_cache = {"layers": kv, "xkv": cache["xkv"], "memory": None}
    elif cfg.is_moe:
        if cfg.n_dense_layers:
            stack, kv = params["dense_layers"], cache["dense"]
            for i in range(_depth(stack)):
                lp = tree_index(stack, i)
                x = _decode_mlp(lp, cfg, _decode_attn(lp, cfg, x, pos,
                                                      tree_index(kv, i)))
        stack, kv = params["moe_layers"], cache["moe"]
        for i in range(_depth(stack)):
            lp = tree_index(stack, i)
            x = _decode_attn(lp, cfg, x, pos, tree_index(kv, i))
            m, _ = moe_lib.moe_forward(lp["moe"], cfg,
                                       rms_norm(x, lp["ln2"], cfg.norm_eps))
            x = x + m
        new_cache = {"dense": cache["dense"], "moe": kv, "memory": None}
    else:
        stack, kv = params["layers"], cache["layers"]
        for i in range(_depth(stack)):
            lp = tree_index(stack, i)
            x = _decode_mlp(lp, cfg, _decode_attn(lp, cfg, x, pos,
                                                  tree_index(kv, i), window))
        new_cache = {"layers": kv, "memory": cache.get("memory")}
    logits = _logits(params, cfg, x)
    return logits, new_cache


def _hybrid_decode(params, cfg, x, pos, cache, window):
    """One token through the hybrid trunk; the Mamba states and the shared
    layer's K/V (one cache a group) are written in place."""
    groups, tail = _hybrid_spans(cfg)
    shared = params["shared"]

    def mamba_steps(layers, states, x):
        for j, layer in enumerate(layers):
            lp = tree_index(params["mamba"], layer)
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            y, st = ssm_lib.mamba2_decode(lp["mamba"], cfg, h,
                                          tree_index(states, j))
            _put(states, j, st)
            x = x + y
        return x

    for gi, layers in enumerate(groups):
        x = mamba_steps(layers, tree_index(cache["mamba_g"], gi), x)
        x = _decode_mlp(shared, cfg, _decode_attn(
            shared, cfg, x, pos, tree_index(cache["attn"], gi), window))
    if tail:
        x = mamba_steps(tail, cache["mamba_t"], x)
    return x


# --------------------------------------------------------------------------
# cache specs (TensorSpec + logical axes)
# --------------------------------------------------------------------------


def _with_stack(tree, *n):
    return tree_map(lambda s: TensorSpec(tuple(n) + tuple(s.shape), s.dtype),
                    tree)


def serve_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                     enc_len: int = 0):
    """(TensorSpec tree, logical-string tree) of the decode cache at a
    horizon of `seq_len` positions, with the reference's dtypes (bf16
    K/V, latents, conv states and shifts; float32 SSM and WKV states).

    enc_len: the encoder memory's true length for the enc-dec archs
    (default cfg.enc_memory_len). The cross K/V must be allocated at the
    real encoder output length: zero-padded cross slots would be
    attended with score 0, not masked."""
    window = _decode_window(cfg, seq_len)
    seq_ax = "seq" if attn_lib.heads_shardable(cfg) else "seq_model"
    kv_log = {"k": f"stack|batch|{seq_ax}|kv_heads|head_dim",
              "v": f"stack|batch|{seq_ax}|kv_heads|head_dim"}
    mla_log = {"c": "stack|batch|seq|", "kr": "stack|batch|seq|"}
    att_log = mla_log if cfg.attention == "mla" else kv_log

    def kv(n):
        return _with_stack(attn_lib.attention_cache_shape(
            cfg, batch, seq_len, window=window), n)

    if cfg.family == "ssm":
        st = rwkv_lib.rwkv6_state_shape(cfg, batch)
        shapes = {"layers": _with_stack(st, cfg.n_layers), "memory": None}
        log = {"layers": {"shift_t": "stack|batch|",
                          "shift_c": "stack|batch|",
                          "wkv": "stack|batch|heads||"},
               "memory": None}
        return shapes, log
    if cfg.family == "hybrid":
        g, n_groups, trailing = _hybrid_groups(cfg)
        mst = ssm_lib.mamba2_state_shape(cfg, batch)
        shapes = {"mamba_g": _with_stack(mst, n_groups, g),
                  "attn": kv(n_groups),
                  "mamba_t": _with_stack(mst, trailing) if trailing else None,
                  "memory": None}
        log = {"mamba_g": {"h": "stack|stack2|batch|||",
                           "conv": "stack|stack2|batch||mlp"},
               "attn": dict(att_log),
               "mamba_t": ({"h": "stack|batch|||", "conv": "stack|batch||mlp"}
                           if trailing else None),
               "memory": None}
        return shapes, log
    if cfg.enc_dec:
        M = enc_len or cfg.enc_memory_len
        xkv = TensorSpec((cfg.n_layers, batch, M, cfg.n_kv_heads,
                          cfg.resolved_head_dim), torch.bfloat16)
        shapes = {"layers": kv(cfg.n_layers), "xkv": {"k": xkv, "v": xkv},
                  "memory": None}
        log = {"layers": att_log,
               "xkv": {"k": "stack|batch|seq|kv_heads|head_dim",
                       "v": "stack|batch|seq|kv_heads|head_dim"},
               "memory": None}
        return shapes, log
    if cfg.is_moe:
        nd = cfg.n_dense_layers
        shapes = {"dense": kv(nd) if nd else None,
                  "moe": kv(cfg.n_layers - nd), "memory": None}
        log = {"dense": att_log if nd else None, "moe": att_log,
               "memory": None}
        return shapes, log
    shapes = {"layers": kv(cfg.n_layers), "memory": None}
    return shapes, {"layers": att_log, "memory": None}


def grow_cache(cache, shapes):
    """Prefill's cache zero-padded to the shapes of `serve_cache_spec`
    (the serving horizon), keeping its own dtype: the params' (bf16 for
    the reference's params). None leaves (grok's absent dense layers, a
    hybrid without trailing blocks) pass through. A DTensor leaf is
    padded on its shards: the padded dims are gathered first (a padded
    dim cannot stay split: its shards would move), the others keep
    their placements."""
    def fit(c, s):
        if tuple(c.shape) == tuple(s.shape):
            return c
        if not is_dtensor(c):
            out = torch.zeros(s.shape, dtype=c.dtype, device=c.device)
            out[tuple(slice(0, n) for n in c.shape)] = c
            return out
        from torch.distributed.tensor import Replicate
        grown = [a != b for a, b in zip(c.shape, s.shape)]
        pls = tuple(Replicate() if p.is_partial() or (
            p.is_shard() and grown[p.dim]) else p for p in c.placements)
        cl = local_of(c, pls)
        out = torch.zeros([b if g else a for a, b, g in
                           zip(cl.shape, s.shape, grown)], dtype=c.dtype,
                          device=cl.device)
        out[tuple(slice(0, n) for n in cl.shape)] = cl
        return from_local_like(out, pls, s.shape, c.device_mesh)
    return tree_map(fit, cache, shapes)
