"""Attention: GQA/MHA/MQA (+ optional QKV bias), MLA (DeepSeek-V3),
cross-attention (encoder-decoder) and their decode caches. The port of
`repro/models/attention.py`.

Layouts (the reference's, kept at every public function)
  q:  (B, S, Hkv, G, hd)   grouped, G = Hq // Hkv
  kv: (B, S, Hkv, hd)
Caches
  gqa: {"k", "v"}: (B, C, Hkv, hd); C = window if windowed else max seq.
  mla: {"c": (B, C, kv_lora), "kr": (B, C, rope_dim)}, the latent cache;
       decode scores against it with W_uk absorbed into q (DeepSeek's
       weight-absorbed form).

Masks are built from absolute positions (not from the top left of the
score matrix), with NEG_INF on float32 scores; the softmax runs in
float32 and is cast to v's dtype before the PV product, as in the
reference. Products and softmax are plain PyTorch ops: the reference
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Maker, TensorSpec, apply_rope, rms_norm
from repro_torch.models.sharding import (contract, current_rules,
                                         from_local_like, is_dtensor,
                                         local_of, local_slices, shard_act,
                                         whole_on_mesh)

QK_CHUNK = 512          # kv-chunk for the online-softmax (flash-style) path
NEG_INF = -1e30
PROD_MODEL_AXIS = 16    # production model-axis width (cache-spec decisions)


def heads_shardable(cfg: ModelConfig, m: int = PROD_MODEL_AXIS) -> bool:
    """Can (kv_heads | q-head-groups) shard over an m-way model axis?"""
    if cfg.attention == "mla":
        return cfg.n_heads % m == 0
    g = cfg.n_heads // max(cfg.n_kv_heads, 1)
    return (cfg.n_kv_heads % m == 0) or (g % m == 0)


def _attn_seq_axis(cfg: ModelConfig) -> str:
    """Sequence-parallel attention when heads cannot shard."""
    if cfg.seq_shard_attn:
        return "seq_model"
    rules = current_rules()
    if rules is None:
        return "seq_model" if not heads_shardable(cfg) else "seq"
    m = rules.axis_size(rules.act_rules.get("kv_heads"))
    return "seq_model" if (m > 1 and not heads_shardable(cfg, m)) else "seq"


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_gqa(mk: Maker, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": mk.w((d, hkv, hq // hkv, hd),
                   ("embed", "kv_heads", "heads", "head_dim"), fan_in=d),
        "wk": mk.w((d, hkv, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wv": mk.w((d, hkv, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wo": mk.w((hkv, hq // hkv, hd, d),
                   ("kv_heads", "heads", "head_dim", "embed"),
                   fan_in=hq * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = mk.z((hkv, hq // hkv, hd), ("kv_heads", "heads", "head_dim"))
        p["bk"] = mk.z((hkv, hd), ("kv_heads", "head_dim"))
        p["bv"] = mk.z((hkv, hd), ("kv_heads", "head_dim"))
    return p


def init_mla(mk: Maker, cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wdq": mk.w((d, qr), ("embed", "q_lora"), fan_in=d),
        "q_norm": mk.ones((qr,), ("q_lora",)),
        "wuq": mk.w((qr, h, nope + rope), ("q_lora", "heads", "head_dim"),
                    fan_in=qr),
        "wdkv": mk.w((d, kr + rope), ("embed", "kv_lora"), fan_in=d),
        "kv_norm": mk.ones((kr,), ("kv_lora",)),
        "wuk": mk.w((kr, h, nope), ("kv_lora", "heads", "head_dim"),
                    fan_in=kr),
        "wuv": mk.w((kr, h, vh), ("kv_lora", "heads", "head_dim"), fan_in=kr),
        "wo": mk.w((h, vh, d), ("heads", "head_dim", "embed"), fan_in=h * vh),
    }


def init_attention(mk: Maker, cfg: ModelConfig):
    return init_mla(mk, cfg) if cfg.attention == "mla" else init_gqa(mk, cfg)


# --------------------------------------------------------------------------
# core softmax-attention on grouped layouts
# --------------------------------------------------------------------------


def _masked_attn_naive(q, k, v, mask, scale):
    """q (B,S,K,G,h); k,v (B,T,K,h); mask (B,S,T) or (S,T) bool keep."""
    s = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        s = torch.where(m[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)


def _masked_attn_chunked(q, k, v, q_pos, kv_pos, scale, causal, window):
    """Online softmax over KV chunks of QK_CHUNK (flash-style, plain ops),
    in float32. q (B,S,K,G,h); k,v (B,T,K,h); q_pos (S,), kv_pos (T,).
    Memory a step is O(S * chunk) instead of O(S * T)."""
    B, S, K, G, _ = q.shape
    T = k.shape[1]
    C = min(QK_CHUNK, T)
    qf = q.float()
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, T, C):
        # the last chunk is the ragged remainder: the reference pads it
        # with masked keys (position -1), which add exactly 0 to a row
        # that has kept a key
        kj, vj, pj = k[:, c0:c0 + C], v[:, c0:c0 + C], kv_pos[c0:c0 + C]
        s = torch.einsum("bskgh,bckh->bkgsc", qf, kj.float()) * scale
        keep = (pj >= 0)[None, :]
        if causal:
            keep = keep & (q_pos[:, None] >= pj[None, :])
        if window:
            keep = keep & (q_pos[:, None] - pj[None, :] < window)
        s = torch.where(keep[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgsc,bckh->bkgsh", p, vj.float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)                  # (B,S,K,G,h)


def _attn_shards(core, q, k, v, q_pos, kv_pos):
    """`core(q, k, v, q_pos, kv_pos)` -> o (B,S,K,G,hv) on this rank's
    shards on a mesh of several ranks (on one rank: `core` as it is).
    Attention runs apart for each batch row and each head: q keeps its
    split of the batch, of the query rows (with its slice of q_pos, None
    where the core reads no positions) or of a head dim; k and v follow a
    batch or kv-head split and are whole along the others (every key for
    every query). The core runs on plain tensors: DTensor's einsum
    flattens split head dims it may not. Under autograd a split of the
    query rows (or of a query head dim) is a sum over those ranks of k's
    and v's gradients."""
    if not is_dtensor(q):
        return core(q, k, v, q_pos, kv_pos)
    from torch.distributed.tensor import Replicate, Shard
    q_pls, kv_pls = [], []
    for p in q.placements:
        d = p.dim if p.is_shard() else None
        q_pls.append(Shard(d) if d in (0, 1, 2, 3) else Replicate())
        kv_pls.append(Shard(d) if d in (0, 2) else Replicate())
    rows = local_slices(q.shape, q_pls, q.device_mesh)[1]
    o = core(local_of(q, q_pls), local_of(k, kv_pls, out=q_pls),
             local_of(v, kv_pls, out=q_pls),
             None if q_pos is None else q_pos[rows], kv_pos)
    return from_local_like(o, q_pls, tuple(q.shape[:4]) + (v.shape[-1],),
                           q.device_mesh)


def _attn_dispatch(q, k, v, q_pos, kv_pos, scale, causal, window, impl):
    T = k.shape[1]
    if impl == "auto":
        impl = "naive" if T <= 4096 else "chunked"

    def core(q, k, v, q_pos, kv_pos):
        if impl == "chunked":
            return _masked_attn_chunked(q, k, v, q_pos, kv_pos, scale,
                                        causal, window)
        keep = torch.ones((q.shape[1], T), dtype=torch.bool,
                          device=q.device)
        if causal:
            keep = keep & (q_pos[:, None] >= kv_pos[None, :])
        if window:
            keep = keep & (q_pos[:, None] - kv_pos[None, :] < window)
        keep = keep & (kv_pos >= 0)[None, :]
        return _masked_attn_naive(q, k, v, keep, scale)
    return _attn_shards(core, q, k, v, q_pos, kv_pos)


# --------------------------------------------------------------------------
# in-place cache writes
# --------------------------------------------------------------------------


def write_slot(cache, slot: int, row) -> None:
    """cache[:, slot] = row, in place. On a mesh the write goes into this
    rank's shard of the cache, and only where that shard holds the slot
    (the cache's dim 1 may be split, "seq_model"); `row` is first
    redistributed to the cache's placements without that dim. DTensor
    has no strategy for an indexed write into a sharded tensor."""
    if not is_dtensor(cache):
        cache[:, slot] = row
        return
    from torch.distributed.tensor import Replicate, Shard
    row_pls = tuple(
        p if not p.is_shard() else
        Replicate() if p.dim == 1 else Shard(p.dim - (p.dim > 1))
        for p in cache.placements)
    row = local_of(row, row_pls)
    span = local_slices(cache.shape, cache.placements,
                        cache.device_mesh)[1]
    if span.start <= slot < span.stop:
        cache.to_local()[:, slot - span.start] = row


# --------------------------------------------------------------------------
# GQA forward
# --------------------------------------------------------------------------


def add_bias(x, b):
    """x + b. On a mesh the bias is made whole first (DTensor would
    gather it with collectives of its own) and the add runs in float32
    and rounds once, as a bf16 add does: the bias's gradient, a sum over
    the ranks' rows, is then reduced in float32 and rounded once, as on
    one device."""
    if not is_dtensor(b):
        return x + b
    return (x.float() + whole_on_mesh(b.float())).to(x.dtype)


def _gqa_qkv(p, cfg: ModelConfig, x, positions):
    # promoting: the encoder's first layer sees bf16 frames (`contract`
    # casts mixed operands to their promoted dtype, as jnp does)
    q = contract("bsd,dkgh->bskgh", x, p["wq"])
    k = contract("bsd,dkh->bskh", x, p["wk"])
    v = contract("bsd,dkh->bskh", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = (add_bias(q, p["bq"]), add_bias(k, p["bk"]),
                   add_bias(v, p["bv"]))
    q = shard_act(q, "batch", _attn_seq_axis(cfg), "kv_heads", "heads",
                  "head_dim")
    if positions is not None:          # rope (not for abs-pos stubs)
        q = apply_rope(q, positions, cfg.rope_theta, heads=2)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, cfg: ModelConfig, x, positions, *, causal=True, window=0,
                impl=None, return_cache=False):
    """Train/prefill path. x (B,S,D); positions (S,). Returns
    (out, cache or None)."""
    impl = impl or cfg.attention_impl
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    scale = 1.0 / (cfg.resolved_head_dim ** 0.5)
    kv_pos = (positions if positions is not None
              else torch.arange(k.shape[1], device=x.device))
    o = _attn_dispatch(q, k, v, kv_pos, kv_pos, scale, causal, window, impl)
    out = contract("bskgh,kghd->bsd", o, p["wo"])
    out = shard_act(out, "batch", "seq", None)
    cache = {"k": k, "v": v} if return_cache else None
    return out, cache


def gqa_decode(p, cfg: ModelConfig, x1, pos: int, cache, *, window=0):
    """One-token decode. x1 (B,1,D); pos the token's absolute position (a
    Python int); cache k/v (B,C,K,h), of x1's dtype.

    The new K/V row is written at slot min(pos, C-1), or pos % C under a
    window (a ring buffer), IN PLACE: the cache tensors are updated and
    returned (the reference returns updated copies). Slots are masked by
    the true positions they hold."""
    pos = int(pos)
    q = contract("bsd,dkgh->bskgh", x1, p["wq"])
    k1 = contract("bsd,dkh->bskh", x1, p["wk"])
    v1 = contract("bsd,dkh->bskh", x1, p["wv"])
    if cfg.qkv_bias:
        q, k1, v1 = (add_bias(q, p["bq"]), add_bias(k1, p["bk"]),
                     add_bias(v1, p["bv"]))
    posv = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
    q = apply_rope(q, posv, cfg.rope_theta, heads=2)
    k1 = apply_rope(k1, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    if k.dtype != k1.dtype or v.dtype != v1.dtype:
        raise TypeError(f"cache dtype {k.dtype} / {v.dtype} differs from the "
                        f"new K/V's {k1.dtype}")
    C = k.shape[1]
    slot = pos % C if window else min(pos, C - 1)
    write_slot(k, slot, k1[:, 0])
    write_slot(v, slot, v1[:, 0])
    cache_ax = _attn_seq_axis(cfg)
    k = shard_act(k, "batch", cache_ax, "kv_heads", "head_dim")
    v = shard_act(v, "batch", cache_ax, "kv_heads", "head_dim")

    idx = torch.arange(C, device=x1.device)
    if window:
        kv_pos = pos - torch.remainder(pos - idx, C)   # ring-buffer positions
    else:
        kv_pos = torch.where(idx <= pos, idx, -1)

    scale = 1.0 / (cfg.resolved_head_dim ** 0.5)

    def core(q, k, v, _q_pos, kv_pos):
        s = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
        s = torch.where((kv_pos >= 0)[None, None, None, None, :], s,
                        NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        return torch.einsum("bkgst,btkh->bskgh", pattn.to(v.dtype), v)
    o = _attn_shards(core, q, k, v, posv, kv_pos)
    out = contract("bskgh,kghd->bsd", o, p["wo"])
    return out, {"k": k, "v": v}


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int, window=0):
    """The decode cache's TensorSpecs (bf16, as the reference's)."""
    C = min(seq, window) if window else seq
    hd = cfg.resolved_head_dim
    spec = TensorSpec((batch, C, cfg.n_kv_heads, hd), torch.bfloat16)
    return {"k": spec, "v": spec}


# --------------------------------------------------------------------------
# Cross-attention (enc-dec): kv from encoder memory, no rope, no mask
# --------------------------------------------------------------------------


def cross_kv(p, memory):
    """The cross-attention K/V of the encoder memory, computed once a
    request (prefill) and cached for decode. On a mesh they come out
    split by batch and kv heads, as the cache spec places them."""
    k = contract("bmd,dkh->bmkh", memory, p["wk"])
    v = contract("bmd,dkh->bmkh", memory, p["wv"])
    return k, v


def cross_forward(p, cfg: ModelConfig, x, memory=None, kv=None):
    """x (B,S,D) attends to every memory row, unmasked (kv: cross_kv's
    pair, or computed from `memory`); on a mesh on each rank's batch rows
    and heads (`_attn_shards`)."""
    q = contract("bsd,dkgh->bskgh", x, p["wq"])
    k, v = cross_kv(p, memory) if kv is None else kv
    scale = 1.0 / (cfg.resolved_head_dim ** 0.5)

    def core(q, k, v, _q_pos, _kv_pos):
        return _masked_attn_naive(q, k, v, None, scale)
    o = _attn_shards(core, q, k, v, None, None)
    return contract("bskgh,kghd->bsd", o, p["wo"])


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------


def _mla_q(p, cfg, x, positions):
    cq = rms_norm(contract("bsd,dr->bsr", x, p["wdq"]), p["q_norm"],
                  cfg.norm_eps)
    q = contract("bsr,rhe->bshe", cq, p["wuq"])         # e = nope + rope
    qn = q[..., :cfg.qk_nope_head_dim]
    qr = apply_rope(q[..., cfg.qk_nope_head_dim:], positions, cfg.rope_theta)
    return qn, qr


def _mla_latent(p, cfg, x, positions):
    ckr = contract("bsd,dr->bsr", x, p["wdkv"])
    c = rms_norm(ckr[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    kr = ckr[..., cfg.kv_lora_rank:]                    # (B,S,rope) shared
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, kr


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** 0.5)


def mla_forward(p, cfg: ModelConfig, x, positions, *, impl=None,
                return_cache=False):
    """Train/prefill: k and v expanded from the latent, in the grouped
    layout with K = H, G = 1. The cache is the latent {"c", "kr"}."""
    impl = impl or cfg.attention_impl
    qn, qr = _mla_q(p, cfg, x, positions)
    c, kr = _mla_latent(p, cfg, x, positions)
    kn = contract("bsr,rhe->bshe", c, p["wuk"])
    v = contract("bsr,rhe->bshe", c, p["wuv"])
    q = torch.cat([qn, qr], dim=-1)[:, :, :, None, :]            # (B,S,H,1,e)
    k = torch.cat([kn, kr[:, :, None, :].expand(
        *kn.shape[:3], cfg.qk_rope_head_dim)], dim=-1)
    q = shard_act(q, "batch", "seq", "kv_heads", None, None)
    k = shard_act(k, "batch", "seq", "kv_heads", None)
    o = _attn_dispatch(q, k, v, positions, positions, _mla_scale(cfg), True,
                       0, impl)                                   # (B,S,H,1,vh)
    out = contract("bshv,hvd->bsd", o[:, :, :, 0, :], p["wo"])
    out = shard_act(out, "batch", "seq", None)
    cache = {"c": c, "kr": kr} if return_cache else None
    return out, cache


def mla_decode(p, cfg: ModelConfig, x1, pos: int, cache):
    """One-token decode, weight-absorbed: q_eff = qn W_uk^T scores against
    the latent cache directly, and W_uv is applied after the PV product.
    The new latent row is written at slot min(pos, C-1) IN PLACE (the
    reference's dynamic_update_slice clamps the same way); slots past
    pos are masked."""
    pos = int(pos)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
    qn, qr = _mla_q(p, cfg, x1, posv)                   # (B,1,H,.)
    c1, kr1 = _mla_latent(p, cfg, x1, posv)
    c, kr = cache["c"], cache["kr"]
    if c.dtype != c1.dtype or kr.dtype != kr1.dtype:
        raise TypeError(f"cache dtype {c.dtype} / {kr.dtype} differs from "
                        f"the new latent's {c1.dtype}")
    C = c.shape[1]
    slot = min(pos, C - 1)
    write_slot(c, slot, c1[:, 0])
    write_slot(kr, slot, kr1[:, 0])

    q_eff = contract("bshe,rhe->bshr", qn, p["wuk"])
    s = (contract("bshr,btr->bhst", q_eff, c)
         + contract("bshe,bte->bhst", qr, kr))
    s = s.float() * _mla_scale(cfg)
    idx = torch.arange(C, device=x1.device)
    s = torch.where((idx <= pos)[None, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o_lat = contract("bhst,btr->bshr", pattn.to(c.dtype), c)  # (B,1,H,r)
    o = contract("bshr,rhv->bshv", o_lat, p["wuv"])
    out = contract("bshv,hvd->bsd", o, p["wo"])
    return out, {"c": c, "kr": kr}


def mla_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    """The latent cache's TensorSpecs (bf16, as the reference's)."""
    return {"c": TensorSpec((batch, seq, cfg.kv_lora_rank), torch.bfloat16),
            "kr": TensorSpec((batch, seq, cfg.qk_rope_head_dim),
                             torch.bfloat16)}


# --------------------------------------------------------------------------
# unified entry points
# --------------------------------------------------------------------------


def attention_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                      window=0, return_cache=False):
    if cfg.attention == "mla":
        return mla_forward(p, cfg, x, positions, return_cache=return_cache)
    return gqa_forward(p, cfg, x, positions, causal=causal, window=window,
                       return_cache=return_cache)


def attention_decode(p, cfg: ModelConfig, x1, pos, cache, *, window=0):
    if cfg.attention == "mla":
        return mla_decode(p, cfg, x1, pos, cache)
    return gqa_decode(p, cfg, x1, pos, cache, window=window)


def attention_cache_shape(cfg: ModelConfig, batch: int, seq: int, window=0):
    if cfg.attention == "mla":
        return mla_cache_shape(cfg, batch, seq)
    return gqa_cache_shape(cfg, batch, seq, window=window)
