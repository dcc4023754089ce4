"""Attention: GQA/MHA/MQA (+ optional QKV bias) and its decode cache. The
port of the GQA part of `repro/models/attention.py`.

Layouts (the reference's, kept at every public function)
  q:  (B, S, Hkv, G, hd)   grouped, G = Hq // Hkv
  kv: (B, S, Hkv, hd)
Cache
  {"k", "v"}: (B, C, Hkv, hd); C = window if windowed else max seq.

Masks are built from absolute positions (not from the top left of the
score matrix), with NEG_INF on float32 scores; the softmax runs in
float32 and is cast to v's dtype before the PV product, as in the
reference. Products and softmax are plain PyTorch ops: the reference
computes them outside any Pallas kernel. MLA (DeepSeek-V3) and
cross-attention are not ported yet (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Maker, TensorSpec, apply_rope
from repro_torch.models.sharding import current_rules, shard_act

QK_CHUNK = 512          # kv-chunk for the online-softmax (flash-style) path
NEG_INF = -1e30
PROD_MODEL_AXIS = 16    # production model-axis width (cache-spec decisions)
ITEM8 = "ROADMAP.md Queue 1 item 8"


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port serves the dense GQA trunk; "
        f"MoE, MLA, cross-attention, SSM and RWKV blocks wait for {ITEM8}")


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


def init_attention(mk: Maker, cfg: ModelConfig):
    if cfg.attention != "gqa":
        raise not_ported(f"attention={cfg.attention!r} ({cfg.name})")
    return init_gqa(mk, cfg)


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


def _attn_dispatch(q, k, v, q_pos, kv_pos, scale, causal, window, impl):
    T = k.shape[1]
    if impl == "auto":
        impl = "naive" if T <= 4096 else "chunked"
    if impl == "chunked":
        return _masked_attn_chunked(q, k, v, q_pos, kv_pos, scale, causal,
                                    window)
    keep = torch.ones((q.shape[1], T), dtype=torch.bool, device=q.device)
    if causal:
        keep = keep & (q_pos[:, None] >= kv_pos[None, :])
    if window:
        keep = keep & (q_pos[:, None] - kv_pos[None, :] < window)
    keep = keep & (kv_pos >= 0)[None, :]
    return _masked_attn_naive(q, k, v, keep, scale)


# --------------------------------------------------------------------------
# GQA forward
# --------------------------------------------------------------------------


def _gqa_qkv(p, cfg: ModelConfig, x, positions):
    q = torch.einsum("bsd,dkgh->bskgh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = shard_act(q, "batch", _attn_seq_axis(cfg), "kv_heads", "heads",
                  "head_dim")
    if positions is not None:          # rope (not for abs-pos stubs)
        B, S, K, G, h = q.shape
        q = apply_rope(q.reshape(B, S, K * G, h), positions, cfg.rope_theta
                       ).reshape(B, S, K, G, h)
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
    out = torch.einsum("bskgh,kghd->bsd", o, p["wo"])
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
    B = x1.shape[0]
    q = torch.einsum("bsd,dkgh->bskgh", x1, p["wq"])
    k1 = torch.einsum("bsd,dkh->bskh", x1, p["wk"])
    v1 = torch.einsum("bsd,dkh->bskh", x1, p["wv"])
    if cfg.qkv_bias:
        q, k1, v1 = q + p["bq"], k1 + p["bk"], v1 + p["bv"]
    posv = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
    K, G, h = q.shape[2], q.shape[3], q.shape[4]
    q = apply_rope(q.reshape(B, 1, K * G, h), posv,
                   cfg.rope_theta).reshape(B, 1, K, G, h)
    k1 = apply_rope(k1, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    if k.dtype != k1.dtype or v.dtype != v1.dtype:
        raise TypeError(f"cache dtype {k.dtype} / {v.dtype} differs from the "
                        f"new K/V's {k1.dtype}")
    C = k.shape[1]
    slot = pos % C if window else min(pos, C - 1)
    k[:, slot] = k1[:, 0]
    v[:, slot] = v1[:, 0]
    cache_ax = _attn_seq_axis(cfg)
    k = shard_act(k, "batch", cache_ax, "kv_heads", "head_dim")
    v = shard_act(v, "batch", cache_ax, "kv_heads", "head_dim")

    idx = torch.arange(C, device=x1.device)
    if window:
        kv_pos = pos - torch.remainder(pos - idx, C)   # ring-buffer positions
    else:
        kv_pos = torch.where(idx <= pos, idx, -1)

    scale = 1.0 / (cfg.resolved_head_dim ** 0.5)
    s = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    s = torch.where((kv_pos >= 0)[None, None, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", pattn.to(v.dtype), v)
    out = torch.einsum("bskgh,kghd->bsd", o, p["wo"])
    return out, {"k": k, "v": v}


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int, window=0):
    """The decode cache's TensorSpecs (bf16, as the reference's)."""
    C = min(seq, window) if window else seq
    hd = cfg.resolved_head_dim
    spec = TensorSpec((batch, C, cfg.n_kv_heads, hd), torch.bfloat16)
    return {"k": spec, "v": spec}


# --------------------------------------------------------------------------
# unified entry points
# --------------------------------------------------------------------------


def attention_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                      window=0, return_cache=False):
    if cfg.attention != "gqa":
        raise not_ported(f"attention={cfg.attention!r} ({cfg.name})")
    return gqa_forward(p, cfg, x, positions, causal=causal, window=window,
                       return_cache=return_cache)


def attention_decode(p, cfg: ModelConfig, x1, pos, cache, *, window=0):
    if cfg.attention != "gqa":
        raise not_ported(f"attention={cfg.attention!r} ({cfg.name})")
    return gqa_decode(p, cfg, x1, pos, cache, window=window)


def attention_cache_shape(cfg: ModelConfig, batch: int, seq: int, window=0):
    if cfg.attention != "gqa":
        raise not_ported(f"attention={cfg.attention!r} ({cfg.name})")
    return gqa_cache_shape(cfg, batch, seq, window=window)
