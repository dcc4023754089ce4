"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.
The port of `repro/models/rwkv.py`.

Decode state a layer: {"shift_t", "shift_c": (B,D), "wkv": (B,H,hd,hd)
float32}, of constant size. The WKV recurrence runs step by step in
float32, in plain PyTorch ops (the reference's is a jnp scan).

On a mesh of several ranks the products go through `sharding.contract`,
the ("embed",)-split mixing vectors and norm parameters are gathered
whole before they meet the batch-split activations, and the WKV
recurrence with its per-head group norm runs on each rank's batch rows
and heads (`_wkv_shards`): its state is split by batch and heads, as the
reference's cache spec `"stack|batch|heads||"` places it. Under autograd
the heads' u and group-norm leaves get their gradients summed over the
ranks of the batch rows, in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Maker, TensorSpec, layer_norm
from repro_torch.models.sharding import (contract, from_local_like,
                                         is_dtensor, local_of,
                                         whole_on_mesh)

DDLERP_RANK = 32
DECAY_RANK = 64
N_MIX = 5  # r, k, v, g, w


def init_rwkv6(mk: Maker, cfg: ModelConfig):
    d = cfg.d_model
    h = cfg.n_heads
    hd = cfg.resolved_head_dim
    return {
        "ln1_g": mk.ones((d,), ("embed",)), "ln1_b": mk.z((d,), ("embed",)),
        "ln2_g": mk.ones((d,), ("embed",)), "ln2_b": mk.z((d,), ("embed",)),
        # --- time mix ---
        "mu_base": mk.z((d,), ("embed",)),
        "mu": mk.z((N_MIX, d), (None, "embed")),
        "w_a1": mk.w((d, N_MIX * DDLERP_RANK), ("embed", None), fan_in=d),
        "w_a2": mk.w((N_MIX, DDLERP_RANK, d), (None, None, "embed"),
                     fan_in=DDLERP_RANK),
        "wr": mk.w((d, h, hd), ("embed", "heads", "head_dim"), fan_in=d),
        "wk": mk.w((d, h, hd), ("embed", "heads", "head_dim"), fan_in=d),
        "wv": mk.w((d, h, hd), ("embed", "heads", "head_dim"), fan_in=d),
        "wg": mk.w((d, h, hd), ("embed", "heads", "head_dim"), fan_in=d),
        "w0": mk.const(torch.zeros(d) - 4.0, ("embed",)),      # decay bias
        "ww1": mk.w((d, DECAY_RANK), ("embed", None), fan_in=d),
        "ww2": mk.w((DECAY_RANK, d), (None, "embed"), fan_in=DECAY_RANK),
        "u": mk.z((h, hd), ("heads", "head_dim")),             # bonus
        "gn_g": mk.ones((h, hd), ("heads", "head_dim")),
        "gn_b": mk.z((h, hd), ("heads", "head_dim")),
        "wo": mk.w((h, hd, d), ("heads", "head_dim", "embed"), fan_in=d),
        # --- channel mix ---
        "cmu_k": mk.z((d,), ("embed",)),
        "cmu_r": mk.z((d,), ("embed",)),
        "cwk": mk.w((d, cfg.d_ff), ("embed", "mlp"), fan_in=d),
        "cwv": mk.w((cfg.d_ff, d), ("mlp", "embed"), fan_in=cfg.d_ff),
        "cwr": mk.w((d, d), ("embed", "embed"), fan_in=d),
    }


def _ddlerp(p, x, xx):
    """Data-dependent token-shift mixes. x, xx (B,S,D) -> 5 mixed
    tensors."""
    base = x + xx * whole_on_mesh(p["mu_base"])
    a = torch.tanh(contract("bsd,dr->bsr", base, p["w_a1"]).float())
    a = a.reshape(*a.shape[:-1], N_MIX, DDLERP_RANK)
    off = contract("bsmr,mrd->bsmd", a.to(x.dtype), p["w_a2"])
    mix = whole_on_mesh(p["mu"])[None, None] + off         # (B,S,5,D)
    return [x + xx * mix[..., i, :] for i in range(N_MIX)]


def _decay(p, xw):
    lo = contract("bsd,dr->bsr", xw, p["ww1"]).float()
    w = (whole_on_mesh(p["w0"]).float()
         + contract("bsr,rd->bsd", lo, p["ww2"].float()))
    return torch.exp(-torch.exp(w))                        # (B,S,D) in (0,1)


def _group_norm(y, g, b, eps):
    """Per-head layer norm. y (B,S,H,hd)."""
    yf = y.float()
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.mean((yf - mu) ** 2, dim=-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + eps)
    return (yf * g.float() + b.float()).to(y.dtype)


def _shifted(x, shift_prev):
    """x moved one token later, shift_prev (B,D) in front."""
    return torch.cat([shift_prev[:, None], x[:, :-1]], dim=1)


def _wkv(r, k, v, w, g, u, gn_g, gn_b, wkv0, eps, dtype):
    """The WKV recurrence, the per-head group norm and the gate on plain
    tensors: r, k, v, w, g (B,S,H,hd) float32; u, gn_g, gn_b (H,hd);
    wkv0 (B,H,hd,hd) float32 or None (zeros). Returns (y (B,S,H,hd) in
    `dtype`, the last state)."""
    B, S, H, hd = r.shape
    u = u.float()
    s_wkv = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device) if wkv0 is None else wkv0)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B,H,hd,hd)
        att = s_wkv + (u * k[:, t])[..., :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhij,bhi->bhj", att, r[:, t]))
        s_wkv = w[:, t, :, :, None] * s_wkv + kv
    y = torch.stack(ys, dim=1)                             # (B,S,H,hd) f32
    y = _group_norm(y, gn_g, gn_b, eps)
    return (y.float() * g).to(dtype), s_wkv


def _wkv_shards(p, r, k, v, w, g, wkv0, eps, dtype):
    """`_wkv` on a mesh of several ranks: each rank runs its batch rows and
    heads (the mesh dims that split r along dims 0 and 2; every other
    dim whole), with its heads of u and the group norm (in float32: under
    autograd their gradients are partial sums over the rows' ranks, then
    reduced in float32), and the results are wrapped back into DTensors:
    y split as r, the state (B,H,hd,hd) by batch and heads. One rank:
    `_wkv` as it is."""
    if not is_dtensor(r):
        return _wkv(r, k, v, w, g, p["u"], p["gn_g"], p["gn_b"], wkv0, eps,
                    dtype)
    from torch.distributed.tensor import Replicate, Shard
    pls = tuple(Shard(q.dim) if q.is_shard() and q.dim in (0, 2)
                else Replicate() for q in r.placements)
    state_pls = tuple(Shard(1) if q.is_shard() and q.dim == 2 else q
                      for q in pls)
    head_pls = tuple(Shard(0) if q.is_shard() and q.dim == 2 else Replicate()
                     for q in pls)
    y, s_wkv = _wkv(*(local_of(t, pls) for t in (r, k, v, w, g)),
                    *(local_of(p[n], head_pls, out=pls, dtype=torch.float32)
                      for n in ("u", "gn_g", "gn_b")),
                    None if wkv0 is None else local_of(wkv0, state_pls),
                    eps, dtype)
    B, _, H, hd = r.shape
    dm = r.device_mesh
    return (from_local_like(y, pls, tuple(r.shape), dm),
            from_local_like(s_wkv, state_pls, (B, H, hd, hd), dm))


def _time_mix(p, cfg, x, shift_prev, wkv0):
    """x (B,S,D) post-ln; wkv0 None for a fresh sequence. Returns (out,
    last x, wkv state)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    xx = _shifted(x, shift_prev) - x
    xr, xk, xv, xg, xw = _ddlerp(p, x, xx)
    r = contract("bsd,dhe->bshe", xr, p["wr"]).float()
    k = contract("bsd,dhe->bshe", xk, p["wk"]).float()
    v = contract("bsd,dhe->bshe", xv, p["wv"]).float()
    g = F.silu(contract("bsd,dhe->bshe", xg, p["wg"]).float())
    w = _decay(p, xw).reshape(B, S, H, hd)
    y, s_wkv = _wkv_shards(p, r, k, v, w, g, wkv0, cfg.norm_eps, x.dtype)
    out = contract("bshe,hed->bsd", y, p["wo"])
    return out, x[:, -1], s_wkv


def _channel_mix(p, x, shift_prev):
    xx = _shifted(x, shift_prev) - x
    xk = x + xx * whole_on_mesh(p["cmu_k"])
    xr = x + xx * whole_on_mesh(p["cmu_r"])
    k = contract("bsd,df->bsf", xk, p["cwk"])
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = contract("bsf,fd->bsd", k, p["cwv"])
    r = torch.sigmoid(contract("bsd,de->bse", xr, p["cwr"]).float())
    return (r * kv.float()).to(x.dtype), x[:, -1]


def rwkv6_forward(p, cfg: ModelConfig, x, state=None):
    """x (B,S,D); state None (a fresh sequence) or a decode state. Returns
    (x, new state); decode is S = 1 with a state. A fresh sequence's
    shifts are zeros laid out as x's rows, and its WKV state starts at
    zeros inside `_wkv`."""
    if state is None:
        zero = torch.zeros_like(x[:, 0])
        state = {"shift_t": zero, "shift_c": zero, "wkv": None}
    h1 = layer_norm(x, p["ln1_g"], p["ln1_b"], cfg.norm_eps)
    att, sh_t, wkv = _time_mix(p, cfg, h1, state["shift_t"], state["wkv"])
    x = x + att
    h2 = layer_norm(x, p["ln2_g"], p["ln2_b"], cfg.norm_eps)
    ffn, sh_c = _channel_mix(p, h2, state["shift_c"])
    x = x + ffn
    return x, {"shift_t": sh_t, "shift_c": sh_c, "wkv": wkv}


def rwkv6_state_shape(cfg: ModelConfig, batch: int):
    """The decode state's TensorSpecs (shifts bf16, wkv float32, as the
    reference's)."""
    hd = cfg.resolved_head_dim
    shift = TensorSpec((batch, cfg.d_model), torch.bfloat16)
    return {"shift_t": shift, "shift_c": shift,
            "wkv": TensorSpec((batch, cfg.n_heads, hd, hd), torch.float32)}
