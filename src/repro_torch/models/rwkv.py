"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.
The port of `repro/models/rwkv.py`.

Decode state a layer: {"shift_t", "shift_c": (B,D), "wkv": (B,H,hd,hd)
float32}, of constant size. The WKV recurrence runs step by step in
float32, in plain PyTorch ops (the reference's is a jnp scan).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Maker, TensorSpec, layer_norm

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
    base = x + xx * p["mu_base"]
    a = torch.tanh(torch.einsum("bsd,dr->bsr", base, p["w_a1"]).float())
    a = a.reshape(*a.shape[:-1], N_MIX, DDLERP_RANK)
    off = torch.einsum("bsmr,mrd->bsmd", a.to(x.dtype), p["w_a2"])
    mix = p["mu"][None, None] + off                        # (B,S,5,D)
    return [x + xx * mix[..., i, :] for i in range(N_MIX)]


def _decay(p, xw):
    w = p["w0"].float() + torch.einsum(
        "bsd,dr->bsr", xw, p["ww1"]).float() @ p["ww2"].float()
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


def _time_mix(p, cfg, x, shift_prev, wkv0):
    """x (B,S,D) post-ln. Returns (out, last x, wkv state)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    xx = _shifted(x, shift_prev) - x
    xr, xk, xv, xg, xw = _ddlerp(p, x, xx)
    r = torch.einsum("bsd,dhe->bshe", xr, p["wr"]).float()
    k = torch.einsum("bsd,dhe->bshe", xk, p["wk"]).float()
    v = torch.einsum("bsd,dhe->bshe", xv, p["wv"]).float()
    g = F.silu(torch.einsum("bsd,dhe->bshe", xg, p["wg"]).float())
    w = _decay(p, xw).reshape(B, S, H, hd)
    u = p["u"].float()
    s_wkv = wkv0
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B,H,hd,hd)
        att = s_wkv + (u * k[:, t])[..., :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhij,bhi->bhj", att, r[:, t]))
        s_wkv = w[:, t, :, :, None] * s_wkv + kv
    y = torch.stack(ys, dim=1)                             # (B,S,H,hd) f32
    y = _group_norm(y, p["gn_g"], p["gn_b"], cfg.norm_eps)
    y = (y.float() * g).to(x.dtype)
    out = torch.einsum("bshe,hed->bsd", y, p["wo"])
    return out, x[:, -1], s_wkv


def _channel_mix(p, x, shift_prev):
    xx = _shifted(x, shift_prev) - x
    xk = x + xx * p["cmu_k"]
    xr = x + xx * p["cmu_r"]
    k = torch.einsum("bsd,df->bsf", xk, p["cwk"])
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = torch.einsum("bsf,fd->bsd", k, p["cwv"])
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["cwr"]).float())
    return (r * kv.float()).to(x.dtype), x[:, -1]


def rwkv6_forward(p, cfg: ModelConfig, x, state=None):
    """x (B,S,D); state None (a fresh sequence) or a decode state. Returns
    (x, new state); decode is S = 1 with a state."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    if state is None:
        state = {"shift_t": x.new_zeros((B, D)),
                 "shift_c": x.new_zeros((B, D)),
                 "wkv": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                    device=x.device)}
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
