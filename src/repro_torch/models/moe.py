"""Mixture-of-Experts with RT-NeRF-style hybrid sparse dispatch: the port of
`repro/models/moe.py`.

The paper encodes a sparse factor as a bitmap below 80% sparsity and as
COO at or above it. The token -> expert assignment matrix is such a
factor, with sparsity 1 - top_k / E, so there are two dispatch modes:

  "coo"    sort/gather dispatch, grouped by sequence (decode: the batch's
           tokens form one group), with a per-expert capacity; the
           assignments past it are dropped.
  "bitmap" dense-masked: every token through every expert, the gate
           weights zeroing the unrouted pairs, in chunks of BITMAP_CHUNK
           tokens.

`cfg.resolved_dispatch()` picks the mode by the 80% rule unless
`cfg.moe_dispatch` names one. The two agree up to capacity drops. Both are
plain PyTorch products (the reference computes them in jnp, outside any
Pallas kernel).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Maker, geglu, gelu, swiglu
from repro_torch.models.sharding import shard_act

BITMAP_CHUNK = 256          # tokens per chunk in dense-masked mode


def init_moe(mk: Maker, cfg: ModelConfig):
    d = cfg.d_model
    dff = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    p = {
        "router": mk.w((d, e), ("embed", "experts"), fan_in=d),
        "w1": mk.w((e, d, dff), ("experts", "embed", "mlp"), fan_in=d),
        "w2": mk.w((e, dff, d), ("experts", "mlp", "embed"), fan_in=dff),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = mk.w((e, d, dff), ("experts", "embed", "mlp"), fan_in=d)
    if cfg.n_shared_experts:
        sdff = dff * cfg.n_shared_experts
        p["sw1"] = mk.w((d, sdff), ("embed", "mlp"), fan_in=d)
        p["sw2"] = mk.w((sdff, d), ("mlp", "embed"), fan_in=sdff)
        if cfg.act in ("swiglu", "geglu"):
            p["sw3"] = mk.w((d, sdff), ("embed", "mlp"), fan_in=d)
    return p


def _act(cfg: ModelConfig, h1, h3=None):
    """The gated activation (swiglu / geglu) with an up projection, else
    the tanh gelu in float32, cast back."""
    if h3 is not None:
        return (geglu if cfg.act == "geglu" else swiglu)(h1, h3)
    return gelu(h1.float()).to(h1.dtype)


def _expert_ffn(p, cfg: ModelConfig, xin):
    """xin (..., E, C, D) -> (..., E, C, D), batched over experts."""
    h1 = torch.einsum("...ecd,edf->...ecf", xin, p["w1"])
    h3 = (torch.einsum("...ecd,edf->...ecf", xin, p["w3"]) if "w3" in p
          else None)
    return torch.einsum("...ecf,efd->...ecd", _act(cfg, h1, h3), p["w2"])


def _router_scores(p, cfg: ModelConfig, x):
    """x (..., D) -> (vals, idx, aux): the top-k gates renormalised, and the
    switch load-balance aux E * sum_e(frac_tokens_e * mean_prob_e).

    Gates are sigmoids for DeepSeek, softmax otherwise. Among equal
    scores the lower expert index comes first, as in `jax.lax.top_k`
    (`torch.topk` orders ties otherwise; a stable descending sort does
    not)."""
    logits = torch.einsum("...d,de->...e", x, p["router"]).float()
    if cfg.name.startswith("deepseek"):
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    probs = torch.softmax(logits, dim=-1)
    e = cfg.n_experts
    sel = torch.nn.functional.one_hot(idx[..., 0], e).float()  # primary
    frac = sel.reshape(-1, e).mean(dim=0)
    mprob = probs.reshape(-1, e).mean(dim=0)
    aux = e * torch.sum(frac * mprob)
    return vals, idx, aux


# --------------------------------------------------------------------------
# COO mode: sort/gather dispatch, grouped per sequence
# --------------------------------------------------------------------------


def _route_one_group(idx, vals, S: int, E: int, C: int):
    """idx/vals (..., S, k) -> buf (..., E, C), the token index in each
    expert's slots (S = empty), and wbuf (..., E, C), its gate. Each
    leading index is a group of its own (the reference vmaps over them).

    The assignments are sorted by expert, stably, so an expert's slots
    take its tokens in token order; those past slot C-1 are dropped
    (written to a row E that is discarded)."""
    lead = idx.shape[:-2]
    k = idx.shape[-1]
    dev = idx.device
    e_flat = idx.reshape(-1, S * k)
    w_flat = vals.reshape(-1, S * k)
    G = e_flat.shape[0]
    t_flat = torch.arange(S, dtype=torch.int64, device=dev).repeat_interleave(
        k).expand(G, S * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_s = torch.gather(e_flat, 1, order)
    t_s = torch.gather(t_flat, 1, order)
    w_s = torch.gather(w_flat, 1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    posn = (torch.arange(S * k, device=dev)[None]
            - torch.gather(starts, 1, e_s))
    e_tgt = torch.where(posn < C, e_s, E)              # row E = drop
    p_tgt = torch.clamp(posn, 0, C - 1)
    g = torch.arange(G, device=dev)[:, None].expand(G, S * k)
    buf = torch.full((G, E + 1, C), S, dtype=torch.int64, device=dev)
    buf[g, e_tgt, p_tgt] = t_s
    wbuf = torch.zeros((G, E + 1, C), dtype=w_flat.dtype, device=dev)
    wbuf[g, e_tgt, p_tgt] = w_s
    return (buf[:, :E].reshape(*lead, E, C),
            wbuf[:, :E].reshape(*lead, E, C))


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert in a group of S tokens."""
    return max(int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
               cfg.top_k)


def moe_forward_coo(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x (B,S,D). Groups are sequences; at decode (S == 1) the B tokens
    form one group."""
    B, S, D = x.shape
    if S == 1:
        out, aux = _moe_coo_grouped(p, cfg, x.reshape(1, B, D), B)
        return out.reshape(B, S, D), aux
    return _moe_coo_grouped(p, cfg, x, S)


def _moe_coo_grouped(p, cfg, xg, S):
    G, _, D = xg.shape
    E = cfg.n_experts
    C = capacity(cfg, S)
    vals, idx, aux = _router_scores(p, cfg, xg)
    buf, wbuf = _route_one_group(idx, vals, S, E, C)    # (G,E,C)
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    x_pad = shard_act(x_pad, "batch", "seq", None)
    xin = torch.gather(x_pad, 1, buf.reshape(G, E * C, 1).expand(
        G, E * C, D)).reshape(G, E, C, D)
    xin = shard_act(xin, "batch", "experts", "cap", None)
    y = _expert_ffn(p, cfg, xin)                        # (G,E,C,D)
    del xin                 # (G, E, C, D) each: at full width, GBs apiece
    y = y * wbuf[..., None].to(y.dtype)
    # combine: scatter-add into (G, S+1, D); row S (the empty slots) is
    # discarded
    rows = (buf + torch.arange(G, device=xg.device)[:, None, None]
            * (S + 1)).reshape(-1)
    out = y.new_zeros((G * (S + 1), D)).index_add_(0, rows,
                                                   y.reshape(-1, D))
    out = shard_act(out.reshape(G, S + 1, D), "batch", "seq", None)
    return out[:, :S], aux


# --------------------------------------------------------------------------
# Bitmap mode: dense-masked (all experts), chunked over the sequence
# --------------------------------------------------------------------------


def moe_forward_bitmap(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Every token of a chunk through every expert (`_expert_ffn` on the
    chunk's tokens broadcast over the experts, so no expert weight is
    copied), weighted by the dense gate matrix: the "bitmap" with
    weights, zero where a token does not route."""
    B, S, D = x.shape
    E = cfg.n_experts
    vals, idx, aux = _router_scores(p, cfg, x)          # (B,S,k)
    gates = torch.zeros((B, S, E), dtype=torch.float32,
                        device=x.device).scatter_(-1, idx, vals)
    out = []
    step = min(BITMAP_CHUNK, S)
    for c0 in range(0, S, step):
        xj = x[:, c0:c0 + step].reshape(-1, D)          # (B*Cc, D)
        gj = gates[:, c0:c0 + step].reshape(-1, E)
        ye = _expert_ffn(p, cfg, xj.expand(E, *xj.shape))   # (E,B*Cc,D)
        out.append(torch.einsum("emd,me->md", ye, gj.to(ye.dtype))
                   .reshape(B, -1, D))
    return torch.cat(out, dim=1), aux


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def moe_forward(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    mode = cfg.resolved_dispatch()
    out, aux = (moe_forward_coo if mode == "coo" else moe_forward_bitmap)(
        p, cfg, x)
    if cfg.moe_out_shard:
        out = shard_act(out, "batch", "seq", None)
    if cfg.n_shared_experts:
        h1 = torch.einsum("bsd,df->bsf", x, p["sw1"])
        h3 = (torch.einsum("bsd,df->bsf", x, p["sw3"]) if "sw3" in p
              else None)
        out = out + torch.einsum("bsf,fd->bsd", _act(cfg, h1, h3), p["sw2"])
    return out, aux
