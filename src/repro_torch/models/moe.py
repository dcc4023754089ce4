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

On a mesh of several ranks (`models.sharding`) the experts split over
"model" as their params are placed: each rank routes its tokens (its
batch rows where the groups split over "data"; every token of the group
where they do not, as at decode), runs its own experts on the tokens
dispatched to them, and the combine is a partial sum over "model",
reduced in float32. The sort, gather and scatter run on local shards
(`_Shards`): DTensor has no strategy for them. Under autograd the
experts' and router's gradients are this rank's partial sums, reduced
to their placements; the routing decisions are integers and carry
none.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Maker, geglu, gelu, swiglu
from repro_torch.models.sharding import (contract, from_local_like,
                                         local_of, local_slices, on_ranks,
                                         redistribute, shard_act, whole)

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
    vals, idx, sel, probs = _route(p, cfg, x)
    return vals, idx, _aux(cfg, sel, probs)


def _aux(cfg: ModelConfig, sel, probs):
    """E * sum_e(frac_tokens_e * mean_prob_e) over the tokens given."""
    e = cfg.n_experts
    frac = sel.reshape(-1, e).mean(dim=0)
    mprob = probs.reshape(-1, e).mean(dim=0)
    return e * torch.sum(frac * mprob)


def _route(p, cfg: ModelConfig, x):
    """`_router_scores` before its aux: (vals, idx, the primary experts
    one-hot, the router probabilities)."""
    logits = torch.einsum("...d,de->...e", x, p["router"]).float()
    if cfg.name.startswith("deepseek"):
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    probs = torch.softmax(logits, dim=-1)
    sel = torch.nn.functional.one_hot(idx[..., 0], cfg.n_experts).float()
    return vals, idx, sel, probs


class _Shards:
    """This rank's share of an MoE call on a mesh of several ranks.

    `p` holds the router whole and this rank's experts (w1 / w3 / w2
    gathered over every axis but the one that splits experts, i.e. FSDP's
    "data" shards of "embed"); `e0` is its first expert; `x` the token
    rows it routes: its own batch rows where `split_batch` and the rows
    split over "data", every row otherwise. `out` makes the local combine
    a DTensor (a partial sum over the expert axes), `aux` reduces the
    load-balance statistics over the batch axes. On one rank each is the
    identity (`p`, 0, `x`)."""

    def __init__(self, p, x, split_batch: bool):
        self.ranks = on_ranks()
        if not self.ranks:
            self.p, self.e0, self.x = p, 0, x
            return
        from torch.distributed.tensor import Partial, Replicate, Shard
        self.dm = p["w1"].device_mesh
        ex = [q.is_shard() and q.dim == 0 for q in p["w1"].placements]
        ex_pls = tuple(Shard(0) if e else Replicate() for e in ex)
        rep = (Replicate(),) * len(ex)
        bt = [split_batch and not e and q.is_shard() and q.dim == 0
              for e, q in zip(ex, x.placements)]
        self.shape = tuple(x.shape)
        self.out_pls = tuple(Partial() if e else Shard(0) if b else
                             Replicate() for e, b in zip(ex, bt))
        self.p = {k: local_of(w, ex_pls if k in ("w1", "w2", "w3") else rep,
                              out=self.out_pls)
                  for k, w in p.items() if k in ("router", "w1", "w2", "w3")}
        self.e0 = local_slices(p["w1"].shape, ex_pls, self.dm)[0].start
        self.x = local_of(x, tuple(Shard(0) if b else Replicate()
                                   for b in bt), out=self.out_pls)
        # the ranks along the expert axes route the same tokens: the
        # first of them holds the load-balance statistics and the others
        # zeros, so that the router's gradient through `aux` enters the
        # partial sum over those axes once, as its gradient through
        # `out` does
        self.stat_pls = tuple(Partial() if b or e else Replicate()
                              for e, b in zip(ex, bt))
        self.stat_lead = all(self.dm.get_local_rank(i) == 0
                             for i, e in enumerate(ex) if e)

    def act(self, t, *logical):
        """`shard_act` on one rank; on several, `t` is a local shard
        already."""
        return t if self.ranks else shard_act(t, *logical)

    def out(self, y):
        """The local combine as a DTensor, its partial sums over the
        expert axes reduced in float32 (`sharding.contract`'s reason)."""
        if not self.ranks:
            return y
        from torch.distributed.tensor import Replicate
        out = from_local_like(y.float(), self.out_pls, self.shape, self.dm)
        return redistribute(out, tuple(
            Replicate() if p.is_partial() else p for p in self.out_pls)
        ).to(y.dtype)

    def aux(self, cfg, sel, probs):
        """The load-balance aux over every token of the batch."""
        if not self.ranks:
            return _aux(cfg, sel, probs)
        e = cfg.n_experts
        n = sel.reshape(-1, e).shape[0]
        sums = torch.stack([sel.reshape(-1, e).sum(dim=0),
                            probs.reshape(-1, e).sum(dim=0),
                            torch.full((e,), float(n), device=sel.device)])
        if not self.stat_lead:
            sums = torch.zeros_like(sums)
        sums = whole(from_local_like(sums, self.stat_pls, (3, e), self.dm))
        return e * torch.sum((sums[0] / sums[2]) * (sums[1] / sums[2]))


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
    sh = _Shards(p, x, split_batch=S > 1)
    xl = sh.x
    if S == 1:
        out, sel, probs = _moe_coo_grouped(sh, cfg, xl.reshape(
            1, xl.shape[0], D), xl.shape[0])
        out = out.reshape(xl.shape[0], S, D)
    else:
        out, sel, probs = _moe_coo_grouped(sh, cfg, xl, S)
    return sh.out(out), sh.aux(cfg, sel, probs)


def _moe_coo_grouped(sh: _Shards, cfg, xg, S):
    """The COO dispatch of groups xg (G,S,D) through this rank's experts
    (all of them on one rank); returns (the combine (G,S,D), the router's
    one-hot and probabilities)."""
    p = sh.p
    G, _, D = xg.shape
    E = cfg.n_experts
    C = capacity(cfg, S)
    vals, idx, sel, probs = _route(p, cfg, xg)
    buf, wbuf = _route_one_group(idx, vals, S, E, C)    # (G,E,C)
    El = p["w1"].shape[0]
    buf, wbuf = buf[:, sh.e0:sh.e0 + El], wbuf[:, sh.e0:sh.e0 + El]
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    x_pad = sh.act(x_pad, "batch", "seq", None)
    xin = torch.gather(x_pad, 1, buf.reshape(G, El * C, 1).expand(
        G, El * C, D)).reshape(G, El, C, D)
    xin = sh.act(xin, "batch", "experts", "cap", None)
    y = _expert_ffn(p, cfg, xin)                        # (G,El,C,D)
    del xin                 # (G, E, C, D) each: at full width, GBs apiece
    y = y * wbuf[..., None].to(y.dtype)
    # combine: scatter-add into (G, S+1, D); row S (the empty slots) is
    # discarded
    rows = (buf + torch.arange(G, device=xg.device)[:, None, None]
            * (S + 1)).reshape(-1)
    out = y.new_zeros((G * (S + 1), D)).index_add_(0, rows,
                                                   y.reshape(-1, D))
    out = sh.act(out.reshape(G, S + 1, D), "batch", "seq", None)
    return out[:, :S], sel, probs


# --------------------------------------------------------------------------
# Bitmap mode: dense-masked (all experts), chunked over the sequence
# --------------------------------------------------------------------------


def moe_forward_bitmap(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Every token of a chunk through every expert (`_expert_ffn` on the
    chunk's tokens broadcast over the experts, so no expert weight is
    copied), weighted by the dense gate matrix: the "bitmap" with
    weights, zero where a token does not route."""
    sh = _Shards(p, x, split_batch=True)
    xl = sh.x
    B, S, D = xl.shape
    E = cfg.n_experts
    El = sh.p["w1"].shape[0]
    vals, idx, sel, probs = _route(sh.p, cfg, xl)       # (B,S,k)
    gates = torch.zeros((B, S, E), dtype=torch.float32,
                        device=xl.device).scatter_(-1, idx, vals)
    gates = gates[..., sh.e0:sh.e0 + El]
    out = []
    step = min(BITMAP_CHUNK, S)
    for c0 in range(0, S, step):
        xj = xl[:, c0:c0 + step].reshape(-1, D)         # (B*Cc, D)
        gj = gates[:, c0:c0 + step].reshape(-1, El)
        ye = _expert_ffn(sh.p, cfg, xj.expand(El, *xj.shape))  # (El,B*Cc,D)
        out.append(torch.einsum("emd,me->md", ye, gj.to(ye.dtype))
                   .reshape(B, -1, D))
    return sh.out(torch.cat(out, dim=1)), sh.aux(cfg, sel, probs)


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
        h1 = contract("bsd,df->bsf", x, p["sw1"])
        h3 = (contract("bsd,df->bsf", x, p["sw3"]) if "sw3" in p
              else None)
        out = out + contract("bsf,fd->bsd", _act(cfg, h1, h3), p["sw2"])
    return out, aux
