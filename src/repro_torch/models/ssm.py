"""Mamba2 (SSD) block, zamba2's trunk: the port of `repro/models/ssm.py`.

`impl="scan"` is the per-step recurrence; `impl="chunked"` is the
chunk-parallel SSD form (a decay-weighted quadratic form within each
chunk of SSD_CHUNK steps, the state carried across chunks). The tests
hold each against the other and against the reference. Both are plain
PyTorch ops (the reference computes them in jnp).

State: h (B, nH, hd, N) float32; conv (B, conv_w - 1, conv channels).

On a mesh of several ranks (`_Shards`) the in- and out-projections go
through `sharding.contract`, and the rest of a block runs on each rank's
batch rows. The in-projection's output is gathered whole over the
"model" axis before it is cut into its z / x / B / C / dt segments (a
"model" split of `in_proj`'s columns falls inside a segment); the causal
conv runs on the rank's own channels of `conv_w` (the conv state stays
split by channels, as the reference's cache spec `"...|batch||mlp"`
places it) and its output is gathered; the scan, whose state h the
reference's spec keeps whole over "model", runs on every head; and the
gated norm's gain multiplies the rank's columns of `out_proj`'s split
only, so that the out-projection's partial sums need no gather first.
Under autograd (the train step) every piece a rank takes whole over the
norm's column axes (the projection, the per-head leaves, the gathered
conv output) has a partial gradient there, as the rank goes on with its
own columns only (`local_of(out=)`, `_Shards.out`); those pieces are
taken in float32, so that their partial sums are reduced in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Maker, TensorSpec
from repro_torch.models.sharding import (contract, from_local_like,
                                         is_dtensor, local_of, local_slices)

SSD_CHUNK = 128


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_state
    return d_in, nh, conv_ch


def init_mamba2(mk: Maker, cfg: ModelConfig):
    d = cfg.d_model
    d_in, nh, conv_ch = ssm_dims(cfg)
    n = cfg.ssm_state
    return {
        "in_proj": mk.w((d, 2 * d_in + 2 * n + nh), ("embed", "mlp"),
                        fan_in=d),
        "conv_w": mk.w((cfg.ssm_conv, conv_ch), (None, "mlp"),
                       fan_in=cfg.ssm_conv),
        "conv_b": mk.z((conv_ch,), ("mlp",)),
        "a_log": mk.const(torch.zeros(nh) + 0.5, (None,)),
        "d_skip": mk.ones((nh,), (None,)),
        "dt_bias": mk.z((nh,), (None,)),
        "norm": mk.ones((d_in,), ("mlp",)),
        "out_proj": mk.w((d_in, d), ("mlp", "embed"), fan_in=d_in),
    }


def _split_proj(p, cfg, zxbcdt):
    d_in, nh, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xs = zxbcdt[..., d_in:2 * d_in]
    b = zxbcdt[..., 2 * d_in:2 * d_in + n]
    c = zxbcdt[..., 2 * d_in + n:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, xs, b, c, dt


def _causal_conv(xbc, w, bias, conv_state=None):
    """Depthwise causal conv. xbc (B,S,C); w (K,C). Returns (y, new_state),
    the state the last K-1 inputs."""
    K = w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    else:
        pad = conv_state
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(K)) + bias
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return F.silu(y.float()).to(xbc.dtype), new_state


def _gated(y, z, eps):
    """The gated RMS norm before its gain, in float32."""
    yf = y.float() * F.silu(z.float())
    return yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)


def _gated_norm(y, z, gamma, eps):
    return (_gated(y, z, eps) * gamma.float()).to(y.dtype)


class _Shards:
    """This rank's share of a Mamba2 block on a mesh of several ranks.

    `proj` is the in-projection's output on this rank's batch rows (the
    mesh dims that split its dim 0), whole along every other dim (float32
    under autograd); `p` holds the replicated per-head leaves (a_log,
    d_skip, dt_bias), and
    `state` gives a decode state's leaf on those rows. `conv` runs the
    causal conv on the rank's channels and gathers its output, `norm`
    returns the gated norm on the rank's columns of the out-projection
    (a DTensor), `wrap` makes a local state leaf a DTensor. On one rank
    each is the plain computation on `p` and the projection itself."""

    def __init__(self, p, zxbcdt):
        self.ranks = is_dtensor(zxbcdt)
        self.w = p
        if not self.ranks:
            self.p, self.proj = p, zxbcdt
            return
        from torch.distributed.tensor import Partial, Replicate, Shard
        self.dm = zxbcdt.device_mesh
        self.B, self.S = zxbcdt.shape[:2]
        self.rows = tuple(Shard(0) if q.is_shard() and q.dim == 0
                          else Replicate() for q in zxbcdt.placements)
        # what the ranks compute from a shard whole over their columns:
        # their rows, and, over the mesh dims that split the gated norm's
        # columns, results that differ (each rank goes on with its own
        # columns only), so that a gradient there is a partial sum
        self.out = tuple(Partial() if q.is_shard() and r.is_replicate()
                         else r
                         for r, q in zip(self.rows, p["norm"].placements))
        # under autograd the pieces whose gradients are partial sums are
        # taken in float32 (each use widens them anyway, or the conv casts
        # its input back), so that those sums are reduced in float32 and
        # round once, as on one device
        self.dtype = zxbcdt.dtype
        self.wide = torch.float32 if torch.is_grad_enabled() else None
        self.proj = local_of(zxbcdt, self.rows, out=self.out,
                             dtype=self.wide)
        self.p = {k: local_of(p[k], (Replicate(),) * self.dm.ndim,
                              out=self.out, dtype=self.wide)
                  for k in ("a_log", "d_skip", "dt_bias")}

    def _cols(self, leaf):
        """(placements of a (B, S, C) activation whose C splits as the
        1-D or last dim of `leaf`, placements of `leaf`, this rank's
        slice of C)."""
        from torch.distributed.tensor import Replicate, Shard
        act, own = [], []
        for q, r in zip(leaf.placements, self.rows):
            if q.is_shard() and r.is_shard():
                raise ValueError("a mesh axis splits both the batch and "
                                 "the channels of a Mamba2 block")
            act.append(Shard(2) if q.is_shard() else r)
            own.append(Shard(leaf.dim() - 1) if q.is_shard() else Replicate())
        C = leaf.shape[-1]
        cut = local_slices((self.B, self.S, C), act, self.dm)[2]
        return tuple(act), tuple(own), cut

    def state(self, t):
        return local_of(t, self.rows) if self.ranks else t

    def wrap(self, t):
        if not self.ranks:
            return t
        return from_local_like(t, self.rows, (self.B,) + tuple(t.shape[1:]),
                               self.dm)

    def conv(self, xbc, conv_state):
        """(conv output whole over channels, new conv state: on a mesh the
        rank's channels, a DTensor split as `conv_b`)."""
        if not self.ranks:
            return _causal_conv(xbc, self.w["conv_w"], self.w["conv_b"],
                                conv_state)
        from torch.distributed.tensor import Shard
        act, own, cut = self._cols(self.w["conv_b"])
        w_own = tuple(Shard(1) if q.is_shard() else q for q in own)
        y, st = _causal_conv(
            xbc[..., cut].to(self.dtype),
            local_of(self.w["conv_w"], w_own, out=act),
            local_of(self.w["conv_b"], own, out=act),
            None if conv_state is None else local_of(conv_state, act))
        C = xbc.shape[-1]
        y = local_of(from_local_like(y, act, (self.B, y.shape[1], C),
                                     self.dm), self.rows, out=self.out,
                     dtype=self.wide)
        return y, from_local_like(st, act, (self.B, st.shape[1], C),
                                  self.dm)

    def norm(self, y, z, eps):
        if not self.ranks:
            return _gated_norm(y, z, self.w["norm"], eps)
        act, own, cut = self._cols(self.w["norm"])
        g = local_of(self.w["norm"], own, out=act, dtype=self.wide)
        yl = (_gated(y, z, eps)[..., cut] * g.float()).to(y.dtype)
        return from_local_like(yl, act, (self.B, y.shape[1], y.shape[-1]),
                               self.dm)


def _ssm_inputs(p, cfg, x, conv_state=None):
    """The in-projection, conv and discretisation shared by forward and
    decode: (the block's `_Shards`, z, xh (B,S,nh,hd), b, c (B,S,n), dt,
    da (B,S,nh) float32, conv state), each on this rank's rows."""
    d_in, nh, _ = ssm_dims(cfg)
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    sh = _Shards(p, contract("bsd,de->bse", x, p["in_proj"]))
    z, xs, b, c, dt_raw = _split_proj(p, cfg, sh.proj)
    xbc, conv_state = sh.conv(torch.cat([xs, b, c], dim=-1), conv_state)
    xs, b, c = xbc[..., :d_in], xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + sh.p["dt_bias"].float())
    da = torch.exp(-torch.exp(sh.p["a_log"].float()) * dt)       # (B,S,nh)
    B, S = xs.shape[:2]
    return sh, z, xs.reshape(B, S, nh, hd), b, c, dt, da, conv_state


def _ssm_output(p, sh, cfg, dtype, y, xh, z):
    """The skip, gated norm and out-projection. y, xh (B,S,nh,hd)."""
    B, S = xh.shape[:2]
    y = y + sh.p["d_skip"].float()[:, None] * xh.float()
    y = y.reshape(B, S, -1).to(dtype)
    return contract("bse,ed->bsd", sh.norm(y, z, cfg.norm_eps),
                    p["out_proj"])


def _ssd_scan(xh, b, c, dt, da):
    """The per-step recurrence h_t = da_t h_{t-1} + dt_t x_t b_t^T,
    y_t = h_t c_t, in float32. Returns (y (B,S,nh,hd), h_last)."""
    B, S, nh, hd = xh.shape
    xf, bf, cf = xh.float(), b.float(), c.float()
    h = torch.zeros((B, nh, hd, b.shape[-1]), dtype=torch.float32,
                    device=xh.device)
    ys = []
    for t in range(S):
        u = (dt[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, None, None]
        h = h * da[:, t, :, None, None] + u
        ys.append(torch.einsum("bhdn,bn->bhd", h, cf[:, t]))
    return torch.stack(ys, dim=1), h


def mamba2_forward(p, cfg: ModelConfig, x, *, impl: str = "scan"):
    """Train/prefill. x (B,S,D) -> (y, final state {"h", "conv"})."""
    sh, z, xh, b, c, dt, da, conv_state = _ssm_inputs(p, cfg, x)
    if impl == "chunked":
        y, h_last = _ssd_chunked(xh, b, c, dt, da)
    else:
        y, h_last = _ssd_scan(xh, b, c, dt, da)
    out = _ssm_output(p, sh, cfg, x.dtype, y, xh, z)
    return out, {"h": sh.wrap(h_last.float()), "conv": conv_state}


def _ssd_chunked(xh, b, c, dt, da):
    """Chunk-parallel SSD. xh (B,S,nh,hd); b,c (B,S,n); dt,da (B,S,nh)
    float32. Within a chunk, y_intra from a decay-weighted quadratic
    form; across chunks, h carried with the chunk's decay. The last
    chunk is padded to SSD_CHUNK steps with da = 1 and zero inputs, as in
    the reference."""
    B, S, nh, hd = xh.shape
    n = b.shape[-1]
    C = min(SSD_CHUNK, S)
    pad = -S % C

    def padded(t, value=0.0):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)

    xf, bf, cf = padded(xh.float()), padded(b.float()), padded(c.float())
    dtp, dap = padded(dt), padded(da, 1.0)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=xh.device))
    h = torch.zeros((B, nh, hd, n), dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, S + pad, C):
        xj, bj, cj = xf[:, c0:c0 + C], bf[:, c0:c0 + C], cf[:, c0:c0 + C]
        dtj, daj = dtp[:, c0:c0 + C], dap[:, c0:c0 + C]
        cum = torch.cumsum(torch.log(torch.clamp(daj, min=1e-38)), dim=1)
        # intra-chunk: y[t] = sum_{s<=t} exp(cum_t - cum_s) dt_s (c_t.b_s) x_s
        w = cum[:, :, None, :] - cum[:, None, :, :]              # (B,C,C,nh)
        g = torch.where(mask[None, :, :, None], torch.exp(w), 0.0)
        cb = torch.einsum("btn,bsn->bts", cj, bj)                # (B,C,C)
        m = cb[:, :, :, None] * g * dtj[:, None, :, :]           # (B,C,C,nh)
        y_intra = torch.einsum("btsh,bshd->bthd", m, xj)
        # inter-chunk: the carried state's contribution
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bhdn,btn->bthd", h, cj)
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)           # (B,C,nh)
        hb = torch.einsum("bth,bthd,btn->bhdn", dtj * decay_to_end, xj, bj)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + hb
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba2_decode(p, cfg: ModelConfig, x1, state) -> Tuple[torch.Tensor,
                                                           dict]:
    """One token. x1 (B,1,D); state {"h", "conv"}; returns (y, new
    state)."""
    sh, z, xh, b, c, dt, da, conv_state = _ssm_inputs(p, cfg, x1,
                                                      state["conv"])
    xt = xh[:, 0].float()
    h = (sh.state(state["h"]) * da[:, 0, :, None, None]
         + (dt[:, 0, :, None] * xt)[..., None] * b[:, 0].float()[:, None,
                                                                None, :])
    y = torch.einsum("bhdn,bn->bhd", h, c[:, 0].float())
    out = _ssm_output(p, sh, cfg, x1.dtype, y[:, None], xh, z)
    return out, {"h": sh.wrap(h), "conv": conv_state}


def mamba2_state_shape(cfg: ModelConfig, batch: int):
    """The decode state's TensorSpecs (h float32, conv bf16, as the
    reference's)."""
    _, nh, conv_ch = ssm_dims(cfg)
    return {"h": TensorSpec((batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                            torch.float32),
            "conv": TensorSpec((batch, cfg.ssm_conv - 1, conv_ch),
                               torch.bfloat16)}
