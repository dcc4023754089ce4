"""Shared building blocks: the port of `repro/models/common.py`.

Parameters are built as `PL(tensor, logical)` pairs, one source for the
value tree and the logical-axis tree (`models.sharding` resolves the
axes); `split_pl` separates them. Trees are nested dicts (None leaves
stay None), keyed as the reference's pytrees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# Param-with-logical-axes leaves
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PL:
    """A parameter leaf: value + logical axis names."""
    arr: Any
    logical: Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype without its data (the reference's
    `jax.ShapeDtypeStruct`)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def is_pl(x) -> bool:
    return isinstance(x, PL)


def log_str(logical: Tuple[Optional[str], ...]) -> str:
    """Logical axes as one '|'-joined string (the reference keeps strings
    as leaves so the logical tree has the param tree's structure)."""
    return "|".join(a or "" for a in logical)


def log_parse(s: str) -> Tuple[Optional[str], ...]:
    return tuple(a if a else None for a in s.split("|")) if s else ()


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts (and of the trees in `rest`,
    which share `tree`'s structure); None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def split_pl(tree):
    """(params, logical) trees from a tree of PL leaves."""
    return (tree_map(lambda leaf: leaf.arr, tree),
            tree_map(lambda leaf: log_str(leaf.logical), tree))


class Maker:
    """Deterministic param factory with fan-in init. Draws are standard
    normals from `generator` in float32 (on the generator's device: a CPU
    generator gives the same model on every device), times
    scale / sqrt(fan_in), cast to `dtype`, then moved to `device`."""

    def __init__(self, generator: torch.Generator, dtype=torch.bfloat16,
                 device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device("cpu") if device is None else device

    def _put(self, arr: torch.Tensor) -> torch.Tensor:
        return arr.to(self.dtype).to(self.device)

    def w(self, shape: Sequence[int], logical: Sequence[Optional[str]],
          fan_in: Optional[int] = None, scale: float = 1.0) -> PL:
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical {logical}")
        fi = fan_in if fan_in is not None else shape[0]
        std = scale / math.sqrt(max(fi, 1))
        arr = torch.randn(tuple(shape), generator=self.generator,
                          dtype=torch.float32,
                          device=self.generator.device) * std
        return PL(self._put(arr), tuple(logical))

    def z(self, shape: Sequence[int], logical: Sequence[Optional[str]]) -> PL:
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical {logical}")
        return PL(torch.zeros(tuple(shape), dtype=self.dtype,
                              device=self.device), tuple(logical))

    def ones(self, shape: Sequence[int],
             logical: Sequence[Optional[str]]) -> PL:
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical {logical}")
        return PL(torch.ones(tuple(shape), dtype=self.dtype,
                             device=self.device), tuple(logical))

    def const(self, value, logical: Sequence[Optional[str]]) -> PL:
        return PL(self._put(torch.as_tensor(value)), tuple(logical))


class MetaMaker(Maker):
    """A Maker that draws nothing: every leaf is an uninitialised tensor on
    the meta device, of the shape and dtype the drawn one would have (the
    full trees of the largest archs in seconds, with no memory)."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__(None, dtype=dtype, device=torch.device("meta"))

    def w(self, shape: Sequence[int], logical: Sequence[Optional[str]],
          fan_in: Optional[int] = None, scale: float = 1.0) -> PL:
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical {logical}")
        return PL(torch.empty(tuple(shape), dtype=self.dtype,
                              device=self.device), tuple(logical))


# --------------------------------------------------------------------------
# Numerics (each follows the reference's float32 upcasts and casts back)
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    if type(gamma) is not torch.Tensor:
        # a DTensor gain split over "data" (FSDP's "embed") is gathered
        # here, not inside the product (`sharding.redistribute`), in
        # float32: its gradient, a sum over the ranks' rows, is then
        # reduced in float32 and rounded to the gain's dtype once, as on
        # one device
        from repro_torch.models.sharding import whole_on_mesh
        gamma = whole_on_mesh(gamma.float())
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    if type(gamma) is not torch.Tensor:
        # DTensor gain and bias gathered as `rms_norm`'s gain is
        from repro_torch.models.sharding import whole_on_mesh
        gamma, beta = whole_on_mesh(gamma.float()), whole_on_mesh(
            beta.float())
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean((h - mu) ** 2, dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * gamma.float() + beta.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate.float()).to(x_gate.dtype) * x_up


def geglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return gelu(x_gate.float()).to(x_gate.dtype) * x_up


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               heads: int = 1) -> torch.Tensor:
    """x (..., S, <heads dims>, hd) rotated by halves (x1 = first half,
    x2 = second, not interleaved pairs); positions (..., S); float32
    angles. `heads` counts the head dims after S (2 for the grouped
    (K, G) layout), so that no head dim is merged: on a mesh either may
    be the sharded one. `positions` may be a plain tensor beside a
    DTensor `x` (`sharding.mesh_context`)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=positions.device)    # (hd/2,)
    ang = positions[..., None].float() * inv                # (..., S, hd/2)
    lead = ang.shape[:-1] + (1,) * heads + ang.shape[-1:]
    cos = torch.cos(ang).reshape(lead)                      # (..., S, 1.., hd/2)
    sin = torch.sin(ang).reshape(lead)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (..., V) any float dtype, labels (...)
    integer."""
    logits = logits.float()
    if type(logits) is torch.Tensor:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
    else:
        # a DTensor on a mesh of several ranks: each token's loss from the
        # ranks' columns (`token_nll`), then whole on every rank
        from repro_torch.models.sharding import token_nll, whole
        nll = whole(token_nll(logits, labels))
        mask = whole(mask) if mask is not None else None
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def positional_encoding(x: torch.Tensor, n_bands: int) -> torch.Tensor:
    """NeRF-style PE: concat(x, sin/cos(2^i x))."""
    outs = [x]
    for i in range(n_bands):
        outs.append(torch.sin((2.0 ** i) * x))
        outs.append(torch.cos((2.0 ** i) * x))
    return torch.cat(outs, dim=-1)
