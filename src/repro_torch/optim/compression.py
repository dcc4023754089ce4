"""Gradient compression for exchanges across the data axis: the port of
`repro/optim/compression.py`. Top-k sparsification is the paper's COO
insight on gradients (at high sparsity, (index, value) streams beat a
dense exchange) with the residual kept for error feedback; int8
quantization is the bitmap regime's analogue (dense but narrow)."""
from __future__ import annotations

from typing import Tuple

import torch


def compress_topk(g: torch.Tensor, frac: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the top `frac` entries by magnitude. Returns (idx int32, vals
    float32, residual float32 of g's shape). Among equal magnitudes the
    lower index comes first, as in `jax.lax.top_k` (`torch.topk` orders
    ties otherwise; a stable descending sort does not)."""
    flat = g.reshape(-1).to(torch.float32)
    k = max(int(flat.shape[0] * frac), 1)
    _, idx = torch.sort(torch.abs(flat), descending=True, stable=True)
    idx = idx[:k]
    vals = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return idx.to(torch.int32), vals, residual.reshape(g.shape)


def decompress_topk(idx: torch.Tensor, vals: torch.Tensor,
                    shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.long(), vals.to(torch.float32)).reshape(
        tuple(shape))


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 0-dim): q = round(g / scale), half to even,
    clipped to +-127, with scale = max|g| / 127 (at least 1e-12 / 127)."""
    g32 = g.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=g.device)
    scale = torch.maximum(torch.max(torch.abs(g32)),
                          torch.tensor(1e-12, **f32)) / torch.tensor(127.0,
                                                                     **f32)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
