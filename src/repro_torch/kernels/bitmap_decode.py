"""Bitmap gather: random access into a bitmap-encoded (rows, cols) matrix.
The port of `repro/kernels/bitmap_decode.py` `bitmap_gather`.

`bitmap_gather` launches the CUDA kernel (`csrc/bitmap_gather.cu`) on
CUDA tensors and runs the plain PyTorch version `bitmap_gather_ref` on
CPU tensors; anything else raises. `bitmap_gather.launches` counts kernel
launches. (`bitmap_matmul`, the reference's other kernel in this module,
is not ported yet.)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparse import bitmap_rank, popcount32
from repro_torch.kernels import _build


def bitmap_gather_ref(words: torch.Tensor, rowptr: torch.Tensor,
                      values: torch.Tensor, queries: torch.Tensor, cols: int,
                      rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version. queries are linear row-major indices; the address of
    a set bit is rank[r, wi] + popcount(word & below). Without `rank` the
    table is derived from (words, rowptr) first: the same address as the
    reference's masked popcount over the row."""
    if rank is None:
        rank = bitmap_rank(words, rowptr)
    rows, nwords = words.shape
    q = queries.to(torch.int64)
    r = torch.div(q, cols, rounding_mode="floor")
    c = q - r * cols
    r = r.clamp(0, rows - 1)
    wi = torch.div(c, 32, rounding_mode="floor").clamp(0, nwords - 1)
    bi = c % 32
    w = words[r, wi].to(torch.int64) & 0xFFFFFFFF
    below = (torch.ones_like(bi) << bi) - 1
    addr = rank[r, wi].to(torch.int64) + popcount32(w & below)
    bit = (w >> bi) & 1
    vals = values[addr.clamp(0, values.shape[0] - 1)]
    return torch.where(bit > 0, vals, torch.zeros_like(vals))


def bitmap_gather(words: torch.Tensor, rowptr: torch.Tensor,
                  values: torch.Tensor, queries: torch.Tensor, *, cols: int,
                  rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """values of the encoded matrix at int32 linear `queries` (0 at zeros).
    `words` holds the uint32 bitmap as int32 bit patterns; `rank` is the
    optional (rows, words) int32 table of `core.sparse.bitmap_rank`."""
    if queries.device.type == "cpu":
        return bitmap_gather_ref(words, rowptr, values, queries, cols,
                                 rank=rank)
    _build.require(words.dim() == 2, "bitmap_gather: words must be 2-D")
    rows, nwords = words.shape
    _build.require(rows > 0 and nwords == (cols + 31) // 32,
                   f"bitmap_gather: words {tuple(words.shape)} do not fit "
                   f"{cols} columns")
    _build.require(values.dim() == 1 and values.shape[0] > 0,
                   "bitmap_gather: values must be a non-empty vector")
    _build.require_cuda("bitmap_gather words", words, torch.int32)
    _build.require_cuda("bitmap_gather rowptr", rowptr, torch.int32, (rows,))
    if rank is not None:
        _build.require_cuda("bitmap_gather rank", rank, torch.int32,
                            (rows, nwords))
    _build.require_cuda("bitmap_gather values", values, torch.float32)
    _build.require_cuda("bitmap_gather queries", queries, torch.int32)
    _build.require(queries.dim() == 1, "bitmap_gather: queries must be 1-D")
    out = torch.empty(queries.shape, dtype=torch.float32,
                      device=queries.device)
    fn = _build.entry("bitmap_gather_launch",
                      (_build.P, _build.P, _build.P, _build.P, _build.I32,
                       _build.I32, _build.I32, _build.I32, _build.P,
                       _build.P, _build.I64, _build.P))
    code = fn(words.data_ptr(), rowptr.data_ptr(),
              None if rank is None else rank.data_ptr(), values.data_ptr(),
              values.shape[0], rows, nwords, cols, queries.data_ptr(),
              out.data_ptr(), queries.shape[0],
              _build.stream_ptr(queries.device))
    _build.check("bitmap_gather", code)
    bitmap_gather.launches += 1
    return out


bitmap_gather.launches = 0
