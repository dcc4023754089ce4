"""COO gather: values of a sorted COO stream at linear coordinates (0 where
absent). The port of `repro/kernels/coo_gather.py` `coo_gather`.

`coo_gather` launches the CUDA kernel (`csrc/coo_gather.cu`) on CUDA
tensors and runs the plain PyTorch version `coo_gather_ref` on CPU
tensors; anything else raises. `coo_gather.launches` counts kernel
launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build


def search_steps(n: int) -> int:
    """Binary-search steps over n sorted coordinates (+1: lo == hi)."""
    return max(int(math.ceil(math.log2(n))), 1) + 1


def coo_gather_ref(coords: torch.Tensor, values: torch.Tensor,
                   queries: torch.Tensor) -> torch.Tensor:
    """Plain version: `searchsorted` over the sorted coordinates."""
    n = coords.shape[0]
    q = queries.to(coords.dtype)
    lo = torch.searchsorted(coords, q)
    safe = lo.clamp(0, n - 1)
    found = (lo < n) & (coords[safe] == q)
    vals = values[safe]
    return torch.where(found, vals, torch.zeros_like(vals))


def coo_gather(coords: torch.Tensor, values: torch.Tensor,
               queries: torch.Tensor) -> torch.Tensor:
    """values at `queries` (int32 linear coords) from a sorted int32
    `coords` stream padded with PAD_COORD; 0 where absent."""
    if queries.device.type == "cpu":
        return coo_gather_ref(coords, values, queries)
    n = coords.shape[0]
    _build.require(coords.dim() == 1 and n > 0,
                   "coo_gather: coords must be a non-empty vector")
    _build.require_cuda("coo_gather coords", coords, torch.int32)
    _build.require_cuda("coo_gather values", values, torch.float32, (n,))
    _build.require_cuda("coo_gather queries", queries, torch.int32)
    _build.require(queries.dim() == 1, "coo_gather: queries must be 1-D")
    out = torch.empty(queries.shape, dtype=torch.float32,
                      device=queries.device)
    fn = _build.entry("coo_gather_launch",
                      (_build.P, _build.P, _build.I32, _build.I32, _build.P,
                       _build.P, _build.I64, _build.P))
    code = fn(coords.data_ptr(), values.data_ptr(), n, search_steps(n),
              queries.data_ptr(), out.data_ptr(), queries.shape[0],
              _build.stream_ptr(queries.device))
    _build.check("coo_gather", code)
    coo_gather.launches += 1
    return out


coo_gather.launches = 0
