"""COO gather: values of a sorted COO stream at linear coordinates (0 where
absent). The port of `repro/kernels/coo_gather.py` `coo_gather`.

`coo_gather` launches the CUDA kernel (`csrc/coo_gather.cu`) on CUDA
tensors and runs the plain PyTorch version `coo_gather_ref` on CPU
tensors; anything else raises. `coo_gather.launches` counts kernel
launches.

The kernel gives a CTA a tile of `TILE` consecutive queries and stages
the tile's window of the stream (the entries between its least and
largest query) in shared memory when the window holds at most
`CAPACITY` entries. `coo_plan` is the launch's grid, which the kernel
checks against its own constants; `tile_windows` computes the windows
from the inputs, and `coo_gather_staged` reads back how many tiles the
kernel itself staged.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

# csrc/coo_gather.cu's kThreads and kPer; the launch raises when TILE or
# CAPACITY disagrees with the kernel's kTile or kCapacity
THREADS = 256
PER_THREAD = 8                # queries a thread
TILE = THREADS * PER_THREAD   # queries a CTA
# window entries a CTA stages: 8 KB of static shared memory, so that the
# resident CTAs leave most of an SM's L1 to the stream that wide tiles
# search in device memory
CAPACITY = 1024


class CooPlan(NamedTuple):
    tile: int          # queries a CTA
    capacity: int      # window entries staged in shared memory
    blocks: int        # CTAs


def coo_plan(nq: int) -> CooPlan:
    """Launch plan of the kernel for `nq` queries."""
    _build.require(nq >= 0, "coo_gather: {} queries", nq)
    return CooPlan(TILE, CAPACITY, -(-nq // TILE))


def tile_windows(coords: torch.Tensor, queries: torch.Tensor,
                 tile: int = TILE) -> torch.Tensor:
    """Entries of the stream between each tile's least and largest query,
    as the kernel finds them (lower bound of the least, upper bound of the
    largest): int64 (ceil(nq / tile),). A tile is staged when its window
    holds at most the plan's capacity."""
    nq = queries.shape[0]
    if nq == 0:
        return torch.zeros(0, dtype=torch.int64, device=queries.device)
    pad = -nq % tile
    q = torch.cat([queries, queries[-1:].expand(pad)]).reshape(-1, tile)
    lo = torch.searchsorted(coords, q.amin(dim=1).contiguous())
    hi = torch.searchsorted(coords, q.amax(dim=1).contiguous(), right=True)
    return hi - lo


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


def _launch(coords: torch.Tensor, values: torch.Tensor,
            queries: torch.Tensor, staged: Optional[torch.Tensor]
            ) -> torch.Tensor:
    n = coords.shape[0]
    _build.require(coords.dim() == 1 and n > 0,
                   "coo_gather: coords must be a non-empty vector")
    _build.require_cuda("coo_gather coords", coords, torch.int32)
    _build.require_cuda("coo_gather values", values, torch.float32, (n,))
    _build.require_cuda("coo_gather queries", queries, torch.int32)
    _build.require(queries.dim() == 1, "coo_gather: queries must be 1-D")
    if staged is not None:
        _build.require_cuda("coo_gather staged", staged, torch.int32, (1,))
    nq = queries.shape[0]
    plan = coo_plan(nq)
    out = torch.empty(queries.shape, dtype=torch.float32,
                      device=queries.device)
    vec = int(queries.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = _build.entry("coo_gather_launch",
                      (_build.P, _build.P, _build.I32, _build.I32, _build.I32,
                       _build.I64, _build.I32, _build.P, _build.P, _build.I64,
                       _build.P, _build.P))
    code = fn(coords.data_ptr(), values.data_ptr(), n, plan.tile,
              plan.capacity, plan.blocks, vec, queries.data_ptr(),
              out.data_ptr(), nq,
              None if staged is None else staged.data_ptr(),
              _build.stream_ptr(queries.device))
    _build.check("coo_gather", code)
    coo_gather.launches += 1
    return out


def coo_gather(coords: torch.Tensor, values: torch.Tensor,
               queries: torch.Tensor, *,
               staged: Optional[torch.Tensor] = None) -> torch.Tensor:
    """values at `queries` (int32 linear coords) from a sorted int32
    `coords` stream padded with PAD_COORD; 0 where absent. On the card,
    `staged` (a one-element int32 CUDA tensor) gains the number of query
    tiles whose window the kernel staged in shared memory, without a
    wait for the launch."""
    if queries.device.type == "cpu":
        return coo_gather_ref(coords, values, queries)
    return _launch(coords, values, queries, staged)


def coo_gather_staged(coords: torch.Tensor, values: torch.Tensor,
                      queries: torch.Tensor) -> tuple:
    """(coo_gather's result, number of query tiles whose window the kernel
    staged in shared memory), from one launch of the kernel on CUDA
    tensors; waits for the launch to finish."""
    _build.require(queries.device.type == "cuda",
                   "coo_gather_staged: the count comes from the kernel, "
                   "which runs on CUDA tensors")
    staged = torch.zeros(1, dtype=torch.int32, device=queries.device)
    out = _launch(coords, values, queries, staged)
    return out, int(staged.item())


coo_gather.launches = 0
