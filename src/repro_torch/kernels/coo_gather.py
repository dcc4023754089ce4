"""COO gather: values of a sorted COO stream at linear coordinates (0 where
absent). The port of `repro/kernels/coo_gather.py` `coo_gather`, and its
gradient with respect to the values, `coo_gather_bwd`.

`coo_gather` and `coo_gather_bwd` launch their CUDA kernels
(`csrc/coo_gather.cu`) on CUDA tensors and run their plain PyTorch
versions `coo_gather_ref` / `coo_gather_bwd_ref` on CPU tensors;
anything else raises. `<wrapper>.launches` counts kernel launches.

The kernel gives a CTA a tile of `TILE` consecutive queries and stages
the tile's window of the stream (the entries between its least and
largest query) in shared memory when the window holds at most
`CAPACITY` entries. `coo_plan` is the launch's grid, which the kernel
checks against its own constants; `tile_windows` computes the windows
from the inputs, and `coo_gather_staged` reads back how many tiles the
kernel itself staged. The backward stages one range of the stream a
CTA, around its first tile's window, for `BWD_SPAN` tiles of `BWD_TILE`
queries (`coo_bwd_plan`); `bwd_search_counts` computes from the inputs
how many of its warps' tiles search that range in shared memory, and
`coo_gather_bwd_staged` reads the kernel's own count back.
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
# the backward's threads (csrc/gather_bwd.cuh kBwdThreads), queries a
# thread and tiles a CTA (csrc/coo_gather.cu kBwdPer, kBwdSpan) and the
# entries a CTA stages (kBwdCapacity): coordinates only, 12 KB, about one
# row's entries of an appearance plane at the training shape (a 2,048-
# query window holds 1,723 entries on average there, 2,178 at most)
BWD_THREADS = 256
BWD_PER_THREAD = 16
BWD_TILE = BWD_THREADS * BWD_PER_THREAD
BWD_SPAN = 16
BWD_CAPACITY = 3072
BWD_WARP_QUERIES = 128        # a warp's queries in each row of a tile


class CooPlan(NamedTuple):
    tile: int          # queries a CTA
    capacity: int      # window entries staged in shared memory
    blocks: int        # CTAs


def coo_plan(nq: int) -> CooPlan:
    """Launch plan of the kernel for `nq` queries."""
    _build.require(nq >= 0, "coo_gather: {} queries", nq)
    return CooPlan(TILE, CAPACITY, -(-nq // TILE))


class CooBwdPlan(NamedTuple):
    tile: int          # queries a tile
    capacity: int      # stream entries a CTA stages
    span: int          # tiles a CTA
    blocks: int        # CTAs


def coo_bwd_plan(nq: int) -> CooBwdPlan:
    """Launch plan of the backward kernel for `nq` queries."""
    _build.require(nq >= 0, "coo_gather_bwd: {} queries", nq)
    tiles = -(-nq // BWD_TILE)
    return CooBwdPlan(BWD_TILE, BWD_CAPACITY, BWD_SPAN,
                      -(-tiles // BWD_SPAN))


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


def bwd_search_counts(coords: torch.Tensor, queries: torch.Tensor,
                      grad: torch.Tensor) -> tuple:
    """(searched in shared memory, live): of the (tile, warp) pairs of the
    backward kernel that hold a query of nonzero gradient (live), those
    whose runs it searches in its CTA's staged range, computed from the
    inputs as the kernel decides. A CTA's range: its first tile's window
    (lower bound of the least live query, upper bound of the largest),
    widened to BWD_CAPACITY entries around it when it holds at most that
    many (staged), else the window itself; a warp's tile is searched there
    when its live queries lie strictly between the entries just outside
    the range."""
    nq, n = queries.shape[0], coords.shape[0]
    tiles = -(-nq // BWD_TILE)
    if tiles == 0:
        return 0, 0
    pad = tiles * BWD_TILE - nq
    dev = queries.device
    q = torch.cat([queries, queries.new_zeros(pad)]).to(torch.int64)
    live = torch.cat([grad != 0, torch.zeros(pad, dtype=torch.bool,
                                             device=dev)])
    lo_key, hi_key = -(1 << 31), (1 << 31) - 1
    q_lo = torch.where(live, q, hi_key).reshape(tiles, -1)
    q_hi = torch.where(live, q, lo_key).reshape(tiles, -1)
    # the CTAs' ranges from their first tiles
    first = torch.arange(0, tiles, BWD_SPAN, device=dev)
    has = live.reshape(tiles, -1)[first].any(dim=1)
    c64 = coords.to(torch.int64)
    lo = torch.searchsorted(c64, q_lo[first].amin(dim=1).contiguous())
    hi = torch.searchsorted(c64, q_hi[first].amax(dim=1).contiguous(),
                            right=True)
    hi = torch.maximum(hi, lo)
    in_smem = has & (hi - lo <= BWD_CAPACITY)
    start = (lo - torch.div(BWD_CAPACITY - (hi - lo), 2,
                            rounding_mode="floor")).clamp(min=0)
    end = (start + BWD_CAPACITY).clamp(max=n)
    start = torch.where(in_smem, (end - BWD_CAPACITY).clamp(min=0), lo)
    end = torch.where(in_smem, end, hi)
    below = torch.where(start > 0, c64[(start - 1).clamp(min=0)], lo_key)
    above = torch.where(end < n, c64[end.clamp(max=n - 1)], hi_key)
    below = torch.where(has, below, hi_key)
    above = torch.where(has, above, lo_key)
    # each warp's queries: 128 a row of the tile, in each of its rows
    rows = BWD_PER_THREAD // 4
    warps = BWD_THREADS // 32

    def per_warp(x):
        return x.reshape(tiles, rows, warps, BWD_WARP_QUERIES).transpose(
            1, 2).reshape(tiles, warps, -1)
    w_live = per_warp(live).any(dim=2)
    w_min = per_warp(q_lo.reshape(-1)).amin(dim=2)
    w_max = per_warp(q_hi.reshape(-1)).amax(dim=2)
    cta = torch.arange(tiles, device=dev) // BWD_SPAN
    inside = (below[cta, None] < w_min) & (w_max < above[cta, None])
    staged = inside & in_smem[cta, None] & w_live
    return int(staged.sum()), int(w_live.sum())


def search_steps(n: int) -> int:
    """Binary-search steps over n sorted coordinates (+1: lo == hi)."""
    return max(int(math.ceil(math.log2(n))), 1) + 1


def coo_slots(coords: torch.Tensor, queries: torch.Tensor) -> tuple:
    """(slot, found) of each query: the int64 index of its lower bound in
    the sorted coordinates, clamped into the stream, and whether the
    coordinate there is the query."""
    n = coords.shape[0]
    q = queries.to(coords.dtype)
    lo = torch.searchsorted(coords, q)
    safe = lo.clamp(0, n - 1)
    return safe, (lo < n) & (coords[safe] == q)


def coo_gather_ref(coords: torch.Tensor, values: torch.Tensor,
                   queries: torch.Tensor) -> torch.Tensor:
    """Plain version: `searchsorted` over the sorted coordinates."""
    slot, found = coo_slots(coords, queries)
    vals = values[slot]
    return torch.where(found, vals, torch.zeros_like(vals))


def coo_gather_bwd_ref(coords: torch.Tensor, queries: torch.Tensor,
                       grad: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: the gradient of `coo_gather` with
    respect to its values (one per coordinate), given the gradient `grad`
    of its output. Each query found in the stream adds its gradient to
    the entry it reads; pad entries and absent queries add nothing."""
    slot, found = coo_slots(coords, queries)
    out = torch.zeros(coords.shape[0], dtype=grad.dtype, device=grad.device)
    # an absent query adds an exact 0 (no boolean mask: no host sync)
    return out.index_add_(0, slot, torch.where(found, grad,
                                               torch.zeros_like(grad)))


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
    vec = _build.aligned16(queries, out)
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


def _launch_bwd(coords: torch.Tensor, queries: torch.Tensor,
                grad: torch.Tensor, staged: Optional[torch.Tensor]
                ) -> torch.Tensor:
    n = coords.shape[0]
    _build.require(coords.dim() == 1 and n > 0,
                   "coo_gather_bwd: coords must be a non-empty vector")
    _build.require_cuda("coo_gather_bwd coords", coords, torch.int32)
    _build.require(queries.dim() == 1, "coo_gather_bwd: queries must be 1-D")
    _build.require_cuda("coo_gather_bwd queries", queries, torch.int32)
    _build.require_cuda("coo_gather_bwd grad", grad, torch.float32,
                        tuple(queries.shape))
    dev = queries.device
    _build.require(coords.device == dev and grad.device == dev,
                   "coo_gather_bwd: tensors on different devices")
    if staged is not None:
        _build.require_cuda("coo_gather_bwd staged", staged, torch.int32,
                            (1,))
    nq = queries.shape[0]
    plan = coo_bwd_plan(nq)
    out = torch.zeros(n, dtype=torch.float32, device=dev)
    fn = _build.entry("coo_gather_bwd_launch",
                      (_build.P, _build.I32, _build.I32, _build.I32,
                       _build.I32, _build.I64, _build.I32, _build.P,
                       _build.P, _build.P, _build.I64, _build.P, _build.P))
    code = fn(coords.data_ptr(), n, plan.tile, plan.capacity, plan.span,
              plan.blocks, _build.aligned16(queries, grad),
              queries.data_ptr(), grad.data_ptr(), out.data_ptr(), nq,
              None if staged is None else staged.data_ptr(),
              _build.stream_ptr(dev))
    _build.check("coo_gather_bwd", code)
    coo_gather_bwd.launches += 1
    return out


def coo_gather_bwd(coords: torch.Tensor, queries: torch.Tensor,
                   grad: torch.Tensor) -> torch.Tensor:
    """The gradient of `coo_gather` with respect to its values: a float32
    vector as long as `coords`, with grad[i] added at the entry query i
    reads, for each query found in the stream (`csrc/coo_gather.cu`
    `coo_gather_bwd_kernel`: runs of equal queries summed in the warp,
    one search and one fp32 atomic a run, so the sum's order changes
    from run to run). Plain version `coo_gather_bwd_ref` on CPU
    tensors."""
    if _build.all_on_cpu("coo_gather_bwd", coords, queries, grad):
        return coo_gather_bwd_ref(coords, queries, grad)
    return _launch_bwd(coords, queries, grad, None)


def coo_gather_bwd_staged(coords: torch.Tensor, queries: torch.Tensor,
                          grad: torch.Tensor) -> tuple:
    """(coo_gather_bwd's result, number of (tile, warp) pairs the kernel
    searched in its staged range: `bwd_search_counts`' first count), from
    one launch of the kernel on CUDA tensors; waits for the launch."""
    _build.require(queries.device.type == "cuda",
                   "coo_gather_bwd_staged: the count comes from the kernel, "
                   "which runs on CUDA tensors")
    staged = torch.zeros(1, dtype=torch.int32, device=queries.device)
    out = _launch_bwd(coords, queries, grad, staged)
    return out, int(staged.item())


coo_gather_bwd.launches = 0
