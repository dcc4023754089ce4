"""Micro-batching of per-view ray batches into fixed-size chunks. The
port's own copy of `repro/serving/batching.py` (host-side numpy).

`plan_microbatches(ray_batches, chunk) -> MicroBatchPlan` packs the queued
views' (rays_o, rays_d) into (n_chunks, chunk, 3) arrays;
`MicroBatchPlan.scatter(outs)` inverts the packing, handing each view back
its contiguous pixel block (pad outputs dropped). The renderer then runs
at one fixed ray shape whatever the mix of views and resolutions.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np


def group_requests(items: Iterable, key: Callable) -> Dict[tuple, List]:
    """Stable grouping in first-seen order: the serving engine's flush path
    buckets queued requests by `(scene, ordering-key)` with this, so every
    bucket renders as one micro-batched group against one per-scene
    snapshot while submission order is preserved within and across
    buckets (first scene submitted flushes first)."""
    groups: Dict[tuple, List] = collections.OrderedDict()
    for it in items:
        groups.setdefault(key(it), []).append(it)
    return groups


@dataclasses.dataclass(frozen=True)
class ViewSlice:
    """Where one view's rays live in the packed stream."""
    view_id: int
    start: int
    stop: int


@dataclasses.dataclass(frozen=True)
class MicroBatchPlan:
    """Packed ray stream + the bookkeeping to unpack per-view results."""
    rays_o: np.ndarray          # (n_chunks, chunk, 3)
    rays_d: np.ndarray          # (n_chunks, chunk, 3)
    slices: Tuple[ViewSlice, ...]
    total: int                  # true ray count before padding
    chunk: int

    @property
    def n_chunks(self) -> int:
        return self.rays_o.shape[0]

    def scatter(self, outs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Chunk outputs (each (chunk, C)) -> per-view arrays, pad dropped."""
        flat = np.concatenate([np.asarray(o) for o in outs])[: self.total]
        return [flat[s.start: s.stop] for s in self.slices]


def plan_microbatches(ray_batches: Sequence[Tuple[np.ndarray, np.ndarray]],
                      chunk: int) -> MicroBatchPlan:
    """Pack per-view (rays_o, rays_d) batches into fixed-size chunks.

    Padding rays originate far outside every scene bound with a unit
    direction, so they intersect no cube — they never register geometric
    hits or compete with real rays for the renderer's per-step pair budget.
    Their outputs are dropped by `scatter`.
    """
    if not ray_batches:
        raise ValueError("plan_microbatches needs at least one view")
    slices, pos = [], 0
    for vid, (ro, _) in enumerate(ray_batches):
        n = int(np.asarray(ro).shape[0])
        slices.append(ViewSlice(vid, pos, pos + n))
        pos += n
    total = pos
    pad = (-total) % chunk
    ro = np.concatenate([np.asarray(o, np.float32) for o, _ in ray_batches])
    rd = np.concatenate([np.asarray(d, np.float32) for _, d in ray_batches])
    if pad:
        ro = np.concatenate([ro, np.full((pad, 3), 1e6, np.float32)])
        pad_d = np.zeros((pad, 3), np.float32)
        pad_d[:, 2] = 1.0                    # unit dir, points away
        rd = np.concatenate([rd, pad_d])
    n_chunks = ro.shape[0] // chunk
    return MicroBatchPlan(ro.reshape(n_chunks, chunk, 3),
                          rd.reshape(n_chunks, chunk, 3),
                          tuple(slices), total, chunk)
