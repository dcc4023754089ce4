"""Batched novel-view serving of one resident compressed field. The
single-scene, synchronous part of `repro/serving/engine.py`.

Costs the per-view loop pays on every request are paid once here:

  * encode     the hybrid bitmap/COO encoding is built at construction
               and the streams stay resident on the device;
  * occupancy  the cube set is built once from the field (through the
               gather kernels for an encoded field) unless given;
  * ordering   per-view `order_cubes` schedules are cached by octant
               ranking (`pipeline.OrderingCache`);
  * batching   queued views are micro-batched into fixed ray chunks
               (`serving.batching`), so the renderer runs at one shape;
  * pair budget  the active-pair compaction budget adapts to observed
               occupancy (`aux["active_pairs_max"]`) with hysteresis.

`submit(cam, gt=None, deadline_s=None) -> ViewFuture` queues a request;
`flush()` renders the queue grouped by ordering key (the queue also
flushes itself at `max_batch_views`, and `ViewFuture.result()` flushes);
`stats()` reports the serving counters under the reference's names.
Everything runs on the caller's thread.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.core import occupancy as occ_lib
from repro_torch.core import pipeline as rt_pipe
from repro_torch.core import rendering
from repro_torch.core.occupancy import CubeSet
from repro_torch.core.rendering import Camera
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.batching import group_requests, plan_microbatches


@dataclasses.dataclass
class ViewResult:
    view_id: int
    img: Optional[np.ndarray]       # (H*W, 3); None when timed out
    psnr: Optional[float]           # vs the submitted gt, if any
    latency_s: float                # submit -> resolve (queueing + render)
    stats: Dict[str, object]
    timed_out: bool = False         # deadline passed before render started
    depth: Optional[np.ndarray] = None    # (H*W,) accumulated E[w t]
    opacity: Optional[np.ndarray] = None  # (H*W,) 1 - final transmittance


class ViewFuture:
    """Handle for one queued view; `result()` flushes the engine if the
    view has not been rendered yet."""

    def __init__(self, engine: "RenderEngine", view_id: int):
        self._engine = engine
        self._view_id = view_id
        self._result: Optional[ViewResult] = None

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> ViewResult:
        if self._result is None:
            self._engine.flush()
        if self._result is None:
            raise RuntimeError(f"view {self._view_id} was not rendered")
        return self._result

    def _set(self, res: ViewResult):
        self._result = res


@dataclasses.dataclass(eq=False)
class _Request:
    cam: Camera
    gt: Optional[np.ndarray]
    future: ViewFuture
    t_submit: float
    deadline: Optional[float] = None     # absolute perf_counter time


class RenderEngine:
    """Batched novel-view serving of one field on one device."""

    def __init__(self, cfg: NeRFConfig, field, cubes: Optional[CubeSet] = None,
                 *, encode: bool = True, ray_chunk: int = 4096,
                 cube_chunk: int = 8, pair_budget: Optional[int] = None,
                 adaptive_pair_budget: bool = True,
                 order_mode: str = "octant", max_batch_views: int = 8,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ray_chunk = int(ray_chunk)
        self.cube_chunk = int(cube_chunk)
        self.max_batch_views = int(max_batch_views)

        f = field_lib.as_backend(field, cfg).to(self.device)
        self.field = f.encode() if encode else f.decode()
        if cubes is None:
            occ = occ_lib.build_occupancy(self.field, cfg)
            cubes = occ_lib.extract_cubes(occ, cfg)
        else:
            cubes = occ_lib.cubes_from_arrays(
                cubes.centers, cubes.valid, cubes.count, cubes.radius,
                cubes.occ, device=self.device)
        self.cubes = cubes
        self.ordering = rt_pipe.OrderingCache(cubes, order_mode)
        self.factor_bytes = self.field.factor_bytes()
        self.factor_bytes_dense = self.field.dense_factor_bytes()

        # the active-pair budget starts at the static default (or
        # `pair_budget`) and, when adaptive, resizes to observed occupancy
        n_pairs = self.cube_chunk * self.ray_chunk
        self._pair_budget = min(
            int(pair_budget) if pair_budget else max(n_pairs // 4, 128),
            n_pairs)
        self.pair_budget_initial = self._pair_budget
        self._adaptive_budget = bool(adaptive_pair_budget)
        self._budget_resizes = 0
        self._pair_window = collections.deque(maxlen=8)
        self._low_occ_streak = 0
        self._pair_occupancy_last = 0.0
        self._build_render()

        self._queue: List[_Request] = []
        self._next_id = 0
        self._views = 0
        self._flushes = 0
        self._render_s = 0.0
        self._dropped = 0
        self._timeouts = 0
        self._latencies = collections.deque(maxlen=65536)

    def _build_render(self):
        self._render = rt_pipe.make_ray_renderer(
            self.cfg, chunk=self.cube_chunk, pair_budget=self._pair_budget)

    # -- request/response --------------------------------------------------

    def submit(self, cam: Camera, gt=None, *,
               deadline_s: Optional[float] = None) -> ViewFuture:
        """Queue one novel-view request; returns its future. If
        `deadline_s` (seconds from now) passes before the render starts,
        the request resolves as timed out instead of rendering late. The
        queue flushes when it reaches `max_batch_views`."""
        fut = ViewFuture(self, self._next_id)
        now = time.perf_counter()
        deadline = None if deadline_s is None else now + deadline_s
        self._queue.append(_Request(cam, gt, fut, now, deadline))
        self._next_id += 1
        if len(self._queue) >= self.max_batch_views:
            self.flush()
        return fut

    def render_views(self, cams, gts=None) -> List[ViewResult]:
        """Submit a batch of cameras and flush."""
        gts = gts if gts is not None else [None] * len(cams)
        futs = [self.submit(c, g) for c, g in zip(cams, gts)]
        self.flush()
        return [f.result() for f in futs]

    def flush(self) -> List[ViewResult]:
        """Render every queued view: expire requests past their deadline,
        group the rest by ordering key, micro-batch each group's rays into
        fixed chunks and render them. If a render fails, the unresolved
        requests go back on the queue before the error propagates."""
        if not self._queue:
            return []
        reqs, self._queue = self._queue, []
        try:
            return self._flush(reqs)
        except BaseException:
            self._queue = [r for r in reqs
                           if r.future._result is None] + self._queue
            raise

    def _flush(self, reqs: List[_Request]) -> List[ViewResult]:
        t0 = time.perf_counter()
        budget = self._pair_budget
        results: List[ViewResult] = []
        live: List[_Request] = []
        for r in reqs:
            if r.deadline is not None and t0 > r.deadline:
                res = ViewResult(view_id=r.future._view_id, img=None,
                                 psnr=None, latency_s=t0 - r.t_submit,
                                 stats={}, timed_out=True)
                self._timeouts += 1
                r.future._set(res)
                results.append(res)
            else:
                live.append(r)
        if not live:
            return results

        groups = group_requests(live,
                                lambda r: self.ordering.key_for(r.cam.origin))
        pairs = [0, 0]          # [max active pairs, render calls]
        dropped = [0]
        try:
            for reqs_g in groups.values():
                self._render_group(reqs_g, results, pairs, dropped)
        finally:
            self._render_s += time.perf_counter() - t0
            self._flushes += 1
            if pairs[1]:
                self._note_flush_pairs(pairs[0], dropped[0], budget)
        return results

    def _render_group(self, reqs_g: List[_Request],
                      results: List[ViewResult], pairs: List[int],
                      dropped: List[int]):
        for r in reqs_g:                      # one cache access per view
            centers, valid = self.ordering.get_ordered(r.cam.origin)
        batches = []
        for r in reqs_g:
            o, d = rendering.camera_rays(r.cam)
            batches.append((o.cpu().numpy(), d.cpu().numpy()))
        plan = plan_microbatches(batches, self.ray_chunk)
        outs, geo_outs = [], []
        g_dropped, g_pairs = 0, 0
        g_processed = 0.0
        for i in range(plan.n_chunks):
            ro = torch.from_numpy(plan.rays_o[i]).to(self.device)
            rd = torch.from_numpy(plan.rays_d[i]).to(self.device)
            rgb, aux = self._render(self.field, centers, valid, ro, rd)
            outs.append(rgb.cpu().numpy())
            geo_outs.append(torch.stack([aux["depth"], aux["opacity"]],
                                        dim=-1).cpu().numpy())
            g_dropped += int(aux["dropped_pairs"])
            g_pairs = max(g_pairs, int(aux["active_pairs_max"]))
            g_processed += float(aux["processed_samples"])
            pairs[1] += 1
        pairs[0] = max(pairs[0], g_pairs)
        dropped[0] += g_dropped
        self._dropped += g_dropped
        path = self.field.dispatch_path()
        for r, img, geo in zip(reqs_g, plan.scatter(outs),
                               plan.scatter(geo_outs)):
            psnr = None
            if r.gt is not None:
                psnr = float(rendering.psnr(
                    torch.from_numpy(img).clamp(0, 1),
                    torch.as_tensor(np.asarray(r.gt, np.float32))))
            res = ViewResult(
                view_id=r.future._view_id, img=img, psnr=psnr,
                latency_s=time.perf_counter() - r.t_submit,
                depth=np.ascontiguousarray(geo[:, 0]),
                opacity=np.ascontiguousarray(geo[:, 1]),
                stats={"occ_accesses": float(self.cubes.count),
                       "factor_bytes": float(self.factor_bytes),
                       "factor_bytes_dense": float(self.factor_bytes_dense),
                       "dropped_pairs": g_dropped,
                       "active_pairs_max": g_pairs,
                       "processed_samples": g_processed,
                       "dispatch_path": path})
            self._latencies.append(res.latency_s)
            self._views += 1
            r.future._set(res)
            results.append(res)

    # -- adaptive pair budget ----------------------------------------------

    def _note_flush_pairs(self, max_pairs: int, dropped: int, budget: int):
        """Resize the active-pair budget from observed occupancy, with the
        reference's hysteresis: grow at once (x2, capped at the full pair
        count) when pairs were dropped or the budget filled; shrink only
        after 3 consecutive flushes below 25% occupancy, to 2x the recent
        observed max (256-aligned, floor 128)."""
        n_pairs = self.cube_chunk * self.ray_chunk
        self._pair_occupancy_last = max_pairs / max(budget, 1)
        if not self._adaptive_budget or budget != self._pair_budget:
            return
        self._pair_window.append(max_pairs)
        new = None
        if dropped > 0 or max_pairs >= budget:
            new = min(budget * 2, n_pairs)
            self._low_occ_streak = 0
        elif max_pairs * 4 < budget:
            self._low_occ_streak += 1
            if self._low_occ_streak >= 3:
                want = max(2 * max(self._pair_window), 128)
                want = min(-(-want // 256) * 256, n_pairs)
                if want < budget:
                    new = want
                self._low_occ_streak = 0
        else:
            self._low_occ_streak = 0
        if new is not None and new != budget:
            self._pair_budget = new
            self._budget_resizes += 1
            self._build_render()

    # -- telemetry ---------------------------------------------------------

    def stats(self) -> Dict:
        lat = np.asarray(self._latencies, np.float64)

        def pct(q):
            return float(np.percentile(lat, q)) if lat.size else 0.0

        return {
            "views_served": self._views,
            "flushes": self._flushes,
            "fps": self._views / self._render_s if self._render_s > 0 else 0.0,
            "render_s_total": self._render_s,
            "latency_p50_s": pct(50),
            "latency_p95_s": pct(95),
            "latency_p99_s": pct(99),
            "latency_mean_s": float(lat.mean()) if lat.size else 0.0,
            "dropped_pairs": self._dropped,
            "timeouts": self._timeouts,
            "pair_budget": self._pair_budget,
            "pair_budget_initial": self.pair_budget_initial,
            "pair_budget_resizes": self._budget_resizes,
            "pair_occupancy_last": self._pair_occupancy_last,
            "ray_chunk": self.ray_chunk,
            "cube_chunk": self.cube_chunk,
            "ordering_cache": self.ordering.stats(),
            "occ_accesses_per_view": self.cubes.count,
            "factor_bytes": self.factor_bytes,
            "factor_bytes_dense": self.factor_bytes_dense,
            "compression_ratio": self.field.compression_ratio(),
            "field_kind": self.field.kind,
            "dispatch_path": self.field.dispatch_path(),
        }
