"""Per-request span tracing for the port's serving stack. The port's own
copy of `repro/obs/tracing.py`: host spans on `time.perf_counter`.

A `ViewTrace` is one request's span tree through the engine lifecycle:

    view (submit -> deliver)
    |-- submit      enqueue under the engine lock
    |-- queue       submit -> the flush that claimed the request
    |-- group       (scene, ordering key) bucketing of the whole batch
    |-- ordering    per-view ordering-cache lookups for the group
    |-- compaction  micro-batch planning for the group
    |-- render      the ray renderer's scan steps and the copy to the host
    |                 (attrs: dispatch path, chunks, dropped pairs)
    `-- deliver     PSNR + result construction -> future resolution

Group-level stages are measured once per flush group and attached to
every member request's trace. Delta frames (`engine.submit_delta`) add
`warp` and `mask` on the submitting thread and `composite` on the flush
thread, so reports iterate REPORT_STAGES and skip empty stages.

A `Tracer` mints traces, folds every finished trace's stage durations
into `request_stage_s{stage=...}` histograms in the shared
`MetricsRegistry`, counts render dispatch paths
(`render_dispatch_total{path=...}`), and keeps the last `max_traces`
completed trees. `enabled=False` short-circuits everything.

On the device side, `core/pipeline.make_ray_renderer` opens
`torch.profiler.record_function` ranges named `rtnerf.intersect`,
`rtnerf.compact`, `rtnerf.field_eval`, `rtnerf.composite` and
`rtnerf.scatter` around each scan step's stages while a profiler is
recording, so a `torch.profiler` capture lines up with these spans. The
reference's `fused.*` scopes inside its Pallas kernel have no host
counterpart here: that work runs inside one CUDA kernel launch.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry

# canonical stage order of one request's lifecycle (doc + report order).
# Every request passes through all of STAGES; the temporal tier's stages
# (engine.submit_delta: warp/mask on the submitting thread, composite on
# the flush thread) only appear on delta frames, so reports iterate
# REPORT_STAGES — the full lifecycle order — and skip empty stages.
STAGES = ("submit", "queue", "group", "ordering", "compaction", "render",
          "deliver")
REPORT_STAGES = ("warp", "mask", "submit", "queue", "group", "ordering",
                 "compaction", "render", "composite", "deliver")


@dataclasses.dataclass
class Span:
    """One timed stage: [t0, t1] absolute perf_counter seconds + attrs."""
    name: str
    t0: float
    t1: float
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)


class ViewTrace:
    """The span tree of one request: a root (submit -> deliver) plus one
    child span per lifecycle stage. Built concurrently from the submitting
    thread and the flushing thread; appends are lock-protected."""

    def __init__(self, view_id: int, scene: str, t_submit: float):
        self.view_id = view_id
        self.scene = scene
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        self._lock = threading.Lock()
        self._spans: List[Span] = []

    def add(self, name: str, t0: float, t1: float, **attrs) -> Span:
        sp = Span(name, t0, t1, attrs)
        with self._lock:
            self._spans.append(sp)
        return sp

    def span(self, name: str, **attrs):
        """Context manager measuring one stage on the current thread."""
        return _SpanCtx(self, name, attrs)

    def spans(self) -> List[Span]:
        with self._lock:
            return sorted(self._spans, key=lambda s: s.t0)

    def stage_durations(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for sp in self.spans():
            out[sp.name] = out.get(sp.name, 0.0) + sp.dur_s
        return out

    def tree(self) -> Dict:
        """JSON-able span tree, times relative to submit."""
        t_end = self.t_done if self.t_done is not None else self.t_submit
        return {
            "view_id": self.view_id,
            "scene": self.scene,
            "dur_s": max(t_end - self.t_submit, 0.0),
            "stages": [
                {"name": sp.name,
                 "t0_s": max(sp.t0 - self.t_submit, 0.0),
                 "dur_s": sp.dur_s, **sp.attrs}
                for sp in self.spans()],
        }


class _SpanCtx:
    def __init__(self, trace: ViewTrace, name: str, attrs: Dict):
        self._trace, self._name, self._attrs = trace, name, attrs

    def __enter__(self) -> Dict:
        self._t0 = time.perf_counter()
        return self._attrs          # caller may add attrs inside the block

    def __exit__(self, *exc):
        self._trace.add(self._name, self._t0, time.perf_counter(),
                        **self._attrs)
        return False


class Tracer:
    """Mints ViewTraces and folds finished ones into the registry."""

    def __init__(self, registry: MetricsRegistry, *, max_traces: int = 256,
                 enabled: bool = True):
        self.registry = registry
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._completed: collections.deque = collections.deque(
            maxlen=int(max_traces))

    def start(self, view_id: int, scene: str,
              t_submit: Optional[float] = None) -> Optional[ViewTrace]:
        if not self.enabled:
            return None
        return ViewTrace(view_id, scene,
                         time.perf_counter() if t_submit is None
                         else t_submit)

    def finish(self, trace: Optional[ViewTrace],
               t_done: Optional[float] = None):
        """Close the root span, aggregate stage durations into the shared
        registry, retain the tree."""
        if trace is None:
            return
        trace.t_done = time.perf_counter() if t_done is None else t_done
        for stage, dur in trace.stage_durations().items():
            self.registry.histogram("request_stage_s", stage=stage).record(
                dur)
        for sp in trace.spans():
            path = sp.attrs.get("dispatch_path")
            if path is not None:
                self.registry.counter("render_dispatch_total",
                                      path=path).inc()
        with self._lock:
            self._completed.append(trace)

    def completed(self) -> List[ViewTrace]:
        """Most-recent-last completed traces (bounded window)."""
        with self._lock:
            return list(self._completed)

    def last(self) -> Optional[ViewTrace]:
        with self._lock:
            return self._completed[-1] if self._completed else None
