"""Metrics registry of the port's serving stack. The port's own copy of
`repro/obs/registry.py`: the same names, kinds and snapshot schema, so a
dashboard or report reads either package's numbers alike.

One `MetricsRegistry` per `SceneStore` (shared with the engine serving
it): every producer records into named, optionally labelled metrics, and
every consumer (`stats()`, the JSON/Prometheus exposition in
`obs/exposition.py`) reads one coherent snapshot.

Three metric kinds, all thread-safe:

  * `Counter`   monotone float accumulator (`inc`): totals (views
                served, flushes, dropped pairs, render seconds);
  * `Gauge`     last-write-wins value (`set`): states (pair budget,
                queue depth);
  * `Histogram` bounded ring buffer of observations with all-time
                `count`/`sum`/`max` kept separately, so a long-running
                service never grows per-request state while percentiles
                (p50/p95/p99) cover the recent window.

Labels: `registry.counter("scene_views", scene="lego")` keys the metric by
(name, sorted label items), the Prometheus data model. Handles are cached:
repeated lookups return the same object, and hot paths hold the handle.
`get_registry()` returns the process-default registry for one-off
scripts.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.obs.lockdebug import make_lock

LabelKey = Tuple[Tuple[str, str], ...]

# repro-lint lock-discipline declarations (docs/static_analysis.md).
# Metric locks are leaves of the serving lock order: nothing is acquired
# while one is held.
GUARDED_BY = {
    "Counter": {"lock": "_lock", "attrs": ("_value",)},
    "Gauge": {"lock": "_lock", "attrs": ("_value",)},
    "Histogram": {"lock": "_lock",
                  "attrs": ("_window", "_count", "_sum", "_max")},
    "MetricsRegistry": {"lock": "_lock", "attrs": ("_metrics",)},
}


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone float accumulator."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = make_lock("obs.metric")
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict:
        return {"value": self.value}


class Gauge:
    """Last-write-wins value."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = make_lock("obs.metric")
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict:
        return {"value": self.value}


class Histogram:
    """Bounded ring buffer of observations + all-time count/sum/max.

    Percentiles are computed over the resident window (the most recent
    `maxlen` observations); `count`/`sum`/`max` cover everything ever
    recorded — so rates and worst-cases survive the window rolling over
    while memory stays O(maxlen) for the life of the service.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: LabelKey = (), maxlen: int = 4096):
        self.name = name
        self.labels = labels
        self.maxlen = int(maxlen)
        self._lock = make_lock("obs.metric")
        self._window: collections.deque = collections.deque(
            maxlen=self.maxlen)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def record(self, v: float):
        v = float(v)
        with self._lock:
            self._window.append(v)
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    def extend(self, vs: Iterable[float]):
        for v in vs:
            self.record(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        """All-time maximum (not windowed)."""
        with self._lock:
            return self._max

    @property
    def last(self) -> float:
        with self._lock:
            return self._window[-1] if self._window else 0.0

    def window(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._window, np.float64)

    def percentile(self, q: float) -> float:
        w = self.window()
        return float(np.percentile(w, q)) if w.size else 0.0

    def mean(self) -> float:
        w = self.window()
        return float(w.mean()) if w.size else 0.0

    def snapshot(self) -> Dict:
        with self._lock:
            w = np.asarray(self._window, np.float64)
            out = {"count": self._count, "sum": self._sum, "max": self._max,
                   "window_len": int(w.size), "maxlen": self.maxlen,
                   "last": float(w[-1]) if w.size else 0.0}
        for q in (50, 95, 99):
            out[f"p{q}"] = float(np.percentile(w, q)) if w.size else 0.0
        out["mean"] = float(w.mean()) if w.size else 0.0
        return out


class MetricsRegistry:
    """Named, labelled metrics with cached handles and a JSON snapshot."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = make_lock("obs.registry")
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}, "
                    f"not {cls.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, maxlen: int = 4096,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, maxlen=maxlen)

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict:
        """JSON-able view: {kind: {flat_name: {...}}} where flat_name is
        `name{k=v,...}` for labelled metrics (Prometheus-style)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            flat = flat_name(m.name, m.labels)
            out[m.kind + "s"][flat] = m.snapshot()
        return out


def flat_name(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-default registry (scripts / one-off consumers). Serving
    components create or share per-store registries instead — see module
    docstring."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry
