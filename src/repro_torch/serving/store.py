"""SceneStore: a registry of named resident scenes under one device-memory
budget. The port of `repro/serving/store.py`.

RT-NeRF's hybrid bitmap/COO encoding (paper Sec. 4.2) exists so that many
scenes fit in device memory at once; this module is where that pays off
for serving. A `SceneStore` owns, per named scene, the resident published
state: the (normally encoded) `FieldBackend` on the store's device, its
occupancy `CubeSet`, a per-scene `pipeline.OrderingCache`, and cumulative
serving/swap telemetry. `RenderEngine` resolves `submit(cam, scene=...)`
against the store and renders each flush group from a per-scene snapshot.

The memory budget (`max_resident_bytes`, defaulting from
`NeRFConfig.max_resident_bytes`) bounds the encoded factor bytes resident
across scenes. Registering, publishing or reviving a scene that would
exceed it evicts resident scenes, lowest priority first and then least
recently used: their encoded streams go to disk through
`ckpt.spill_field` (bit for bit, no decompress) together with their cube
set, and every device reference to them is dropped, so the card's memory
is freed. The next `submit`/`publish`/`get_field` touching an evicted
scene revives the identical representation through `ckpt.unspill_field`
(cubes reloaded, not rebuilt), so it renders as before.

Lock order: engine lock, then store lock, never the reverse. The store
lock guards scene records and the LRU clock; renders never run under it:
the engine takes per-scene snapshots (field, cubes, ordering) under the
lock and renders outside, so an in-flight flush keeps its snapshot even if
the scene is evicted or republished meanwhile.

Telemetry lives in ONE `obs.MetricsRegistry` per store (shared with the
engine serving it); `stats()` keys are the reference's, computed from the
registry.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import distributed
from repro_torch.core import field as field_lib
from repro_torch.core import occupancy as occ_lib
from repro_torch.core import pipeline as rt_pipe
from repro_torch.core.occupancy import CubeSet
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.sharding import AxisRules, make_rules
from repro_torch.obs import Counter, Histogram, MetricsRegistry, lockdebug

CUBES_FILE = "cubes.npz"

# Lint declarations (scripts/repro_lint.py, docs/static_analysis.md).
# `assume_held` methods are called with the store lock held (reentrant
# RLock callers): the lock is a precondition, not acquired inside.
GUARDED_BY = {
    "SceneStore": {
        "lock": "_lock",
        "attrs": ("_records", "_clock", "_spill_dir"),
        "assume_held": ("_get", "_touch", "_enforce_budget"),
    },
}
LOCK_ATTR_CLASSES = {
    "SceneStore.metrics": "MetricsRegistry",
    "SceneStore._evictions_total": "Counter",
    "SceneStore._revivals_total": "Counter",
    "SceneStore._swap_latency_last": "Gauge",
}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_cubes(directory: str, cubes: CubeSet):
    """Persist a CubeSet next to a spilled field (`CUBES_FILE`, the
    reference's format) so revival reloads the exact geometry instead of
    rebuilding it."""
    np.savez(os.path.join(directory, CUBES_FILE),
             centers=_np(cubes.centers), valid=_np(cubes.valid),
             count=cubes.count, radius=cubes.radius, occ=_np(cubes.occ))


def load_cubes(directory: str, *, device: DeviceLike = None) -> CubeSet:
    """Inverse of `save_cubes` (reloaded, never rebuilt), on `device`."""
    dev = resolve_device(device)
    with np.load(os.path.join(directory, CUBES_FILE)) as z:
        return occ_lib.cubes_from_arrays(
            z["centers"], z["valid"], int(z["count"]), float(z["radius"]),
            z["occ"], device=dev)


def place_cubes(cubes: CubeSet, device: torch.device) -> CubeSet:
    """`cubes` on `device`: the same object when its tensors are already
    there, else a copy (numpy or another package's arrays included)."""
    if all(isinstance(t, torch.Tensor) and t.device == device
           for t in (cubes.centers, cubes.valid, cubes.occ)):
        return cubes
    return occ_lib.cubes_from_arrays(cubes.centers, cubes.valid,
                                     cubes.count, cubes.radius, cubes.occ,
                                     device=device)


class SceneSnapshot(NamedTuple):
    """A consistent per-scene view for one flush: renders read this, never
    the live record, so publishes/evictions mid-render can't tear it."""
    scene: str
    field: field_lib.FieldBackend
    cubes: CubeSet
    ordering: rt_pipe.OrderingCache
    factor_bytes: int
    factor_bytes_dense: int


@dataclasses.dataclass(eq=False)
class SceneMetrics:
    """One scene's registry handles (cumulative: they survive eviction).

    Latency and swap-latency are bounded-ring histograms (percentiles over
    the recent window, all-time count/max kept by the histogram itself),
    so per-request and per-publish state never grows for the life of a
    long-running service; `views_served`/`swaps` count everything.
    """
    views_served: Counter
    latencies: Histogram          # window 4096
    render_s: Counter
    swaps: Counter
    swap_latencies: Histogram     # window 256; .max is the all-time max
    evictions: Counter
    revivals: Counter

    @classmethod
    def create(cls, registry: MetricsRegistry, scene: str) -> "SceneMetrics":
        return cls(
            views_served=registry.counter("scene_views_served", scene=scene),
            latencies=registry.histogram("scene_latency_s", maxlen=4096,
                                         scene=scene),
            render_s=registry.counter("scene_render_s", scene=scene),
            swaps=registry.counter("scene_swaps", scene=scene),
            swap_latencies=registry.histogram("scene_swap_latency_s",
                                              maxlen=256, scene=scene),
            evictions=registry.counter("scene_evictions", scene=scene),
            revivals=registry.counter("scene_revivals", scene=scene),
        )


@dataclasses.dataclass(eq=False)
class SceneRecord:
    """One named scene: resident state + metrics that survive eviction."""
    name: str
    m: SceneMetrics
    field: Optional[field_lib.FieldBackend] = None
    cubes: Optional[CubeSet] = None
    ordering: Optional[rt_pipe.OrderingCache] = None
    factor_bytes: int = 0
    factor_bytes_dense: int = 0
    resident: bool = False
    spill_path: Optional[str] = None
    last_used: int = 0
    pinned: bool = False          # never LRU-evicted while pinned
    priority: int = 0             # higher survives budget pressure longer
    _ord_hits: int = 0            # ordering counters parked while evicted
    _ord_misses: int = 0
    _ord_nn_hits: int = 0


class SceneStore:
    """Named resident scenes with LRU eviction under a byte budget."""

    def __init__(self, cfg: NeRFConfig, *, rules: Optional[AxisRules] = None,
                 device: DeviceLike = None, encode: bool = True,
                 order_mode: str = "octant",
                 max_resident_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.encode_fields = bool(encode)
        self.order_mode = order_mode
        if max_resident_bytes is None:
            max_resident_bytes = cfg.max_resident_bytes
        self.max_resident_bytes = (int(max_resident_bytes)
                                   if max_resident_bytes else None)
        if rules is None:
            rules = make_rules(make_host_mesh(device))
        elif device is not None and resolve_device(device) != \
                rules.mesh.device:
            raise ValueError(f"device {device} differs from the mesh's "
                             f"{rules.mesh.device}")
        # the rules' mesh: fields are placed whole on this rank's device
        # (`distributed.place_field`); on a mesh of several ranks every
        # rank keeps its own store, which the same calls in the same order
        # keep equal (the eviction order is a function of them), and
        # spills into its own directory
        self.rules = rules
        self.device = rules.mesh.device
        if spill_dir is not None and rules.mesh.size > 1:
            spill_dir = os.path.join(spill_dir, f"rank{rules.mesh.rank}")
        self._spill_dir = spill_dir
        self._lock = lockdebug.make_lock("store", kind="rlock")
        self._records: Dict[str, SceneRecord] = {}
        self._clock = 0
        # one registry per store, shared by the engine serving it, not
        # the process default: two stores in one process never bleed
        # counters into each other
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._evictions_total = self.metrics.counter("store_evictions")
        self._revivals_total = self.metrics.counter("store_revivals")
        self._swap_latency_last = self.metrics.gauge(
            "store_swap_latency_s_last")

    @property
    def evictions_total(self) -> int:
        return int(self._evictions_total.value)

    @property
    def revivals_total(self) -> int:
        return int(self._revivals_total.value)

    @property
    def last_swap_latency_s(self) -> float:
        return self._swap_latency_last.value

    # -- infrastructure ----------------------------------------------------

    @property
    def spill_dir(self) -> str:
        with self._lock:
            if self._spill_dir is None:
                self._spill_dir = tempfile.mkdtemp(prefix="scene_store_")
            return self._spill_dir

    def _touch(self, rec: SceneRecord):
        self._clock += 1
        rec.last_used = self._clock

    def _prepare(self, field, cubes: Optional[CubeSet]):
        """Coerce -> normalise representation -> place on the store's
        device. encode serves the hybrid streams (no-op when pre-encoded);
        encode=False decodes, the dense-baseline toggle. Cubes rebuild at
        the shared `cfg.occ_sigma_thresh` when not supplied (on the card,
        through the gather kernels for an encoded field). The field is
        placed before it is encoded, so the encode runs on the store's
        device."""
        field = distributed.place_field(field_lib.as_backend(field, self.cfg),
                                        self.rules)
        field = field.encode() if self.encode_fields else field.decode()
        if cubes is None:
            occ = occ_lib.build_occupancy(field, self.cfg)
            cubes = occ_lib.extract_cubes(occ, self.cfg)
        else:
            cubes = place_cubes(cubes, self.device)
        return field, cubes

    # -- scene lifecycle ---------------------------------------------------

    def register(self, name: str, field, cubes: Optional[CubeSet] = None
                 ) -> SceneRecord:
        """Make `name` resident with `field` (+ optional precomputed cubes).
        Registering an existing name is an error — republish via
        `publish()`, which keeps the scene's telemetry."""
        def taken():
            return ValueError(
                f"scene '{name}' already registered — use publish() to "
                f"replace its field")
        with self._lock:                  # fail fast, before the encode/
            if name in self._records:     # occupancy work in _prepare
                raise taken()
        field, cubes = self._prepare(field, cubes)
        with self._lock:
            if name in self._records:     # lost a register-register race
                raise taken()
            rec = SceneRecord(name=name,
                              m=SceneMetrics.create(self.metrics, name))
            self._records[name] = rec
            self._install(rec, field, cubes)
            self._touch(rec)
            self._enforce_budget(protect=name)
        return rec

    def _install(self, rec: SceneRecord, field, cubes: CubeSet):
        """Publish (field, cubes) into `rec` (store lock held, field already
        prepared). A NEW ordering cache, counters carried — a flush holding
        the previous snapshot stays consistent."""
        rec.field = field
        rec.cubes = cubes
        if rec.ordering is not None:
            rec.ordering = rec.ordering.with_cubes(cubes)
        else:
            rec.ordering = rt_pipe.OrderingCache(cubes, self.order_mode,
                                                 scene=rec.name,
                                                 registry=self.metrics)
            rec.ordering.hits, rec.ordering.misses, rec.ordering.nn_hits = \
                (rec._ord_hits, rec._ord_misses, rec._ord_nn_hits)
        rec.factor_bytes = field.factor_bytes()
        rec.factor_bytes_dense = field.dense_factor_bytes()
        rec.resident = True

    def publish(self, name: str, field, cubes: Optional[CubeSet] = None):
        """Atomically replace a scene's served field (the swap_field
        path). The scene need not be resident: publishing into an evicted
        scene revives it around the new field. Queued engine requests are
        never dropped: they render from the new snapshot at their flush.
        Pass precomputed `cubes` to keep the lock hold, and with it the
        producer-visible swap latency, to the pointer switch."""
        t0 = time.perf_counter()
        field, cubes = self._prepare(field, cubes)
        with self._lock:
            rec = self._get(name)
            self._install(rec, field, cubes)
            self._touch(rec)
            swap_s = time.perf_counter() - t0
            rec.m.swaps.inc()
            rec.m.swap_latencies.record(swap_s)   # bounded ring, all-time max
            self._swap_latency_last.set(swap_s)
            self._enforce_budget(protect=name)

    def update_cubes(self, name: str, cubes: CubeSet):
        """Occupancy rebuilt (e.g. the field was re-pruned): swap the cube
        set; the ordering cache restarts empty (counters carried)."""
        cubes = place_cubes(cubes, self.device)
        with self._lock:
            rec = self.ensure_resident(name)
            rec.cubes = cubes
            rec.ordering = rec.ordering.with_cubes(cubes)

    def _get(self, name: str) -> SceneRecord:
        rec = self._records.get(name)
        if rec is None:
            raise KeyError(
                f"unknown scene '{name}' (registered: "
                f"{sorted(self._records) or 'none'})")
        return rec

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._records

    def scenes(self) -> List[str]:
        with self._lock:
            return sorted(self._records)

    def first_scene(self) -> Optional[str]:
        """Earliest-registered scene name — the engine's default route for
        scene-less (single-scene, pre-store) call sites."""
        with self._lock:
            return next(iter(self._records), None)

    def resident_scenes(self) -> List[str]:
        with self._lock:
            return sorted(n for n, r in self._records.items() if r.resident)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(r.factor_bytes for r in self._records.values()
                       if r.resident)

    # -- pin / priority ----------------------------------------------------

    def pin(self, name: str, pinned: bool = True):
        """Pin a scene against LRU eviction: a pinned scene is never chosen
        as a budget victim (an explicit `evict()` still works: the caller
        is being deliberate there)."""
        with self._lock:
            self._get(name).pinned = bool(pinned)

    def set_priority(self, name: str, priority: int):
        """Eviction priority: under budget pressure the LOWEST-priority
        resident scene is evicted first (ties broken by LRU clock).
        Default 0."""
        with self._lock:
            self._get(name).priority = int(priority)

    # -- eviction / revival ------------------------------------------------

    def _enforce_budget(self, protect: Optional[str] = None):
        """Evict resident scenes until under budget. Victim order: lowest
        priority first, then least-recently-used. Never evicts `protect`,
        pinned scenes, or the last one standing if it alone exceeds the
        budget: an unservable store would be worse than an over-budget
        one."""
        if self.max_resident_bytes is None:
            return
        while self.resident_bytes() > self.max_resident_bytes:
            victims = [r for r in self._records.values()
                       if r.resident and r.name != protect and not r.pinned]
            if not victims:
                break
            self.evict(min(victims,
                           key=lambda r: (r.priority, r.last_used)).name)

    def evict(self, name: str):
        """Demote a resident scene to its encoded checkpoint: spill the
        bitmap/COO streams as they are (`ckpt.spill_field`) plus the cube
        set, then drop every device reference the store holds to them
        (field, cubes, and the ordering cache's permuted tensors), so the
        card's memory is freed once no snapshot holds them. Telemetry
        stays on the record; the ordering counters are parked for
        revival."""
        with self._lock:
            rec = self._get(name)
            if not rec.resident:
                return
            path = os.path.join(self.spill_dir, name)
            ckpt_lib.spill_field(path, rec.field,
                                 extra_meta={"scene": name})
            save_cubes(path, rec.cubes)
            rec._ord_hits = rec.ordering.hits
            rec._ord_misses = rec.ordering.misses
            rec._ord_nn_hits = rec.ordering.nn_hits
            rec.field = rec.cubes = rec.ordering = None
            rec.spill_path = path
            rec.resident = False
            rec.m.evictions.inc()
            self._evictions_total.inc()

    def ensure_resident(self, name: str) -> SceneRecord:
        """Revive `name` from its spill checkpoint if evicted (bit-for-bit:
        `ckpt.unspill_field` rebuilds the exact encoded representation, and
        the cube set is reloaded, not rebuilt). Touches the LRU clock."""
        with self._lock:
            rec = self._get(name)
            if not rec.resident:
                # placement only: the representation is already encoded
                field, _ = ckpt_lib.unspill_field(rec.spill_path, self.cfg,
                                                  device="cpu")
                field = distributed.place_field(field, self.rules)
                cubes = load_cubes(rec.spill_path, device=self.device)
                self._install(rec, field, cubes)
                rec.m.revivals.inc()
                self._revivals_total.inc()
                self._touch(rec)
                self._enforce_budget(protect=name)
            self._touch(rec)
            return rec

    # -- engine-facing reads -----------------------------------------------

    def snapshot(self, name: str) -> SceneSnapshot:
        """The consistent (field, cubes, ordering) triple one flush group
        renders from, reviving the scene first if needed."""
        with self._lock:
            rec = self.ensure_resident(name)
            return SceneSnapshot(name, rec.field, rec.cubes, rec.ordering,
                                 rec.factor_bytes, rec.factor_bytes_dense)

    def get_field(self, name: str) -> field_lib.FieldBackend:
        """The currently published field (revived if evicted)."""
        with self._lock:
            return self.ensure_resident(name).field

    def dispatch_path(self, name: str) -> str:
        """The path the scene's field evaluates by (`FieldBackend.
        dispatch_path`), or "evicted" while it is on disk."""
        with self._lock:
            rec = self._get(name)
            return rec.field.dispatch_path() if rec.resident else "evicted"

    def note_served(self, name: str, latencies: List[float],
                    render_s: float):
        """Commit one flush group's serving telemetry to the scene."""
        with self._lock:
            rec = self._get(name)
            rec.m.views_served.inc(len(latencies))
            rec.m.latencies.extend(latencies)
            rec.m.render_s.inc(render_s)

    # -- telemetry ---------------------------------------------------------

    def _scene_stats(self, rec: SceneRecord) -> Dict:
        m = rec.m
        views, render_s = int(m.views_served.value), m.render_s.value
        ordering = (rec.ordering.stats() if rec.ordering is not None
                    else {"hits": rec._ord_hits, "misses": rec._ord_misses,
                          "nn_hits": rec._ord_nn_hits, "entries": 0})
        return {
            "scene": rec.name,
            "resident": rec.resident,
            "views_served": views,
            "fps": views / render_s if render_s > 0 else 0.0,
            "render_s": render_s,
            "latency_p50_s": m.latencies.percentile(50),
            "latency_p95_s": m.latencies.percentile(95),
            "latency_p99_s": m.latencies.percentile(99),
            "factor_bytes": float(rec.factor_bytes),
            "factor_bytes_dense": float(rec.factor_bytes_dense),
            "compression_ratio": (rec.factor_bytes_dense
                                  / max(rec.factor_bytes, 1)),
            "field_kind": (rec.field.kind if rec.resident else "evicted"),
            "occ_accesses_per_view": (float(rec.cubes.count)
                                      if rec.resident else 0.0),
            "pinned": rec.pinned,
            "priority": rec.priority,
            "swaps": int(m.swaps.value),
            "swap_latency_s_last": m.swap_latencies.last,
            "swap_latency_s_max": m.swap_latencies.max,   # all-time
            "evictions": int(m.evictions.value),
            "revivals": int(m.revivals.value),
            "ordering_cache": ordering,
        }

    def stats(self, scene: Optional[str] = None) -> Dict:
        with self._lock:
            if scene is not None:
                return self._scene_stats(self._get(scene))
            return {
                "n_scenes": len(self._records),
                "resident_scenes": self.resident_scenes(),
                "resident_bytes": self.resident_bytes(),
                "max_resident_bytes": self.max_resident_bytes,
                "evictions": self.evictions_total,
                "revivals": self.revivals_total,
                "scenes": {n: self._scene_stats(r)
                           for n, r in sorted(self._records.items())},
            }
