"""Scene-routed streaming serving engine over a store of resident
compressed fields. The port of `repro/serving/engine.py`.

A `serving.store.SceneStore` keeps any number of named scenes resident on
one device (encoded hybrid bitmap/COO fields, per-scene occupancy cubes
and ordering caches) under one device-memory budget
(`NeRFConfig.max_resident_bytes`, LRU eviction to encoded checkpoints with
transparent revival), and ONE `RenderEngine` serves request streams
against all of them. Costs the per-view loop would pay on every request
are paid once per engine or once per scene:

  * encode        the hybrid encoding is built at scene registration and
                  stays resident in the store;
  * occupancy     each scene's cube set is built once (through the gather
                  kernels for an encoded field) unless given or reloaded;
  * ordering      per-view `order_cubes` schedules are cached per scene
                  (`pipeline.OrderingCache`);
  * batching      queued views are micro-batched into fixed ray chunks
                  (`serving.batching`), so the renderer runs at one shape
                  whatever the mix of views, resolutions and scenes;
  * pair budget   the active-pair compaction budget adapts to observed
                  occupancy (`aux["active_pairs_max"]`) with hysteresis.

API: `submit(cam, scene="lego", deadline_s=...) -> ViewFuture` queues a
request against a scene (scene=None routes to the default scene, so the
single-scene call sites keep working); `flush()` renders the queue grouped
by (scene, ordering key), each group from one consistent per-scene
snapshot; `submit_delta(cam, prev)` renders only the rays the temporal
warp of the previous frame cannot vouch for (`serving.temporal`);
`swap_field(field, scene=...)` / `update_cubes(cubes, scene=...)` publish
through the store; `register_scene(name, field)` adds scenes to a running
engine; `stats()` aggregates and `stats(scene=...)` itemises, both from
the shared metrics registry; `stage_breakdown()` reads the per-request
span histograms (`obs.tracing`). All entry points are thread-safe; renders
run outside the engine lock. With `auto_flush_interval` set a background
thread flushes on a full queue or when the interval expires; `close()`
(or the context manager) joins it. `from_scene` / `from_scenes` train
each field once or restore it from its checkpoint (`prepare_field`).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import distributed
from repro_torch.core import field as field_lib
from repro_torch.core import occupancy as occ_lib
from repro_torch.core import pipeline as rt_pipe
from repro_torch.core import rendering, tensorf
from repro_torch.core import train as train_lib
from repro_torch.core.occupancy import CubeSet
from repro_torch.core.rendering import Camera
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S, make_host_mesh
from repro_torch.models.sharding import make_rules
from repro_torch.obs import REPORT_STAGES, MetricsRegistry, Tracer, lockdebug
from repro_torch.obs.tracing import ViewTrace
from repro_torch.serving import temporal
from repro_torch.serving.batching import group_requests, plan_microbatches
from repro_torch.serving.store import SceneSnapshot, SceneStore


@dataclasses.dataclass
class ViewResult:
    view_id: int
    img: Optional[np.ndarray]       # (H*W, 3); None when timed out
    psnr: Optional[float]           # vs the submitted gt, if any
    latency_s: float                # submit -> resolve (queueing + render)
    stats: Dict[str, object]
    timed_out: bool = False         # deadline passed before render started
    scene: str = ""                 # which resident scene rendered this
    trace: Optional[Dict] = None    # span tree (obs.ViewTrace.tree()), if
                                    # tracing was on at submit
    depth: Optional[np.ndarray] = None    # (H*W,) accumulated E[w t]
    opacity: Optional[np.ndarray] = None  # (H*W,) 1 - final transmittance
    cam: Optional[Camera] = None    # the camera this frame was rendered for
                                    # (with depth/opacity, what
                                    # submit_delta warps for the next frame)
    warp_fraction: float = 0.0      # fraction served by the temporal warp
                                    # (0.0 = fully rendered / keyframe)


class ViewFuture:
    """Handle for one queued view.

    `result()` resolves the future: with the engine's background flush
    thread running it waits (the flusher renders); without it, the
    caller's thread flushes the engine, and if a concurrent flush already
    claimed this request, waits for that render to land. With a `timeout`
    an unresolved view raises TimeoutError after that many seconds."""

    def __init__(self, engine: "RenderEngine", view_id: int):
        self._engine = engine
        self._view_id = view_id
        self._result: Optional[ViewResult] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._result is not None

    def result(self, timeout: Optional[float] = None) -> ViewResult:
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while self._result is None:
            if not self._engine._auto_flush_on():
                self._engine.flush()         # propagates render errors
                if self._result is not None:
                    break
            # flusher active, or a concurrent flush claimed this request:
            # wait for the render (short slices so errors surface)
            wait = 0.1
            if deadline is not None:
                wait = min(wait, deadline - time.perf_counter())
                if wait <= 0:
                    raise TimeoutError(
                        f"view {self._view_id} unresolved after {timeout}s")
            self._event.wait(max(wait, 1e-3))
            self._engine._raise_flush_error()
        return self._result

    def _set(self, res: ViewResult):
        self._result = res
        self._event.set()


@dataclasses.dataclass(eq=False)
class _Request:
    cam: Camera
    gt: Optional[np.ndarray]
    future: ViewFuture
    t_submit: float
    deadline: Optional[float] = None     # absolute perf_counter time
    scene: str = ""                      # routing key into the SceneStore
    trace: Optional[ViewTrace] = None    # span tree; None = tracing off
    delta: Optional[temporal.DeltaPlan] = None  # sparse-ray work order;
                                         # None = render the full frame


FIELD_META = "field_meta.json"

# Lint declarations (scripts/repro_lint.py, docs/static_analysis.md):
# mutable RenderEngine state below is guarded by `_lock` (`_flush_cv` is a
# Condition over the same lock); `_render_lock` serializes renders and
# takes part in lock ordering only. Methods in `assume_held` are called
# with the lock held (reentrant RLock callers).
GUARDED_BY = {
    "RenderEngine": {
        "lock": "_lock",
        "aliases": ("_flush_cv",),
        "locks": ("_render_lock",),
        "attrs": ("_queue", "_next_id", "_flusher", "_flush_error",
                  "auto_flush_interval", "_pair_budget", "_pair_window",
                  "_low_occ_streak", "_pair_occupancy_last",
                  "_budget_resizes", "_render"),
        "assume_held": ("_note_flush_pairs", "_build_render"),
    },
}
# Attribute -> class map for static lock-order edges (calls made while a
# lock is held resolve into these classes' own lock acquisitions).
LOCK_ATTR_CLASSES = {
    "RenderEngine.store": "SceneStore",
    "RenderEngine.metrics": "MetricsRegistry",
    "RenderEngine._g_queue": "Gauge",
    "RenderEngine._g_budget": "Gauge",
    "RenderEngine._m_render_s": "Counter",
    "RenderEngine._m_flushes": "Counter",
    "RenderEngine._m_latency": "Histogram",
}

def prepare_field(cfg: NeRFConfig, scene: str, *, ckpt_dir: Optional[str],
                  train_steps: int = 200, n_views: int = 8,
                  image_hw: int = 64, seed: int = 0, verbose: bool = True,
                  device: DeviceLike = None) -> field_lib.FieldBackend:
    """Load the trained field of `scene` from `ckpt_dir` onto `device`, or
    train it once (compressed-native, `core.train.train_nerf`) and
    checkpoint it there in its encoded representation, with the
    reference's meta file, so that the next call restores. A restore is
    checked against the scene (`FIELD_META`) and the cfg shapes
    (`field.cfg_mismatches`); a field checkpoint (`ckpt.save_field`)
    restores encoded, a legacy params-dict checkpoint (no state keys)
    restores dense."""
    dev = resolve_device(device)
    step = ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None
    if step is None:
        return _train_field(cfg, scene, ckpt_dir=ckpt_dir,
                            train_steps=train_steps, n_views=n_views,
                            image_hw=image_hw, seed=seed, verbose=verbose,
                            device=dev)
    meta_path = os.path.join(ckpt_dir, FIELD_META)
    if not os.path.exists(meta_path):
        raise ValueError(
            f"checkpoint at {ckpt_dir} has no {FIELD_META}: can't verify "
            f"which scene it holds; restore the meta file")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("scene") != scene:
        raise ValueError(
            f"checkpoint at {ckpt_dir} holds scene '{meta.get('scene')}', "
            f"not '{scene}': use a different --ckpt-dir per scene")
    if verbose:
        print(f"[engine] restoring scene '{scene}' from {ckpt_dir} "
              f"(trained {meta.get('steps')} steps, seed {meta.get('seed')})")
    try:
        restored, _ = ckpt_lib.restore_field(ckpt_dir, step, cfg, device=dev)
    except ValueError:
        # legacy checkpoint: a raw params dict saved without state_keys /
        # field_spec; restore through the template path, serve it dense
        like = {k: torch.empty(shape, device="meta")
                for k, shape in tensorf.field_shapes(cfg).items()}
        params = ckpt_lib.restore_checkpoint(ckpt_dir, step, like,
                                             device=dev)
        restored = field_lib.DenseField(params, cfg)
        if verbose:
            print(f"[engine] {ckpt_dir} holds a legacy params-dict "
                  f"checkpoint; restored dense (re-save with "
                  f"ckpt.save_field to keep it encoded)")
    bad = field_lib.cfg_mismatches(restored, cfg)
    if bad:
        raise ValueError(
            f"checkpoint at {ckpt_dir} was trained with a different "
            f"NeRFConfig: {'; '.join(bad)}")
    return restored


def _train_field(cfg: NeRFConfig, scene: str, *, ckpt_dir: Optional[str],
                 train_steps: int, n_views: int, image_hw: int, seed: int,
                 verbose: bool, device: torch.device
                 ) -> field_lib.FieldBackend:
    """prepare_field's train branch: train, then checkpoint (meta first:
    dying between the writes leaves meta and no step, which retrains on
    the next call rather than serving blind)."""
    res = train_lib.train_nerf(cfg, scene, steps=train_steps,
                               n_views=n_views, image_hw=image_hw,
                               log_every=max(train_steps // 2, 1), seed=seed,
                               verbose=verbose, device=device)
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, FIELD_META), "w") as f:
            json.dump({"scene": scene, "steps": train_steps, "seed": seed,
                       "grid_res": cfg.grid_res}, f)
        path = ckpt_lib.save_field(ckpt_dir, train_steps, res.field)
        if verbose:
            print(f"[engine] checkpointed field to {path}")
    return res.field


class RenderEngine:
    """Batched novel-view serving on one device or across the ranks of a
    mesh, scene-routed over a SceneStore.

    The single-scene constructor `RenderEngine(cfg, field, cubes, ...)`
    builds a one-scene store (under `scene_name`, default "default") and
    every scene-less entry point routes to that default scene.
    Multi-scene serving passes `store=` (or calls `register_scene` on a
    running engine) and keys each call with `scene=`. `device` is where
    the store keeps its scenes and the renderer runs (None: the card; with
    `store=`, the store's device).

    `mesh` (None: `launch.mesh.make_host_mesh(device)`, the world mesh
    when a process group is up) spreads each ray chunk over the mesh's
    "data" ranks (`core.distributed`): every rank runs the same program
    (the same submits in the same order), renders its slice of each chunk
    and receives the whole image, and the chunk's counters are reduced to
    what one device counts, so every rank keeps the same pair budget.
    Rank 0 decides which queued views each flush renders and which have
    expired, and sends that to the other ranks before any renders: a
    flush is a collective, and so is `submit` when it fills the queue.
    With the background flusher, rank 0's thread times the flushes and
    the other ranks' threads follow it (`start_auto_flush`)."""

    def __init__(self, cfg: NeRFConfig, field=None,
                 cubes: Optional[CubeSet] = None, *,
                 store: Optional[SceneStore] = None,
                 scene_name: str = "default",
                 encode: bool = True, ray_chunk: int = 4096,
                 cube_chunk: int = 8, pair_budget: Optional[int] = None,
                 adaptive_pair_budget: bool = True,
                 order_mode: str = "octant", max_batch_views: int = 8,
                 delta_ray_bucket: Optional[int] = None,
                 auto_flush_interval: Optional[float] = None,
                 max_resident_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 trace_requests: bool = True,
                 device: DeviceLike = None, mesh=None):
        self.cfg = cfg
        self.ray_chunk = int(ray_chunk)
        self.cube_chunk = int(cube_chunk)
        self.max_batch_views = int(max_batch_views)

        if store is not None:
            if field is not None or cubes is not None:
                raise ValueError(
                    "pass either store= or a (field, cubes) pair, not both")
            if registry is not None and registry is not store.metrics:
                raise ValueError(
                    "registry= conflicts with store=: the engine shares "
                    "its store's registry")
            if device is not None and resolve_device(device) != store.device:
                raise ValueError(f"device {device} differs from the store's "
                                 f"{store.device}")
            if mesh is not None and mesh is not store.rules.mesh:
                raise ValueError("mesh= conflicts with store=: the engine "
                                 "serves on its store's mesh")
            self.store = store
        else:
            if mesh is None:
                mesh = make_host_mesh(device)
            elif device is not None and resolve_device(device) != \
                    mesh.device:
                raise ValueError(f"device {device} differs from the mesh's "
                                 f"{mesh.device}")
            self.store = SceneStore(
                cfg, rules=make_rules(mesh), encode=encode,
                order_mode=order_mode, max_resident_bytes=max_resident_bytes,
                spill_dir=spill_dir, registry=registry)
            if field is not None:
                self.store.register(scene_name, field, cubes)
            elif cubes is not None:
                raise ValueError("cubes given without a field")
        self.device = self.store.device
        self.rules = self.store.rules
        self.n_devices = self.rules.mesh.size
        if self.n_devices > 1 and self.n_devices != dist.get_world_size():
            raise ValueError(
                f"a mesh of {self.n_devices} ranks in a process group of "
                f"{dist.get_world_size()}: the engine's flushes are "
                f"collectives of the whole group")

        # ONE registry for the store's whole serving stack: engine totals,
        # per-scene records and request-stage histograms. trace_requests
        # =False disables span tracing only; the counters always run.
        self.metrics = self.store.metrics
        self.tracer = Tracer(self.metrics, enabled=trace_requests)
        m = self.metrics
        self._m_views = m.counter("engine_views_served")
        self._m_flushes = m.counter("engine_flushes")
        self._m_render_s = m.counter("engine_render_s")
        self._m_dropped = m.counter("engine_dropped_pairs")
        self._m_timeouts = m.counter("engine_timeouts")
        self._m_latency = m.histogram("engine_latency_s", maxlen=65536)
        self._g_queue = m.gauge("engine_queue_depth")
        self._g_budget = m.gauge("engine_pair_budget")
        # temporal tier (submit_delta): created eagerly so every metrics
        # snapshot carries the warp schema before the first delta frame
        self._m_warp_rays = m.counter("warp_rays_total")
        self._m_delta_rays = m.counter("engine_delta_rays")
        self._m_delta_views = m.counter("engine_delta_views")
        self._m_delta_fallbacks = m.counter("engine_delta_full_fallbacks")
        self._m_warp_frac = m.histogram("warp_fraction", maxlen=4096)
        m.counter("render_dispatch_total", path="delta")
        # fresh-ray counts are padded to this bucket so a delta frame's
        # chunk count doesn't track the disocclusion count frame to frame
        self.delta_ray_bucket = int(delta_ray_bucket if delta_ray_bucket
                                    else max(self.ray_chunk // 8, 32))

        # ONE renderer shared by every scene (the field is an argument).
        # The active-pair budget starts at the static default (or
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
        self._g_budget.set(self._pair_budget)
        self._build_render()

        # _lock guards queue / stats / budget; renders run OUTSIDE it
        # (serialized by _render_lock) against per-scene store snapshots,
        # so producers, swap_field and eviction never wait behind a render
        self._lock = lockdebug.make_lock("engine", kind="rlock")
        self._render_lock = lockdebug.make_lock("engine.render")
        self._flush_cv = threading.Condition(self._lock)

        self._queue: List[_Request] = []
        self._next_id = 0

        self._flusher: Optional[threading.Thread] = None
        self._flusher_stop = threading.Event()
        self._flush_error: Optional[BaseException] = None
        self.auto_flush_interval: Optional[float] = None
        if auto_flush_interval is not None:
            self.start_auto_flush(auto_flush_interval)

    def _build_render(self):
        self._render = rt_pipe.make_ray_renderer(
            self.cfg, chunk=self.cube_chunk, pair_budget=self._pair_budget)

    # -- observability -----------------------------------------------------

    def queue_depth(self) -> int:
        """Requests currently queued (not yet claimed by a flush)."""
        with self._lock:
            return len(self._queue)

    def set_tracing(self, enabled: bool):
        """Toggle per-request span tracing (the counters always run).
        Requests already queued keep the mode they were submitted under."""
        self.tracer.enabled = bool(enabled)

    # -- scene routing -----------------------------------------------------

    @property
    def default_scene(self) -> Optional[str]:
        """Where scene-less calls route: the earliest-registered scene."""
        return self.store.first_scene()

    def _scene_key(self, scene: Optional[str]) -> str:
        if scene is not None:
            return scene
        name = self.default_scene
        if name is None:
            raise RuntimeError("engine has no registered scenes: call "
                               "register_scene() or pass field/cubes")
        return name

    def register_scene(self, name: str, field,
                       cubes: Optional[CubeSet] = None) -> str:
        """Add a resident scene to the running engine (budget-enforced:
        may evict a colder scene). Returns the scene key."""
        self.store.register(name, field, cubes)
        return name

    # -- single-scene views (default-scene routed) -------------------------

    @property
    def field(self):
        return self.store.get_field(self._scene_key(None))

    @property
    def cubes(self) -> CubeSet:
        return self.store.snapshot(self._scene_key(None)).cubes

    @property
    def ordering(self) -> rt_pipe.OrderingCache:
        return self.store.snapshot(self._scene_key(None)).ordering

    # -- background flush thread -------------------------------------------

    def _auto_flush_on(self) -> bool:
        with self._lock:
            t = self._flusher
        return t is not None and t.is_alive()

    def _raise_flush_error(self):
        with self._lock:
            err, self._flush_error = self._flush_error, None
        if err is not None:
            raise err

    def start_auto_flush(self, interval_s: float):
        """Start the background flush thread: producers only enqueue
        (submit never renders inline); the flusher renders when the queue
        reaches `max_batch_views` or every `interval_s` seconds, whichever
        comes first. Pair with `close()` (or use the engine as a context
        manager): the thread is not a daemon, so a leak is loud.

        On a mesh of several ranks only rank 0's thread times flushes; on
        every other rank the thread follows rank 0 (`_follow_loop`),
        rendering each flush rank 0 announces, and `flush()` there waits
        for the views queued so far. Every rank starts it and closes the
        engine alike."""
        with self._lock:
            if self._flusher is not None:
                raise RuntimeError("auto-flush thread already running")
            self.auto_flush_interval = float(interval_s)
            self._flusher_stop.clear()
            follow = self.n_devices > 1 and dist.get_rank() != 0
            self._flusher = threading.Thread(
                target=self._follow_loop if follow else self._flush_loop,
                name="engine-auto-flush")
            self._flusher.start()

    def _flush_loop(self):
        while True:
            with self._flush_cv:
                # a pending error means the last flush failed and requeued
                # its batch: wait out the interval then (backoff) instead
                # of spinning on a queue that stays full
                if not self._flusher_stop.is_set() and \
                        (self._flush_error is not None or
                         len(self._queue) < self.max_batch_views):
                    self._flush_cv.wait(self.auto_flush_interval)
                if self._flusher_stop.is_set():
                    break
            try:
                self.flush()
            except BaseException as e:   # surfaced via result()/close()
                with self._lock:
                    self._flush_error = e
        try:
            self.flush()                 # drain so close() strands nothing
        except BaseException as e:
            with self._lock:
                self._flush_error = e

    def _follow_loop(self):
        """A flush thread on a rank other than 0: render each flush that
        rank 0 announces (its view ids and expiries), once this rank has
        queued those views, until rank 0 closes its engine (an empty
        announcement)."""
        while True:
            header = [None]
            try:
                dist.broadcast_object_list(header, src=0)
                if header[0] is None:
                    return
                with self._render_lock:
                    reqs, expired = self._take(header[0],
                                               COLLECTIVE_TIMEOUT_S)
                    with self._lock:
                        render_fn, budget = self._render, self._pair_budget
                    self._render_claimed(reqs, expired, render_fn, budget)
            except BaseException as e:   # surfaced via result()/close()
                with self._lock:
                    self._flush_error = e
                return

    def _take(self, header, wait_s: float):
        """(requests, expired): the views rank 0 announced (`header`: view
        ids and expiries), taken off this rank's queue, waiting up to
        `wait_s` for this rank's program to submit them. The same submits
        in the same order give the same ids on every rank; a view still
        missing means the ranks ran different programs: it raises."""
        ids = [v for v, _ in header]
        deadline = time.monotonic() + wait_s
        with self._flush_cv:
            while True:
                have = {r.future._view_id: r for r in self._queue}
                missing = [v for v in ids if v not in have]
                left = deadline - time.monotonic()
                if not missing:
                    break
                if left <= 0:
                    raise RuntimeError(
                        f"rank {dist.get_rank()} never queued views "
                        f"{missing} that rank 0 flushes: every rank must "
                        f"submit the same views in the same order")
                self._flush_cv.wait(left)
            take = set(ids)
            self._queue = [r for r in self._queue
                           if r.future._view_id not in take]
            self._g_queue.set(len(self._queue))
        return [have[v] for v in ids], [e for _, e in header]

    def _following(self) -> bool:
        return (self.n_devices > 1 and dist.get_rank() != 0
                and self._auto_flush_on())

    def close(self, timeout: Optional[float] = None):
        """Stop the background flush thread (joining it), drain the queue,
        and surface any deferred flush error. With a `timeout`, a flush
        thread still running after that many seconds raises TimeoutError
        (it has been told to stop, and exits after its current flush).
        On a mesh, rank 0 then tells the following ranks' threads to
        stop, and a following rank's thread ends there."""
        with self._lock:
            t, self._flusher = self._flusher, None
            self._flusher_stop.set()
            self._flush_cv.notify_all()
        lead = self.n_devices == 1 or dist.get_rank() == 0
        if t is not None and lead:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"auto-flush thread still running after {timeout}s")
            self.flush()
            if self.n_devices > 1:
                dist.broadcast_object_list([None], src=0)
        elif t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"rank {dist.get_rank()}'s flush thread still follows "
                    f"rank 0 after {timeout}s")
            with self._lock:
                stranded = [r.future._view_id for r in self._queue]
            if stranded:
                raise RuntimeError(f"views {stranded} were never flushed by "
                                   f"rank 0")
        else:
            self.flush()
        self._raise_flush_error()

    def __enter__(self) -> "RenderEngine":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- field lifecycle ---------------------------------------------------

    @classmethod
    def from_scene(cls, cfg: NeRFConfig, scene: str, *,
                   ckpt_dir: Optional[str] = None, train_steps: int = 200,
                   n_views: int = 8, image_hw: int = 64,
                   prune_sparsity: float = 0.0, seed: int = 0,
                   verbose: bool = True, device: DeviceLike = None,
                   **kw) -> "RenderEngine":
        """Train once or restore (`prepare_field`), prune, rebuild
        occupancy, go resident under the scene's own name."""
        field = prepare_field(cfg, scene, ckpt_dir=ckpt_dir,
                              train_steps=train_steps, n_views=n_views,
                              image_hw=image_hw, seed=seed, verbose=verbose,
                              device=device)
        if prune_sparsity > 0.0:
            field = field.prune(sparsity=prune_sparsity)
        occ = occ_lib.build_occupancy(field, cfg)
        cubes = occ_lib.extract_cubes(occ, cfg)
        return cls(cfg, field, cubes, scene_name=scene, device=device, **kw)

    @classmethod
    def from_scenes(cls, cfg: NeRFConfig, scenes: Sequence[str], *,
                    ckpt_root: Optional[str] = None, train_steps: int = 200,
                    n_views: int = 8, image_hw: int = 64,
                    prune_sparsity: float = 0.0, seed: int = 0,
                    verbose: bool = True, device: DeviceLike = None,
                    **kw) -> "RenderEngine":
        """One engine serving several named scenes, each trained once or
        restored from its subdirectory of `ckpt_root` and registered; with
        a `max_resident_bytes` budget the store evicts cold scenes as
        warmer ones register."""
        if not scenes:
            raise ValueError("from_scenes needs at least one scene")
        engine: Optional[RenderEngine] = None
        for s in scenes:
            ckpt = os.path.join(ckpt_root, s) if ckpt_root else None
            field = prepare_field(cfg, s, ckpt_dir=ckpt,
                                  train_steps=train_steps, n_views=n_views,
                                  image_hw=image_hw, seed=seed,
                                  verbose=verbose, device=device)
            if prune_sparsity > 0.0:
                field = field.prune(sparsity=prune_sparsity)
            if engine is None:
                engine = cls(cfg, field, None, scene_name=s, device=device,
                             **kw)
            else:
                engine.register_scene(s, field)
        return engine

    def swap_field(self, field, cubes: Optional[CubeSet] = None, *,
                   scene: Optional[str] = None):
        """Atomically publish a new field for one scene through the store.
        Queued requests are not dropped: they render from the new field
        at the next flush; a render already in flight finishes from its
        own snapshot. Without `cubes` the occupancy is rebuilt from the
        new field at cfg.occ_sigma_thresh."""
        self.store.publish(self._scene_key(scene), field, cubes)

    def update_cubes(self, cubes: CubeSet, *, scene: Optional[str] = None):
        """Occupancy rebuilt (e.g. the field was re-pruned): swap the cube
        set and start from an empty ordering cache."""
        self.store.update_cubes(self._scene_key(scene), cubes)

    # -- request/response --------------------------------------------------

    def submit(self, cam: Camera, gt=None, *, scene: Optional[str] = None,
               deadline_s: Optional[float] = None) -> ViewFuture:
        """Queue one novel-view request against a scene; returns a future.
        scene=None routes to the default scene. Submitting against an
        evicted scene revives it here, before the engine lock is taken.
        The queue flushes when it reaches `max_batch_views` (or on
        flush()/result()); with the background flusher running, submit
        only enqueues and notifies. If `deadline_s` (seconds from now)
        passes before the render starts, the request resolves timed out
        instead of rendering late."""
        key = self._scene_key(scene)
        self.store.ensure_resident(key)
        return self._enqueue(cam, gt, key, deadline_s)

    def _enqueue(self, cam: Camera, gt, key: str,
                 deadline_s: Optional[float], *,
                 delta: Optional[temporal.DeltaPlan] = None,
                 t_start: Optional[float] = None,
                 pre_spans: Sequence[tuple] = ()) -> ViewFuture:
        """Shared tail of submit/submit_delta: queue one request under the
        engine lock. `t_start` backdates the request (submit_delta's warp
        ran before the lock); `pre_spans` are (name, t0, t1, attrs) stage
        spans measured before the trace existed."""
        with self._lock:
            fut = ViewFuture(self, self._next_id)
            now = time.perf_counter()
            t0 = now if t_start is None else t_start
            trace = self.tracer.start(self._next_id, key, t_submit=t0)
            deadline = None if deadline_s is None else now + deadline_s
            self._queue.append(
                _Request(cam, gt, fut, t0, deadline, key, trace, delta))
            self._next_id += 1
            self._g_queue.set(len(self._queue))
            if trace is not None:
                for name, s0, s1, attrs in pre_spans:
                    trace.add(name, s0, s1, **attrs)
                trace.add("submit", now, time.perf_counter())
            full = len(self._queue) >= self.max_batch_views
            if self.n_devices > 1:
                self._flush_cv.notify_all()    # a following thread waits
            if full and self._auto_flush_on():
                self._flush_cv.notify()
                full = False
        if full:
            self.flush()
        return fut

    def submit_delta(self, cam: Camera, prev: Optional[ViewResult] = None,
                     gt=None, *, scene: Optional[str] = None,
                     deadline_s: Optional[float] = None,
                     max_delta_frac: float = 0.6) -> ViewFuture:
        """Queue a frame-coherent request: warp `prev` (the previous
        frame's ViewResult) to `cam` and render only the rays the warp
        cannot vouch for; the composited frame resolves like `submit`'s,
        with `warp_fraction` telling how much was reused. A full render
        (identical to `submit`'s) is the fallback when `prev` is unusable
        (a keyframe, a timed-out prev, another resolution) or when the
        fresh rays exceed `max_delta_frac` of the frame. The warp and mask
        run on the submitting thread (traced as `warp` / `mask`)."""
        key = self._scene_key(scene)
        self.store.ensure_resident(key)
        usable = (prev is not None and not prev.timed_out
                  and prev.img is not None and prev.depth is not None
                  and prev.opacity is not None and prev.cam is not None
                  and int(prev.cam.h) == int(cam.h)
                  and int(prev.cam.w) == int(cam.w))
        if not usable:
            return self._enqueue(cam, gt, key, deadline_s)
        t_w0 = time.perf_counter()
        warp = temporal.warp_radiance(prev.img, prev.cam, cam, prev.depth,
                                      opacity=prev.opacity)
        t_w1 = time.perf_counter()
        plan = temporal.plan_delta(warp, bucket=self.delta_ray_bucket)
        t_m1 = time.perf_counter()
        n_pix = int(cam.h) * int(cam.w)
        if plan.n_real > max_delta_frac * n_pix:
            self._m_delta_fallbacks.inc()
            return self._enqueue(cam, gt, key, deadline_s, t_start=t_w0)
        spans = (("warp", t_w0, t_w1, {}),
                 ("mask", t_w1, t_m1,
                  {"fresh_rays": plan.n_rays,
                   "warp_fraction": plan.warp_fraction}))
        return self._enqueue(cam, gt, key, deadline_s, delta=plan,
                             t_start=t_w0, pre_spans=spans)

    def flush(self) -> List[ViewResult]:
        """Render every queued view: group by (scene, ordering key),
        micro-batch each group's rays into fixed chunks and render them,
        each group from its scene's snapshot. Renders are serialized on
        `_render_lock` but run outside the engine lock. If a render fails,
        unresolved requests go back on the queue before the error
        propagates. On a rank that follows rank 0's flush thread, it waits
        for the views queued so far instead."""
        if self._following():
            with self._lock:
                futs = [r.future for r in self._queue]
            return [f.result() for f in futs]
        with self._render_lock:
            with self._lock:
                if not self._queue:
                    return []
                render_fn = self._render
                budget = self._pair_budget
            reqs, expired = self._claim()
            return self._render_claimed(reqs, expired, render_fn, budget)

    def _render_claimed(self, reqs: List[_Request], expired: List[bool],
                        render_fn, budget: int) -> List[ViewResult]:
        try:
            # snapshots are taken outside the engine lock (reviving a scene
            # evicted since its submit reads the disk) but inside this try,
            # so a failed revival requeues the batch
            snaps: Dict[str, SceneSnapshot] = {}
            for r in reqs:
                if r.scene not in snaps:
                    snaps[r.scene] = self.store.snapshot(r.scene)
            return self._flush(reqs, expired, snaps, render_fn, budget)
        except BaseException:
            with self._lock:
                self._queue = [r for r in reqs
                               if r.future._result is None] + self._queue
            raise

    def _claim(self):
        """(requests, expired): take this flush's views off the queue. On
        one rank, all of them, expired where the deadline has passed. On
        a mesh, rank 0 decides for every rank by its own queue and clock,
        and broadcasts the view ids and expiries; the other ranks take
        those views (`_take`)."""
        if self.n_devices > 1 and dist.get_rank() != 0:
            header = [None]
            dist.broadcast_object_list(header, src=0)
            return self._take(header[0], 0.0)
        with self._lock:
            reqs, self._queue = self._queue, []
            self._g_queue.set(0)
        now = time.perf_counter()
        expired = [r.deadline is not None and now > r.deadline for r in reqs]
        if self.n_devices > 1:
            try:
                dist.broadcast_object_list(
                    [[(r.future._view_id, e) for r, e in zip(reqs, expired)]],
                    src=0)
            except BaseException:
                with self._lock:
                    self._queue = reqs + self._queue
                raise
        return reqs, expired

    def _flush(self, reqs: List[_Request], expired: List[bool],
               snaps: Dict[str, SceneSnapshot], render_fn,
               budget: int) -> List[ViewResult]:
        t0 = time.perf_counter()
        results: List[ViewResult] = []

        # deadline pass: fail expired requests now, render the rest. Every
        # request's queue span closes here.
        live: List[_Request] = []
        for r, late in zip(reqs, expired):
            if r.trace is not None:
                r.trace.add("queue", r.t_submit, t0)
            if late:
                trace_tree = None
                if r.trace is not None:
                    r.trace.add("deliver", t0, t0, timed_out=True)
                    self.tracer.finish(r.trace, t_done=t0)
                    trace_tree = r.trace.tree()
                res = ViewResult(view_id=r.future._view_id, img=None,
                                 psnr=None, latency_s=t0 - r.t_submit,
                                 stats={}, timed_out=True, scene=r.scene,
                                 trace=trace_tree)
                self._m_timeouts.inc()
                r.future._set(res)
                results.append(res)
            else:
                live.append(r)
        if not live:
            return results

        tg = time.perf_counter()
        # delta requests batch apart from full frames: their ray sets are
        # sparse index gathers of the frame
        groups = group_requests(
            live, lambda r: (r.scene, snaps[r.scene].ordering.key_for(
                r.cam.origin), r.delta is not None))
        tg1 = time.perf_counter()
        for r in live:
            if r.trace is not None:
                r.trace.add("group", tg, tg1, n_groups=len(groups),
                            batch_views=len(live))

        flush_pairs = [0, 0]    # [max active pairs, successful render calls]
        flush_dropped = [0]
        try:
            self._flush_groups(groups, results, snaps, render_fn,
                               flush_pairs, flush_dropped)
        finally:
            # time spent counts even when a later group's render raised
            with self._lock:
                self._m_render_s.inc(time.perf_counter() - t0)
                self._m_flushes.inc()
                if flush_pairs[1]:
                    self._note_flush_pairs(flush_pairs[0], flush_dropped[0],
                                           budget)
        return results

    def _flush_groups(self, groups: Dict[tuple, List[_Request]],
                      results: List[ViewResult],
                      snaps: Dict[str, SceneSnapshot], render_fn,
                      flush_pairs: List[int], flush_dropped: List[int]):
        rules = self.rules
        for (scene, _okey, is_delta), reqs_g in groups.items():
            snap = snaps[scene]
            ordering = snap.ordering
            traces = [r.trace for r in reqs_g if r.trace is not None]

            def span_all(name, t0, t1, **attrs):
                # group-level stages are shared intervals: each member
                # request spent exactly [t0, t1] in this stage
                for tr in traces:
                    tr.add(name, t0, t1, **attrs)

            tg0 = time.perf_counter()
            for r in reqs_g:                      # one cache access per view
                centers, valid = ordering.get_ordered(r.cam.origin)
            t_ord = time.perf_counter()
            span_all("ordering", tg0, t_ord,
                     cache_entries=len(ordering._entries))
            batches = []
            for r in reqs_g:
                o, d = rendering.camera_rays(r.cam)
                o, d = o.cpu().numpy(), d.cpu().numpy()
                if r.delta is not None:
                    # only the low-confidence rays render; the rest of the
                    # frame arrives pre-warped in r.delta.warp
                    o, d = o[r.delta.idx], d[r.delta.idx]
                batches.append((o, d))
            plan = plan_microbatches(batches, self.ray_chunk)
            t_plan = time.perf_counter()
            span_all("compaction", t_ord, t_plan, n_chunks=plan.n_chunks,
                     rays=plan.total)
            outs, geo_outs = [], []
            g_dropped, g_pairs = 0, 0
            g_processed = 0.0
            for i in range(plan.n_chunks):
                n = plan.rays_o[i].shape[0]
                ro, rd = distributed.shard_rays(rules, plan.rays_o[i],
                                                plan.rays_d[i])
                rgb, aux = render_fn(snap.field, centers, valid, ro, rd)
                # this rank's rays, then the whole chunk: rgb, depth,
                # opacity in one tensor, the counters in another
                px = torch.cat([rgb, aux["depth"][:, None],
                                aux["opacity"][:, None]], dim=-1)
                px = distributed.gather_rays(rules, px, n).cpu().numpy()
                counts = torch.cat([
                    aux["dropped_pairs"].reshape(1).double(),
                    aux["processed_samples"].reshape(1).double(),
                    aux["active_pairs"].double()])
                counts = distributed.reduce_counts(rules, counts, n).tolist()
                outs.append(px[:, :3])
                geo_outs.append(px[:, 3:])
                g_dropped += int(counts[0])
                g_processed += counts[1]
                g_pairs = max(g_pairs, int(max(counts[2:])))
                flush_pairs[1] += 1
            flush_pairs[0] = max(flush_pairs[0], g_pairs)
            flush_dropped[0] += g_dropped
            imgs = plan.scatter(outs)
            geos = plan.scatter(geo_outs)
            t_done = time.perf_counter()
            # the render span covers the scan steps AND the copy to the
            # host (which waits for the device)
            path = snap.field.dispatch_path()
            span_all("render", t_plan, t_done, dispatch_path=path,
                     n_chunks=plan.n_chunks, dropped_pairs=g_dropped,
                     active_pairs_max=g_pairs,
                     path="delta" if is_delta else "full")
            group: List[tuple] = []
            for r, img, geo in zip(reqs_g, imgs, geos):
                if r.delta is not None:
                    img, geo, warp_frac = self._composite_delta(r, img, geo)
                else:
                    warp_frac = 0.0
                psnr = None
                if r.gt is not None:
                    psnr = float(rendering.psnr(
                        torch.from_numpy(img).clamp(0, 1),
                        torch.as_tensor(np.asarray(r.gt, np.float32))))
                lat = time.perf_counter() - r.t_submit
                group.append((r, ViewResult(
                    view_id=r.future._view_id, img=img, psnr=psnr,
                    latency_s=lat, scene=scene,
                    depth=np.ascontiguousarray(geo[:, 0]),
                    opacity=np.ascontiguousarray(geo[:, 1]), cam=r.cam,
                    warp_fraction=warp_frac, stats={
                        "occ_accesses": float(snap.cubes.count),
                        "factor_bytes": float(snap.factor_bytes),
                        "factor_bytes_dense": float(snap.factor_bytes_dense),
                        "dropped_pairs": g_dropped,
                        "active_pairs_max": g_pairs,
                        "processed_samples": g_processed,
                        "dispatch_path": path,
                    })))
            # commit the whole group's stats (global, then per scene),
            # THEN resolve its futures: a waiter that wakes on resolution
            # sees them in stats()
            self._m_dropped.inc(g_dropped)
            for _, res in group:
                self._m_latency.record(res.latency_s)
                self._m_views.inc()
            self.store.note_served(scene,
                                   [res.latency_s for _, res in group],
                                   time.perf_counter() - tg0)
            for r, res in group:
                if r.trace is not None:
                    t_del = time.perf_counter()
                    r.trace.add("deliver", t_done, t_del, psnr=res.psnr)
                    self.tracer.finish(r.trace, t_done=t_del)
                    res.trace = r.trace.tree()
                results.append(res)
                r.future._set(res)

    def _composite_delta(self, r: _Request, fresh_img: np.ndarray,
                         fresh_geo: np.ndarray):
        """Composite one delta request: overwrite the warped frame's
        low-confidence pixels with the fresh rays (pad entries re-write
        pixel 0 with its own fresh value), record the temporal-tier
        telemetry, and return (img, geo, warp_fraction) shaped like a full
        render's."""
        plan = r.delta
        t_c0 = time.perf_counter()
        warp = plan.warp
        img = warp.rgb.astype(np.float32)
        geo = np.stack([warp.depth, warp.opacity],
                       axis=-1).astype(np.float32)
        img[plan.idx] = fresh_img
        geo[plan.idx] = fresh_geo
        n_pix = warp.confidence.size
        self._m_delta_views.inc()
        self._m_delta_rays.inc(plan.n_real)
        self._m_warp_rays.inc(n_pix - plan.n_real)
        self._m_warp_frac.record(plan.warp_fraction)
        self.metrics.counter("render_dispatch_total", path="delta").inc()
        if r.trace is not None:
            r.trace.add("composite", t_c0, time.perf_counter(),
                        fresh_rays=plan.n_rays,
                        warp_fraction=plan.warp_fraction)
        return img, geo, plan.warp_fraction

    # -- adaptive pair budget ----------------------------------------------

    def _note_flush_pairs(self, max_pairs: int, dropped: int, budget: int):
        """Resize the active-pair budget from observed occupancy (engine
        lock and render lock held, so the renderer is rebuilt between
        flushes), with the reference's hysteresis: grow at once (x2,
        capped at the full pair count) when pairs were dropped or the
        budget filled; shrink only after 3 consecutive flushes below 25%
        occupancy, to 2x the recent observed max (256-aligned, floor
        128)."""
        n_pairs = self.cube_chunk * self.ray_chunk
        self._pair_occupancy_last = max_pairs / max(budget, 1)
        if not self._adaptive_budget or budget != self._pair_budget:
            return          # a resize already happened since this snapshot
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
            self._g_budget.set(new)
            self._build_render()

    def render_views(self, cams, gts=None, *,
                     scene: Optional[str] = None) -> List[ViewResult]:
        """Submit a batch of cameras and flush."""
        gts = gts if gts is not None else [None] * len(cams)
        futs = [self.submit(c, g, scene=scene) for c, g in zip(cams, gts)]
        self.flush()
        return [f.result() for f in futs]

    # -- telemetry ---------------------------------------------------------

    def stats(self, scene: Optional[str] = None) -> Dict:
        """stats() aggregates across scenes under the reference's keys,
        from the shared registry (field_kind, factor bytes and the
        port's `dispatch_path` come from the default scene);
        stats(scene="lego") itemises one scene (the store's keys)."""
        if scene is not None:
            return self.store.stats(scene)
        with self._lock:
            views = int(self._m_views.value)
            render_s = self._m_render_s.value
            out = {
                "views_served": views,
                "flushes": int(self._m_flushes.value),
                "fps": views / render_s if render_s > 0 else 0.0,
                "render_s_total": render_s,
                "latency_p50_s": self._m_latency.percentile(50),
                "latency_p95_s": self._m_latency.percentile(95),
                "latency_p99_s": self._m_latency.percentile(99),
                "latency_mean_s": self._m_latency.mean(),
                "dropped_pairs": int(self._m_dropped.value),
                "timeouts": int(self._m_timeouts.value),
                "pair_budget": self._pair_budget,
                "pair_budget_initial": self.pair_budget_initial,
                "pair_budget_resizes": self._budget_resizes,
                "pair_occupancy_last": self._pair_occupancy_last,
                "auto_flush_interval": self.auto_flush_interval,
                "auto_flush_running": self._auto_flush_on(),
                "ray_chunk": self.ray_chunk,
                "cube_chunk": self.cube_chunk,
                "n_devices": self.n_devices,
                "delta": {
                    "views": int(self._m_delta_views.value),
                    "fresh_rays": int(self._m_delta_rays.value),
                    "warped_rays": int(self._m_warp_rays.value),
                    "full_fallbacks": int(self._m_delta_fallbacks.value),
                    "warp_fraction_mean": self._m_warp_frac.mean(),
                    "ray_bucket": self.delta_ray_bucket,
                },
            }
        ss = self.store.stats()
        scenes = ss["scenes"]
        out.update({
            "n_scenes": ss["n_scenes"],
            "resident_scenes": ss["resident_scenes"],
            "resident_bytes": ss["resident_bytes"],
            "max_resident_bytes": ss["max_resident_bytes"],
            "evictions": ss["evictions"],
            "revivals": ss["revivals"],
            "scenes": scenes,
            "field_swaps": sum(s["swaps"] for s in scenes.values()),
            "swap_latency_s_last": self.store.last_swap_latency_s,
            "swap_latency_s_max": max(
                [s["swap_latency_s_max"] for s in scenes.values()],
                default=0.0),
            "ordering_cache": {
                "hits": sum(s["ordering_cache"]["hits"]
                            for s in scenes.values()),
                "misses": sum(s["ordering_cache"]["misses"]
                              for s in scenes.values()),
                "nn_hits": sum(s["ordering_cache"].get("nn_hits", 0)
                               for s in scenes.values()),
                "entries": sum(s["ordering_cache"]["entries"]
                               for s in scenes.values()),
            },
        })
        default = self.default_scene
        if default is not None:
            d = scenes[default]
            out.update({
                "occ_accesses_per_view": d["occ_accesses_per_view"],
                "factor_bytes": d["factor_bytes"],
                "factor_bytes_dense": d["factor_bytes_dense"],
                "compression_ratio": d["compression_ratio"],
                "field_kind": d["field_kind"],
                "dispatch_path": self.store.dispatch_path(default),
            })
        return out

    def stage_breakdown(self) -> Dict[str, Dict[str, float]]:
        """Per-stage latency table in lifecycle order: stage -> {count,
        p50_s, p95_s, p99_s, mean_s, total_s}, read from the
        `request_stage_s{stage=...}` histograms the tracer folds every
        finished request into. The temporal stages (warp, mask, composite)
        appear once delta frames are served."""
        out = {}
        for st in REPORT_STAGES:
            h = self.metrics.histogram("request_stage_s", stage=st)
            if h.count:
                out[st] = {"count": h.count, "p50_s": h.percentile(50),
                           "p95_s": h.percentile(95),
                           "p99_s": h.percentile(99), "mean_s": h.mean(),
                           "total_s": h.sum}
        return out
