"""Fleet tier, router side: consistent-hash scene-affinity routing over
`serving.fleet` worker processes. The port of `repro/serving/router.py`:
the same ring (sha1 vnodes: the same owners for the same keys), the same
routing, replication, replay and `fleet_*` metric families.

One `FleetRouter` owns N spawned workers (each a `SceneStore`-backed
`RenderEngine`, see `fleet.worker_main`) and shards scenes across them:

  * **Affinity** — `HashRing` maps each scene to an owner worker (vnode
    consistent hashing), so a scene's encoded field, cube set, ordering
    cache, and jit state stay warm on one process instead of thrashing
    every worker's LRU. Affinity is *policy*, not a constraint: any
    alive worker can serve any scene (the router lazily registers the
    scene there first), which is what makes replay-after-death and the
    tests' `prefer_worker=` overrides work.
  * **Replication** — `set_replicas(scene, n)` makes a hot scene
    resident on the first n ring owners behind the same key; per-request
    the router picks the replica with the fewest outstanding requests.
    Replicas are registered from the same `fleet.export_scene` path, so
    frames are bit-identical across replicas.
  * **Pin / priority** — `pin(scene)` / `set_priority(scene, p)` forward
    to the owning workers' stores so a popularity spike on cold scenes
    cannot evict a pinned hot scene (`SceneStore._enforce_budget`).
  * **Prefetch** — `prefetch(scene)` asks the owner to revive a
    predicted-next scene on a background thread ahead of the requests.
  * **Failure handling** — a dead worker (SIGKILL, crash, closed pipe)
    is detected by its reader thread hitting EOF. The router removes it
    from the ring (routing version bumps), then resolves every in-flight
    request that was pending on it: requests whose deadline already
    passed complete as timed-out results (the engine's existing deadline
    semantics), live ones are *replayed* on a surviving owner
    (`fleet_replays_total`; renders are idempotent, so at-least-once is
    safe). No future is ever left hanging; with zero survivors the
    future fails with `FleetError`.

Fleet-level metrics flow through the obs registry (`fleet_*` families,
`docs/observability.md`), with the reference's names and labels.

Devices: `engine_kwargs["device"]` is resolved here, before any worker is
spawned (None means the card and raises without one; there is no
fallback to the CPU), and reaches every worker as a string. All workers
share that one device. Workers start with the "spawn" method, never
"fork": a forked child of a process holding a CUDA context cannot use
CUDA, and spawn re-imports the parent's `__main__`, so scripts keep
their work under `if __name__ == "__main__"`.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.obs import lockdebug
from repro_torch.obs.registry import MetricsRegistry

from repro_torch.serving import fleet

# repro-lint lock-discipline declarations (docs/static_analysis.md).
# `_lock` is an RLock over the routing state: ring membership, the
# replica/pin tables, and the worker table mutate only under it. Metric
# writes may nest inside it (router -> obs.registry is a declared
# lock-order edge; never the reverse).
GUARDED_BY = {
    "FleetRouter": {
        "lock": "_lock",
        "attrs": ("_closed", "_replicas", "_pins", "ring", "_workers"),
        "assume_held": ("_pick_worker", "_ensure_registered",
                        "_set_routing_gauges", "_alive"),
    },
}
LOCK_ATTR_CLASSES = {
    "FleetRouter.registry": "MetricsRegistry",
}


class FleetError(RuntimeError):
    """A request that can no longer be served by any alive worker."""


# -- consistent hashing ----------------------------------------------------


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each node contributes `vnodes` points at sha1("node/i") on a sorted
    ring; a key is owned by the first node clockwise of sha1(key).
    `owners(key, n)` walks further clockwise for distinct replica owners.
    Adding/removing a node only remaps the keys adjacent to its vnode
    points — ~1/K of the keyspace — which is what keeps worker churn from
    invalidating every worker's resident set (tested property-style in
    `tests/test_fleet.py`). `version` increments on every membership
    change; the router exports it as the `fleet_routing_version` gauge.
    """

    def __init__(self, nodes: Optional[List[str]] = None, *,
                 vnodes: int = 64):
        self.vnodes = int(vnodes)
        self.version = 0
        self._ring: List[tuple] = []      # sorted (hash, node)
        self._nodes: set = set()
        for n in nodes or []:
            self.add(n)

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")

    def add(self, node: str):
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.vnodes):
            self._ring.append((self._hash(f"{node}/{i}"), node))
        self._ring.sort()
        self.version += 1

    def remove(self, node: str):
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]
        self.version += 1

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def owners(self, key: str, n: int = 1) -> List[str]:
        """First `n` distinct nodes clockwise of the key's hash point."""
        if not self._ring:
            return []
        n = min(n, len(self._nodes))
        h = self._hash(key)
        import bisect
        start = bisect.bisect_right(self._ring, (h, chr(0x10FFFF)))
        out: List[str] = []
        for idx in range(len(self._ring)):
            node = self._ring[(start + idx) % len(self._ring)][1]
            if node not in out:
                out.append(node)
                if len(out) == n:
                    break
        return out

    def owner(self, key: str) -> str:
        o = self.owners(key, 1)
        if not o:
            raise FleetError("hash ring is empty — no alive workers")
        return o[0]


# -- request plumbing ------------------------------------------------------


@dataclass
class FleetResult:
    """Router-side completion record for one fleet render request."""
    view_id: int
    img: Optional[np.ndarray]
    psnr: Optional[float]
    latency_s: float                     # router submit -> result
    worker_latency_s: float              # worker enqueue -> worker reply
    timed_out: bool
    scene: str
    worker: str
    replayed: bool = False


class FleetFuture:
    """Completion handle for a routed render. Always resolves: with a
    `FleetResult` (possibly timed-out), or raises `FleetError` when no
    alive worker could serve it."""

    def __init__(self, view_id: int, scene: str):
        self.view_id = view_id
        self.scene = scene
        self._event = threading.Event()
        self._result: Optional[FleetResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> FleetResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.view_id} ({self.scene}) not done "
                f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _set(self, result: FleetResult):
        self._result = result
        self._event.set()

    def _set_error(self, err: BaseException):
        self._error = err
        self._event.set()


@dataclass
class _Pending:
    """One in-flight request as the router tracks it (for completion,
    and for replay/fail when its worker dies)."""
    req: int
    future: FleetFuture
    scene: str
    cam: object
    gt: Optional[np.ndarray]
    deadline_t: Optional[float]          # absolute perf_counter deadline
    t0: float
    replayed: bool = False


@dataclass
class _WorkerState:
    name: str
    proc: object
    conn: object
    send_lock: threading.Lock = field(default_factory=threading.Lock)
    pending: Dict[int, _Pending] = field(default_factory=dict)
    control: Dict[int, threading.Event] = field(default_factory=dict)
    control_reply: Dict[int, Dict] = field(default_factory=dict)
    scenes: set = field(default_factory=set)   # registered on this worker
    alive: bool = True
    reader: Optional[threading.Thread] = None
    last_stats: Dict = field(default_factory=dict)


# -- router ----------------------------------------------------------------


class FleetRouter:
    """Scene-affinity router over `n_workers` fleet worker processes.

    `scenes` maps scene name -> `fleet.export_scene` directory; scenes
    are registered on workers lazily, right before the first render each
    worker sees for that scene (pipe FIFO guarantees ordering), so
    spawning K workers doesn't front-load K full registrations per scene.
    `engine_kwargs` go to each worker's `RenderEngine`; their `device`
    (None: the card) is resolved before the workers start.
    """

    def __init__(self, cfg, scenes: Dict[str, str], *, n_workers: int = 2,
                 engine_kwargs: Optional[Dict] = None,
                 registry: Optional[MetricsRegistry] = None,
                 vnodes: int = 64, deadline_s: Optional[float] = None):
        import multiprocessing as mp

        self.cfg = cfg
        self.scene_paths = dict(scenes)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.default_deadline_s = deadline_s
        self._engine_kwargs = dict(engine_kwargs or {})
        self.device = resolve_device(self._engine_kwargs.get("device"))
        self._engine_kwargs["device"] = str(self.device)
        self._replicas: Dict[str, int] = {}
        self._pins: Dict[str, Dict] = {}   # scene -> {pinned, priority}
        self._req_ids = itertools.count(1)
        self._view_ids = itertools.count(0)
        self._lock = lockdebug.make_lock("router", kind="rlock")
        self._closed = False

        # unlabelled fleet families created eagerly so every metrics
        # snapshot carries the full schema (check_metrics_schema pins
        # them) even before the first death/replay/timeout happens
        for fam in ("fleet_replays_total", "fleet_worker_deaths",
                    "fleet_timeouts_total", "fleet_prefetches_total"):
            self.registry.counter(fam)
        self.registry.gauge("fleet_replicas", scene="_none").set(0)
        self.registry.histogram("fleet_latency_s")

        ctx = mp.get_context("spawn")
        self.ring = HashRing(vnodes=vnodes)
        self._workers: Dict[str, _WorkerState] = {}
        for i in range(int(n_workers)):
            name = f"w{i}"
            proc, conn = fleet.spawn_worker(ctx, name, cfg,
                                            self._engine_kwargs)
            st = _WorkerState(name=name, proc=proc, conn=conn)
            st.reader = threading.Thread(target=self._reader_loop,
                                         args=(st,), name=f"reader-{name}",
                                         daemon=True)
            self._workers[name] = st
            self.ring.add(name)
            st.reader.start()
        # reader threads are live from here on: a worker dying mid-spawn
        # already mutates the ring under the lock, so read it there too
        with self._lock:
            self._set_routing_gauges()

    # -- metrics helpers ---------------------------------------------------

    def _set_routing_gauges(self):
        self.registry.gauge("fleet_routing_version").set(self.ring.version)
        self.registry.gauge("fleet_workers_alive").set(
            sum(1 for w in self._workers.values() if w.alive))

    # -- wire helpers ------------------------------------------------------

    def _send(self, st: _WorkerState, msg: Dict):
        with st.send_lock:
            st.conn.send_bytes(fleet.pack_msg(msg))

    def _control(self, st: _WorkerState, msg: Dict,
                 timeout: float = 30.0) -> Dict:
        """Send a control op and wait for its ack/reply."""
        req = next(self._req_ids)
        msg = dict(msg, req=req)
        ev = threading.Event()
        st.control[req] = ev
        try:
            self._send(st, msg)
        except (OSError, BrokenPipeError):
            st.control.pop(req, None)
            raise FleetError(f"worker {st.name} unreachable")
        if not ev.wait(timeout):
            st.control.pop(req, None)
            raise FleetError(
                f"worker {st.name} did not ack {msg.get('op')!r} "
                f"within {timeout}s")
        reply = st.control_reply.pop(req, {})
        if reply.get("op") == "err":
            raise FleetError(f"worker {st.name}: {reply.get('error')}")
        return reply

    # -- reader thread -----------------------------------------------------

    def _reader_loop(self, st: _WorkerState):
        while True:
            try:
                raw = st.conn.recv_bytes()
            except (EOFError, OSError):
                break
            try:
                m = fleet.unpack_msg(raw)
            except fleet.WireError:
                continue
            req = m.get("req")
            op = m.get("op")
            if op in ("result",) or (op == "err" and req in st.pending):
                p = st.pending.pop(req, None)
                if p is None:
                    continue
                if op == "err":
                    p.future._set_error(FleetError(
                        f"worker {st.name}: {m.get('error')}"))
                    continue
                self.registry.counter("fleet_results_total",
                                      worker=st.name).inc()
                lat = time.perf_counter() - p.t0
                self.registry.histogram("fleet_latency_s").record(lat)
                if m.get("timed_out"):
                    self.registry.counter("fleet_timeouts_total").inc()
                p.future._set(FleetResult(
                    view_id=p.future.view_id, img=m.get("img"),
                    psnr=m.get("psnr"), latency_s=lat,
                    worker_latency_s=float(m.get("worker_latency_s", 0.0)),
                    timed_out=bool(m.get("timed_out")), scene=p.scene,
                    worker=st.name, replayed=p.replayed))
            else:
                ev = st.control.get(req)
                if ev is not None:
                    st.control_reply[req] = m
                    ev.set()
        self._on_worker_death(st)

    # -- failure handling --------------------------------------------------

    def _on_worker_death(self, st: _WorkerState):
        """Pipe EOF from a worker: re-hash its shard range and resolve
        every request that was in flight on it — replay live requests on
        a surviving owner, complete already-expired ones as timed-out."""
        with self._lock:
            if not st.alive:
                return
            st.alive = False
            orphans = list(st.pending.values())
            st.pending.clear()
            for req, ev in list(st.control.items()):
                st.control_reply[req] = {
                    "op": "err", "error": f"worker {st.name} died"}
                ev.set()
            if self._closed:
                # expected reader exit during shutdown — not a death.
                for p in orphans:
                    p.future._set_error(FleetError("router closed"))
                return
            self.ring.remove(st.name)
            self.registry.counter("fleet_worker_deaths").inc()
            self._set_routing_gauges()
        for p in orphans:
            now = time.perf_counter()
            if p.deadline_t is not None and now >= p.deadline_t:
                # deadline already passed — same semantics as an engine
                # flush discovering a stale request: timed-out result.
                self.registry.counter("fleet_timeouts_total").inc()
                p.future._set(FleetResult(
                    view_id=p.future.view_id, img=None, psnr=None,
                    latency_s=now - p.t0, worker_latency_s=0.0,
                    timed_out=True, scene=p.scene, worker=st.name,
                    replayed=p.replayed))
                continue
            try:
                self.registry.counter("fleet_replays_total").inc()
                self._dispatch(p, replay=True)
            except FleetError as e:
                p.future._set_error(e)

    # -- scene placement ---------------------------------------------------

    def _alive(self, name: str) -> Optional[_WorkerState]:
        st = self._workers.get(name)
        return st if st is not None and st.alive else None

    def _ensure_registered(self, st: _WorkerState, scene: str):
        """Register `scene` on `st` ahead of its first render there. The
        register travels the same FIFO pipe as the render, so ordering is
        guaranteed without waiting for the ack here — but we do wait, so
        registration failures surface on this call, not a later render."""
        if scene in st.scenes:
            return
        path = self.scene_paths.get(scene)
        if path is None:
            raise FleetError(f"unknown scene {scene!r}")
        pin = self._pins.get(scene, {})
        self._control(st, {"op": "register", "scene": scene, "path": path,
                           "pin": bool(pin.get("pinned", False)),
                           "priority": int(pin.get("priority", 0))},
                      timeout=120.0)
        st.scenes.add(scene)
        self.registry.counter("fleet_registrations_total",
                              worker=st.name).inc()

    def _pick_worker(self, scene: str,
                     prefer_worker: Optional[str] = None) -> _WorkerState:
        """Replica choice: among the scene's ring owners (replica count
        for hot scenes, else 1), the one with fewest outstanding
        requests. `prefer_worker` overrides for tests — affinity is
        policy, any alive worker may serve any scene."""
        if prefer_worker is not None:
            st = self._alive(prefer_worker)
            if st is None:
                raise FleetError(f"worker {prefer_worker!r} is not alive")
            return st
        n = self._replicas.get(scene, 1)
        owners = [self._alive(o) for o in self.ring.owners(scene, n)]
        owners = [o for o in owners if o is not None]
        if not owners:
            raise FleetError(f"no alive worker for scene {scene!r}")
        return min(owners, key=lambda st: len(st.pending))

    def _dispatch(self, p: _Pending, *, replay: bool = False,
                  prefer_worker: Optional[str] = None):
        with self._lock:
            st = self._pick_worker(p.scene, prefer_worker)
            self._ensure_registered(st, p.scene)
            p.replayed = p.replayed or replay
            msg = {"op": "render", "req": p.req, "scene": p.scene}
            msg.update(fleet.cam_to_wire(p.cam))
            if p.gt is not None:
                msg["gt"] = p.gt
            if p.deadline_t is not None:
                # recompute remaining time at (re)send so replays keep the
                # original wall-clock deadline, not a fresh one.
                msg["deadline_s"] = max(0.0,
                                        p.deadline_t - time.perf_counter())
            st.pending[p.req] = p
            try:
                self._send(st, msg)
            except (OSError, BrokenPipeError):
                st.pending.pop(p.req, None)
                raise FleetError(f"worker {st.name} unreachable")
            self.registry.counter("fleet_requests_total",
                                  worker=st.name).inc()
            self.registry.gauge("fleet_outstanding",
                                worker=st.name).set(len(st.pending))

    # -- public API --------------------------------------------------------

    def submit(self, cam, gt=None, *, scene: str,
               deadline_s: Optional[float] = None,
               prefer_worker: Optional[str] = None) -> FleetFuture:
        """Route one render. Returns a `FleetFuture` that always
        resolves — result, timed-out result, or `FleetError`."""
        with self._lock:
            closed = self._closed
        if closed:
            raise FleetError("router is closed")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        t0 = time.perf_counter()
        p = _Pending(req=next(self._req_ids),
                     future=FleetFuture(next(self._view_ids), scene),
                     scene=scene,
                     cam=cam,
                     gt=None if gt is None else fleet.to_host(gt),
                     deadline_t=None if deadline_s is None
                     else t0 + float(deadline_s),
                     t0=t0)
        self._dispatch(p, prefer_worker=prefer_worker)
        return p.future

    def set_replicas(self, scene: str, n: int):
        """Replicate a hot scene onto its first `n` ring owners; later
        submits pick the least-loaded replica. Registration is eager so
        the fan-out exists before the popularity spike it serves."""
        n = max(1, int(n))
        with self._lock:
            self._replicas[scene] = n
            self.registry.gauge("fleet_replicas", scene=scene).set(n)
            for name in self.ring.owners(scene, n):
                st = self._alive(name)
                if st is not None:
                    self._ensure_registered(st, scene)

    def replica_workers(self, scene: str) -> List[str]:
        with self._lock:
            n = self._replicas.get(scene, 1)
            return [o for o in self.ring.owners(scene, n)
                    if self._alive(o) is not None]

    def pin(self, scene: str, pinned: bool = True, *,
            priority: Optional[int] = None):
        """Pin (and optionally prioritise) a scene on every worker that
        has it; remembered for workers that register it later."""
        with self._lock:
            entry = self._pins.setdefault(scene, {})
            entry["pinned"] = bool(pinned)
            if priority is not None:
                entry["priority"] = int(priority)
            for st in self._workers.values():
                if st.alive and scene in st.scenes:
                    msg = {"op": "pin", "scene": scene, "pinned": pinned}
                    if priority is not None:
                        msg["priority"] = int(priority)
                    self._control(st, msg)

    def set_priority(self, scene: str, priority: int):
        with self._lock:
            pinned = self._pins.get(scene, {}).get("pinned", False)
            self.pin(scene, pinned, priority=priority)

    def prefetch(self, scene: str):
        """Async revival of a predicted-next scene on its owner."""
        with self._lock:
            st = self._pick_worker(scene)
            self._ensure_registered(st, scene)
            self._control(st, {"op": "prefetch", "scene": scene})
            self.registry.counter("fleet_prefetches_total").inc()

    def evict(self, scene: str, worker: Optional[str] = None):
        with self._lock:
            targets = ([self._alive(worker)] if worker else
                       [st for st in self._workers.values() if st.alive])
            for st in targets:
                if st is not None and scene in st.scenes:
                    self._control(st, {"op": "evict", "scene": scene})

    def inject(self, worker: str, *, stall_s: float):
        """Fault injection: plant a pre-flush stall in a worker (used by
        the slow-worker fixtures in tests/conftest.py)."""
        with self._lock:
            st = self._alive(worker)
        if st is None:
            raise FleetError(f"worker {worker!r} is not alive")
        self._control(st, {"op": "inject", "stall_s": float(stall_s)})

    def worker_pid(self, worker: str) -> int:
        with self._lock:
            return self._workers[worker].proc.pid

    def alive_workers(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._workers.items() if st.alive)

    def owner_of(self, scene: str) -> str:
        with self._lock:
            return self.ring.owner(scene)

    def poll_stats(self, timeout: float = 30.0) -> Dict[str, Dict]:
        """Fetch per-worker engine stats and refresh the per-worker
        gauges (`fleet_worker_fps` / `_queue_depth` / `_evictions`)."""
        out: Dict[str, Dict] = {}
        with self._lock:
            workers = list(self._workers.items())
        for name, st in workers:
            if not st.alive:
                continue
            try:
                reply = self._control(st, {"op": "stats"}, timeout=timeout)
            except FleetError:
                continue
            s = reply.get("stats", {})
            st.last_stats = s
            out[name] = s
            self.registry.gauge("fleet_worker_fps", worker=name).set(
                float(s.get("fps", 0.0)))
            self.registry.gauge("fleet_worker_queue_depth",
                                worker=name).set(
                int(s.get("queue_depth", 0)))
            self.registry.gauge("fleet_worker_evictions", worker=name).set(
                int(s.get("evictions", 0)))
        return out

    def stats(self) -> Dict:
        """Fleet roll-up: routing state + per-worker engine stats."""
        workers = self.poll_stats()
        snap = self.registry.snapshot()["counters"]
        with self._lock:
            routing_version = self.ring.version

        def total(prefix):
            return sum(v["value"] for k, v in snap.items()
                       if k == prefix or k.startswith(prefix + "{"))

        return {
            "routing_version": routing_version,
            "workers_alive": len(self.alive_workers()),
            "requests_total": total("fleet_requests_total"),
            "results_total": total("fleet_results_total"),
            "replays_total": total("fleet_replays_total"),
            "worker_deaths": total("fleet_worker_deaths"),
            "timeouts_total": total("fleet_timeouts_total"),
            "prefetches_total": total("fleet_prefetches_total"),
            "registrations_total": total("fleet_registrations_total"),
            "latency_p95_s": self.registry.histogram(
                "fleet_latency_s").percentile(95.0),
            "workers": workers,
        }

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float = 15.0):
        """Graceful shutdown: ask workers to exit, then join/terminate."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = list(self._workers.values())
        for st in workers:
            if st.alive:
                try:
                    self._send(st, {"op": "shutdown"})
                except (OSError, BrokenPipeError):
                    pass
        for st in workers:
            st.proc.join(timeout)
            if st.proc.is_alive():
                st.proc.terminate()
                st.proc.join(5.0)
            st.alive = False
            try:
                st.conn.close()
            except OSError:
                pass
        with self._lock:
            self._set_routing_gauges()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["HashRing", "FleetRouter", "FleetFuture", "FleetResult",
           "FleetError"]
