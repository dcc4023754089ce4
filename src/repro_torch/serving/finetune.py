"""Online fine-tuning service: a background trainer publishing into one
named scene of a live SceneStore. The port of
`repro/serving/finetune.py`.

A `FineTuneLoop` attaches to a scene of a `serving.store.SceneStore`
(`FineTuneLoop.attach(store, scene)`), owns a `core.train.NerfTrainer`
for it (compressed-native, support revival at every `occ_every`
boundary), and runs it on a background thread while the `RenderEngine`
keeps serving every resident scene. Every `publish_every` steps, and
after the last step, it snapshots the trainer's field, rebuilds the
occupancy cube set on the trainer thread, and publishes through
`SceneStore.publish`: publication serializes with eviction on the store
lock, and a publish into a scene evicted meanwhile revives it around the
new field. Queued futures survive a swap (the engine's contract).

    loop = FineTuneLoop.attach(store, "lego", steps=400, publish_every=100)
    loop.start()            # background thread; the engine keeps serving
    ...                     # submit(cam, scene=...) from any thread
    loop.join(timeout)      # waits, re-raises a trainer error
    loop.swaps              # [{step, train_psnr, swap_s, t_wall}, ...]

The trainer runs on the device of the field it starts from (the store's
device for `start_field="init"`). `FineTuneLoop(engine, "lego", ...)`
resolves the engine's store and targets the scene of that name if it is
registered, else the engine's default scene.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.core import occupancy as occ_lib
from repro_torch.core import train as train_lib
from repro_torch.obs import lockdebug
from repro_torch.serving.store import SceneStore

# Lint declarations (scripts/repro_lint.py, docs/static_analysis.md):
# `history`, `swaps` and `_error` are written on the trainer thread and
# read from the caller's thread; `_lock` is a leaf: nothing else is
# acquired while it is held.
GUARDED_BY = {
    "FineTuneLoop": {"lock": "_lock",
                     "attrs": ("history", "swaps", "_error")},
}


class FineTuneLoop:
    """Background compressed-native fine-tuning published into one named
    scene of a live SceneStore.

    The trainer starts from `start_field` when given, else from the
    scene's currently published field (revived from its spill checkpoint
    if it was evicted); `start_field="init"` trains from a fresh field on
    the store's device. One publication is always made for the final
    step, so `steps >= publish_every` gives at least one swap.
    """

    def __init__(self, target, scene_name: str, *,
                 scene: Optional[str] = None, steps: int = 400,
                 publish_every: int = 100, occ_every: Optional[int] = None,
                 n_views: int = 8, image_hw: int = 64,
                 prune_tol: float = 1e-3, revive_frac: float = 0.05,
                 seed: int = 0, start_field=None, verbose: bool = False):
        if isinstance(target, SceneStore):
            store, engine = target, None
        elif hasattr(target, "store"):            # a RenderEngine
            engine = target
            store = engine.store
        else:
            raise TypeError(
                f"FineTuneLoop target must be a SceneStore or RenderEngine, "
                f"not {type(target).__name__}")
        if scene is None:
            if scene_name in store:
                scene = scene_name
            elif engine is not None:
                scene = engine.default_scene
            else:
                scene = scene_name
        if scene not in store:
            raise KeyError(
                f"scene '{scene}' is not registered in the store "
                f"(registered: {store.scenes() or 'none'}): register it "
                f"before attaching a fine-tuner")
        self.store = store
        self.scene = scene
        self.steps = int(steps)
        self.publish_every = max(int(publish_every), 1)
        self.verbose = bool(verbose)
        # telemetry in the store's registry, labelled by the scene
        m = store.metrics
        self._m_steps = m.counter("finetune_steps", scene=scene)
        self._m_publish_s = m.histogram("finetune_publish_s", maxlen=256,
                                        scene=scene)
        self._g_train_psnr = m.gauge("finetune_train_psnr", scene=scene)
        if start_field is None:
            start_field = store.get_field(scene)   # revives if evicted
        elif isinstance(start_field, str) and start_field == "init":
            start_field = None
        self.trainer = train_lib.NerfTrainer(
            store.cfg, scene_name, field=start_field, n_views=n_views,
            image_hw=image_hw,
            occ_every=(self.publish_every if occ_every is None
                       else int(occ_every)),
            prune_tol=prune_tol, revive_frac=revive_frac, seed=seed,
            verbose=verbose, device=store.device)
        self._lock = lockdebug.make_lock("finetune")
        self.history: List[Dict[str, float]] = []
        self.swaps: List[Dict[str, float]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._t0 = 0.0

    @classmethod
    def attach(cls, store: SceneStore, scene: str, *,
               data_scene: Optional[str] = None, **kw) -> "FineTuneLoop":
        """One trainer thread for one resident scene: train on
        `data_scene` (default: the scene itself) and publish into
        `store`'s `scene` record."""
        return cls(store, data_scene or scene, scene=scene, **kw)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FineTuneLoop":
        if self._thread is not None:
            raise RuntimeError("fine-tune loop already started")
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(
            target=self._run, name=f"finetune-trainer-{self.scene}")
        self._thread.start()
        return self

    def stop(self):
        """Request an early exit (the current step finishes first)."""
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        """Wait for the trainer thread; re-raise any trainer error. Raises
        TimeoutError if the thread is still running after `timeout`."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("fine-tune loop still running")
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def __enter__(self) -> "FineTuneLoop":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        self.join()
        return False

    # -- trainer thread ----------------------------------------------------

    def _run(self):
        try:
            for i in range(self.steps):
                if self._stop.is_set():
                    break
                rec = self.trainer.step()
                rec["t_wall"] = time.perf_counter() - self._t0
                self._m_steps.inc()
                self._g_train_psnr.set(rec["psnr"])
                with self._lock:
                    self.history.append(rec)
                if (i + 1) % self.publish_every == 0 or i == self.steps - 1:
                    self._publish(rec)
        except BaseException as e:                # re-raised by join()
            with self._lock:
                self._error = e

    def _publish(self, rec: Dict[str, float]):
        """Snapshot -> occupancy rebuild (this thread) -> store.publish;
        the store lock is held only for the pointer switch inside
        publish."""
        t_pub = time.perf_counter()
        field = self.trainer.snapshot()
        occ = occ_lib.build_occupancy(field, self.store.cfg)
        cubes = occ_lib.extract_cubes(occ, self.store.cfg)
        t0 = time.perf_counter()
        self.store.publish(self.scene, field, cubes)
        swap_s = time.perf_counter() - t0
        # snapshot + occupancy rebuild + swap; the store's own swap
        # latency records the swap alone
        self._m_publish_s.record(time.perf_counter() - t_pub)
        with self._lock:
            self.swaps.append(
                {"step": rec["step"], "train_psnr": rec["psnr"],
                 "swap_s": swap_s,
                 "t_wall": time.perf_counter() - self._t0})
        if self.verbose:
            print(f"  [finetune:{self.scene}] step {rec['step']:5d} "
                  f"published field (train-psnr {rec['psnr']:.2f}, "
                  f"swap {swap_s * 1e3:.1f}ms)", flush=True)
