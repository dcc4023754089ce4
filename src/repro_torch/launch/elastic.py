"""Fault tolerance for the training loop: the port of
`repro/launch/elastic.py`, on one device.

The contract is the reference's:

  1. the training state (params, optimizer state) is checkpointed every
     `ckpt_every` steps (atomic and asynchronous, `ckpt/checkpoint.py`);
  2. `HealthMonitor` times each step: a step past `timeout_factor` x the
     EWMA step time is logged as a straggler; a step that raises
     `NodeFailure`, or the error PyTorch raises for a failed device,
     triggers recovery;
  3. recovery rebuilds the mesh from the surviving devices, rebuilds the
     step and state on it, and restores the latest checkpoint;
  4. the data stream is a pure function of (step, shard)
     (`data/tokens.py`), so a resumed run replays no batch and skips none.

The runner drives one device: remeshing a run of several ranks onto the
survivors, with a re-sharded restore, is ROADMAP.md Queue 1 item 10e,
and a device list of several raises. An injected failure here rebuilds
on the same device. Any other exception of a step (a shape error, say)
is not a node failure and propagates at once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import HostMesh, make_mesh


class NodeFailure(RuntimeError):
    """Raised by the step wrapper when a device or host is lost."""


# what a failed device raises in PyTorch (not every build has it)
DEVICE_ERRORS = tuple(e for e in (getattr(torch, "AcceleratorError", None),)
                      if e is not None)


@dataclasses.dataclass
class HealthMonitor:
    """EWMA step timer with straggler detection."""
    alpha: float = 0.1
    timeout_factor: float = 5.0
    warmup_steps: int = 3
    _ewma: Optional[float] = None
    _steps: int = 0

    def observe(self, dt: float) -> bool:
        """Record a step time; True if this step counts as a straggler."""
        self._steps += 1
        if self._ewma is None:
            self._ewma = dt
            return False
        straggler = (self._steps > self.warmup_steps
                     and dt > self.timeout_factor * self._ewma)
        self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return straggler

    @property
    def ewma(self) -> Optional[float]:
        return self._ewma


def make_mesh_from(devices: Sequence, model_axis: int,
                   device=None) -> HostMesh:
    """The largest (data, model) mesh on the surviving devices, as the
    reference's: 8 -> (4, 2), 4 -> (2, 2), 3 -> (3, 1) at `model_axis` 2.
    `devices` are devices or ranks (ints), one rank a device; a repeated
    entry counts once, and entries of several device types raise. One
    device gives the one-device mesh on it. Ranks that are exactly those
    of the initialised process group give the live mesh over it
    (`launch.mesh.make_mesh`, each rank on `device`, None: its card);
    any other list of several gives the mesh's shape alone (device and
    DeviceMesh None)."""
    if model_axis < 1:
        raise ValueError(f"model_axis {model_axis} < 1")
    ranks = []
    for d in devices:
        d = d if isinstance(d, int) else torch.device(d)
        if d not in ranks:
            ranks.append(d)
    kinds = sorted({"rank" if isinstance(d, int) else d.type for d in ranks})
    if len(kinds) != 1:
        raise ValueError(f"a mesh of devices {[str(d) for d in ranks]}: "
                         f"entries of one device type only, not {kinds}")
    n = len(ranks)
    model = min(model_axis, n)
    while n % model:
        model -= 1
    shape = {"data": n // model, "model": model}
    if n == 1 and not isinstance(ranks[0], int):
        return HostMesh(shape, ("data", "model"), resolve_device(ranks[0]))
    if (n > 1 and kinds == ["rank"] and dist.is_initialized()
            and sorted(ranks) == list(range(dist.get_world_size()))):
        return make_mesh(n // model, model, device)
    return HostMesh(shape, ("data", "model"), None)


@dataclasses.dataclass
class ElasticRunner:
    """Drives train steps with checkpoint / restart. `build(mesh)` returns
    (step_fn, state): `step_fn(state, batch)` -> (state, metrics), the
    state a tree of tensors on the mesh's device."""
    build: Callable
    ckpt_dir: str
    model_axis: int = 1
    ckpt_every: int = 50
    max_recoveries: int = 8

    def run(self, n_steps: int, batches: Callable[[int], dict],
            devices: Optional[List] = None, inject_failure_at: int = -1):
        """Run n_steps; `inject_failure_at` raises a NodeFailure once at that
        step, after dropping half of the devices (a test hook). `devices`
        None: the card. Returns (state, log): the log holds ("step", step,
        loss), ("straggler", step, seconds), ("restore", step, devices),
        ("failure", step, message) and ("remesh", step, devices)."""
        devices = list(devices if devices is not None
                       else [resolve_device(None)])
        mgr = CheckpointManager(self.ckpt_dir)
        monitor = HealthMonitor()
        log = []
        recoveries = 0
        mesh = make_mesh_from(devices, self.model_axis)
        if mesh.size > 1:
            raise NotImplementedError(
                f"a run on {len(devices)} devices: the elastic runner drives "
                f"one device (remeshing across ranks is ROADMAP.md Queue 1 "
                f"item 10e)")
        step_fn, state = self.build(mesh)
        start, restored = mgr.restore_latest(state, device=mesh.device)
        step0 = 0
        if restored is not None:
            state = restored
            step0 = start + 1
            log.append(("restore", start, len(devices)))

        step = step0
        while step < n_steps:
            try:
                if step == inject_failure_at and recoveries == 0:
                    devices = devices[: max(len(devices) // 2, 1)]
                    raise NodeFailure(f"injected loss at step {step}")
                t0 = time.time()
                state, metrics = step_fn(state, batches(step))
                # the loss read waits for the device: dt is the step's
                loss = float(metrics.get("loss", 0.0))
                dt = time.time() - t0
                if monitor.observe(dt):
                    log.append(("straggler", step, dt))
                if step % self.ckpt_every == 0:
                    mgr.save_async(step, state)
                log.append(("step", step, loss))
                step += 1
            except (NodeFailure, *DEVICE_ERRORS) as e:
                recoveries += 1
                if recoveries > self.max_recoveries:
                    raise
                log.append(("failure", step, str(e)[:80]))
                mgr.wait()
                state = None            # restored below: free it first
                mesh = make_mesh_from(devices, self.model_axis)
                step_fn, state = self.build(mesh)
                start, restored = mgr.restore_latest(state,
                                                     device=mesh.device)
                if restored is not None:
                    state = restored
                    step = start + 1
                else:
                    step = 0
                log.append(("remesh", step, len(devices)))
        mgr.wait()
        mgr.save_async(n_steps - 1, state)
        mgr.wait()
        return state, log
