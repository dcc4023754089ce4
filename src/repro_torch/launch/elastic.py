"""Fault tolerance for the training loop: the port of
`repro/launch/elastic.py`, on one device or across the ranks of a
process group (one rank a device, as torchrun starts them).

The contract is the reference's:

  1. the training state (params, optimizer state) is checkpointed every
     `ckpt_every` steps (atomic and asynchronous, `ckpt/checkpoint.py`;
     placed state is gathered leaf by leaf and written as its whole
     values by the mesh's rank 0);
  2. `HealthMonitor` times each step: a step past `timeout_factor` x the
     EWMA step time is logged as a straggler; a step that raises
     `NodeFailure` (or, on one device, the error PyTorch raises for a
     failed device) triggers recovery;
  3. recovery rebuilds the mesh from the surviving devices, rebuilds the
     step and state on it, and restores the latest checkpoint re-sharded
     onto it (each leaf cut from its whole value as the new state's
     leaf is placed);
  4. the data stream is a pure function of (step, shard)
     (`data/tokens.py`), so a resumed run replays no batch and skips none.

Across ranks the injected failure is the reference's simulated node
loss: every rank keeps the first half of the ranks, all of them build
the survivors' mesh (`make_mesh_from`, a collective over the world),
the survivors restore onto it, and the dropped ranks leave the loop and
wait until the survivors finish. A real rank death shows up as a
collective's error after `launch.mesh.COLLECTIVE_TIMEOUT_S` and
propagates: recovering from it needs a new process group among the
survivors, which is torchrun's elastic restart, not simulated here
(ROADMAP.md Queue 1). Any other exception of a step (a shape error,
say) is not a node failure and propagates at once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import HostMesh, make_mesh, make_submesh


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
    device gives the one-device mesh on it. Ranks of the initialised
    process group give the live mesh over them, each rank on `device`
    (None: its card): the whole world's `launch.mesh.make_mesh`, or for
    some of its ranks `launch.mesh.make_submesh`, which every rank of the
    world must build, those left out too (their mesh has `member`
    False). Without a process group, several entries give the mesh's
    shape alone (device and DeviceMesh None), which refuses to
    communicate."""
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
    if kinds == ["rank"] and dist.is_initialized():
        if sorted(ranks) == list(range(dist.get_world_size())):
            return make_mesh(n // model, model, device)
        return make_submesh(ranks, n // model, model, device)
    return HostMesh(shape, ("data", "model"), None)


def _scalar(x) -> float:
    """A metric as a float: a DTensor made whole on its mesh first (a
    collective every rank of the mesh makes at the same point)."""
    from repro_torch.models.sharding import is_dtensor, whole_on_mesh
    if is_dtensor(x):
        x = whole_on_mesh(x.detach()).to_local()
    return float(x)


@dataclasses.dataclass
class ElasticRunner:
    """Drives train steps with checkpoint / restart. `build(mesh)` returns
    (step_fn, state): `step_fn(state, batch)` -> (state, metrics), the
    state a tree of tensors on the mesh's device (placed on the mesh
    where it spans several ranks). `device`: this rank's device on a mesh
    of ranks (None: its card). `manager` is the last run's
    CheckpointManager (its `timings`)."""
    build: Callable
    ckpt_dir: str
    model_axis: int = 1
    ckpt_every: int = 50
    max_recoveries: int = 8
    device: DeviceLike = None
    manager: Optional[CheckpointManager] = dataclasses.field(
        default=None, init=False, repr=False)

    def run(self, n_steps: int, batches: Callable[[int], dict],
            devices: Optional[List] = None, inject_failure_at: int = -1):
        """Run n_steps; `inject_failure_at` raises a NodeFailure once at that
        step, after dropping half of the devices (a test hook: every rank
        keeps the same first half). `devices` None: the ranks of the
        process group, or without one the card. Returns (state, log): the
        log holds ("step", step, loss), ("straggler", step, seconds),
        ("restore", step, devices), ("failure", step, message) and
        ("remesh", step, devices). A rank that the failure drops builds
        the survivors' mesh with them, leaves the loop, waits until they
        finish and returns (None, log)."""
        if devices is None:
            devices = (list(range(dist.get_world_size()))
                       if dist.is_initialized() else [resolve_device(None)])
        devices = list(devices)
        # a run over the ranks of the process group (not one device)
        ranked = dist.is_initialized() and all(
            isinstance(d, int) for d in devices)
        if ranked and sorted(set(devices)) != list(
                range(dist.get_world_size())):
            raise ValueError(f"a run over the ranks {devices}: a run across "
                             f"ranks starts on every rank of the world")
        mgr = CheckpointManager(self.ckpt_dir)
        self.manager = mgr
        monitor = HealthMonitor()
        log = []
        recoveries = 0
        leave = None
        mesh = make_mesh_from(devices, self.model_axis, self.device)
        if mesh.size > 1 and mesh.device_mesh is None:
            raise ValueError(
                f"a run on {len(devices)} devices needs a process group of "
                f"their ranks (launch.mesh.init_ranks, or torchrun)")
        # a device error on one rank of several is not seen by the others,
        # which meet it as a collective's timeout: it propagates
        errors = (NodeFailure,) + (() if ranked else DEVICE_ERRORS)
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
                loss = _scalar(metrics.get("loss", 0.0))
                dt = time.time() - t0
                if monitor.observe(dt):
                    log.append(("straggler", step, dt))
                if step % self.ckpt_every == 0:
                    mgr.save_async(step, state)
                log.append(("step", step, loss))
                step += 1
            except errors as e:
                recoveries += 1
                if recoveries > self.max_recoveries:
                    raise
                log.append(("failure", step, str(e)[:80]))
                mgr.wait()
                state = None            # restored below: free it first
                if ranked:
                    # every checkpoint is published before any is read
                    dist.barrier()
                mesh = make_mesh_from(devices, self.model_axis, self.device)
                if ranked and leave is None and (
                        len(devices) < dist.get_world_size()):
                    leave = _leave_group()
                if not mesh.member:
                    _leave(leave)
                    return None, log
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
        if leave is not None:
            _leave(leave)               # the dropped ranks wait there
        return state, log


# how long a rank dropped from the mesh waits for the survivors to finish
LEAVE_TIMEOUT_S = 7 * 24 * 3600.0


def _leave_group():
    """A gloo group of the whole world for `_leave`, made at the remesh
    (a collective every rank enters), with a timeout that outlasts the
    survivors' run rather than the process group's collective one."""
    import datetime
    return dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=LEAVE_TIMEOUT_S))


def _leave(group) -> None:
    """The barrier of `_leave_group`'s group at which a rank dropped from
    the mesh waits until the survivors finish (a gloo rank that exits
    early aborts the others), and which the survivors enter at their
    end."""
    dist.barrier(group=group)
    dist.destroy_process_group(group)
