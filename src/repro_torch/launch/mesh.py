"""Meshes for the port's launchers: the port of `repro/launch/mesh.py`.

The port runs SPMD, one process (rank) per device, as PyTorch does:
`init_ranks` starts the process group (from `torchrun`'s environment or
an explicit `init_method`) and gives the rank its device, and the meshes
below are `torch.distributed.device_mesh` DeviceMeshes over that group
with the reference's axis names. Without a process group, the host mesh
is the one-device mesh. `models.sharding.make_rules` and `resolve_spec`
read only a mesh's `shape` and `axis_names`.

The production meshes (256 or 512 ranks, `make_production_mesh`) belong
to the dry-run tooling (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

# every collective of a process group started here fails after this long,
# so ranks that disagree on the order of collectives raise instead of
# hanging
COLLECTIVE_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A mesh's shape (axis -> size) and axis names, this rank's device,
    the DeviceMesh over the process group (None for one rank, and for a
    mesh that only carries a shape, as sharding specs need), and the
    process group's ranks that the mesh holds, in its row-major order
    (None without a process group)."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    device: Optional[torch.device]
    device_mesh: Any = None
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks (a rank left
        out of a mesh over some of the world's ranks is not)."""
        return self.ranks is None or dist.get_rank() in self.ranks

    def group(self, axis: str):
        """The process group along `axis` that holds this rank; None where
        the axis has one rank."""
        if self.shape.get(axis, 1) == 1:
            return None
        return self._live().get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis` (0 where the axis has one rank)."""
        if self.shape.get(axis, 1) == 1:
            return 0
        return self._live().get_local_rank(axis)

    @property
    def rank(self) -> int:
        """This rank's place in the mesh (0 on a one-rank mesh)."""
        if self.size == 1:
            return 0
        self._live()
        return self.ranks.index(dist.get_rank())

    def _live(self):
        if self.device_mesh is None:
            raise ValueError(
                f"the mesh {self.shape} carries a shape only: build it over "
                f"a process group (launch.mesh.init_ranks) to communicate")
        if not self.member:
            raise ValueError(f"this process (rank {dist.get_rank()}) is not "
                             f"one of the mesh's ranks {list(self.ranks)}")
        return self.device_mesh


def init_ranks(device: DeviceLike = None, *, backend: Optional[str] = None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> torch.device:
    """Start this process's rank of the process group and return its
    device. `init_method` None reads `torchrun`'s environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); otherwise pass it
    with `rank` and `world_size` (the tests use "file://<path>").
    `device` None is the card `cuda:<local rank>`; "cpu" runs the rank on
    the CPU; a named card ("cuda:0") puts ranks that share it there. The
    backend is NCCL for a CUDA device and gloo for the CPU unless given:
    ranks that share one card need `backend="gloo"` (NCCL refuses two
    ranks on one card). Every collective fails after `timeout_s`."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    if device is None:
        dev = resolve_device(
            f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}")
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # before the group starts, so NCCL and DeviceMesh take this card
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=dev if backend == "nccl" else None)
    return dev


def _mesh_device_type(dev: torch.device) -> str:
    return "cuda" if dev.type == "cuda" else "cpu"


@functools.lru_cache(maxsize=None)
def _device_mesh(world_group, device_type: str, ranks: Tuple[int, ...],
                 shape: Tuple[int, ...], names: Tuple[str, ...]):
    """One DeviceMesh per (process group, device type, ranks, shape):
    building one creates process groups, a collective that every rank of
    the world must enter (those outside the mesh too, which hold it with
    no coordinate), so the ranks build each mesh once, in the same order,
    and share it."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.tensor(ranks).view(shape),
                      mesh_dim_names=names)


def _ranks_mesh(shape: Dict[str, int], names: Tuple[str, ...],
                ranks: Tuple[int, ...], device: DeviceLike) -> HostMesh:
    """The mesh of `shape` over `ranks` of the initialised process group
    (row-major), on `device` on the ranks it holds; a rank outside it
    builds it too and gets it with device None. One rank of a larger
    world gives the one-device mesh, built with no collective."""
    dims = tuple(shape[a] for a in names)
    ranks = tuple(ranks)
    world = dist.get_world_size()
    if math.prod(dims) != len(ranks) or len(set(ranks)) != len(ranks):
        raise ValueError(f"a mesh of {dict(shape)} over the ranks "
                         f"{list(ranks)}")
    if not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {list(ranks)} outside the process group's "
                         f"{world}")
    here = dist.get_rank() in ranks
    dev = resolve_device(device) if here else None
    if len(ranks) == 1 and world > 1:
        return HostMesh(dict(shape), names, dev, None, ranks)
    # every rank builds it on its own device type: that of the ranks in it
    dtype = _mesh_device_type(resolve_device(device))
    dm = _device_mesh(dist.group.WORLD, dtype, ranks, dims, names)
    return HostMesh(dict(shape), names, dev, dm, ranks)


def _world_mesh(shape: Dict[str, int], names: Tuple[str, ...],
                device: DeviceLike) -> HostMesh:
    dims = tuple(shape[a] for a in names)
    world = dist.get_world_size()
    if math.prod(dims) != world:
        raise ValueError(f"a mesh of {dict(shape)} needs {math.prod(dims)} "
                         f"ranks, the process group has {world}")
    return _ranks_mesh(shape, names, tuple(range(world)), device)


def make_submesh(ranks, data: int, model: int,
                 device: DeviceLike = None) -> HostMesh:
    """The (data, model) mesh over `ranks` of the initialised process
    group, row-major (the survivors of a failure: `launch.elastic`).
    Every rank of the world must call it, those left out too: building
    its process groups is a collective over the world. On the ranks it
    holds it is live on `device` (None: the card); a rank left out gets
    it with `member` False and device None. One rank: the one-device
    mesh on that rank."""
    if not dist.is_initialized():
        raise ValueError(f"a mesh over the ranks {list(ranks)} needs a "
                         f"process group (launch.mesh.init_ranks)")
    return _ranks_mesh({"data": data, "model": model}, ("data", "model"),
                       tuple(ranks), device)


def make_host_mesh(device: DeviceLike = None) -> HostMesh:
    """Whatever this host runs: the (world, 1) ("data", "model") mesh over
    the initialised process group, or without one the one-device mesh,
    on `device` (None: the card)."""
    names = ("data", "model")
    if not dist.is_initialized():
        return HostMesh({"data": 1, "model": 1}, names,
                        resolve_device(device))
    return _world_mesh({"data": dist.get_world_size(), "model": 1}, names,
                       device)


def make_mesh(data: int, model: int, device: DeviceLike = None) -> HostMesh:
    """The (data, model) mesh over the initialised process group, which
    must hold data x model ranks: the reference's `jax.make_mesh((data,
    model), ("data", "model"))`. Without a group, the one-device mesh
    (data = model = 1) on `device` (None: the card)."""
    shape = {"data": data, "model": model}
    names = ("data", "model")
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(
                f"a mesh of {shape} needs a process group of "
                f"{data * model} ranks (launch.mesh.init_ranks)")
        return HostMesh(shape, names, resolve_device(device))
    return _world_mesh(shape, names, device)


def make_pipeline_mesh(*, stages: int = 4, data: int = 8, model: int = 8,
                       device: DeviceLike = None) -> HostMesh:
    """The (stage, data, model) mesh for `launch/pipeline.gpipe` over the
    initialised process group, which must hold stages x data x model
    ranks (one rank needs none)."""
    shape = {"stage": stages, "data": data, "model": model}
    names = ("stage", "data", "model")
    if not dist.is_initialized():
        if stages * data * model != 1:
            raise ValueError(
                f"a mesh of {shape} needs a process group of "
                f"{stages * data * model} ranks (launch.mesh.init_ranks)")
        return HostMesh(shape, names, resolve_device(device))
    return _world_mesh(shape, names, device)
