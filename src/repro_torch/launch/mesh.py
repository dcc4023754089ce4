"""Meshes for the port's launchers: the port of `repro/launch/mesh.py`'s
host mesh. The port runs on one device; meshes of several devices wait
for ROADMAP.md Queue 1 item 10."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A mesh's shape (axis -> size) and axis names over its device: all
    that `models.sharding.make_rules` and `resolve_spec` read."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    device: torch.device


def make_host_mesh(device: DeviceLike = None) -> HostMesh:
    """The one-device mesh {"data": 1, "model": 1} on `device` (None: the
    card)."""
    return HostMesh({"data": 1, "model": 1}, ("data", "model"),
                    resolve_device(device))
