"""Distributed NeRF on one device. The port of `repro/core/distributed.py`.

The reference places the serving field and each ray chunk on a JAX mesh:
the encoded streams replicated (`stream_sharding`), the rays split over the
batch axes (`ray_sharding`), the VM components over "model"
(`nerf_param_sharding`). On a one-device mesh each of these is a plain
device placement, and that is what this module does: the card's machine
has one card, so every placement here is `.to(device)`.

Not ported yet: `nerf_param_sharding`, `ray_sharding` and
`stream_sharding` need a mesh abstraction (`models/sharding.AxisRules`,
with the language-model substrate and `torch.distributed`'s DeviceMesh);
`nerf_input_specs` and `lower_nerf_cell` belong to the dry-run tooling
(`launch/dryrun.py`), which lowers XLA programs and has no one-to-one
counterpart here.

Training uses the differentiable uniform pipeline (as TensoRF does); the
cube-centric RT-NeRF pipeline is the serving path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.core import rendering
from repro_torch.core import train as train_lib
from repro_torch.core.occupancy import CubeSet
from repro_torch.device import DeviceLike, resolve_device


def place_field(field, device: DeviceLike):
    """A resident serving field on `device`: every stream tensor, the
    integer metadata and the MLP (a `FieldBackend`, or a params dict), as
    the reference's one placement call over the whole tree does on a
    one-device mesh."""
    dev = resolve_device(device)
    if isinstance(field, dict):
        return {k: torch.as_tensor(v).to(dev) for k, v in field.items()}
    return field.to(dev)


def shard_rays(device: DeviceLike, rays_o, rays_d
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One micro-batched ray chunk (numpy arrays or tensors) on `device`:
    the reference's single-device path, where the chunk is replicated."""
    dev = resolve_device(device)

    def put(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        return a.to(dev)
    return put(rays_o), put(rays_d)


def build_render_step(cfg: NeRFConfig):
    """Batched novel-view rendering: rays -> rgb through the uniform
    pipeline, with the occupancy grid as one cube's (the serving analogue
    of Step 2-1/2-2/3)."""

    def render_step(params, occ, rays_o, rays_d):
        dev = occ.device
        cubes = CubeSet(centers=torch.zeros((1, 3), device=dev),
                        valid=torch.ones((1,), dtype=torch.bool, device=dev),
                        count=1, radius=0.0, occ=occ)
        rgb, _ = rendering.render_uniform(params, cfg, cubes, rays_o, rays_d)
        return rgb

    return render_step


def build_nerf_train_step(cfg: NeRFConfig, opt):
    """One optimizer step on a params dict and a batch {"rays_o",
    "rays_d", "rgb"}: the uniform render without occupancy, loss = MSE +
    sigma_sparsity_l1 * L1 + tv_weight * TV (`train.loss_and_grads`),
    then `opt.update`. Returns (params, optimizer state, loss)."""

    def train_step(params, opt_state, batch):
        field = field_lib.DenseField(params, cfg)
        loss, _mse, grads = train_lib.loss_and_grads(
            field, cfg, batch["rays_o"], batch["rays_d"], batch["rgb"])
        params, opt_state = opt.update(grads, opt_state, field.trainable())
        return params, opt_state, loss

    return train_step
