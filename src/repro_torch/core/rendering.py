"""Cameras, rays and volume compositing (paper Eq. 1). The port of the
parts of `repro/core/rendering.py` the serving path uses."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.device import DeviceLike, resolve_device


class Camera(NamedTuple):
    c2w: torch.Tensor       # (3,3) rotation, columns = camera axes in world
    origin: torch.Tensor    # (3,)
    focal: float
    h: int
    w: int


def look_at_camera(origin, target, focal, h, w, *,
                   device: DeviceLike = None) -> Camera:
    dev = resolve_device(device)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(dev)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    fwd = target - origin
    fwd = fwd / torch.linalg.norm(fwd)
    up0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    right = torch.linalg.cross(fwd, up0)
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-8)
    up = torch.linalg.cross(right, fwd)
    # camera axes: x=right, y=up, z=-fwd (OpenGL-style)
    c2w = torch.stack([right, up, -fwd], dim=1)
    return Camera(c2w, origin, float(focal), int(h), int(w))


def pixel_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor):
    """px,py (N,) pixel coords -> unit ray dirs (N,3) in world. The focal
    length divides as a 0-dim device tensor, so the card computes the true
    quotient as the CPU does (not a product with the reciprocal)."""
    focal = torch.full((), float(cam.focal), dtype=torch.float32,
                       device=px.device)
    x = (px + 0.5 - cam.w / 2.0) / focal
    y = -(py + 0.5 - cam.h / 2.0) / focal
    d_cam = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    d = d_cam @ cam.c2w.T
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def camera_rays(cam: Camera):
    """All H*W rays, row-major: (origins (N,3), directions (N,3))."""
    dev = cam.c2w.device
    py, px = torch.meshgrid(
        torch.arange(cam.h, dtype=torch.float32, device=dev),
        torch.arange(cam.w, dtype=torch.float32, device=dev), indexing="ij")
    d = pixel_rays(cam, px.reshape(-1), py.reshape(-1))
    return cam.origin.expand(d.shape), d


def step_world(cfg: NeRFConfig) -> float:
    return cfg.step_size * (2.0 * cfg.scene_bound / cfg.occ_res)


def composite(sigma, rgb, mask, delta, white_bg=True):
    """Eq. 1 along the last axis of samples. sigma (R,N), rgb (R,N,3),
    mask (R,N)."""
    tau = torch.where(mask, sigma * delta, torch.zeros_like(sigma))
    cum = torch.cumsum(tau, dim=-1)
    t_k = torch.exp(-(cum - tau))                # transmittance before k
    w = t_k * (1.0 - torch.exp(-tau))
    color = torch.sum(w[..., None] * rgb, dim=-2)
    t_final = torch.exp(-cum[..., -1])
    if white_bg:
        color = color + t_final[..., None]
    return color, t_final, w


def psnr(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    mse = torch.mean(torch.square(img - ref))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
