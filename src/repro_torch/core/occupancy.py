"""Binary occupancy grid + non-zero cube extraction. The port of
`repro/core/occupancy.py`.

The grid is evaluated on the field's device (for an encoded field, through
the gather kernels); the cube list is extracted on the host in numpy at
occupancy-update time and padded to a static `max_cubes`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.device import DeviceLike, resolve_device


class CubeSet(NamedTuple):
    """Static-shape set of non-zero occupancy cubes."""
    centers: torch.Tensor   # (max_cubes, 3) world-space centers
    valid: torch.Tensor     # (max_cubes,) bool
    count: int              # true number of cubes
    radius: float           # bounding-ball radius
    occ: torch.Tensor       # (G,G,G) bool


def grid_coords(cfg: NeRFConfig, device) -> torch.Tensor:
    """Voxel-center coordinates along one axis of the occupancy grid. The
    divisor is a 0-dim device tensor: a CUDA tensor divided by a Python
    scalar is a product with the reciprocal, one ulp off the true quotient
    the reference and the CPU compute."""
    g = cfg.occ_res
    g_t = torch.full((), float(g), dtype=torch.float32, device=device)
    xs = (torch.arange(g, device=device) + 0.5) / g_t * 2.0 - 1.0
    return xs * cfg.scene_bound


def build_occupancy(field, cfg: NeRFConfig,
                    sigma_thresh: Optional[float] = None,
                    chunk: int = 65536) -> torch.Tensor:
    """Evaluate sigma on the occupancy grid -> (G,G,G) bool, on the
    field's device, `chunk` points per evaluation."""
    if sigma_thresh is None:
        sigma_thresh = cfg.occ_sigma_thresh
    f = field_lib.as_backend(field, cfg)
    g = cfg.occ_res
    xs = grid_coords(cfg, f.device)
    pts = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    sig = torch.cat([f.sigma(pts[i:i + chunk])
                     for i in range(0, pts.shape[0], chunk)])
    return sig.reshape(g, g, g) > sigma_thresh


def extract_cubes(occ: torch.Tensor, cfg: NeRFConfig) -> CubeSet:
    """Max-pool occupancy into cubes and list the non-zero cube centers
    (host-side numpy; tensors come back on `occ`'s device)."""
    g, cs = cfg.occ_res, cfg.cube_size
    gc = g // cs
    occ_np = occ.cpu().numpy().reshape(gc, cs, gc, cs, gc, cs)
    cube_occ = occ_np.any(axis=(1, 3, 5))
    idx = np.argwhere(cube_occ)
    n = idx.shape[0]
    if n > cfg.max_cubes:
        # keep the densest cubes (by voxel count) under the static bound
        counts = occ_np.sum(axis=(1, 3, 5))[tuple(idx.T)]
        keep = np.argsort(-counts)[: cfg.max_cubes]
        idx = idx[keep]
        n = cfg.max_cubes
    pad = np.zeros((cfg.max_cubes, 3), np.int32)
    pad[:n] = idx
    cube_world = 2.0 * cfg.scene_bound * cs / g
    centers = (pad + 0.5) * cube_world - cfg.scene_bound
    valid = np.zeros(cfg.max_cubes, bool)
    valid[:n] = True
    radius = cube_world * np.sqrt(3.0) / 2.0
    return cubes_from_arrays(centers, valid, n, radius, occ)


def cubes_from_arrays(centers, valid, count: int, radius: float, occ, *,
                      device: DeviceLike = None) -> CubeSet:
    """A CubeSet from plain arrays (numpy, or anything `np.asarray` takes:
    how the reference's CubeSet crosses over) on `device`; by default
    `occ`'s device when `occ` is a tensor."""
    if device is None and isinstance(occ, torch.Tensor):
        dev = occ.device
    else:
        dev = resolve_device(device)

    def t(a, dtype):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return CubeSet(t(centers, np.float32), t(valid, bool), int(count),
                   float(radius), t(occ, bool))


def occupancy_query(occ: torch.Tensor, cfg: NeRFConfig,
                    pts: torch.Tensor) -> torch.Tensor:
    """Baseline Step 2-1: quantize points (..., 3) to the binary grid and
    look them up; False outside the scene bound. The bound divides as a
    0-dim device tensor (a true quotient on the card too), and the cell
    index is clamped to [0, G-1] before it truncates: the reference's
    truncate-then-clip for every finite point, with no float-to-int
    conversion out of range. The grid is indexed with int64."""
    g = cfg.occ_res
    bound = torch.full((), float(cfg.scene_bound), dtype=torch.float32,
                       device=pts.device)
    x = (pts / bound * 0.5 + 0.5) * g
    ijk = x.clamp(0.0, g - 1.0).to(torch.int64)
    inside = torch.all(pts.abs() <= cfg.scene_bound, dim=-1)
    return occ[ijk[..., 0], ijk[..., 1], ijk[..., 2]] & inside
