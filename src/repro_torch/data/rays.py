"""Procedural Synthetic-NeRF-like scenes, posed views and ray batches. The
port of `repro/data/rays.py`.

The 8 Blender scenes are analytic SDF scenes named after the originals,
with a sphere-traced ground-truth renderer; they span a wide occupancy
and factor sparsity range (ficus / mic / materials sparse, lego / ship
dense).

`make_scene` seeds its one random scene (ficus) with a stable hash of the
name (`zlib.crc32`), so a scene is the same in every process. The
reference seeds with Python's `hash`, which is salted per process
(PYTHONHASHSEED): its ficus differs between processes, and parity tests
carry the reference's ficus arrays over instead of re-deriving them.

`scene_sdf` and `render_gt` evaluate each primitive with separate
elementwise ops (no reduction kernels; norms and roots as
`core.rendering` rounds them), so the ground truth comes out bit for bit
the same on the card and on the CPU.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.rendering import (Camera, camera_rays, look_at_camera,
                                        norm3, sqrt_rn)
from repro_torch.device import DeviceLike, resolve_device

SPHERE, BOX, CYL = 0, 1, 2
HIT_DIST = 5e-3       # render_gt: a ray hits where the final SDF is below
HIT_T_MAX = 7.0       # ... and the march stayed inside this distance


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    prim_type: np.ndarray    # (P,) int
    center: np.ndarray       # (P,3)
    size: np.ndarray         # (P,3) radii / half-extents / (r, h, -)
    color: np.ndarray        # (P,3)


def _mk(name, prims) -> Scene:
    t = np.array([p[0] for p in prims], np.int32)
    c = np.array([p[1] for p in prims], np.float32)
    s = np.array([p[2] for p in prims], np.float32)
    col = np.array([p[3] for p in prims], np.float32)
    return Scene(name, t, c, s, col)


def scene_seed(name: str) -> int:
    """The scene's random seed: a stable hash of its name."""
    return zlib.crc32(name.encode()) % (2 ** 31)


def make_scene(name: str) -> Scene:
    """8 scenes named after Synthetic-NeRF, ordered sparse -> dense."""
    rng = np.random.RandomState(scene_seed(name))
    if name == "mic":          # very sparse: thin stand + small head
        return _mk(name, [
            (SPHERE, [0, 0, 0.7], [0.18, 0, 0], [0.8, 0.8, 0.85]),
            (CYL, [0, 0, -0.1], [0.04, 0.75, 0], [0.3, 0.3, 0.32]),
            (BOX, [0, 0, -0.9], [0.3, 0.3, 0.05], [0.2, 0.2, 0.22]),
        ])
    if name == "materials":    # sparse row of spheres
        prims = []
        for i in range(6):
            x = -1.1 + i * 0.44
            prims.append((SPHERE, [x, 0, -0.6], [0.2, 0, 0],
                          [0.2 + 0.13 * i, 0.9 - 0.12 * i, 0.4]))
        return _mk(name, prims)
    if name == "ficus":        # thin trunk + leaf blobs
        prims = [(CYL, [0, 0, -0.4], [0.05, 0.55, 0], [0.45, 0.3, 0.15])]
        for _ in range(9):
            a = rng.rand() * 2 * np.pi
            r = 0.25 + 0.45 * rng.rand()
            z = 0.15 + 0.75 * rng.rand()
            prims.append((SPHERE, [r * np.cos(a), r * np.sin(a), z],
                          [0.13, 0, 0], [0.1, 0.5 + 0.3 * rng.rand(), 0.12]))
        return _mk(name, prims)
    if name == "drums":
        return _mk(name, [
            (CYL, [-0.5, 0.3, -0.45], [0.38, 0.22, 0], [0.85, 0.2, 0.2]),
            (CYL, [0.5, 0.3, -0.45], [0.38, 0.22, 0], [0.2, 0.3, 0.85]),
            (CYL, [0, -0.5, -0.35], [0.45, 0.3, 0], [0.9, 0.75, 0.2]),
            (SPHERE, [-0.75, -0.5, 0.3], [0.22, 0, 0], [0.9, 0.85, 0.3]),
            (SPHERE, [0.75, -0.5, 0.3], [0.22, 0, 0], [0.9, 0.85, 0.3]),
        ])
    if name == "chair":
        return _mk(name, [
            (BOX, [0, 0, -0.25], [0.45, 0.45, 0.07], [0.6, 0.35, 0.15]),
            (BOX, [0, 0.42, 0.35], [0.45, 0.06, 0.55], [0.65, 0.4, 0.2]),
            (BOX, [-0.38, -0.38, -0.7], [0.06, 0.06, 0.4], [0.35, 0.2, 0.1]),
            (BOX, [0.38, -0.38, -0.7], [0.06, 0.06, 0.4], [0.35, 0.2, 0.1]),
            (BOX, [-0.38, 0.38, -0.7], [0.06, 0.06, 0.4], [0.35, 0.2, 0.1]),
            (BOX, [0.38, 0.38, -0.7], [0.06, 0.06, 0.4], [0.35, 0.2, 0.1]),
        ])
    if name == "hotdog":
        return _mk(name, [
            (BOX, [0, 0, -0.55], [0.9, 0.55, 0.08], [0.92, 0.92, 0.9]),
            (CYL, [0, -0.12, -0.32], [0.16, 0.65, 1], [0.85, 0.6, 0.3]),
            (CYL, [0, 0.12, -0.32], [0.16, 0.65, 1], [0.85, 0.6, 0.3]),
            (CYL, [0, 0, -0.22], [0.12, 0.6, 1], [0.7, 0.25, 0.1]),
        ])
    if name == "lego":         # dense: grid of bricks
        prims = []
        for i in range(4):
            for j in range(3):
                z = -0.6 + 0.28 * (i % 3)
                prims.append((BOX, [-0.6 + 0.4 * i, -0.4 + 0.4 * j, z],
                              [0.18, 0.18, 0.12],
                              [0.8, 0.65 - 0.1 * j, 0.1 + 0.2 * (i % 2)]))
        prims.append((BOX, [0, 0, -0.85], [0.9, 0.7, 0.06], [0.4, 0.4, 0.42]))
        return _mk(name, prims)
    if name == "ship":         # dense, large extent
        return _mk(name, [
            (BOX, [0, 0, -0.72], [1.2, 1.2, 0.05], [0.25, 0.45, 0.6]),
            (BOX, [0, 0, -0.5], [0.85, 0.3, 0.16], [0.5, 0.33, 0.18]),
            (BOX, [0.5, 0, -0.2], [0.08, 0.08, 0.35], [0.45, 0.3, 0.2]),
            (BOX, [-0.3, 0, -0.1], [0.06, 0.06, 0.45], [0.45, 0.3, 0.2]),
            (BOX, [-0.3, 0, 0.15], [0.02, 0.5, 0.25], [0.95, 0.95, 0.9]),
            (BOX, [0.5, 0, 0.0], [0.02, 0.38, 0.18], [0.95, 0.95, 0.9]),
        ])
    raise KeyError(name)


SCENES = ("chair", "drums", "ficus", "hotdog", "lego", "materials", "mic",
          "ship")


# --------------------------------------------------------------------------
# analytic SDF + ground-truth renderer
# --------------------------------------------------------------------------


def _prim_sdf(kind: int, rel: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Distance from points `rel` (N, 3), relative to the primitive's
    center, to one primitive of type `kind` and size `s` (3,)."""
    if kind == SPHERE:
        return norm3(rel) - s[0]
    if kind == BOX:
        q = rel.abs() - s
        qx, qy, qz = q.unbind(-1)
        return (norm3(torch.clamp(q, min=0.0))
                + torch.clamp(torch.maximum(torch.maximum(qx, qy), qz),
                              max=0.0))
    x, y, z = rel.unbind(-1)
    dxy = sqrt_rn(x * x + y * y) - s[0]
    dz = z.abs() - s[1]
    ox, oz = torch.clamp(dxy, min=0.0), torch.clamp(dz, min=0.0)
    return (sqrt_rn(ox * ox + oz * oz)
            + torch.clamp(torch.maximum(dxy, dz), max=0.0))


def scene_sdf(scene: Scene, p: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p (N,3) -> (dist (N,), nearest primitive's color (N,3)); the first
    primitive wins a tie, as `argmin` picks it."""
    dev = p.device
    center = torch.from_numpy(scene.center).to(dev)
    size = torch.from_numpy(scene.size).to(dev)
    best_d, best = None, None
    for i, kind in enumerate(scene.prim_type.tolist()):
        d = _prim_sdf(kind, p - center[i], size[i])
        if best_d is None:
            best_d = d
            best = torch.zeros(d.shape, dtype=torch.int64, device=dev)
        else:
            closer = d < best_d
            best_d = torch.where(closer, d, best_d)
            best = torch.where(closer, i, best)
    return best_d, torch.from_numpy(scene.color).to(dev)[best]


def sphere_trace(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                 n_steps: int = 64):
    """March rays (o, d) (N, 3) for `n_steps` steps of the clipped SDF from
    t = 1: (t (N,), final points (N, 3), their SDF (N,), their nearest
    color (N, 3))."""
    t = torch.ones(o.shape[0], dtype=torch.float32, device=o.device)
    for _ in range(n_steps):
        dist, _ = scene_sdf(scene, o + d * t[:, None])
        t = t + torch.clamp(dist, -0.05, 0.3)
    p = o + d * t[:, None]
    dist, col = scene_sdf(scene, p)
    return t, p, dist, col


def render_gt(scene: Scene, cam: Camera, *, n_steps: int = 64,
              light=(0.4, 0.3, 0.85)) -> torch.Tensor:
    """Sphere-traced ground truth image (H*W, 3) on the camera's device:
    Lambert shading from central-difference normals, white background."""
    return trace_gt(scene, cam, n_steps=n_steps, light=light)[0]


def trace_gt(scene: Scene, cam: Camera, *, n_steps: int = 64,
             light=(0.4, 0.3, 0.85)):
    """`render_gt`'s image with each pixel's final march distance t and
    SDF: (image (H*W, 3), t (H*W,), dist (H*W,)). A pixel is a hit where
    dist < HIT_DIST and t < HIT_T_MAX."""
    o, d = camera_rays(cam)
    t, p, dist, col = sphere_trace(scene, o, d, n_steps)
    hit = (dist < HIT_DIST) & (t < HIT_T_MAX)

    eps = 1e-3
    grads = []
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float32, device=p.device)
        e[i] = eps
        grads.append(scene_sdf(scene, p + e)[0] - scene_sdf(scene, p - e)[0])
    n = torch.stack(grads, dim=-1)
    n = n / torch.clamp(norm3(n), min=1e-8)[:, None]
    lv = np.asarray(light, np.float32)
    lv = torch.from_numpy(lv / np.float32(np.linalg.norm(light))).to(p.device)
    lam = torch.clamp((n[:, 0] * lv[0] + n[:, 1] * lv[1]) + n[:, 2] * lv[2],
                      0.0, 1.0)
    shade = (0.35 + 0.65 * lam)[:, None] * col
    return torch.where(hit[:, None], shade, 1.0), t, dist


def make_cameras(n_views: int, h: int, w: int, radius: float = 4.0,
                 elevation: float = 0.5, *,
                 device: DeviceLike = None) -> List[Camera]:
    """`n_views` cameras on an orbit around the origin, on `device`."""
    dev = resolve_device(device)
    cams = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        o = np.array([radius * np.cos(a) * np.cos(elevation),
                      radius * np.sin(a) * np.cos(elevation),
                      radius * np.sin(elevation)], np.float32)
        cams.append(look_at_camera(o, [0, 0, 0], 1.2 * w, h, w, device=dev))
    return cams


@dataclasses.dataclass
class RayDataset:
    rays_o: np.ndarray      # (M,3)
    rays_d: np.ndarray      # (M,3)
    rgb: np.ndarray         # (M,3)
    device: DeviceLike = None

    def batches(self, batch: int, seed: int = 0):
        """Endless random batches (rays_o, rays_d, rgb) as tensors on the
        dataset's device (None: the card), drawn with
        `np.random.RandomState(seed)` as the reference draws them."""
        dev = resolve_device(self.device)
        rng = np.random.RandomState(seed)
        m = self.rays_o.shape[0]
        while True:
            idx = rng.randint(0, m, size=batch)
            yield tuple(torch.from_numpy(a[idx]).to(dev)
                        for a in (self.rays_o, self.rays_d, self.rgb))


def build_dataset(scene: Scene, n_views: int, h: int, w: int, *,
                  device: DeviceLike = None) -> RayDataset:
    """Every ray of `n_views` orbit views with its ground-truth color,
    rendered on `device`; the arrays are kept on the host."""
    dev = resolve_device(device)
    ro, rd, rgb = [], [], []
    for cam in make_cameras(n_views, h, w, device=dev):
        o, d = camera_rays(cam)
        rgb.append(render_gt(scene, cam).cpu().numpy())
        ro.append(o.cpu().numpy())
        rd.append(d.cpu().numpy())
    return RayDataset(np.concatenate(ro), np.concatenate(rd),
                      np.concatenate(rgb), device=dev)
