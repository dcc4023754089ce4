"""Temporal tier: frame-coherent radiance warping for streaming serving.
The port of `repro/serving/temporal.py` (numpy, on the host).

Consecutive cameras along a head-tracked path are nearly identical, yet a
stateless engine re-renders every ray of every frame. This module
reprojects the previous frame's radiance to the new camera and flags the
pixels the reprojection cannot vouch for; the engine then renders only
those rays (`RenderEngine.submit_delta`) and composites warped + fresh
into a full frame.

The warp is a forward splat:

  1. unproject: every source pixel becomes a world point at its rendered
     surface depth (`aux["depth"]` / `aux["opacity"]` of
     `pipeline.make_ray_renderer`: depth is E[w t], so the surface
     distance is depth / opacity; pixels with about zero opacity are
     background and sit on a far plane);
  2. project: world points into the new camera (the exact inverse of
     `rendering.pixel_rays`);
  3. splat: nearest-wins z-buffer into the target pixel grid;
  4. confidence: a target pixel is confident only if a splat covered it
     AND its winning source pixel was not on a depth discontinuity; the
     low-confidence set is dilated so one-pixel misses do not survive.

`plan_delta` turns the confidence mask into a padded fresh-ray index list
(bucketed, so a delta frame's chunk count stays stable frame to frame)
plus the `warp_fraction` the registry exports. Cameras may hold tensors
on any device; they are read to the host once per warp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from repro_torch.core.rendering import Camera


@dataclasses.dataclass
class WarpResult:
    """Previous frame forward-warped to a new camera (all (H*W,...) numpy,
    row-major like `rendering.camera_rays`)."""
    rgb: np.ndarray          # (H*W, 3) warped radiance (white where uncovered)
    depth: np.ndarray        # (H*W,) E[w·t] in the NEW camera (renderer units)
    opacity: np.ndarray      # (H*W,) carried source opacity (0 = background)
    confidence: np.ndarray   # (H*W,) bool — True = safe to reuse, False =
                             # disoccluded / depth edge / off-screen: re-render
    h: int = 0
    w: int = 0

    @property
    def warp_fraction(self) -> float:
        """Fraction of the frame the warp can serve without rendering."""
        return float(np.mean(self.confidence)) if self.confidence.size else 0.0


def _np64(x) -> np.ndarray:
    """A tensor (any device) or array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _camera_rays_np(cam: Camera) -> np.ndarray:
    """numpy twin of `rendering.camera_rays` directions (H*W, 3), unit."""
    h, w, f = int(cam.h), int(cam.w), float(cam.focal)
    py, px = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    x = (px.reshape(-1) + 0.5 - w / 2.0) / f
    y = -(py.reshape(-1) + 0.5 - h / 2.0) / f
    d_cam = np.stack([x, y, -np.ones_like(x)], axis=-1)
    d = d_cam @ _np64(cam.c2w).T
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _project_np(cam: Camera, pts: np.ndarray):
    """World points -> (px, py, z) in `cam` — exact inverse of
    `rendering.pixel_rays` (z is the forward camera-space depth; points
    with z <= 0 are behind the camera)."""
    rel = (pts - _np64(cam.origin)) \
        @ _np64(cam.c2w)            # world->cam: R^T (p-o)
    z = -rel[:, 2]
    zs = np.where(z > 1e-9, z, 1.0)                  # keep the divide finite
    px = rel[:, 0] / zs * float(cam.focal) + cam.w / 2.0 - 0.5
    py = -rel[:, 1] / zs * float(cam.focal) + cam.h / 2.0 - 0.5
    return px, py, z


def warp_radiance(prev_frame: np.ndarray, prev_cam: Camera, new_cam: Camera,
                  depth: np.ndarray, *, opacity: Optional[np.ndarray] = None,
                  min_opacity: float = 0.05, far: Optional[float] = None,
                  depth_grad_thresh: float = 0.15,
                  dilate: int = 1) -> WarpResult:
    """Forward-warp the previous frame's radiance to a new camera.

    prev_frame (H*W, 3) and depth/opacity (H*W,) are the renderer outputs
    for `prev_cam` (`ViewResult.img` / `.depth` / `.opacity`); depth is
    the accumulated E[w·t], so the surface distance along each unit ray is
    depth / opacity. `opacity=None` treats depth as the surface distance
    directly. Pixels below `min_opacity` are background and warp on a far
    plane at `far` (default: 1.5x the deepest surface — far enough that
    background parallax is sub-pixel for nearby cameras).

    Returns a `WarpResult` whose confidence mask is False exactly where
    the new frame must be rendered: target pixels no source splat covered
    (disocclusion / entered the frustum), pixels whose winning source sat
    on a depth discontinuity of relative size > `depth_grad_thresh`
    (silhouettes), and a `dilate`-step 3x3 dilation of both."""
    h, w = int(prev_cam.h), int(prev_cam.w)
    n = h * w
    rgb_src = np.asarray(prev_frame, np.float64).reshape(n, 3)
    d_acc = np.asarray(depth, np.float64).reshape(n)
    if opacity is None:
        op = np.ones(n)
        t_surf = d_acc.copy()
    else:
        op = np.clip(np.asarray(opacity, np.float64).reshape(n), 0.0, 1.0)
        t_surf = d_acc / np.maximum(op, 1e-6)
    fg = op >= min_opacity
    if far is None:
        far = 1.5 * float(t_surf[fg].max()) if fg.any() else \
            2.0 * float(np.linalg.norm(_np64(prev_cam.origin))) + 1.0
    t_surf = np.where(fg, t_surf, far)

    # source-space depth edges: a pixel adjacent to a large relative depth
    # jump sits on a silhouette — its far side hides a disocclusion, so
    # neither side of the edge is trustworthy after reprojection
    t_img = t_surf.reshape(h, w)
    grad = np.zeros((h, w))
    grad[:, 1:] = np.maximum(grad[:, 1:], np.abs(np.diff(t_img, axis=1)))
    grad[:, :-1] = np.maximum(grad[:, :-1], np.abs(np.diff(t_img, axis=1)))
    grad[1:, :] = np.maximum(grad[1:, :], np.abs(np.diff(t_img, axis=0)))
    grad[:-1, :] = np.maximum(grad[:-1, :], np.abs(np.diff(t_img, axis=0)))
    edge_src = (grad > depth_grad_thresh * np.maximum(t_img, 1e-6)).reshape(n)

    # unproject -> project -> nearest-wins splat
    pts = _np64(prev_cam.origin) \
        + _camera_rays_np(prev_cam) * t_surf[:, None]
    px, py, z = _project_np(new_cam, pts)
    t_new = np.linalg.norm(pts - _np64(new_cam.origin),
                           axis=-1)
    pxi = np.round(px).astype(np.int64)
    pyi = np.round(py).astype(np.int64)
    ok = (z > 1e-9) & (pxi >= 0) & (pxi < w) & (pyi >= 0) & (pyi < h)
    src = np.flatnonzero(ok)
    tgt = pyi[src] * w + pxi[src]
    # write far-to-near so the nearest source wins every contested pixel;
    # tie-break on source index for a deterministic warp
    order = np.lexsort((src, -t_new[src]))
    src, tgt = src[order], tgt[order]

    out_rgb = np.ones((n, 3))                 # white background where bare
    out_depth = np.zeros(n)
    out_op = np.zeros(n)
    covered = np.zeros(n, bool)
    edge_hit = np.zeros(n, bool)
    out_rgb[tgt] = rgb_src[src]
    # keep the E[w·t] representation so a warped frame can seed the next
    # warp exactly like a rendered one: depth = surface distance * opacity
    out_depth[tgt] = np.where(fg[src], t_new[src] * op[src], 0.0)
    out_op[tgt] = np.where(fg[src], op[src], 0.0)
    covered[tgt] = True
    edge_hit[tgt] = edge_src[src]

    bad = (~covered) | edge_hit
    bad = bad.reshape(h, w)
    for _ in range(max(int(dilate), 0)):
        grown = bad.copy()
        grown[1:, :] |= bad[:-1, :]
        grown[:-1, :] |= bad[1:, :]
        grown[:, 1:] |= bad[:, :-1]
        grown[:, :-1] |= bad[:, 1:]
        bad = grown
    return WarpResult(rgb=out_rgb, depth=out_depth, opacity=out_op,
                      confidence=~bad.reshape(n), h=h, w=w)


@dataclasses.dataclass
class DeltaPlan:
    """The fresh-ray work order `submit_delta` attaches to a request."""
    warp: WarpResult
    idx: np.ndarray          # (n_padded,) int64 pixel indices to re-render;
                             # entries past n_real are pad (pixel 0, whose
                             # fresh value overwrites harmlessly)
    n_real: int              # true low-confidence count
    warp_fraction: float     # confident fraction of the frame

    @property
    def n_rays(self) -> int:
        return int(self.idx.shape[0])


def plan_delta(warp: WarpResult, *, bucket: int) -> DeltaPlan:
    """Turn a confidence mask into a padded fresh-ray index list.

    The index count is rounded up to a multiple of `bucket` (minimum one
    bucket) so the number of micro-batch chunks a delta frame contributes,
    and so the renderer calls per flush, is stable across frames instead
    of tracking the disocclusion count. Pad entries
    point at pixel 0: they render a duplicate fresh value whose composite
    write is idempotent."""
    if bucket <= 0:
        raise ValueError(f"bucket must be positive, got {bucket}")
    need = np.flatnonzero(~warp.confidence)
    n_real = int(need.size)
    n_pad = max(-(-n_real // bucket), 1) * int(bucket)
    idx = np.zeros(n_pad, np.int64)
    idx[:n_real] = need
    n_pix = warp.confidence.size
    frac = 1.0 - n_real / n_pix if n_pix else 0.0
    return DeltaPlan(warp=warp, idx=idx, n_real=n_real, warp_fraction=frac)
