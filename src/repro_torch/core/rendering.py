"""Cameras, rays, volume compositing (paper Eq. 1) and the uniform-sampling
baseline pipeline. The port of `repro/core/rendering.py`.

The baseline is TensoRF's rendering path (paper Fig. 3): uniform samples
along every ray, an occupancy-grid query per sample, the field on every
sample, early ray termination on the accumulated transmittance.

Camera and ray geometry is written as separate elementwise ops (no
matmul, no reduction kernel; 3-vector dot products and norms through
`dot3`, roots through `sqrt_rn`): each op rounds once and alike on
either device, so a camera and its rays come out bit for bit the same on
the card and on the CPU.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.core import occupancy as occ_lib
from repro_torch.device import DeviceLike, common_device, resolve_device

# render_uniform evaluates at most this many samples (rays x
# max_samples_per_ray) at a time: at NeRFConfig() that is 4096 rays, whose
# appearance planes alone gather 402,653,184 values a plane through the
# encoded streams (1.6 GB of int32 queries and 1.6 GB of output). Rays are
# independent, so the image does not depend on it.
UNIFORM_PASS_SAMPLES = 4096 * 512


class Camera(NamedTuple):
    c2w: torch.Tensor       # (3,3) rotation, columns = camera axes in world
    origin: torch.Tensor    # (3,)
    focal: float
    h: int
    w: int


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (of 3) of a * b, rounded as the reference's
    dot products and norms round on the CPU: a0 * b0, then two fused
    multiply-adds. Each fma is a float64 product (exact) plus a float64
    sum, rounded to float32, in separate ops, so the result has the same
    bits on every device."""
    acc = a[..., 0] * b[..., 0]
    for i in (1, 2):
        acc = (a[..., i].double() * b[..., i].double()
               + acc.double()).float()
    return acc


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on every device: through
    float64, whose root rounds to the nearest float32 exactly. PyTorch's
    vectorised CPU sqrt (AVX-512) is not correctly rounded, the card's
    and the reference's are."""
    return torch.sqrt(x.double()).float()


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (of 3), as `dot3` rounds."""
    return sqrt_rn(dot3(v, v))


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def look_at_camera(origin, target, focal, h, w, *,
                   device: DeviceLike = None) -> Camera:
    dev = resolve_device(device)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(dev)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    fwd = target - origin
    fwd = fwd / norm3(fwd)
    up0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    right = _cross3(fwd, up0)
    right = right / torch.clamp(norm3(right), min=1e-8)
    up = _cross3(right, fwd)
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
    d = torch.stack([dot3(d_cam, cam.c2w[j]) for j in range(3)], dim=-1)
    return d / norm3(d)[..., None]


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


def uniform_pass(f, cfg: NeRFConfig, occ, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, *, use_occupancy: bool = True,
                 white_bg: bool = True):
    """One pass of `render_uniform` over a batch of rays: (rgb (R, 3),
    occupied samples per ray, visible samples per ray), the counts int64.
    `f` is a FieldBackend; `occ` the (G, G, G) occupancy grid, unused
    without occupancy."""
    n = cfg.max_samples_per_ray
    delta = step_world(cfg)
    t = cfg.near + (torch.arange(n, device=rays_o.device) + 0.5) * delta
    t = t.expand(rays_o.shape[0], n)
    pts = rays_o[:, None] + rays_d[:, None] * t[..., None]      # (R, N, 3)

    if use_occupancy:
        occ_hit = occ_lib.occupancy_query(occ, cfg, pts)
    else:
        occ_hit = torch.all(pts.abs() <= cfg.scene_bound, dim=-1)
    flat = pts.reshape(-1, 3)
    sigma = f.sigma(flat).reshape(t.shape)
    sigma = torch.where(occ_hit, sigma, 0.0)

    # early termination mask (T from the density so far)
    tau = sigma * delta
    cum = torch.cumsum(tau, dim=-1)
    visible = occ_hit & (torch.exp(-(cum - tau)) > cfg.term_eps)

    feats = f.app_features(flat)
    dirs = rays_d[:, None].expand(pts.shape).reshape(-1, 3)
    rgb = f.color(feats, dirs).reshape(*t.shape, 3)
    color, _, _ = composite(sigma, rgb, visible, delta, white_bg)
    return color, occ_hit.sum(dim=-1), visible.sum(dim=-1)


def render_uniform(field, cfg: NeRFConfig, cubes: occ_lib.CubeSet,
                   rays_o: torch.Tensor, rays_d: torch.Tensor, *,
                   use_occupancy: bool = True,
                   white_bg: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Baseline pipeline: uniform samples + occupancy queries + early
    termination. `field` is anything `field.as_backend` accepts (an
    encoded field is sampled through the bitmap/COO gathers in place);
    rays_o/rays_d (R, 3). Returns (rgb (R, 3), stats) on the rays' device,
    which the field and the cube set must share.

    The rays go through `uniform_pass` UNIFORM_PASS_SAMPLES samples at a
    time; the image is a single pass's. The four counts are summed in
    int64 and returned as float32 0-dim tensors. The reference sums them
    in float32 in one pass, which is exact below 2^24 (at every test
    size); at 800 x 800 (327,680,000 samples) its occupied and visible
    counts pass 2^24 and may round, where these do not until the final
    conversion.
    """
    f = field_lib.as_backend(field, cfg)
    occ = cubes.occ if use_occupancy else None
    dev = common_device(rays_o, rays_d, f.device, occ,
                        what="render_uniform's field, cube set and rays")
    n_rays, n = rays_o.shape[0], cfg.max_samples_per_ray
    step = max(1, UNIFORM_PASS_SAMPLES // n)
    colors = []
    occupied = torch.zeros((), dtype=torch.int64, device=dev)
    visible = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, n_rays, step):
        c, n_occ, n_vis = uniform_pass(
            f, cfg, occ, rays_o[i:i + step], rays_d[i:i + step],
            use_occupancy=use_occupancy, white_bg=white_bg)
        colors.append(c)
        occupied += n_occ.sum()
        visible += n_vis.sum()
    color = torch.cat(colors) if colors else rays_o.new_zeros((0, 3))

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)
    stats = {
        "occ_accesses": f32(float(n_rays * n)),
        "candidate_samples": f32(float(n_rays * n)),
        "preexisting_samples": f32(occupied),
        "processed_samples": f32(visible),
    }
    return color, stats


def psnr(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    mse = torch.mean(torch.square(img - ref))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
