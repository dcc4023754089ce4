"""RT-NeRF's efficient rendering pipeline (paper Sec. 3.1) and the
coarse-grained view-dependent ordering (Sec. 3.2). The port of
`repro/core/pipeline.py`.

`render_rtnerf` renders one view image-space, the paper's own algorithm;
`make_ray_renderer` builds the ray-centric renderer the serving engine
runs; `order_cubes` / `octant_rank` / `ordering_key` implement the Sec. 3.2
ordering and its exact reuse key; `OrderingCache` memoises per-view
schedules across a request stream.

The renderer loops over the non-zero cubes in front-to-back order, a few
cubes (`chunk`) per step. Each step intersects every ray with the cubes'
slabs, compacts the hitting ray-cube pairs into a fixed budget, evaluates
the field on their samples (the fused kernel for an encoded field),
composites each segment and scatters the result into per-ray
accumulators. The reference's `lax.scan` is a Python loop here with no
host synchronisation inside it: every counter stays a device tensor. The
stages carry `torch.profiler.record_function` ranges named as the
reference's `jax.named_scope` markers (`rtnerf.intersect`, `.compact`,
`.field_eval`, `.composite`, `.scatter`) while a profiler records.
"""
from __future__ import annotations

import collections
import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.core.occupancy import CubeSet
from repro_torch.core.rendering import (Camera, dot3, norm3, pixel_rays,
                                        sqrt_rn, step_world)
from repro_torch.device import common_device


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# Sec. 3.2 view-dependent ordering
# --------------------------------------------------------------------------


def octant_rank(origin):
    """Rank of each of the 8 scene octants by distance of its center to
    the (normalised) view origin; host-side numpy, the one implementation
    both `order_cubes` and `ordering_key` consume."""
    o = _host(origin).astype(np.float32).reshape(-1)
    o_n = (o / np.maximum(np.abs(o).max(), np.float32(1e-6))).astype(
        np.float32)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float32) * np.float32(0.5)
    d = np.linalg.norm(signs - o_n[None], axis=-1).astype(np.float32)
    return tuple(int(r) for r in np.argsort(np.argsort(d, kind="stable"),
                                            kind="stable"))


def ordering_key(origin, mode: str = "octant", quantum: float = 0.25):
    """Hashable cache key that determines `order_cubes`' output: the octant
    ranking ("octant"), the origin quantised to `quantum` ("trajectory"),
    or the rounded origin ("distance")."""
    if mode == "trajectory":
        o = _host(origin).astype(np.float64).reshape(-1)
        return tuple(int(q) for q in np.round(o / float(quantum)))
    if mode != "octant":
        return tuple(np.round(_host(origin).astype(np.float64), 6).tolist())
    return octant_rank(origin)


class OrderingCache:
    """Cache of per-view `order_cubes` schedules, one entry per
    `ordering_key`, LRU-bounded by `max_entries`. In "trajectory" mode an
    exact-key miss falls back to the nearest cached pose within
    `nn_radius` quanta (tie-break on (distance, key), so lookups do not
    depend on LRU order).

    `scene` labels the cache (the serving SceneStore keeps one per resident
    scene); `with_cubes(cubes)` is the rebuild path: a NEW cache over the
    new cube set that carries the hit/miss counters forward, so an
    in-flight render keeps its old cache consistent while telemetry stays
    cumulative. With a metrics `registry`, hits and misses are also
    exported as `ordering_cache_hits` / `ordering_cache_misses` counters
    (labelled by scene)."""

    def __init__(self, cubes: CubeSet, mode: str = "octant",
                 max_entries: int = 64, scene: Optional[str] = None, *,
                 pose_quantum: float = 0.25, nn_radius: float = 1.5,
                 registry=None):
        self.cubes = cubes
        self.mode = mode
        self.scene = scene
        self.max_entries = int(max_entries)
        self.pose_quantum = float(pose_quantum)
        self.nn_radius = float(nn_radius)
        self.registry = registry
        self._entries = collections.OrderedDict()  # key -> (perm, ctr, vld)
        self.hits = 0
        self.misses = 0
        self.nn_hits = 0            # subset of hits served by NN fallback
        self._c_hits = self._c_misses = None
        if registry is not None:
            labels = {"scene": scene} if scene is not None else {}
            self._c_hits = registry.counter("ordering_cache_hits", **labels)
            self._c_misses = registry.counter("ordering_cache_misses",
                                              **labels)

    def with_cubes(self, cubes: CubeSet) -> "OrderingCache":
        """Fresh (empty) cache over `cubes`, counters carried over: the
        cube-set-changed path (occupancy rebuild, field swap). A new object
        rather than an in-place invalidate, so a snapshot taken before the
        swap keeps rendering from a consistent (cubes, ordering) pair."""
        nxt = OrderingCache(cubes, self.mode, self.max_entries, self.scene,
                            pose_quantum=self.pose_quantum,
                            nn_radius=self.nn_radius, registry=self.registry)
        nxt.hits, nxt.misses, nxt.nn_hits = (self.hits, self.misses,
                                             self.nn_hits)
        return nxt

    def key_for(self, origin) -> tuple:
        return ordering_key(origin, self.mode, self.pose_quantum)

    def _nearest(self, k: tuple):
        best = None
        for k2 in self._entries:
            d = math.dist(k, k2)
            if d <= self.nn_radius and (best is None or (d, k2) < best):
                best = (d, k2)
        return None if best is None else best[1]

    def _note(self, hit: bool, nn: bool = False):
        if hit:
            self.hits += 1
            self.nn_hits += int(nn)
            if self._c_hits is not None:
                self._c_hits.inc()
        else:
            self.misses += 1
            if self._c_misses is not None:
                self._c_misses.inc()

    def _lookup(self, origin) -> tuple:
        k = self.key_for(origin)
        e = self._entries.get(k)
        if e is None and self.mode == "trajectory":
            k_nn = self._nearest(k)
            if k_nn is not None:
                self._note(hit=True, nn=True)
                self._entries.move_to_end(k_nn)
                return self._entries[k_nn]
        if e is None:
            self._note(hit=False)
            perm = order_cubes(self.cubes, origin, self.mode)
            e = (perm, self.cubes.centers[perm], self.cubes.valid[perm])
            self._entries[k] = e
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        else:
            self._note(hit=True)
            self._entries.move_to_end(k)
        return e

    def get(self, origin) -> torch.Tensor:
        """This view's front-to-back cube permutation."""
        return self._lookup(origin)[0]

    def get_ordered(self, origin):
        """The permuted (centers, valid) tensors for this view."""
        _, centers, valid = self._lookup(origin)
        return centers, valid

    def invalidate(self, cubes: Optional[CubeSet] = None):
        """Drop every cached schedule (counters kept), optionally over a
        new cube set."""
        self._entries.clear()
        if cubes is not None:
            self.cubes = cubes

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "nn_hits": self.nn_hits, "entries": len(self._entries)}


def order_cubes(cubes: CubeSet, origin, mode: str = "octant") -> torch.Tensor:
    """Front-to-back permutation of the cube list for this view: octants
    ranked by distance to the origin, scan order within an octant
    ("octant", "trajectory"), or a per-cube distance sort ("distance").
    Invalid cubes sort last; the sort is stable, as `jnp.argsort` is."""
    c = cubes.centers
    n = c.shape[0]
    if mode in ("octant", "trajectory"):
        oct_id = ((c[:, 0] > 0).to(torch.int64) * 4
                  + (c[:, 1] > 0).to(torch.int64) * 2
                  + (c[:, 2] > 0).to(torch.int64))
        rank = torch.tensor(octant_rank(origin), dtype=torch.float32,
                            device=c.device)
        key = rank[oct_id] * (n + 1.0) + torch.arange(
            n, dtype=torch.float32, device=c.device)
    else:
        o = torch.as_tensor(_host(origin), dtype=torch.float32).to(c.device)
        key = norm3(c - o[None])
    key = torch.where(cubes.valid, key, torch.full_like(key, math.inf))
    return torch.argsort(key, stable=True)


# --------------------------------------------------------------------------
# Sec. 3.1 pre-existing points from non-zero cubes
# --------------------------------------------------------------------------


def auto_tile(cfg: NeRFConfig, cam: Camera) -> int:
    """Static tile size covering the projected ball at the near plane."""
    r_pix = cam.focal * cfg.cube_ball_radius() / max(
        cfg.near - cfg.scene_bound * 0.0 - cfg.cube_ball_radius(), 0.5)
    t = int(math.ceil(2.0 * r_pix / 8.0) * 8 + 8)
    return max(8, min(t, 128))


def samples_per_segment(cfg: NeRFConfig) -> int:
    """Static bound on samples inside one ball: ceil(2r / step) + 1."""
    return int(math.ceil(2.0 * cfg.cube_ball_radius() / step_world(cfg))) + 1


def _cube_samples(cfg: NeRFConfig, cam: Camera, center: torch.Tensor,
                  tile: int, intersect: str = "box"):
    """Steps 2-1-b/c/d for cubes `center` (C, 3), or one cube (3,):
    per-tile-pixel sample geometry (pix_id (C, P), d (C, P, 3), pts
    (C, P, ns, 3), ts (C, P, ns), s_mask (C, P, ns)), P = tile * tile.

    Step 2-1-b projects the cube's bounding ball, 2-1-c takes the static
    tile x tile pixel window around its projected center (origin rounded
    half to even, as `jnp.round`) with an in-circle mask, 2-1-d
    intersects each pixel's ray with the ball ("ball", the paper's) or
    with the cube's slabs ("box", which removes the double counting of
    overlapping balls). Where the tile is wider than the image, pixel
    ids run past it: `in_img` masks their samples, and the caller clamps
    the ids before indexing."""
    one = center.dim() == 1
    center = center.reshape(-1, 3)
    dev = center.device
    # project the centers: (center - origin) @ c2w, camera coordinates
    rel = torch.stack([dot3(center - cam.origin, cam.c2w[:, j])
                       for j in range(3)], dim=-1)              # (C, 3)
    depth = -rel[:, 2]
    r = cfg.cube_ball_radius()
    safe_depth = torch.clamp(depth - r, min=0.1)
    cx = rel[:, 0] / safe_depth * cam.focal + cam.w / 2.0
    cy = -rel[:, 1] / safe_depth * cam.focal + cam.h / 2.0
    # a true quotient (a Python scalar over a tensor is a reciprocal)
    r_pix = torch.full((), cam.focal * r, dtype=torch.float32,
                       device=dev) / safe_depth

    # the static tile x tile window around the projected center
    half = tile // 2
    x0 = torch.clamp(torch.round(cx).to(torch.int64) - half, 0,
                     max(cam.w - tile, 0))
    y0 = torch.clamp(torch.round(cy).to(torch.int64) - half, 0,
                     max(cam.h - tile, 0))
    dx = torch.arange(tile, device=dev)
    px = (x0[:, None, None] + dx[None, None, :]).expand(-1, tile, tile)
    py = (y0[:, None, None] + dx[None, :, None]).expand(-1, tile, tile)
    px = px.reshape(-1, tile * tile)
    py = py.reshape(-1, tile * tile)
    ex, ey = px - cx[:, None], py - cy[:, None]
    rp = r_pix[:, None] + 1.0
    in_oval = ex * ex + ey * ey <= rp * rp
    in_img = (px < cam.w) & (py < cam.h)
    pix_id = py * cam.w + px

    # Step 2-1-d: analytic intersection (line-sphere or line-slab)
    d = pixel_rays(cam, px.to(torch.float32).reshape(-1),
                   py.to(torch.float32).reshape(-1)).reshape(*px.shape, 3)
    if intersect == "ball":
        oc = cam.origin - center                                # (C, 3)
        b = dot3(d, oc[:, None])
        disc = b * b - (dot3(oc, oc)[:, None] - r * r)
        hit_geo = disc > 0.0
        sq = sqrt_rn(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
    else:                                   # exact cube slabs
        hw = cfg.cube_world() / 2.0
        safe_d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        ta = (center[:, None] - hw - cam.origin) / safe_d
        tb = (center[:, None] + hw - cam.origin) / safe_d
        t0 = torch.minimum(ta, tb).amax(dim=-1)
        t1 = torch.maximum(ta, tb).amin(dim=-1)
        hit_geo = t1 > t0
    hit = hit_geo & in_oval & in_img & (depth > cfg.near * 0.5)[:, None]
    t0 = torch.clamp(t0, min=cfg.near)

    ns = samples_per_segment(cfg)
    delta = step_world(cfg)
    ts = t0[..., None] + (torch.arange(ns, device=dev) + 0.5) * delta
    s_mask = hit[..., None] & (ts < t1[..., None])              # (C, P, ns)
    pts = cam.origin + d[..., None, :] * ts[..., None]
    out = (pix_id, d, pts, ts, s_mask)
    return tuple(o[0] for o in out) if one else out


def compact_select(flat_hit: torch.Tensor, budget: int) -> torch.Tensor:
    """Indices of the hitting pairs first (ascending pair order), cut to
    `budget`. The composite key `miss * n + index` is unique, so the
    selection does not depend on any sort's tie-breaking."""
    n = flat_hit.shape[0]
    key = ((~flat_hit).to(torch.int32) * n
           + torch.arange(n, dtype=torch.int32, device=flat_hit.device))
    return torch.argsort(key, stable=True)[:budget]


def _stage(name: str):
    """A `torch.profiler.record_function` range named like the
    reference's `jax.named_scope` stage markers, opened only while a
    profiler records (a range costs microseconds of host time on every
    scan step otherwise)."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def make_ray_renderer(cfg: NeRFConfig, *, chunk: int = 8,
                      pair_budget: Optional[int] = None,
                      white_bg: bool = True):
    """Ray-centric RT-NeRF renderer (serving path).

    Returns `render(field, centers, valid, rays_o, rays_d) -> (rgb, aux)`:
    centers/valid are the *ordered* cube tensors (an `order_cubes`
    permutation applied), rays an arbitrary batch on the same device.
    Geometry is the exact line-slab intersection per (cube, ray). Only
    the hitting pairs, compacted into `pair_budget` slots, go through the
    field and the MLP; pairs beyond the budget are dropped and counted in
    `aux["dropped_pairs"]`, and `aux["active_pairs_max"]` is the largest
    hitting-pair count of any step (the serving engine's budget signal),
    `aux["active_pairs"]` the count of each step (a mesh sums them across
    the ranks that split a chunk before taking the largest).
    `aux` also carries per-ray transmittance, depth, opacity and the
    processed-sample count, all as device tensors.
    """
    delta = step_world(cfg)
    ns = samples_per_segment(cfg)
    half = cfg.cube_world() / 2.0

    def render(field, centers, valid, rays_o, rays_d):
        f = field_lib.as_backend(field, cfg)
        dev = rays_o.device
        n_rays = rays_o.shape[0]
        nc = centers.shape[0]
        # pad (never truncate) the cube list to a chunk multiple
        pad = (-nc) % chunk
        if pad:
            centers = torch.cat([centers, centers.new_zeros((pad, 3))])
            valid = torch.cat([valid, valid.new_zeros((pad,))])
        n_chunks = (nc + pad) // chunk
        n_pairs = chunk * n_rays
        budget = min(pair_budget or max(n_pairs // 4, 128), n_pairs)

        safe_d = torch.where(rays_d.abs() < 1e-9,
                             torch.full_like(rays_d, 1e-9), rays_d)
        offs = (torch.arange(ns, device=dev) + 0.5) * delta    # (ns,)
        log_t = torch.zeros((n_rays,), dtype=torch.float32, device=dev)
        color = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
        depth = torch.zeros((n_rays,), dtype=torch.float32, device=dev)
        processed = torch.zeros((), dtype=torch.float32, device=dev)
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        step_hits = []
        ctr_all = centers.reshape(n_chunks, chunk, 3)
        vld_all = valid.reshape(n_chunks, chunk)

        for s in range(n_chunks):
            ctr, vld = ctr_all[s], vld_all[s]

            # Step 2-1-d: line-slab intersection of every ray with each cube
            with _stage("rtnerf.intersect"):
                ta = (ctr[:, None] - half - rays_o[None]) / safe_d[None]
                tb = (ctr[:, None] + half - rays_o[None]) / safe_d[None]
                t0 = torch.minimum(ta, tb).amax(dim=-1)         # (chunk, N)
                t1 = torch.maximum(ta, tb).amin(dim=-1)
                alive = torch.exp(log_t) > cfg.term_eps
                # t1 > near: cubes behind the camera yield no samples and
                # must not take pair-budget slots
                hit = (t1 > t0) & (t1 > cfg.near) & vld[:, None] & alive[None]
                t0 = torch.clamp(t0, min=cfg.near)

            # active-pair compaction: hits first, cut to the budget
            with _stage("rtnerf.compact"):
                flat_hit = hit.reshape(-1)
                idx = compact_select(flat_hit, budget)
                sel = flat_hit[idx]
                ray_i = idx % n_rays
                t0s = t0.reshape(-1)[idx]
                t1s = t1.reshape(-1)[idx]
                ro_s = rays_o[ray_i]
                rd_s = rays_d[ray_i]
                ts = t0s[:, None] + offs[None]
                s_mask = sel[:, None] & (ts < t1s[:, None])    # (budget, ns)
                pts = ro_s[:, None] + rd_s[:, None] * ts[..., None]
                # points grouped by chunk-local cube for the fused kernel;
                # non-selected pairs land out of window and are masked below
                cid = (idx // n_rays).to(torch.int32)[:, None].expand(
                    s_mask.shape).reshape(-1)

            # the reference's fused.* scopes inside its Pallas kernel have
            # no host counterpart: that work is one CUDA kernel launch
            with _stage("rtnerf.field_eval"):
                sigma, feats = f.sigma_app(pts.reshape(-1, 3), ctr, cid)
                sigma = torch.where(s_mask, sigma.reshape(s_mask.shape), 0.0)
                dirs = rd_s[:, None].expand(pts.shape).reshape(-1, 3)
                rgb = f.color(feats, dirs).reshape(*s_mask.shape, 3)

            # per-pair compositing along the segment
            with _stage("rtnerf.composite"):
                tau = sigma * delta
                cum = torch.cumsum(tau, dim=-1)
                w = torch.exp(-(cum - tau)) * (1.0 - torch.exp(-tau))
                seg_rgb = torch.sum(w[..., None] * rgb, dim=-2)  # (budget, 3)
                seg_d = torch.sum(w * ts, dim=-1)
                seg_tau = torch.where(sel, cum[..., -1], 0.0)

            # scatter into the per-ray accumulators (pre-step T)
            with _stage("rtnerf.scatter"):
                t_here = torch.exp(log_t)[ray_i]
                color.index_add_(0, ray_i, torch.where(
                    sel[:, None], t_here[:, None] * seg_rgb, 0.0))
                depth.index_add_(0, ray_i,
                                 torch.where(sel, t_here * seg_d, 0.0))
                log_t.index_add_(0, ray_i, -seg_tau)
                processed = processed + s_mask.sum(dtype=torch.float32)
                n_hit = flat_hit.sum(dtype=torch.int32)
                dropped = dropped + torch.clamp(n_hit - budget, min=0)
                step_hits.append(n_hit)

        t_final = torch.exp(log_t)
        if white_bg:
            color = color + t_final[:, None]
        pairs = (torch.stack(step_hits) if step_hits
                 else torch.zeros((1,), dtype=torch.int32, device=dev))
        return color, {"t_final": t_final, "depth": depth,
                       "opacity": 1.0 - t_final,
                       "processed_samples": processed,
                       "dropped_pairs": dropped,
                       "active_pairs_max": pairs.max(),
                       "active_pairs": pairs}

    return render


def rtnerf_scan(f, cfg: NeRFConfig, cubes: CubeSet, cam: Camera, *,
                order_mode: str = "octant", chunk: int = 1,
                intersect: str = "box", white_bg: bool = True,
                per_pixel: bool = False):
    """The scan of `render_rtnerf` over a FieldBackend `f`: (rgb (H*W, 3),
    processed samples as an int64 0-dim tensor, tile, chunks scanned,
    and with `per_pixel` the processed samples of each pixel, else None).

    Invalid cubes sort last (`order_cubes`), so only the first
    ceil(count / chunk) chunks hold a valid cube; the reference scans all
    max_cubes // chunk of them with the rest masked, which adds exact
    zeros. The chunk partition of the valid cubes is the reference's, so
    the image and the counts are too."""
    dev = common_device(cam.c2w, cam.origin, cubes.centers, f.device,
                        what="render_rtnerf's field, cube set and camera")
    tile = auto_tile(cfg, cam)
    perm = order_cubes(cubes, cam.origin, order_mode)
    centers = cubes.centers[perm]
    valid = cubes.valid[perm]
    n_pix = cam.h * cam.w
    delta = step_world(cfg)
    n_chunks = min(-(-cubes.count // chunk), centers.shape[0] // chunk)
    ctr_all = centers[: n_chunks * chunk].reshape(n_chunks, chunk, 3)
    vld_all = valid[: n_chunks * chunk].reshape(n_chunks, chunk)

    log_t = torch.zeros((n_pix,), dtype=torch.float32, device=dev)
    color = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    processed = torch.zeros((), dtype=torch.int64, device=dev)
    pix_count = (torch.zeros((n_pix,), dtype=torch.int64, device=dev)
                 if per_pixel else None)
    for s in range(n_chunks):
        ctr, vld = ctr_all[s], vld_all[s]

        with _stage("rtnerf.intersect"):
            pix_id, d, pts, _, s_mask = _cube_samples(cfg, cam, ctr, tile,
                                                      intersect)
            s_mask = s_mask & vld[:, None, None]
            # ids past the image (a tile wider than it) read a clamped
            # pixel, as the reference's gather does; `in_img` has masked
            # their samples, and their scatters are dropped below
            in_range = pix_id < n_pix
            ids = torch.clamp(pix_id, max=n_pix - 1)
            # Sec. 3.2 early termination: skip points on opaque rays
            t_here = torch.exp(log_t[ids])                      # (chunk, P)
            s_mask = s_mask & (t_here > cfg.term_eps)[..., None]
            # points grouped by source cube for the fused streaming path
            cid = torch.arange(chunk, dtype=torch.int32,
                               device=dev).repeat_interleave(
                                   s_mask[0].numel())
        with _stage("rtnerf.field_eval"):
            sigma, feats = f.sigma_app(pts.reshape(-1, 3), ctr, cid)
            sigma = torch.where(s_mask, sigma.reshape(s_mask.shape), 0.0)
            dirs = d[:, :, None].expand(pts.shape).reshape(-1, 3)
            rgb = f.color(feats, dirs).reshape(*s_mask.shape, 3)

        # per-(cube, pixel) compositing along the segment
        tau = sigma * delta
        cum = torch.cumsum(tau, dim=-1)
        w = torch.exp(-(cum - tau)) * (1.0 - torch.exp(-tau))
        seg_rgb = torch.sum(w[..., None] * rgb, dim=-2)         # (chunk, P, 3)
        seg_tau = cum[..., -1]

        # scatter into the running per-pixel (T, color) accumulators
        keep = in_range.reshape(-1)
        ids = ids.reshape(-1)
        contrib = (t_here[..., None] * seg_rgb).reshape(-1, 3)
        color.index_add_(0, ids, torch.where(keep[:, None], contrib, 0.0))
        log_t.index_add_(0, ids, torch.where(keep, -seg_tau.reshape(-1),
                                             0.0))
        n_proc = s_mask.sum(dim=-1)
        processed += n_proc.sum()
        if per_pixel:
            pix_count.index_add_(0, ids, torch.where(keep, n_proc.reshape(-1),
                                                     0))
    t_final = torch.exp(log_t)
    if white_bg:
        color = color + t_final[:, None]
    return color, processed, tile, n_chunks, pix_count


def render_rtnerf(field, cfg: NeRFConfig, cubes: CubeSet, cam: Camera, *,
                  order_mode: str = "octant", chunk: int = 1,
                  intersect: str = "box", white_bg: bool = True):
    """Full-image render via the RT-NeRF pipeline: (rgb (H*W, 3), stats).

    `field` is anything `field.as_backend` accepts: a DenseField / params
    dict evaluates the raw factor tensors; a CompressedField evaluates
    its hybrid bitmap/COO streams in place (the fused kernel on the card,
    or the per-op gathers where its window does not fit). The camera, the
    cube set and the field share one device, where it runs. `chunk` cubes
    are composited per scan step (exact at 1, the default); stats are
    float32 0-dim tensors with the reference's keys, processed samples
    counted in int64 until the final conversion.
    """
    f = field_lib.as_backend(field, cfg)
    color, processed, tile, _, _ = rtnerf_scan(
        f, cfg, cubes, cam, order_mode=order_mode, chunk=chunk,
        intersect=intersect, white_bg=white_bg)
    ns = samples_per_segment(cfg)
    dev = color.device

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)
    n = float(cubes.count)
    stats = {
        # the pipeline touches the occupancy structure once per cube
        "occ_accesses": f32(n),
        "candidate_samples": f32(n * tile * tile * ns),
        "processed_samples": f32(processed),
        "n_cubes": f32(n),
        "tile": f32(float(tile)),
        # field-memory footprint of the hot loop (paper Sec. 4.2.2)
        "factor_bytes": f32(float(f.factor_bytes())),
        "factor_bytes_dense": f32(float(f.dense_factor_bytes())),
    }
    return color, stats
