"""TensoRF VM-decomposed radiance field (paper Eq. 2). The port of
`repro/core/tensorf.py`.

The 3D embedding grid is decomposed into three (matrix, vector) mode
pairs, (M^{Y,Z}, v^X), (M^{X,Z}, v^Y), (M^{X,Y}, v^Z), for density
(R_sigma components) and appearance (R_color components). Appearance
features go through a basis matrix and a small view-dependent MLP.
Points live in [-bound, bound]^3; sampling is bilinear on planes and
linear on lines.

A field is a dict of tensors (`init_field`), or an encoded field
(core/field.CompressedField) sampled through the hybrid codec: per point
with the gather kernels, or per cube with the fused kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import sparse
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import fused_sample, ops
from repro_torch.models.common import PL, positional_encoding

# mode m pairs plane axes PLANE_AXES[m] with line axis LINE_AXES[m]
PLANE_AXES = ((1, 2), (0, 2), (0, 1))   # (Y,Z), (X,Z), (X,Y)
LINE_AXES = (0, 1, 2)                   # X, Y, Z


def mlp_in_dim(cfg: NeRFConfig) -> int:
    d_dir = 3 + 2 * 3 * cfg.pe_view
    d_feat = cfg.app_dim + 2 * cfg.app_dim * cfg.pe_feat
    return d_dir + d_feat


def field_shapes(cfg: NeRFConfig) -> Dict[str, Tuple[int, ...]]:
    """The shape of every parameter `init_field(cfg)` allocates, computed
    from the config alone (nothing is allocated)."""
    g, h, in_dim = cfg.grid_res, cfg.mlp_hidden, mlp_in_dim(cfg)
    return {
        "sigma_planes": (3, cfg.r_sigma, g, g),
        "sigma_lines": (3, cfg.r_sigma, g),
        "app_planes": (3, cfg.r_color, g, g),
        "app_lines": (3, cfg.r_color, g),
        "basis": (3 * cfg.r_color, cfg.app_dim),
        "mlp_w1": (in_dim, h),
        "mlp_b1": (h,),
        "mlp_w2": (h, h),
        "mlp_b2": (h,),
        "mlp_w3": (h, 3),
        "mlp_b3": (3,),
    }


def init_field(cfg: NeRFConfig, generator: torch.Generator, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random field parameters of `field_shapes(cfg)`: normal draws from
    `generator` (a CPU generator, so a seed gives the same field on every
    device) scaled by fan-in as in the reference. Zero biases."""
    dev = resolve_device(device)
    out = {}
    for k, shape in field_shapes(cfg).items():
        if k.startswith("mlp_b"):
            out[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
            continue
        fan_in, scale = (1, 0.1) if k in sparse.FACTOR_KEYS else (shape[0],
                                                                  1.0)
        std = scale / math.sqrt(max(fan_in, 1))
        out[k] = (torch.randn(shape, generator=generator,
                              dtype=torch.float32) * std).to(dev)
    return out


# each parameter's logical axes, as the reference's init_field_pl gives them
FIELD_LOGICAL = {
    "sigma_planes": (None, None, None, None),
    "sigma_lines": (None, None, None),
    "app_planes": (None, None, None, None),
    "app_lines": (None, None, None),
    "basis": (None, None),
    "mlp_w1": (None, "mlp"),
    "mlp_b1": ("mlp",),
    "mlp_w2": ("mlp", "mlp"),
    "mlp_b2": ("mlp",),
    "mlp_w3": ("mlp", None),
    "mlp_b3": (None,),
}


def init_field_pl(cfg: NeRFConfig, generator: torch.Generator, *,
                  device: DeviceLike = None) -> Dict[str, PL]:
    """`init_field`'s tensors, the same draws, each wrapped in a `PL` with
    the reference's logical axes (`models.common.split_pl` separates
    them again)."""
    return {k: PL(v, FIELD_LOGICAL[k])
            for k, v in init_field(cfg, generator, device=device).items()}


def to_grid(cfg: NeRFConfig, pts: torch.Tensor) -> torch.Tensor:
    """World [-bound,bound]^3 -> continuous grid coords [0, G-1], with a
    true division (see kernels/fused_sample.to_grid)."""
    return fused_sample.to_grid(pts, grid_res=cfg.grid_res,
                                scene_bound=cfg.scene_bound)


def _stencil(x: torch.Tensor, g: int):
    """Clip to the grid, low corner (int64) and fractional weight."""
    x = x.clamp(0.0, g - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, g - 2)
    return x0, x - x0


def _interp_line(line: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """line (R, G); x (N,) continuous -> (R, N) linear interp."""
    x0, f = _stencil(x, line.shape[-1])
    return line[:, x0] * (1 - f) + line[:, x0 + 1] * f


def _interp_plane(plane: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """plane (R, G, G); u,v (N,) -> (R, N) bilinear interp."""
    g = plane.shape[-1]
    u0, fu = _stencil(u, g)
    v0, fv = _stencil(v, g)
    p00 = plane[:, u0, v0]
    p01 = plane[:, u0, v0 + 1]
    p10 = plane[:, u0 + 1, v0]
    p11 = plane[:, u0 + 1, v0 + 1]
    return (p00 * (1 - fu) * (1 - fv) + p01 * (1 - fu) * fv
            + p10 * fu * (1 - fv) + p11 * fu * fv)


def vm_components(planes, lines, pts_g) -> torch.Tensor:
    """Eq. 2 inner products per component: (3, R, N)."""
    outs = []
    for m in range(3):
        a, b = PLANE_AXES[m]
        pm = _interp_plane(planes[m], pts_g[:, a], pts_g[:, b])
        lm = _interp_line(lines[m], pts_g[:, LINE_AXES[m]])
        outs.append(pm * lm)
    return torch.stack(outs)


def sigma_sum(planes, lines, cfg: NeRFConfig,
              pts: torch.Tensor) -> torch.Tensor:
    """Eq. 2's sum over the modes and the components of `planes` and
    `lines` (all R, or a rank's channels of them): the density before
    its softplus, (N,)."""
    return vm_components(planes, lines, to_grid(cfg, pts)).sum(dim=(0, 1))


def eval_sigma(params, cfg: NeRFConfig, pts: torch.Tensor) -> torch.Tensor:
    """Density (Eq. 2): softplus of the sum over modes and components."""
    return F.softplus(sigma_sum(params["sigma_planes"],
                                params["sigma_lines"], cfg, pts))


def app_sum(planes, lines, basis: torch.Tensor, cfg: NeRFConfig,
            pts: torch.Tensor) -> torch.Tensor:
    """The components of `planes` and `lines` through `basis`, the rows
    that meet them (`basis_rows`): the appearance features (N, app_dim),
    or a rank's share of their sum over R."""
    comp = vm_components(planes, lines, to_grid(cfg, pts))
    feat = comp.reshape(3 * comp.shape[1], -1).T        # (N, 3*R)
    return feat @ basis                                 # (N, app_dim)


def basis_rows(basis: torch.Tensor, r_color: int, lo: int,
               hi: int) -> torch.Tensor:
    """The rows of the (3 * r_color, app_dim) basis that appearance
    channels lo:hi meet. The features are mode-major (row m * r_color +
    r), so a range of channels meets three strided blocks, one a mode."""
    return basis.view(3, r_color, -1)[:, lo:hi].reshape(3 * (hi - lo), -1)


def eval_app_features(params, cfg: NeRFConfig,
                      pts: torch.Tensor) -> torch.Tensor:
    return app_sum(params["app_planes"], params["app_lines"],
                   params["basis"], cfg, pts)


# --------------------------------------------------------------------------
# Compressed-field (hybrid bitmap/COO) evaluation, per op: every factor
# read is a gather over the encoded stream (bitmap_gather / coo_gather).
# --------------------------------------------------------------------------


def gather_factor(ef: sparse.EncodedFactor, cols: torch.Tensor,
                  force: Optional[str] = None) -> torch.Tensor:
    """All R rows of an encoded (R, ncols) factor at column indices `cols`
    (N,) -> (R, N), one gather over the stream for the whole stencil."""
    if ef.fmt == "dense":
        return ef.dense[:, cols.to(torch.int64)]
    rows, ncols = ef.shape
    q = (torch.arange(rows, dtype=torch.int32, device=cols.device)[:, None]
         * ncols + cols[None, :].to(torch.int32)).reshape(-1)
    if ef.fmt == "bitmap":
        e = ef.bitmap
        out = ops.bitmap_gather(e.words, e.rowptr, e.values, q, cols=ncols,
                                rank=e.rank, force=force)
    else:
        out = ops.coo_gather(ef.coo.coords, ef.coo.values, q, force=force)
    return out.reshape(rows, -1)


def _interp_line_enc(ef, x: torch.Tensor, force=None) -> torch.Tensor:
    x0, f = _stencil(x, ef.ncols)
    v0, v1 = gather_factor(ef, torch.cat([x0, x0 + 1]), force).chunk(2, dim=1)
    return v0 * (1 - f) + v1 * f


def _interp_plane_enc(ef, u: torch.Tensor, v: torch.Tensor,
                      force=None) -> torch.Tensor:
    g = int(ef.nd_shape[-1])
    u0, fu = _stencil(u, g)
    v0, fv = _stencil(v, g)
    c00 = u0 * g + v0
    p00, p01, p10, p11 = gather_factor(
        ef, torch.cat([c00, c00 + 1, c00 + g, c00 + g + 1]), force
    ).chunk(4, dim=1)
    return (p00 * (1 - fu) * (1 - fv) + p01 * (1 - fu) * fv
            + p10 * fu * (1 - fv) + p11 * fu * fv)


def vm_components_hybrid(plane_efs, line_efs, pts_g,
                         force=None) -> torch.Tensor:
    outs = []
    for m in range(3):
        a, b = PLANE_AXES[m]
        pm = _interp_plane_enc(plane_efs[m], pts_g[:, a], pts_g[:, b], force)
        lm = _interp_line_enc(line_efs[m], pts_g[:, LINE_AXES[m]], force)
        outs.append(pm * lm)
    return torch.stack(outs)


def eval_sigma_hybrid(cf, cfg: NeRFConfig, pts: torch.Tensor,
                      force=None) -> torch.Tensor:
    """eval_sigma over an encoded field (core/field.CompressedField)."""
    comp = vm_components_hybrid(cf.factors["sigma_planes"],
                                cf.factors["sigma_lines"],
                                to_grid(cfg, pts), force)
    return F.softplus(comp.sum(dim=(0, 1)))


def eval_app_features_hybrid(cf, cfg: NeRFConfig, pts: torch.Tensor,
                             force=None) -> torch.Tensor:
    comp = vm_components_hybrid(cf.factors["app_planes"],
                                cf.factors["app_lines"],
                                to_grid(cfg, pts), force)
    return comp.reshape(3 * cfg.r_color, -1).T @ cf.extras["basis"]


# --------------------------------------------------------------------------
# Fused streaming eval (kernels/fused_sample.py): points grouped by cube,
# per-cube factor windows decoded once, both heads accumulated in one pass.
# --------------------------------------------------------------------------


def fused_window(cfg: NeRFConfig) -> int:
    """Window span W (grid units) covering every interpolation stencil one
    cube's samples can touch: the cube's bounding ball, +1 for the floor
    low corner, +1 for the stencil high corner, +1 slack."""
    span = (cfg.cube_ball_radius() / cfg.scene_bound) * (cfg.grid_res - 1)
    return min(int(math.ceil(span)) + 3, cfg.grid_res)


def window_base(cfg: NeRFConfig, centers: torch.Tensor) -> torch.Tensor:
    """(C, 3) int32 window origins for cube centers (C, 3 world)."""
    W = fused_window(cfg)
    gmin = to_grid(cfg, centers - cfg.cube_ball_radius())
    base = torch.floor(gmin).to(torch.int32) - 1
    return base.clamp(0, cfg.grid_res - W)


def fused_field_inputs(cf) -> Tuple:
    """(spec, streams) of a CompressedField in the canonical order of
    kernels/fused_sample.py, or (None, None) when a factor cannot stream
    (unknown format, or a bitmap without its rank table)."""
    spec, streams = [], []
    for k in sparse.FACTOR_KEYS:
        for ef in cf.factors[k]:
            rows, ncols = ef.shape
            if ef.fmt == "dense":
                spec.append(("dense", rows, ncols))
                streams.append(ef.dense)
            elif ef.fmt == "bitmap":
                e = ef.bitmap
                if e.rank is None:
                    return None, None
                spec.append(("bitmap", rows, ncols))
                streams.extend([e.words, e.rank, e.values])
            elif ef.fmt == "coo":
                spec.append(("coo", rows, ncols))
                streams.extend([ef.coo.coords, ef.coo.values])
            else:
                return None, None
    return tuple(spec), tuple(streams)


def _route(cfg: NeRFConfig, spec, force, device) -> str:
    """"fused", "fused_ref" or "per-op" for this field on `device`. Where
    the kernel route is taken (CUDA tensors, or `force="fused"`), a field
    whose fused window does not fit the kernel's shared memory, or whose
    app_dim is above the kernel's, takes the per-op gathers instead: the
    reference's own fallback for structures the fused path cannot stream.
    The plain version (the CPU's default) has no such limit."""
    mode = ops.fused_mode(force, device)
    if spec is None or mode == "per-op":
        return "per-op"
    if mode == "fused" and not fused_sample.fused_fits(
            fused_window(cfg), spec[0][1], spec[6][1], cfg.app_dim):
        return "per-op"
    return mode


def hybrid_dispatch(cf, force=None) -> str:
    """The path `eval_sigma_app_hybrid` takes for this field on its device:
    "fused" (CUDA kernel), "fused_ref" (plain version) or "per-op" (the
    gathers: the field cannot stream, or its window does not fit the
    kernel)."""
    spec, _ = fused_field_inputs(cf)
    return _route(cf.cfg, spec, force, cf.device)


def eval_sigma_app_hybrid(cf, cfg: NeRFConfig, pts: torch.Tensor,
                          cube_base: torch.Tensor, cube_id: torch.Tensor,
                          force=None):
    """(sigma, app_features) over an encoded field in one pass of the fused
    kernel; the per-op gather composition (bitmap_gather / coo_gather
    kernels on the card) when `hybrid_dispatch` says "per-op". The same
    math as eval_sigma_hybrid + eval_app_features_hybrid."""
    spec, streams = fused_field_inputs(cf)
    mode = _route(cfg, spec, force, pts.device)
    if mode == "per-op":
        per_op_force = force if spec is None else None
        return (eval_sigma_hybrid(cf, cfg, pts, per_op_force),
                eval_app_features_hybrid(cf, cfg, pts, per_op_force))
    raw, feats = ops.fused_sigma_app(
        spec, streams, cf.extras["basis"], pts, cube_base, cube_id,
        grid_res=cfg.grid_res, scene_bound=cfg.scene_bound,
        window=fused_window(cfg), app_dim=cfg.app_dim, force=force)
    return F.softplus(raw), feats


def eval_color(params, cfg: NeRFConfig, feats: torch.Tensor,
               dirs: torch.Tensor) -> torch.Tensor:
    """View-dependent color MLP. feats (N, app_dim); dirs (N, 3) unit."""
    x = torch.cat([positional_encoding(dirs, cfg.pe_view),
                   positional_encoding(feats, cfg.pe_feat)], dim=-1)
    h = torch.relu(x @ params["mlp_w1"] + params["mlp_b1"])
    h = torch.relu(h @ params["mlp_w2"] + params["mlp_b2"])
    return torch.sigmoid(h @ params["mlp_w3"] + params["mlp_b3"])


def abs_grad1(x: torch.Tensor) -> torch.Tensor:
    """|x|, with the reference's gradient: +1 at x = 0 (`jnp.abs`
    differentiates as x >= 0 ? 1 : -1), where `torch.abs` gives 0. The
    L1 term then pulls every zero entry and pad slot, as in the
    reference, and revival ranks zero entries by the same scores."""
    return torch.where(x >= 0, x, -x)


def _mean(x: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    """x.mean(), or x's sum over `count`, a float32 0-dim tensor (a
    shard's share of the whole tensor's mean)."""
    if count is None:
        return x.mean()
    return x.sum() / torch.tensor(float(count), dtype=torch.float32,
                                  device=x.device)


def factor_l1(w: torch.Tensor, numel: Optional[int] = None) -> torch.Tensor:
    """The mean |w| of a factor tensor of `numel` elements (None: w's
    own); of a shard, its share of the whole tensor's mean."""
    return _mean(abs_grad1(w), numel)


def plane_tv(p: torch.Tensor, numel: Optional[int] = None) -> torch.Tensor:
    """The mean squared difference of neighbours along each axis of the
    (..., G, G) planes `p` of `numel` elements (None: p's own); of a
    shard cut on a leading dim, its share of the whole tensor's."""
    n = None if numel is None else numel // p.shape[-1] * (p.shape[-1] - 1)
    d1 = _mean(torch.square(p[..., 1:, :] - p[..., :-1, :]), n)
    d2 = _mean(torch.square(p[..., :, 1:] - p[..., :, :-1]), n)
    return d1 + d2


def field_l1(params) -> torch.Tensor:
    """L1 sparsity regulariser: the mean |w| of each factor tensor,
    summed; it induces the factor sparsity the hybrid encoding uses."""
    return (factor_l1(params["sigma_planes"])
            + factor_l1(params["sigma_lines"])
            + factor_l1(params["app_planes"])
            + factor_l1(params["app_lines"]))


def field_tv(params) -> torch.Tensor:
    """Total variation of the planes (smoothness): the mean squared
    difference of neighbours along each plane axis."""
    return plane_tv(params["sigma_planes"]) + plane_tv(params["app_planes"])


def prune_factors(params, tol: float = 1e-3):
    """Hard-threshold tiny factor entries to exact zeros."""
    out = dict(params)
    for k in sparse.FACTOR_KEYS:
        w = params[k]
        out[k] = torch.where(w.abs() < tol, torch.zeros_like(w), w)
    return out


def _quantile_f32(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of a flat float32 tensor, computed in
    float32 step for step as the reference's `jnp.quantile`, so the
    pruning threshold is the same float."""
    s = torch.sort(x).values
    n = torch.tensor(float(s.shape[0]), dtype=torch.float32)
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo_v = s[int(low.clamp(0, n - 1))].cpu()
    hi_v = s[int(high.clamp(0, n - 1))].cpu()
    return (lo_v * lw + hi_v * hw).to(x.device)


def prune_to_sparsity(params, target: float):
    """Magnitude-prune each factor tensor to (at least) `target` fraction
    of exact zeros."""
    out = dict(params)
    for k in sparse.FACTOR_KEYS:
        w = params[k]
        thresh = _quantile_f32(w.abs().reshape(-1), target)
        out[k] = torch.where(w.abs() <= thresh, torch.zeros_like(w), w)
    return out


def factor_sparsity(params) -> Dict[str, float]:
    """Fraction of exact zeros per factor tensor (paper Fig. 5). The count
    is an integer and the fraction one float32 division, count / size:
    the reference's float32 `jnp.mean(w == 0.0)`, bit for bit, while a
    tensor has fewer than 2^24 elements (its float32 sum of ones is exact
    there; app_planes at NeRFConfig() has 3,686,400)."""
    out = {}
    for k in sparse.FACTOR_KEYS:
        w = params[k]
        zeros = int((w == 0.0).sum())
        out[k] = float(np.float32(zeros) / np.float32(w.numel()))
    return out
