"""Fused decode-sample-accumulate over the hybrid-encoded field. The port
of `repro/kernels/fused_sample.py`.

Per block of cube-grouped points it decodes each cube's small factor
windows straight from the encoded bitmap/COO/dense streams of all twelve
TensoRF VM slices, interpolates them at the points and accumulates the
Eq. 2 products into the density sum and the basis-projected appearance
features, without writing any dense factor to device memory.

Layout contract (shared with `core/tensorf.fused_field_inputs` and
`kernels/ops.fused_sigma_app`):

  * `spec` is a tuple of 12 factor specs in canonical order
    (sigma_planes[0..2], sigma_lines[0..2], app_planes[0..2],
    app_lines[0..2]), each `(fmt, rows, ncols)` with fmt in
    {"dense", "bitmap", "coo"}.
  * `streams` is the matching flat tuple of tensors: dense -> (matrix,),
    bitmap -> (words, rank, values), coo -> (coords, values).
  * Points are grouped by occupancy cube: `cube_base` (C, 3) int32 holds
    each cube's window origin in grid coords, `cube_id` (N,) int32 maps
    every point to its cube. Points whose stencil leaves their window read
    clipped window entries and must be masked out by the caller.

`fused_sigma_app` launches the CUDA kernel (`csrc/fused_sample.cu`) on
CUDA tensors and runs the plain PyTorch version `fused_sigma_app_ref` on
CPU tensors; anything else raises. `fused_sigma_app.launches` counts
kernel launches (one per call, which runs a decode and a sample kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparse import popcount32
from repro_torch.kernels import _build
from repro_torch.kernels.coo_gather import search_steps

# mode m pairs plane axes PLANE_AXES[m] with line axis LINE_AXES[m]
# (restated from core/tensorf: the kernels layer sits below core)
PLANE_AXES = ((1, 2), (0, 2), (0, 1))
LINE_AXES = (0, 1, 2)

STREAMS_PER_FMT = {"dense": 1, "bitmap": 3, "coo": 2}
FMT_CODE = {"dense": 0, "bitmap": 1, "coo": 2}
MAX_APP_DIM = 32          # csrc/fused_sample.cu kMaxAppDim
TILE = 256                # points per CTA (kTile)
BASIS_STRIDE = 40         # kBasisStride: a basis row, 32 columns + 8
MAX_SMEM_BYTES = _build.MAX_SMEM_BYTES
PLAN_CACHE_SIZE = 8       # fields whose checks and descriptor are kept


def fused_supported(spec) -> bool:
    """Whether the fused path can serve this field structure; False sends
    the eval down the per-op gather composition in core/tensorf."""
    return (spec is not None and len(spec) == 12
            and all(fs[0] in STREAMS_PER_FMT for fs in spec))


def stream_count(spec) -> int:
    return sum(STREAMS_PER_FMT[fs[0]] for fs in spec)


def group_streams(spec, streams):
    """Pair each factor spec with its slice of the flat stream tuple."""
    out, i = [], 0
    for fs in spec:
        k = STREAMS_PER_FMT[fs[0]]
        out.append((fs, tuple(streams[i:i + k])))
        i += k
    if i != len(streams):
        raise ValueError(f"got {len(streams)} stream tensors, spec needs {i}")
    return out


def to_grid(pts: torch.Tensor, *, grid_res: int,
            scene_bound: float) -> torch.Tensor:
    """World [-bound, bound]^3 -> continuous grid coords [0, G-1].

    The bound is a device tensor on purpose: PyTorch computes a CUDA
    tensor divided by a Python scalar as a product with the reciprocal,
    which can round one ulp away from the true quotient that the kernel
    and the reference compute, and move a point's floor by a cell."""
    bound = torch.full((), scene_bound, dtype=pts.dtype, device=pts.device)
    return (pts / bound * 0.5 + 0.5) * (grid_res - 1)


def _decode_cols(fs, arrs, cols: torch.Tensor) -> torch.Tensor:
    """All R rows of one encoded (R, ncols) factor at columns `cols` (K,)
    -> (R, K): bitmap = rank read + single-word popcount, COO = sorted
    search, dense = read."""
    fmt, rows, ncols = fs
    cols = cols.to(torch.int64)
    if fmt == "dense":
        return arrs[0][:, cols]
    if fmt == "bitmap":
        words, rank, values = arrs
        wi = cols // 32
        bi = cols % 32
        w = words[:, wi].to(torch.int64) & 0xFFFFFFFF           # (R, K)
        below = ((torch.ones_like(bi) << bi) - 1)[None, :]
        addr = rank[:, wi].to(torch.int64) + popcount32(w & below)
        bit = (w >> bi[None, :]) & 1
        vals = values[addr.clamp(0, values.shape[0] - 1)]
        return torch.where(bit > 0, vals, torch.zeros_like(vals))
    coords, values = arrs                                       # "coo"
    q = (torch.arange(rows, dtype=torch.int64, device=cols.device)[:, None]
         * ncols + cols[None, :]).to(coords.dtype)              # (R, K)
    n = coords.shape[0]
    lo = torch.searchsorted(coords, q.reshape(-1)).reshape(q.shape)
    safe = lo.clamp(0, n - 1)
    found = (lo < n) & (coords[safe] == q)
    vals = values[safe]
    return torch.where(found, vals, torch.zeros_like(vals))


def fused_sigma_app_ref(spec, streams, basis, pts, cube_base, cube_id, *,
                        grid_res: int, scene_bound: float, window: int,
                        app_dim: int):
    """Plain version: the reference's windows-then-sample math in plain
    PyTorch (COO decode by `searchsorted`). Returns (sigma_raw (N,),
    feat (N, app_dim)); softplus is applied by the caller."""
    groups = group_streams(spec, streams)
    ptsg = to_grid(pts, grid_res=grid_res, scene_bound=scene_bound)
    G, W = grid_res, window
    base = cube_base.to(torch.int64)
    C = base.shape[0]
    cid = cube_id.to(torch.int64).clamp(0, C - 1)
    n = ptsg.shape[0]
    dev = ptsg.device
    ii = torch.arange(W, dtype=torch.int64, device=dev)

    p = ptsg.clamp(0.0, G - 1.0)
    p0 = torch.floor(p).to(torch.int64).clamp(0, G - 2)
    fr = p - p0
    loc = (p0 - base[cid]).clamp(0, W - 2)                      # (N, 3)

    out = torch.zeros((n, 1 + app_dim), dtype=torch.float32, device=dev)
    for m in range(3):
        a, b = PLANE_AXES[m]
        ax = LINE_AXES[m]
        spf, spa = groups[m]
        slf, sla = groups[3 + m]
        apf, apa = groups[6 + m]
        alf, ala = groups[9 + m]
        Rs, Rc = spf[1], apf[1]

        # decode: per-cube windows, sigma and app rows of one mode together
        pcols = ((base[:, a, None, None] + ii[None, :, None]) * G
                 + base[:, b, None, None] + ii[None, None, :]).reshape(-1)
        pw = torch.cat([_decode_cols(spf, spa, pcols),
                        _decode_cols(apf, apa, pcols)]).T    # (C*W*W, R)
        lcols = (base[:, ax, None] + ii[None, :]).reshape(-1)
        lw = torch.cat([_decode_cols(slf, sla, lcols),
                        _decode_cols(alf, ala, lcols)]).T    # (C*W, R)

        # sample: bilinear on the plane window, linear on the line
        lu, lv, lx = loc[:, a], loc[:, b], loc[:, ax]
        fu = fr[:, a, None]
        fv = fr[:, b, None]
        fx = fr[:, ax, None]
        i00 = (cid * W + lu) * W + lv
        p00 = pw[i00]
        p01 = pw[i00 + 1]
        p10 = pw[i00 + W]
        p11 = pw[i00 + W + 1]
        pm = (p00 * (1 - fu) * (1 - fv) + p01 * (1 - fu) * fv
              + p10 * fu * (1 - fv) + p11 * fu * fv)
        il = cid * W + lx
        lm = lw[il] * (1 - fx) + lw[il + 1] * fx
        comp = pm * lm                                          # (N, R)

        # accumulate: one product with the ones-column-extended basis
        bm = basis[m * Rc:(m + 1) * Rc]
        bext = torch.zeros((Rs + Rc, 1 + app_dim), dtype=torch.float32,
                           device=dev)
        bext[:Rs, 0] = 1.0
        bext[Rs:, 1:] = bm
        out = out + comp @ bext
    return out[:, 0], out[:, 1:]


def round4(n: int) -> int:
    return (n + 3) & ~3


def window_block_floats(window: int, r: int) -> tuple:
    """Floats of one (cube, mode) block of the decoded scratch: the plane
    window (W*W, R) and the line window (W, R), each padded to 16 bytes so
    one bulk copy moves it."""
    return round4(window * window * r), round4(window * r)


def comp_stride(r_color: int) -> int:
    """Floats per point in the kernel's staged appearance channels: Rc
    rounded up to the mma depth 8, plus 4 (bank spread)."""
    return ((r_color + 7) & ~7) + 4


def fused_smem_bytes(window: int, r_sigma: int, r_color: int) -> int:
    """Shared memory of the sample kernel (csrc/fused_sample.cu SmemPlan):
    one (cube, mode) window, the tile's appearance channels (or its
    (TILE, 32) output staging, whichever is larger), the basis padded to 8
    rows and BASIS_STRIDE columns, per-point fractions, cells and cube ids,
    8 ints and an mbarrier."""
    pb, lb = window_block_floats(window, r_sigma + r_color)
    comp = max(TILE * comp_stride(r_color), TILE * MAX_APP_DIM)
    basis = 3 * ((r_color + 7) & ~7) * BASIS_STRIDE
    points = 5 * TILE + 8
    return 4 * (pb + lb + comp + basis + points) + 8


def fused_fits(window: int, r_sigma: int, r_color: int,
               app_dim: int) -> bool:
    """Whether the sample kernel can take a field of this window, ranks
    and app_dim: its shared memory (`fused_smem_bytes`) within the limit
    a block may use, and app_dim within MAX_APP_DIM. Pure; a False sends
    the field down the per-op gathers (`core/tensorf.hybrid_dispatch`)."""
    return (app_dim <= MAX_APP_DIM and fused_smem_bytes(
        window, r_sigma, r_color) <= MAX_SMEM_BYTES)


def check_smem_fit(window: int, r_sigma: int, r_color: int) -> int:
    """The sample kernel's shared memory in bytes; raises ValueError when
    one (cube, mode) window does not fit beside the rest."""
    need = fused_smem_bytes(window, r_sigma, r_color)
    _build.require(need <= MAX_SMEM_BYTES,
                   "fused_sigma_app: window {} at R = {} needs {} bytes of "
                   "shared memory, above the limit of {} bytes a block may "
                   "use", window, r_sigma + r_color, need, MAX_SMEM_BYTES)
    return need


def field_key(spec, streams, basis, app_dim: int, window: int,
              grid_res: int) -> tuple:
    """What the field's checks and descriptor depend on: the spec, the
    static arguments, and every stream tensor's (and the basis's) pointer,
    shape, strides, dtype and device. Any change to one of them is a new
    key, so a cached descriptor never carries a stale pointer."""
    return (tuple(spec), app_dim, window, grid_res,
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                   t.device) for t in (*streams, basis)))


_PLANS: dict = {}


def _field_plan(spec, streams, basis, app_dim: int, window: int,
                grid_res: int) -> tuple:
    """(Rs, Rc, descriptor) of a field, checked and built once per key."""
    key = field_key(spec, streams, basis, app_dim, window, grid_res)
    plan = _PLANS.get(key)
    if plan is None:
        groups = group_streams(spec, streams)
        Rs, Rc = _check_field(spec, groups, basis, app_dim)
        _build.require(app_dim <= MAX_APP_DIM,
                       "fused_sigma_app: app_dim {} > {}", app_dim,
                       MAX_APP_DIM)
        _build.require(2 <= window <= grid_res,
                       "fused_sigma_app: window {} outside [2, {}]", window,
                       grid_res)
        check_smem_fit(window, Rs, Rc)
        plan = (Rs, Rc, _descriptor(groups))
        if len(_PLANS) >= PLAN_CACHE_SIZE:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    return plan


def _check_field(spec, groups, basis, app_dim: int):
    _build.require(fused_supported(spec),
                   "fused_sigma_app: spec must hold 12 dense/bitmap/coo "
                   "factor slices")
    Rs, Rc = spec[0][1], spec[6][1]
    for f, (fs, arrs) in enumerate(groups):
        fmt, rows, ncols = fs
        _build.require(rows == (Rs if f < 6 else Rc),
                       f"fused_sigma_app: slice {f} has {rows} rows")
        if fmt == "dense":
            _build.require_cuda(f"slice {f} dense", arrs[0], torch.float32,
                                (rows, ncols))
        elif fmt == "bitmap":
            words, rank, values = arrs
            nwords = (ncols + 31) // 32
            _build.require_cuda(f"slice {f} words", words, torch.int32,
                                (rows, nwords))
            _build.require_cuda(f"slice {f} rank", rank, torch.int32,
                                (rows, nwords))
            _build.require_cuda(f"slice {f} values", values, torch.float32)
            _build.require(values.dim() == 1 and values.shape[0] > 0,
                           f"slice {f}: values must be a non-empty vector")
        else:
            coords, values = arrs
            _build.require_cuda(f"slice {f} coords", coords, torch.int32)
            _build.require(coords.dim() == 1 and coords.shape[0] > 0,
                           f"slice {f}: coords must be a non-empty vector")
            _build.require_cuda(f"slice {f} values", values, torch.float32,
                                tuple(coords.shape))
    _build.require_cuda("basis", basis, torch.float32, (3 * Rc, app_dim))
    return Rs, Rc


def _descriptor(groups) -> ctypes.Array:
    """12 x 9 int64: fmt, rows, ncols, nwords, n, steps, pointers a, b, c."""
    desc = (ctypes.c_longlong * (12 * 9))()
    for f, ((fmt, rows, ncols), arrs) in enumerate(groups):
        ptrs = [t.data_ptr() for t in arrs] + [0] * (3 - len(arrs))
        n = arrs[-1].shape[0] if fmt != "dense" else 0
        steps = search_steps(n) if fmt == "coo" else 0
        desc[f * 9:(f + 1) * 9] = [FMT_CODE[fmt], rows, ncols,
                                   (ncols + 31) // 32, n, steps, *ptrs]
    return desc


def fused_sigma_app(spec, streams, basis, pts, cube_base, cube_id, *,
                    grid_res: int, scene_bound: float, window: int,
                    app_dim: int):
    """(sigma_raw (N,), feat (N, app_dim)) for `pts` (N, 3) grouped by
    cube, evaluated straight from the encoded factor streams."""
    if pts.device.type == "cpu":
        return fused_sigma_app_ref(spec, streams, basis, pts, cube_base,
                                   cube_id, grid_res=grid_res,
                                   scene_bound=scene_bound, window=window,
                                   app_dim=app_dim)
    Rs, Rc, desc = _field_plan(spec, streams, basis, app_dim, window,
                               grid_res)
    n = pts.shape[0]
    _build.require_cuda("pts", pts, torch.float32, (n, 3))
    _build.require_cuda("cube_id", cube_id, torch.int32, (n,))
    _build.require(cube_base.dim() == 2 and cube_base.shape[1] == 3
                   and cube_base.shape[0] > 0,
                   "fused_sigma_app: cube_base must be (C, 3), C > 0")
    _build.require_cuda("cube_base", cube_base, torch.int32)
    C = cube_base.shape[0]
    pb, lb = window_block_floats(window, Rs + Rc)
    dev = pts.device
    pwin = torch.empty((C * 3 * pb,), dtype=torch.float32, device=dev)
    lwin = torch.empty((C * 3 * lb,), dtype=torch.float32, device=dev)
    sig = torch.empty((n,), dtype=torch.float32, device=dev)
    feat = torch.empty((n, app_dim), dtype=torch.float32, device=dev)
    fn = _build.entry("fused_sigma_app_launch",
                      (_build.P,) + (_build.P,) * 4 + (_build.I32,) * 7
                      + (_build.F32,) + (_build.P,) * 5)
    code = fn(desc, pts.data_ptr(), cube_id.data_ptr(),
              cube_base.data_ptr(), basis.data_ptr(), n, C, grid_res, window,
              Rs, Rc, app_dim, float(scene_bound), pwin.data_ptr(),
              lwin.data_ptr(), sig.data_ptr(), feat.data_ptr(),
              _build.stream_ptr(dev))
    _build.check("fused_sigma_app", code)
    fused_sigma_app.launches += 1
    return sig, feat


fused_sigma_app.launches = 0
