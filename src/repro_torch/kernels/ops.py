"""Dispatch for the kernel layer. The port of `repro/kernels/ops.py`.

The device of the tensors decides: the CUDA kernels run on CUDA tensors,
their plain PyTorch versions on CPU tensors (inside each wrapper). A
`force` string overrides the default as in the reference:

  * "ref" / "fused_ref"  the plain version, on whatever device;
  * "kernel" / "pallas" / "fused"  the kernel wrapper (which still runs
    the plain version for CPU tensors);
  * "per-op"  (fused path only) the per-op gather composition in
    core/tensorf.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bitmap_decode, coo_gather as coo_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import fused_sample
from repro_torch.kernels import volume_render as vr_mod

_REF = ("ref", "fused_ref")
_KERNEL = ("kernel", "pallas", "fused")


def bitmap_matmul(words, rowptr, values, x, *, cols: int,
                  force: Optional[str] = None) -> torch.Tensor:
    """y = decode(words, rowptr, values) @ x, in x's dtype."""
    if force in _REF:
        return bitmap_decode.bitmap_matmul_ref(words, rowptr, values, x,
                                               cols)
    return bitmap_decode.bitmap_matmul(words, rowptr, values, x, cols=cols)


def bitmap_gather(words, rowptr, values, queries, *, cols: int,
                  rank: Optional[torch.Tensor] = None,
                  force: Optional[str] = None) -> torch.Tensor:
    if force in _REF:
        return bitmap_decode.bitmap_gather_ref(words, rowptr, values,
                                               queries, cols, rank=rank)
    return bitmap_decode.bitmap_gather(words, rowptr, values, queries,
                                       cols=cols, rank=rank)


def coo_gather(coords, values, queries, *,
               force: Optional[str] = None) -> torch.Tensor:
    if force in _REF:
        return coo_mod.coo_gather_ref(coords, values, queries)
    return coo_mod.coo_gather(coords, values, queries)


def fused_mode(force: Optional[str] = None,
               device: Optional[torch.device] = None) -> str:
    """Dispatch mode of the fused decode-sample-accumulate path: "fused"
    (the kernel: CUDA by default), "fused_ref" (the plain version: CPU by
    default), or what `force` names ("per-op" makes core/tensorf use the
    per-op gather composition)."""
    if force in _KERNEL:
        return "fused"
    if force in _REF:
        return "fused_ref"
    if force:
        return force
    dev = torch.device(device) if device is not None else None
    return "fused" if dev is not None and dev.type == "cuda" else "fused_ref"


fused_supported = fused_sample.fused_supported


def fused_sigma_app(spec, streams, basis, pts, cube_base, cube_id, *,
                    grid_res: int, scene_bound: float, window: int,
                    app_dim: int, force: Optional[str] = None):
    """(sigma_raw, feat) straight from the encoded factor streams."""
    kw = dict(grid_res=grid_res, scene_bound=scene_bound, window=window,
              app_dim=app_dim)
    if fused_mode(force, pts.device) == "fused_ref":
        return fused_sample.fused_sigma_app_ref(spec, streams, basis, pts,
                                                cube_base, cube_id, **kw)
    return fused_sample.fused_sigma_app(spec, streams, basis, pts,
                                        cube_base, cube_id, **kw)


def volume_render(sigma, rgb, *, delta: float, term_eps: float = 1e-4,
                  force: Optional[str] = None):
    """(color (R, 3), t_final (R,), nproc) of Eq. 1 front to back."""
    if force in _REF:
        return vr_mod.volume_render_ref(sigma, rgb, delta, term_eps)
    return vr_mod.volume_render(sigma, rgb, delta=delta, term_eps=term_eps)


def flash_attention(q, k, v, *, causal: bool = True,
                    force: Optional[str] = None) -> torch.Tensor:
    """Forward attention (B, H, S, D), causal from the top left. The CUDA
    kernels take float32 or bfloat16 and a head dim D <= 128 only, and
    raise ValueError on anything else; the plain version (CPU tensors, or
    `force="ref"`) takes any dtype and head dim."""
    if force in _REF:
        return flash_mod.flash_attention_ref(q, k, v, causal=causal)
    return flash_mod.flash_attention(q, k, v, causal=causal)
