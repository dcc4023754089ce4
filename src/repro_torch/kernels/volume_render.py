"""Volume rendering (paper Eq. 1) front to back with early ray
termination. The port of `repro/kernels/volume_render.py`.

A sample is alive while the transmittance before it is above `term_eps`;
dead samples get tau = 0, so they add nothing to the color and leave the
transmittance as it was. `nproc` counts the alive samples: the points
the ASIC actually processes.

`volume_render` launches the CUDA kernel (`csrc/volume_render.cu`) on
CUDA tensors and runs the plain PyTorch version `volume_render_ref` on
CPU tensors; anything else raises. `volume_render.launches` counts kernel
launches.

The kernel gives a ray one warp and takes its samples in segments of
`SEGMENT`, each lane a run of `RUN` consecutive samples: all of a
segment's sigma first, then rgb only up to the segment's last alive
sample. nproc comes out of the same kernel: each block adds its count to
counters that belong to the call (zeroed by a one-block kernel that the
main kernel runs under), and the last block to finish writes the total.
`vector_loads` says whether the launch takes 16-byte copies;
`read_bytes` predicts the bytes that the kernel reads for given per-ray
alive counts, and `volume_render_read` returns the bytes the kernel
itself counted.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# csrc/volume_render.cu's kRaysPerBlock, kRun and kSegment
RAYS_PER_BLOCK = 4
RUN = 8                       # consecutive samples a lane
SEGMENT = 32 * RUN            # samples a warp takes at once


def volume_render_ref(sigma: torch.Tensor, rgb: torch.Tensor, delta: float,
                      term_eps: float):
    """Plain version, the reference's `ref.volume_render_ref`: sigma (R, N),
    rgb (R, N, 3) -> (color (R, 3), t_final (R,), nproc 0-dim), all
    float32."""
    tau = sigma.to(torch.float32) * delta
    cum = torch.cumsum(tau, dim=-1)
    alive = torch.exp(-(cum - tau)) > term_eps
    tau = torch.where(alive, tau, torch.zeros_like(tau))
    cum = torch.cumsum(tau, dim=-1)
    w = torch.exp(-(cum - tau)) * (1.0 - torch.exp(-tau))
    color = torch.einsum("rn,rnc->rc", w, rgb.to(torch.float32))
    return color, torch.exp(-cum[:, -1]), alive.to(torch.float32).sum()


def vector_loads(sigma: torch.Tensor, rgb: torch.Tensor) -> bool:
    """True where the kernel reads sigma and rgb as 16-byte vectors: N a
    multiple of 4 (every row then starts 16-byte aligned) and both
    tensors' data 16-byte aligned. Otherwise it fills the same stages by
    4-byte copies."""
    return (sigma.shape[-1] % 4 == 0 and sigma.data_ptr() % 16 == 0
            and rgb.data_ptr() % 16 == 0)


def read_bytes(alive: torch.Tensor, n: int, vec: bool = True) -> int:
    """Bytes the kernel should read for rays with `alive` (R,) alive
    samples each (a prefix of the ray, as for sigma >= 0) of `n`: sigma
    for every segment the warp enters, rgb for each segment up to its last
    alive sample (whole 16-byte vectors with `vec`), and nothing behind.
    The prediction that `volume_render_read`'s count is held against."""
    a = alive.to(torch.int64).cpu()[:, None]
    bases = torch.arange(0, n, SEGMENT)[None, :]
    entered = (bases < a) | (bases == 0)   # alive at the segment's start
    sigma_b = 4 * int((torch.clamp(n - bases, max=SEGMENT) * entered).sum())
    floats = 3 * torch.clamp(a - bases, 0, SEGMENT)
    rgb_f = 4 * ((floats + 3) // 4) if vec else floats
    return sigma_b + 4 * int(rgb_f.sum())


def _launch(sigma: torch.Tensor, rgb: torch.Tensor, delta: float,
            term_eps: float, count: bool) -> tuple:
    """(color, t_final, nproc, counters) from one launch of the kernel;
    counters[2] is the bytes read where `count`."""
    _build.require(sigma.dim() == 2, "volume_render: sigma must be (R, N)")
    R, N = sigma.shape
    _build.require_cuda("volume_render sigma", sigma, torch.float32)
    _build.require_cuda("volume_render rgb", rgb, torch.float32, (R, N, 3))
    _build.require(rgb.device == sigma.device,
                   "volume_render: sigma and rgb on different devices")
    _build.require(term_eps > 0.0, "volume_render: term_eps must be > 0")
    dev = sigma.device
    color = torch.empty((R, 3), dtype=torch.float32, device=dev)
    t_final = torch.empty((R,), dtype=torch.float32, device=dev)
    # the alive count, the blocks done and the bytes read: this call's own
    counters = torch.empty((3,), dtype=torch.int64, device=dev)
    if R == 0:
        return color, t_final, torch.zeros((), device=dev), counters.zero_()
    nproc = torch.empty((), dtype=torch.float32, device=dev)
    fn = _build.entry("volume_render_launch",
                      (_build.P, _build.P, _build.I32, _build.I32,
                       _build.F32, _build.F32, _build.P, _build.P, _build.P,
                       _build.P, _build.I32, _build.I32, _build.P))
    code = fn(sigma.data_ptr(), rgb.data_ptr(), R, N, float(delta),
              math.log(term_eps), color.data_ptr(), t_final.data_ptr(),
              nproc.data_ptr(), counters.data_ptr(),
              int(vector_loads(sigma, rgb)), int(count),
              _build.stream_ptr(dev))
    _build.check("volume_render", code)
    volume_render.launches += 1
    return color, t_final, nproc, counters


def volume_render(sigma: torch.Tensor, rgb: torch.Tensor, *, delta: float,
                  term_eps: float = 1e-4):
    """(color (R, 3), t_final (R,), nproc 0-dim) for float32 sigma (R, N)
    and rgb (R, N, 3), composited front to back."""
    if _build.all_on_cpu("volume_render", sigma, rgb):
        return volume_render_ref(sigma, rgb, delta, term_eps)
    return _launch(sigma, rgb, delta, term_eps, False)[:3]


def volume_render_read(sigma: torch.Tensor, rgb: torch.Tensor, *,
                       delta: float, term_eps: float = 1e-4) -> tuple:
    """(volume_render's result, bytes of sigma and rgb that the kernel's
    copies read from device memory, as the kernel counts them), from one
    launch on CUDA tensors; waits for the launch to finish."""
    _build.require(sigma.device.type == "cuda",
                   "volume_render_read: the count comes from the kernel, "
                   "which runs on CUDA tensors")
    *out, counters = _launch(sigma, rgb, delta, term_eps, True)
    return tuple(out), int(counters[2])


volume_render.launches = 0
