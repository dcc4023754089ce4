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
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build


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


def volume_render(sigma: torch.Tensor, rgb: torch.Tensor, *, delta: float,
                  term_eps: float = 1e-4):
    """(color (R, 3), t_final (R,), nproc 0-dim) for float32 sigma (R, N)
    and rgb (R, N, 3), composited front to back."""
    if _build.all_on_cpu("volume_render", sigma, rgb):
        return volume_render_ref(sigma, rgb, delta, term_eps)
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
    nproc = torch.zeros((), dtype=torch.int64, device=dev)
    fn = _build.entry("volume_render_launch",
                      (_build.P, _build.P, _build.I32, _build.I32,
                       _build.F32, _build.F32, _build.F32, _build.P,
                       _build.P, _build.P, _build.P))
    code = fn(sigma.data_ptr(), rgb.data_ptr(), R, N, float(delta),
              float(term_eps), math.log(term_eps), color.data_ptr(),
              t_final.data_ptr(), nproc.data_ptr(), _build.stream_ptr(dev))
    _build.check("volume_render", code)
    volume_render.launches += 1
    return color, t_final, nproc.to(torch.float32)


volume_render.launches = 0
