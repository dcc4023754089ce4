"""Learning-rate schedules as step -> multiplier functions: the port of
`repro/optim/schedule.py`. `step` is an integer 0-dim tensor (the
optimizer's counter); every constant and divisor enters as a float32 0-dim
tensor on its device, so the card divides as the reference does (PyTorch
divides a CUDA tensor by a Python scalar through its reciprocal)."""
from __future__ import annotations

import math

import torch


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def linear_warmup(warmup_steps: int):
    def fn(step):
        s = step.to(torch.float32)
        return torch.minimum(_f32(1.0, s.device),
                             s / _f32(max(warmup_steps, 1), s.device))
    return fn


def cosine_schedule(warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """Linear warm-up over `warmup_steps`, then a cosine from 1 down to
    `final_frac` at `total_steps`."""
    def fn(step):
        s = step.to(torch.float32)
        dev = s.device
        warm = torch.minimum(_f32(1.0, dev),
                             s / _f32(max(warmup_steps, 1), dev))
        prog = torch.clamp((s - warmup_steps) / _f32(
            max(total_steps - warmup_steps, 1), dev), 0.0, 1.0)
        cos = _f32(final_frac, dev) + _f32((1 - final_frac) * 0.5, dev) * (
            1 + torch.cos(_f32(math.pi, dev) * prog))
        return warm * cos
    return fn
