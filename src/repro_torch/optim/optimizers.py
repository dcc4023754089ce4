"""Optimizers as pairs of pure functions over dicts of tensors. The port
of the part of `repro/optim/optimizers.py` that NeRF training uses:
`Optimizer` and the exact `adamw` update.

Not `torch.optim.AdamW`: the same update in exact arithmetic, but it
divides sqrt(v) by sqrt(bc2) rather than taking sqrt(v / bc2), and decays
the weights in a multiply of their own, so its floats differ in the last
bits. Here every operation is the reference's, in float32:
the bias corrections 1 - b ** step are computed in float32, constants
enter as float32 0-dim tensors (a CUDA tensor divided by a Python scalar
is a product with its reciprocal), and the root goes through
`core.rendering.sqrt_rn` (PyTorch's vectorised CPU sqrt is not correctly
rounded; XLA's and the card's are).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.rendering import sqrt_rn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Dict[str, torch.Tensor]], Any]
    update: Callable[..., Tuple[Dict[str, torch.Tensor], Any]]
    name: str = "opt"


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, wd: float = 0.0) -> Optimizer:
    """AdamW over a dict of tensors: `init(params)` -> state {"step" (int32
    0-dim), "m", "v" (float32 like params)}; `update(grads, state,
    params)` -> (new params, new state), nothing updated in place."""
    def init(params):
        some = next(iter(params.values()))
        return {
            "step": torch.zeros((), dtype=torch.int32, device=some.device),
            "m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                  for k, p in params.items()},
        }

    def update(grads, state, params):
        step = state["step"] + 1
        dev = step.device

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)
        lr_t = f32(lr)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(f32(b1), stepf)
        bc2 = 1.0 - torch.pow(f32(b2), stepf)
        c_b1, c_b2, c_eps = f32(b1), f32(b2), f32(eps)
        c_1b1, c_1b2 = f32(1 - b1), f32(1 - b2)
        p_out, m_out, v_out = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m2 = c_b1 * state["m"][k] + c_1b1 * g
            v2 = c_b2 * state["v"][k] + c_1b2 * g * g
            u = (m2 / bc1) / (sqrt_rn(v2 / bc2) + c_eps)
            if wd:
                u = u + f32(wd) * p.to(torch.float32)
            p_out[k] = (p.to(torch.float32) - lr_t * u).to(p.dtype)
            m_out[k], v_out[k] = m2, v2
        return p_out, {"step": step, "m": m_out, "v": v_out}

    return Optimizer(init, update, "adamw")
