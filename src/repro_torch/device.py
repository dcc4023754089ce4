"""Device choice for the port's entry points.

Every entry point takes `device=`. Left as None it means the card: the
port never falls back to the CPU on its own, because a CPU number must
never pass for a device number. The CPU runs only when a caller names it
(the parity tests do).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None -> "cuda", which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the "
                "CPU (plain PyTorch versions of the kernels)")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev

