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



def common_device(*args, what: str = "arguments") -> torch.device:
    """The one device of `args` (tensors and torch.devices; None is
    skipped). An entry point takes its device from its tensor arguments;
    a mix of devices raises instead of copying one side over."""
    devs = []
    for a in args:
        if a is None:
            continue
        d = a.device if isinstance(a, torch.Tensor) else torch.device(a)
        if d not in devs:
            devs.append(d)
    if len(devs) != 1:
        raise ValueError(f"{what} must lie on one device, got "
                         f"{[str(d) for d in devs] or 'none'}")
    return devs[0]
