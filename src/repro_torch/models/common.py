"""Shared numerics. The port of `repro/models/common.py`, so far only what
the NeRF color MLP uses."""
from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, n_bands: int) -> torch.Tensor:
    """NeRF-style PE: concat(x, sin/cos(2^i x))."""
    outs = [x]
    for i in range(n_bands):
        outs.append(torch.sin((2.0 ** i) * x))
        outs.append(torch.cos((2.0 ** i) * x))
    return torch.cat(outs, dim=-1)
