"""Deterministic synthetic token pipeline for LM training: the port of
`repro/data/tokens.py`.

Tokens come from a counter-based generator keyed by (seed, step, shard):
numpy's Philox with the three packed into its 128-bit key, drawn on the
CPU and moved to the stream's device. So

  * a batch is a pure function of (seed, step, shard): a restored run
    replays no batch and skips none, in any process;
  * shards draw from disjoint keys, so data-parallel hosts need no
    coordination;
  * the card and the CPU get the same numbers.

The layout is the reference's; the numbers are not (it draws with
`jax.random`'s threefry): parity tests carry its batches across.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import TensorSpec

_WORD = 1 << 32


def philox(seed: int, step: int, shard: int) -> np.random.Generator:
    """The generator of (seed, step, shard): Philox keyed by seed (64 bits)
    and step and shard (32 bits each), each key a stream of its own."""
    if not (0 <= seed < _WORD * _WORD and 0 <= step < _WORD
            and 0 <= shard < _WORD):
        raise ValueError(f"seed {seed}, step {step}, shard {shard}: out of "
                         f"the key's range (seed < 2**64, step and shard "
                         f"< 2**32, none negative)")
    key = np.array([seed, step * _WORD + shard], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def _n_front(cfg: ModelConfig) -> int:
    return cfg.n_frontend_tokens if cfg.frontend == "vision" else 0


@dataclasses.dataclass(frozen=True)
class TokenStream:
    cfg: ModelConfig
    shape: ShapeConfig
    n_shards: int = 1
    shard: int = 0
    seed: int = 0
    device: DeviceLike = None        # None: the card

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The global batch for `step` (this shard's slice when n_shards >
        1) on the stream's device: tokens (B, S - n_front) int32, for a
        vision arch frontend (B, n_front, D) bf16, for an enc-dec arch
        enc_frames (B, S, D) bf16, then labels (B, S) int32 and loss_mask
        (B, S) float32, both zero over the frontend's positions."""
        dev = resolve_device(self.device)
        b = self.shape.global_batch // self.n_shards
        s = self.shape.seq_len
        cfg = self.cfg
        rng = philox(self.seed, step, self.shard)
        n_front = _n_front(cfg)
        n_text = s - n_front
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n_text + 1),
                                             dtype=np.int32))
        out: Dict[str, torch.Tensor] = {"tokens": toks[:, :-1]}
        labels = toks[:, 1:]
        mask = torch.ones((b, n_text), dtype=torch.float32)
        if n_front:
            out["frontend"] = torch.from_numpy(rng.standard_normal(
                (b, n_front, cfg.d_model), dtype=np.float32)).to(
                    torch.bfloat16)
            labels = torch.cat([torch.zeros((b, n_front), dtype=torch.int32),
                                labels], dim=1)
            mask = torch.cat([torch.zeros((b, n_front), dtype=torch.float32),
                              mask], dim=1)
        if cfg.enc_dec:
            out["enc_frames"] = torch.from_numpy(rng.standard_normal(
                (b, s, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
        out["labels"] = labels
        out["loss_mask"] = mask
        return {k: v.contiguous().to(dev) for k, v in out.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """TensorSpec stand-ins for one global batch (no labels or mask unless
    the shape trains)."""
    b, s = shape.global_batch, shape.seq_len
    n_front = _n_front(cfg)
    specs: Dict[str, TensorSpec] = {
        "tokens": TensorSpec((b, s - n_front), torch.int32),
        "labels": TensorSpec((b, s), torch.int32),
        "loss_mask": TensorSpec((b, s), torch.float32),
    }
    if n_front:
        specs["frontend"] = TensorSpec((b, n_front, cfg.d_model),
                                       torch.bfloat16)
    if cfg.enc_dec:
        specs["enc_frames"] = TensorSpec((b, s, cfg.d_model), torch.bfloat16)
    if shape.kind != "train":
        specs.pop("labels")
        specs.pop("loss_mask")
    return specs


def input_logical(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, str]:
    """Logical axes of the batch inputs ('|'-joined, as in the reference)."""
    log = {"tokens": "batch|seq", "labels": "batch|seq",
           "loss_mask": "batch|seq"}
    if cfg.frontend == "vision":
        log["frontend"] = "batch|seq|"
    if cfg.enc_dec:
        log["enc_frames"] = "batch|seq|"
    if shape.kind != "train":
        log.pop("labels")
        log.pop("loss_mask")
    return log
