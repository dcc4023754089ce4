"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 trunk + shared attention blocks.

81 Mamba2 blocks; ONE weight-shared attention+MLP block is applied every 6
Mamba blocks (per-invocation LoRA of the original is omitted).
For long_500k the shared attention uses a 4096-token sliding window so the
arch stays sub-quadratic (documented deviation).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,                # mamba2 blocks
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    window=4096,
)
