"""RWKV-6 (Finch) 1.6B [arXiv:2404.05892; unverified] — attn-free, data-dependent decay."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                 # wkv heads of size 64
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    head_dim=64,
    attention="none",
)
