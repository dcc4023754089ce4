"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B; hf] — QKV bias, 40 heads (MHA).

40 heads % 16-way model axis != 0 -> this arch uses sequence-parallel
attention sharding instead of head sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    seq_shard_attn=True,
    rope_theta=1e6,
)
