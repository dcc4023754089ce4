"""Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base; hf] — GQA dense."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,                # padded to 49168 for the 16-way model axis
    rope_theta=1e4,
)
