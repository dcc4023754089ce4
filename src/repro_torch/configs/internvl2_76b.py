"""InternVL2-76B [arXiv:2404.16821; unverified] — InternViT frontend + LLM backbone.

The vision frontend is a STUB per spec: ``input_specs()`` provides precomputed
patch embeddings (n_frontend_tokens, d_model) prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    frontend="vision",
    n_frontend_tokens=256,      # patch embeddings per image (pixel-unshuffled)
    rope_theta=5e5,
)
