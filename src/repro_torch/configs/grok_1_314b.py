"""Grok-1 314B [hf:xai-org/grok-1; unverified] — 8 experts top-2 MoE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    d_ff_expert=32768,
    n_dense_layers=0,
    act="geglu",            # gated GELU MLP (mult-3 param shape)
    # the 80% rule would pick bitmap dispatch at grok's 75% routing
    # sparsity; the config overrides it with sort/gather (COO) dispatch
    moe_dispatch="coo",
)
