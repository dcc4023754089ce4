"""DeepSeek-V3 671B [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed top-8, MTP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense d_ff for the 3 leading dense layers
    vocab=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    d_ff_expert=2048,           # per-expert d_ff (spec: d_ff=2048, MoE 256e top-8)
    n_dense_layers=3,
    mtp=True,
    rope_theta=1e4,
)
