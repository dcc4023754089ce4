"""--arch <id> registry: the port's copy of `repro/configs/registry.py`.
IDs use the public names verbatim."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
    deepseek_v3_671b,
    grok_1_314b,
    internvl2_76b,
    seamless_m4t_large_v2,
    granite_3_8b,
    qwen1_5_32b,
    llama3_2_1b,
    granite_34b,
    zamba2_7b,
    rwkv6_1_6b,
    rtnerf,
)
from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeConfig,
                                      shapes_for)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        deepseek_v3_671b,
        grok_1_314b,
        internvl2_76b,
        seamless_m4t_large_v2,
        granite_3_8b,
        qwen1_5_32b,
        llama3_2_1b,
        granite_34b,
        zamba2_7b,
        rwkv6_1_6b,
    )
}

NERF = rtnerf.CONFIG


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)} + "
                       f"['rtnerf']")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return LM_SHAPES[name]


def all_cells():
    """All 40 (arch, shape, skip_reason) cells, in registry order."""
    cells = []
    for cfg in ARCHS.values():
        for shape, skip in shapes_for(cfg):
            cells.append((cfg, shape, skip))
    return cells


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU tests and smoke runs."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=128,
        vocab=256,
        head_dim=16 if cfg.head_dim else 0,
    )
    if cfg.attention == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    if cfg.is_moe:
        kw.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                  d_ff_expert=64, n_dense_layers=min(cfg.n_dense_layers, 1))
    if cfg.enc_dec:
        kw.update(n_enc_layers=2, enc_memory_len=32)
    if cfg.frontend:
        kw.update(n_frontend_tokens=8)
    if cfg.family in ("hybrid", "ssm"):
        kw.update(ssm_state=16, ssm_head_dim=16)
        if cfg.attn_every:
            kw.update(attn_every=2, n_layers=5)
    return dataclasses.replace(cfg, **kw)
