"""Config dataclasses shared by every architecture and the launchers: the
port's own copy of `repro/configs/base.py` (same fields, defaults,
properties and counts), so the port imports nothing of the JAX package and
a config crosses between the two with `ModelConfig(**dataclasses.asdict(c))`.

Every assigned architecture is a `ModelConfig`; input shapes are
`ShapeConfig`s. Both are frozen (hashable).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def mib_to_bytes(mb: Optional[float]) -> Optional[int]:
    """CLI-facing memory budgets (`--max-resident-mb` style knobs) -> byte
    counts for config fields like `NeRFConfig.max_resident_bytes`.
    None/0/negative mean "unlimited" and map to None."""
    if not mb or mb <= 0:
        return None
    return int(mb * 1024 * 1024)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- attention ---
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    attention: str = "gqa"          # gqa | mla | none
    rope_theta: float = 1e4

    # --- MLA (DeepSeek-V3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0         # leading dense layers (DeepSeek-V3: 3)
    moe_dispatch: str = "auto"      # bitmap | coo | auto (paper's 80% rule)
    capacity_factor: float = 1.25

    # --- encoder-decoder ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_memory_len: int = 4096      # encoder memory length for decode shapes

    # --- modality frontend (stub: precomputed embeddings via input_specs) ---
    frontend: Optional[str] = None  # vision | audio
    n_frontend_tokens: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0             # zamba2: shared attn block every k blocks

    # --- misc architecture ---
    mtp: bool = False               # DeepSeek multi-token-prediction head
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # --- runtime knobs (defaults = paper-faithful baseline; hillclimb flips) ---
    dtype: str = "bfloat16"
    remat_policy: str = "full"      # none | full | dots
    attention_impl: str = "naive"   # naive | chunked
    seq_shard_attn: bool = False    # sequence-parallel attention (qwen1.5)
    window: int = 0                 # sliding window for hybrid long-context
    scan_layers: bool = True        # reference: lax.scan over the stack
    # --- further runtime knobs of the reference ---
    ssm_impl: str = "scan"          # scan | chunked (chunk-parallel SSD)
    grad_accum: int = 1             # microbatch accumulation (activation mem)
    constrain_grads: bool = False   # force reduce-scatter-shaped grad comm
    moe_out_shard: bool = False     # constrain MoE combine output sharding

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        # pad so the vocab axis shards evenly over a 16-way model axis
        return round_up(self.vocab, 16)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def dispatch_sparsity(self) -> float:
        """Sparsity of the token->expert assignment matrix (paper Fig.5 analogue)."""
        if not self.is_moe:
            return 0.0
        return 1.0 - self.top_k / self.n_experts

    def resolved_dispatch(self) -> str:
        """RT-NeRF hybrid-encoding rule (80% threshold) applied to MoE routing."""
        if self.moe_dispatch != "auto":
            return self.moe_dispatch
        return "coo" if self.dispatch_sparsity >= 0.80 else "bitmap"

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count N (analytic; matches init shapes)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        V = self.vocab_padded
        total = V * d                               # embedding
        if not self.tie_embeddings:
            total += V * d                          # lm head
        n_layers = self.n_layers
        enc_layers = self.n_enc_layers if self.enc_dec else 0

        def attn_params() -> int:
            if self.attention == "mla":
                p = d * self.q_lora_rank
                p += self.q_lora_rank * n_q * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                p += self.kv_lora_rank * n_q * (self.qk_nope_head_dim + self.v_head_dim)
                p += n_q * self.v_head_dim * d
                p += self.q_lora_rank + self.kv_lora_rank   # lora norms
                return p
            p = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            if self.qkv_bias:
                p += (n_q + 2 * n_kv) * hd
            return p

        def dense_ff_params(dff: int) -> int:
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            return mult * d * dff

        def moe_ff_params() -> int:
            dff = self.d_ff_expert or self.d_ff
            per_exp = dense_ff_params(dff)
            p = self.n_experts * per_exp + d * self.n_experts   # router
            p += self.n_shared_experts * per_exp
            return p

        def mamba_params() -> int:
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            p = d * (2 * d_in + 2 * self.ssm_state + nh)        # in_proj(x,z) + B,C + dt
            p += self.ssm_conv * (d_in + 2 * self.ssm_state)    # conv over x,B,C
            p += nh + nh                                        # A_log, D
            p += d_in * d                                       # out_proj
            p += d_in                                           # gated norm
            return p

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,w projections + lora for data-dependent decay + out
            p = 6 * d * d + 2 * d * 64 + 5 * d  # approx lora rank 64, token-shift mixes
            p += 2 * d * self.d_ff + d * self.d_ff  # channel mix (r,k,v)
            return p

        if self.family == "ssm":     # rwkv6
            total += n_layers * (rwkv_params() + 2 * d)
            return total
        if self.family == "hybrid":  # zamba2: n_layers mamba blocks + 1 shared attn block
            total += n_layers * (mamba_params() + d)
            n_shared = 1
            total += n_shared * (attn_params() + dense_ff_params(self.d_ff) + 2 * d)
            return total

        per_layer_attn = attn_params() + 2 * d      # + norms
        for li in range(n_layers + enc_layers):
            total += per_layer_attn
            is_dec_moe = self.is_moe and (li >= enc_layers) and \
                ((li - enc_layers) >= self.n_dense_layers)
            if is_dec_moe:
                total += moe_ff_params()
            else:
                total += dense_ff_params(self.d_ff)
            if self.enc_dec and li >= enc_layers:
                total += attn_params() + d          # cross-attention
        if self.mtp:
            total += attn_params() + dense_ff_params(self.d_ff) + 4 * d + 2 * d * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top_k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        dff = self.d_ff_expert or self.d_ff
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        per_exp = mult * self.d_model * dff
        n_moe_layers = self.n_layers - self.n_dense_layers
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_exp
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four assigned LM shapes (see prompt block; identical for all 10 archs).
LM_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def long_context_ok(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM / hybrid)."""
    return cfg.family in ("ssm", "hybrid")


def shapes_for(cfg: ModelConfig):
    """The (shape, skip_reason) list for one arch — 4 cells each."""
    out = []
    for s in LM_SHAPES.values():
        skip = None
        if s.name == "long_500k" and not long_context_ok(cfg):
            skip = "full-attention arch: 500k KV cache is quadratic-regime; skipped per spec"
        out.append((s, skip))
    return out
