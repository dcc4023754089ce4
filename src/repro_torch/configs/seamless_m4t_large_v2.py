"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf] — encoder-decoder, multimodal.

Audio frontend is a STUB per spec: ``input_specs()`` provides precomputed
frame embeddings feeding the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                # decoder layers
    n_enc_layers=24,            # encoder layers
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    enc_memory_len=4096,
    frontend="audio",
    act="gelu",
)
