"""Qwen2-1.5B [dense] — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA with QKV bias, RoPE (theta 1e6), SwiGLU, RMSNorm, tied embeddings.
[arXiv:2407.10671; hf:Qwen/Qwen2-1.5B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    remat="dots",
    source="arXiv:2407.10671; hf:Qwen/Qwen2-1.5B",
)
