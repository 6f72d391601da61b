"""Qwen1.5-0.5B [dense] — 24L d=1024 16H (kv=16, i.e. MHA) d_ff=2816
vocab=151936. QKV bias, RoPE (theta 1e6), SwiGLU, RMSNorm, tied embeddings.
[hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    remat="none",
    source="hf:Qwen/Qwen1.5-0.5B",
)
