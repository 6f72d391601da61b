"""Phi-4-mini 3.8B [dense] — 32L d=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

RoPE, SwiGLU, GQA, RMSNorm, tied embeddings.
[arXiv:2412.08905; hf:microsoft/Phi-4-mini-instruct]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    head_dim=128,
    qkv_bias=False,
    rope_theta=1e4,
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    remat="dots",
    source="arXiv:2412.08905; hf:microsoft/Phi-4-mini-instruct",
)
