"""StarCoder2-7B [dense] — 32L d=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

GQA, RoPE, LayerNorm + GELU MLP, attention/MLP biases (use_bias=True in the
released model; we keep QKV bias). [arXiv:2402.19173; hf:bigcode/starcoder2-7b]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e5,
    tie_embeddings=False,
    norm="layernorm",
    act="gelu",
    remat="dots",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
)
