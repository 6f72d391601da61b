"""Qwen2-VL-7B [vlm] — 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (multimodal rotary: temporal/height/width sections 16/24/24 pairs
of head_dim 128), QKV bias, SwiGLU, RMSNorm. The vision frontend (dynamic-
resolution ViT) is a STUB per the assignment: ``input_specs`` supplies
precomputed patch embeddings (B, frontend_len, d_model); the backbone
prepends them to text tokens. [arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    frontend_len=1024,
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
    remat="dots",
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct",
)
