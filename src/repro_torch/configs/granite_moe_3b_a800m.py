"""Granite-3.0-3B-A800M MoE [moe] — 32L d=1536 24H (GQA kv=8)
expert d_ff=512, vocab=49155, 40 experts top-8.

Fine-grained MoE (many small experts), SwiGLU, RMSNorm, tied embeddings.
[hf:ibm-granite/granite-3.0-3b-a800m-base; config per assignment]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                  capacity_factor=1.25),
    layer_pattern=("ae",),
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    remat="none",
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)
