"""Mixtral-8x22B [moe] — 56L d=6144 48H (GQA kv=8) expert d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention (per assignment).

SWA ⇒ decode KV caches are rolling rings capped at the 4096-token window,
which is what makes the long_500k decode shape runnable (sub-quadratic,
O(window) memory). [arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25),
    layer_pattern=("ae",),
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
    remat="dots",
    long_context_ok=True,
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1",
)
