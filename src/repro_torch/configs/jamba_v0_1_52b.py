"""Jamba-v0.1 52B [hybrid] — 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave.

Period-8 block (paper §3.1: one attention per 8 layers, MoE every other
layer): ('md','me','md','me','ad','me','md','me'). Adaptation note: we use
the Mamba-2/SSD mixer (TPU-friendly chunked dual form) in place of
Jamba's Mamba-1 — same state-space recurrence family, MXU-alignable
(DESIGN.md §2). Hybrid ⇒ long_500k runs (only 4 of 32 layers hold KV).
[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  capacity_factor=1.25),
    ssm=SSMConfig(d_state=128, headdim=64, ngroups=1, conv_kernel=4,
                  expand=2, chunk=256),
    layer_pattern=("md", "me", "md", "me", "ad", "me", "md", "me"),
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
    remat="dots",
    long_context_ok=True,
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
)
