"""Mamba2-780m [ssm] — 48L d=1536 attention-free, vocab=50280,
ssm_state=128 (SSD, state-space duality). d_inner = 2·d = 3072,
headdim 64 → 48 SSD heads, depthwise conv k=4.

Attention-free ⇒ the long_500k decode shape runs (O(1) recurrent state).
[arXiv:2405.21060; hf:state-spaces/mamba2-780m]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,          # unused by 'm-' blocks; kept for schema validity
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    ssm=SSMConfig(d_state=128, headdim=64, ngroups=1, conv_kernel=4,
                  expand=2, chunk=256),
    layer_pattern=("m-",),
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    remat="none",
    long_context_ok=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)
