"""SeamlessM4T-medium [audio] — enc-dec, 12L(+12L) d=1024 16H (kv=16)
d_ff=4096 vocab=256206.

Encoder-decoder transformer backbone; the speech frontend (w2v-BERT conv
feature extractor) is a STUB per the assignment — ``input_specs`` supplies
precomputed frame embeddings to the encoder. Adaptation note: RoPE replaces
the original relative/sinusoidal positions (our unified positional layer);
LayerNorm + GELU as released. Decode shapes lower the cached decoder step
with cross-attention over encoder memory (enc-dec, NOT encoder-only, so
decode is not skipped). [arXiv:2308.11596; hf:facebook/seamless-m4t-medium]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,           # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e4,
    frontend="audio",
    frontend_len=1024,
    tie_embeddings=True,
    norm="layernorm",
    act="gelu",
    remat="none",
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-medium",
)
