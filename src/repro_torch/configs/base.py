"""Model/architecture configuration schema.

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``repro_torch.configs.registry`` maps ``--arch``
ids to them. ``reduced(cfg)`` shrinks any config to a CPU-runnable smoke
variant of the same family. The schema and the config modules are the JAX
package's (``repro.configs``), kept field for field so both packages read
the same configs. ``remat`` steers training's rematerialisation here as
there (``models/blocks.py``), ``moe_groups`` the MoE dispatch groups
(``models/moe.py``), and ``attn_block_k``, ``act_dp`` and ``act_sp`` the
streaming attention layout (``models/attention.py``: the streaming plain
version on the CPU, and on a mesh q, k and v pinned batch-sharded with
every head, q's rows over ``act_sp``); ``scan_layers`` steers only the
JAX package's lowering and is carried and ignored here. ``SHAPES`` and
``input_specs`` name the four shape cells of the JAX package's dry run;
the specs are tensors on the ``meta`` device, which allocate nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "ShapeSpec", "SHAPES",
           "shape_spec", "input_specs", "reduced", "param_count", "scale_layers"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    num_shared: int = 0          # shared (always-on) experts
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    ngroups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | vlm | audio | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: Optional[Tuple[int, int, int]] = None   # M-RoPE (t,h,w)
    sliding_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # per-period layer pattern for hybrids: "a"=attention block, "m"=mamba
    layer_pattern: Optional[Tuple[str, ...]] = None
    encoder_layers: int = 0          # >0 => encoder-decoder
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu | geglu
    frontend: Optional[str] = None   # None | vision | audio (stubbed)
    frontend_len: int = 256          # prefix length of precomputed embeddings
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "none"              # none | dots | full (training)
    long_context_ok: bool = False    # sub-quadratic path exists (long_500k)
    source: str = ""                 # provenance note
    scan_layers: bool = True         # JAX package only (lax.scan vs loop)
    # streaming attention (JAX's dry run ``--attn-block``): the KV block of
    # the streaming plain version on the CPU (0: dense; the kernel streams
    # on the card whatever it is)
    attn_block_k: int = 0
    # on a mesh: attention's q/k/v batch-sharded over these axes with every
    # head on every rank (JAX's _pin_dp; () keeps the local-heads layout)
    act_dp: Tuple[str, ...] = ()
    # and q's sequence over this axis (context parallelism), K/V replicated
    act_sp: Optional[str] = None
    moe_groups: int = 0              # MoE dispatch groups (per-group capacity)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.layer_pattern or ("a",)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not "
                             f"divisible by n_kv_heads {self.n_kv_heads}")
        if self.layer_pattern and self.n_layers % len(self.layer_pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of pattern {self.layer_pattern}")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_spec(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    """A cell of ``SHAPES`` by name, or a ``ShapeSpec`` as it is (a run
    at a chosen size)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg: ModelConfig, shape: Union[str, ShapeSpec]
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins on the ``meta`` device for every model input of this
    shape cell: the token batch (+ stub frontend embeddings for
    [vlm]/[audio]) for train/prefill, one new token and its position per
    sequence for decode. The cache structs come from
    ``launch.steps.cache_struct``."""
    ss = shape_spec(shape)
    B, S = ss.global_batch, ss.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    specs: Dict[str, torch.Tensor] = {}
    if ss.kind in ("train", "prefill"):
        if cfg.is_encdec:
            # the encoder takes the (stub) audio frames, the decoder the
            # text tokens: the work budget S split 1:1
            specs["enc_embeds"] = meta((B, S // 2, cfg.d_model), bf16)
            specs["tokens"] = meta((B, S // 2), i32)
            if ss.kind == "train":
                specs["targets"] = meta((B, S // 2), i32)
        else:
            S_txt = S - (cfg.frontend_len if cfg.frontend else 0)
            specs["tokens"] = meta((B, S_txt), i32)
            if ss.kind == "train":
                specs["targets"] = meta((B, S_txt), i32)
            if cfg.frontend:
                specs["embeds"] = meta((B, cfg.frontend_len, cfg.d_model),
                                       bf16)
    else:  # decode
        specs["token"] = meta((B,), i32)
        specs["position"] = meta((B,), i32)
        if cfg.is_encdec:
            specs["enc_out"] = meta((B, min(S, 4096), cfg.d_model), bf16)
    return specs


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Shrink any config to a smoke-testable variant of the same family."""
    period = len(cfg.pattern)
    n_layers = max(layers, period)
    n_layers -= n_layers % period
    n_heads = max(2, min(cfg.n_heads, 4))
    rep = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // min(rep, n_heads))
    changes = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_kv, d_ff=d_model * 2, vocab_size=vocab,
        head_dim=d_model // n_heads, frontend_len=8,
        encoder_layers=(2 if cfg.is_encdec else 0),
        sliding_window=(16 if cfg.sliding_window else None),
        dtype="float32", param_dtype="float32",
    )
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=d_model * 2)
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, headdim=16, chunk=8)
    if cfg.mrope_sections:
        hd2 = (d_model // n_heads) // 2   # rope pairs
        changes["mrope_sections"] = (hd2 - 2 * (hd2 // 4), hd2 // 4, hd2 // 4)
    return dataclasses.replace(cfg, **changes)


def scale_layers(cfg: ModelConfig, m: int) -> ModelConfig:
    """Same architecture with ``m`` pattern-periods of layers (and ``m``
    encoder layers for enc-dec); all other dims unchanged."""
    period = len(cfg.pattern)
    changes: Dict[str, object] = {"n_layers": m * period}
    if cfg.is_encdec:
        changes["encoder_layers"] = m
    return dataclasses.replace(cfg, **changes)


def _norm_token(cfg: ModelConfig, t: str) -> str:
    """Expand legacy one-char tokens to <mixer><ffn> form."""
    if len(t) == 2:
        return t
    if t == "a":
        return "ae" if cfg.moe else "ad"
    if t == "m":
        return "m-"
    raise ValueError(f"bad pattern token {t!r}")


def param_count(cfg: ModelConfig, active: bool = False) -> int:
    """Analytic parameter count. ``active=True`` counts only the top-k
    experts' parameters (roofline MODEL_FLOPS = 6·N_active·D for MoE)."""
    d, hd = cfg.d_model, cfg.hd
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
    if cfg.qkv_bias:
        attn += (n_q + 2 * n_kv) * hd

    def mlp_params(dff: int) -> int:
        mult = 3 if cfg.act in ("swiglu", "geglu") else 2
        return mult * d * dff

    def mamba_params() -> int:
        s = cfg.ssm
        din = s.d_inner(d)
        nh = s.nheads(d)
        conv_ch = din + 2 * s.ngroups * s.d_state
        p = d * (2 * din + 2 * s.ngroups * s.d_state + nh)   # in_proj
        p += conv_ch * s.conv_kernel + conv_ch               # conv w + b
        p += 3 * nh                                          # A, dt_bias, D
        p += din                                             # gated norm
        p += din * d                                         # out_proj
        return p

    def ffn_params(ffn: str) -> int:
        if ffn == "-":
            return 0
        if ffn == "d":
            return mlp_params(cfg.d_ff) + d                  # + norm2
        m = cfg.moe
        n_e = m.top_k if active else m.num_experts
        return (d * m.num_experts + n_e * mlp_params(m.d_ff_expert)
                + m.num_shared * mlp_params(m.d_ff_expert) + d)

    total = 0
    pattern = cfg.pattern
    reps = cfg.n_layers // len(pattern)
    for tok in pattern:
        tok = _norm_token(cfg, tok)
        blk = d                                              # norm1
        blk += attn if tok[0] == "a" else mamba_params()
        blk += ffn_params(tok[1])
        total += blk * reps
    total += cfg.vocab_size * d                              # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d                          # lm head
    if cfg.is_encdec:
        enc_blk = attn + mlp_params(cfg.d_ff) + 2 * d
        total += cfg.encoder_layers * enc_blk
        total += cfg.n_layers * (attn + d)                   # cross-attn
    return int(total)
