"""Primitive layers: norms, rotary embeddings (incl. M-RoPE), MLPs.

Conventions (as in the JAX package's ``repro.models.layers``): params are
dicts of tensors in the JAX layouts — a linear weight is ``(d_in, d_out)``
and applies as ``x @ w`` — so parameters carry across one to one
(``repro_torch.convert``). ``init_*`` draws from an explicit
``torch.Generator`` and allocates on that generator's device; compute runs
in the activations' dtype with f32 where it matters (norm statistics,
rotary angles).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding

__all__ = ["init_norm", "apply_norm", "rope_freqs", "apply_rope",
           "mrope_positions_text", "init_mlp", "apply_mlp", "init_linear",
           "apply_linear", "init_embedding", "matmul"]

Params = Dict[str, torch.Tensor]

NORM_EPS = 1e-6          # every norm's epsilon, as in the JAX package


def _normal(gen: torch.Generator, shape: Tuple[int, ...], std: float,
            dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str, dtype: torch.dtype,
              device: torch.device) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = NORM_EPS) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies (head_dim//2,) in f32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """Rotate q or k. x (..., S, H, D); positions (..., S) int for standard
    RoPE, or (3, ..., S) for M-RoPE (temporal/height/width id streams).
    The rotation is the half-split one: the first and second halves of D
    form the pairs."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)            # (D/2,)
    if mrope_sections is None:
        ang = positions[..., None].float() * inv    # (..., S, D/2)
    else:
        if positions.shape[0] != 3 or sum(mrope_sections) != D // 2:
            raise ValueError(f"M-RoPE wants (3, ..., S) positions and "
                             f"sections summing to {D // 2}, got "
                             f"{tuple(positions.shape)}, {mrope_sections}")
        parts, off = [], 0
        for s_i, sec in enumerate(mrope_sections):
            parts.append(positions[s_i][..., None].float()
                         * inv[off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)               # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]               # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def mrope_positions_text(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE: all three id streams equal the text position."""
    return positions[None].expand((3,) + tuple(positions.shape))


# ---------------------------------------------------------------------------
# Linear / MLP
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, bias: bool = False) -> Params:
    p = {"w": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype; on DTensors through
    ``sharding.matmul`` (each rank's local product)."""
    w = w.to(x.dtype)
    return sharding.matmul(x, w) if isinstance(x, DTensor) else x @ w


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype: torch.dtype) -> Params:
    if act in ("swiglu", "geglu"):
        return {"wi": init_linear(gen, d, d_ff, dtype)["w"],
                "wg": init_linear(gen, d, d_ff, dtype)["w"],
                "wo": init_linear(gen, d_ff, d, dtype)["w"]}
    return {"wi": init_linear(gen, d, d_ff, dtype)["w"],
            "wo": init_linear(gen, d_ff, d, dtype)["w"]}


def apply_mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    h = matmul(x, p["wi"])
    if act == "swiglu":
        h = F.silu(matmul(x, p["wg"])) * h
    elif act == "geglu":
        h = F.gelu(matmul(x, p["wg"]), approximate="tanh") * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown act {act!r}")
    return matmul(h, p["wo"])


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype) -> torch.Tensor:
    return _normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype)
