"""Gradient compression for the cross-pod all-reduce: int8 quantization
and top-k sparsification, with error feedback (the JAX package's
``repro.optim.compression``).

Only the ``pod``-axis gradient reduce is compressed
(``distributed/collectives.py``); the quantization is per tensor and
symmetric. Error feedback carries the quantization residual into the next
step's gradient, so the compression bias vanishes in expectation.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
codes and the scale equal the JAX package's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.models.tree import tree_map

Params = Any
__all__ = ["compress_int8", "decompress_int8", "int8_codes",
           "compress_topk", "decompress_topk", "ErrorFeedback",
           "ef_int8_roundtrip"]


def int8_codes(xf: torch.Tensor, amax: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``xf`` quantized against the magnitude ``amax`` (a 0-d f32
    tensor): (q int8, scale f32) with ``scale = max(amax / 127, 1e-12)``."""
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q int8, scale f32)."""
    xf = x.float()
    return int8_codes(xf, xf.abs().max())


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_topk(x: torch.Tensor, k_frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Keep the top ``k_frac`` fraction of entries by magnitude: (values
    (k,) f32, flat indices (k,) int32, the original shape), largest
    magnitude first. Entries of equal magnitude may come in another order
    than ``lax.top_k``'s, which puts the lower index first; the set kept
    is the same wherever the k-th largest magnitude is not tied."""
    xf = x.float().reshape(-1)
    k = max(1, int(xf.shape[0] * k_frac))
    _, idx = torch.topk(xf.abs(), k)
    return xf[idx], idx.to(torch.int32), tuple(x.shape)


def decompress_topk(vals: torch.Tensor, idx: torch.Tensor,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals.float()
    return out.reshape(shape)


@dataclass
class ErrorFeedback:
    """Per-leaf carried quantization residual (an f32 tree)."""

    residual: Params

    @staticmethod
    def init(params: Params) -> "ErrorFeedback":
        return ErrorFeedback(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))


def ef_int8_roundtrip(g: torch.Tensor, res: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback int8 round trip of one leaf: (the decompressed
    gradient applied, the new residual)."""
    corrected = g.float() + res
    q, s = compress_int8(corrected)
    deq = decompress_int8(q, s)
    return deq, corrected - deq
