"""CUDA kernel wrapper: single-token GQA decode attention over a KV cache,
prefix or ring layout (``csrc/decode_attention.cu``).

Counterpart of the TPU kernel ``decode_attention_pallas``; the plain
version is :func:`repro_torch.kernels.ref.decode_attention_ref`.
``launches`` counts the calls this process made that launched the
kernel; each call is two device launches (the split pass over
``ceil(S / SPLIT)`` cache chunks and the combine pass).

The launch is the torch op ``repro_torch::decode_attention``
(``torch.library``): its CUDA implementation is the kernel; its fake
implementation gives the output's shape and dtype and allocates the
split pass's f32 scratch as the kernel's does, so a step traced on fake
CUDA tensors (``launch/dryrun.py``) counts the memory the card uses; its
FLOP formula counts ``4·B·Hq·D·S`` over the cache it reads.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, LIB, check_query,
                                                 require_aligned)

__all__ = ["decode_attention_cuda", "launches", "MAX_REP_D", "SPLIT",
           "scratch_floats"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 6 + (_I,) * 9 + (_F, _P)
MAX_REP_D = 2048      # (Hq / Hkv) * D one block accumulates (kMaxAcc4)
SPLIT = 64            # cache slots per split block: the kernels' kChunk
                      # (the launch refuses any other value)

launches = 0


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          ring: bool = False) -> torch.Tensor:
    """CUDA implementation of :func:`ref.decode_attention_ref`.

    q (B, Hq, D); caches (B, S, Hkv, D), one dtype (bf16 or f32); lengths
    (B,) int32, read on the device (no host sync); all contiguous on one
    CUDA device. ``ring=False``: ``lengths`` counts the valid prefix (a
    length above S counts as S). ``ring=True``: ``lengths`` is the absolute
    position of a rolling ring. Returns (B, Hq, D); a head that keeps no
    slot comes out 0, as in the TPU kernel. The split pass writes its
    partials to an f32 scratch buffer of ``B·Hkv·ceil(S/SPLIT)·rep·(D+2)``
    floats allocated here; the launch depends only on the shapes, never
    on the lengths.
    """
    dev = _build.require_cuda(q, "decode_attention_cuda")
    D = check_query(q, 3, "decode_attention_cuda")
    B, Hq, _ = q.shape
    if not isinstance(k_cache, torch.Tensor) or k_cache.dim() != 4:
        raise ValueError(f"k_cache must be (B, S, Hkv, D), got "
                         f"{getattr(k_cache, 'shape', type(k_cache))}")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    _build.require(q, "q", q.dtype, (B, Hq, D), dev)
    _build.require(k_cache, "k_cache", q.dtype, (B, S, Hkv, D), dev)
    _build.require(v_cache, "v_cache", q.dtype, (B, S, Hkv, D), dev)
    _build.require(lengths, "lengths", torch.int32, (B,), dev)
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if (Hq // Hkv) * D > MAX_REP_D:
        raise ValueError(f"(Hq/Hkv)*D = {(Hq // Hkv) * D} exceeds "
                         f"{MAX_REP_D}, what one block accumulates")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    scale = float(D ** -0.5 if scale is None else scale)
    return torch.ops.repro_torch.decode_attention(
        q, k_cache, v_cache, lengths, window, scale, ring)


# ---------------------------------------------------------------------------
# the torch op: the kernel on CUDA tensors, shapes and scratch on fake ones
# ---------------------------------------------------------------------------

LIB.define("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
           "Tensor lengths, int? window, float scale, bool ring) -> Tensor")


def scratch_floats(B: int, S: int, Hq: int, Hkv: int, D: int) -> int:
    """The split pass's f32 partials: ``B·Hkv·ceil(S/SPLIT)·rep·(D+2)``."""
    return B * Hkv * -(-S // SPLIT) * (Hq // Hkv) * (D + 2)


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            lengths: torch.Tensor, window: Optional[int], scale: float,
            ring: bool) -> torch.Tensor:
    """The op's CUDA implementation: the split and combine launches
    (arguments checked by ``decode_attention_cuda``)."""
    require_aligned(q=q, k_cache=k_cache, v_cache=v_cache)
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if S == 0:
        return out.zero_()
    dev = q.device
    scratch = torch.empty(scratch_floats(B, S, Hq, Hkv, D),
                          dtype=torch.float32, device=dev)
    fn = _build.function("decode_attention_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
                  _build.ptr(lengths), _build.ptr(out), _build.ptr(scratch),
                  B, S, Hq, Hkv, D, DTYPES[q.dtype],
                  0 if window is None else int(window), int(ring), SPLIT,
                  scale, _build.stream_of(dev))
    _build.check(code, "decode_attention")
    _build.count_launch(sys.modules[__name__])
    return out


LIB.impl("decode_attention", _launch, "CUDA")


@torch.library.register_fake("repro_torch::decode_attention")
def _fake(q, k_cache, v_cache, lengths, window, scale, ring):
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() and S:
        # the split pass's partials, live while the kernel runs
        torch.empty(scratch_floats(B, S, Hq, Hkv, D), dtype=torch.float32,
                    device=q.device)
    return out


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """q·K and p·V, two FLOPs a multiply-add each, over every cache slot
    (the launch depends on the shapes only)."""
    B, Hq, D = q_shape
    return 4 * B * Hq * D * k_shape[1]
