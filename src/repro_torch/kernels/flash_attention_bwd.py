"""CUDA kernel wrapper: the flash attention backward pass
(``csrc/flash_attention_bwd.cu``) and the autograd Function that trains
through the flash kernels.

It replaces no TPU kernel: the JAX package differentiates its XLA form of
attention (autodiff of ``flash_attention_ref`` / ``flash_attention_xla``).
The plain version is :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`,
the same formulas in plain PyTorch. ``launches`` counts backward calls (one
a call: the call's three kernels are one C launch function).

``flash_attention_train`` is ``torch.autograd.Function`` ``_FlashAttention``:
its forward is the forward kernel through ``repro_torch::flash_attention_fwd_lse``
(the output and each row's log-sum-exp), and it saves q, k, v, out and lse;
its backward is the backward kernel through ``repro_torch::flash_attention_bwd``
and calls no plain version. The op's fake implementation gives dq, dk and
dv shaped like q, k and v, so the dry run (``launch/dryrun.py``) traces the
backward on fake tensors; its FLOP formula counts what the kernels compute,
``14·B·Hq·D`` a kept (query, key) pair: S = QK^T in both passes, dP = dO V^T
in both, and P^T dO, dS^T Q and dS K, two FLOPs a multiply-add each.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, LIB, _offset,
                                                 check_inputs, kept_pairs,
                                                 require_aligned)

__all__ = ["flash_attention_bwd_cuda", "flash_attention_train", "launches"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 10 + (_I,) * 10 + (_F, _P)

launches = 0

LIB.define("flash_attention_bwd(Tensor dout, Tensor q, Tensor k, Tensor v, "
           "Tensor out, Tensor lse, bool causal, int? window, float scale, "
           "int? q_offset=None) -> (Tensor, Tensor, Tensor)")


def flash_attention_bwd_cuda(dout: torch.Tensor, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             q_offset: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """dq, dk and dv of :func:`ref.flash_attention_ref` at ``dout``, from
    the forward's ``out`` and ``lse`` (as ``flash_attention_fwd_lse``
    returns them). q, out, dout (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); lse
    (B, Hq, Sq) f32; all contiguous on one CUDA device, q's dtype (bf16 or
    f32) but lse's. A query row that keeps no key has zero gradient."""
    scale, off = check_inputs(q, k, v, window, scale, q_offset,
                              "flash_attention_bwd_cuda")
    B, Sq, Hq, D = q.shape
    _build.require(out, "out", q.dtype, (B, Sq, Hq, D), q.device)
    _build.require(dout, "dout", q.dtype, (B, Sq, Hq, D), q.device)
    _build.require(lse, "lse", torch.float32, (B, Hq, Sq), q.device)
    return torch.ops.repro_torch.flash_attention_bwd(
        dout, q, k, v, out, lse, causal, window, scale, off)


def _launch(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
            causal: bool, window: Optional[int], scale: float,
            q_offset: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: one call of the launch function (its
    three kernels), arguments checked by ``flash_attention_bwd_cuda``."""
    require_aligned(q=q, k=k, v=v, out=out, dout=dout)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    di = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dev = q.device
    fn = _build.function("flash_attention_bwd_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(out), _build.ptr(dout), _build.ptr(lse),
                  _build.ptr(di), _build.ptr(dq), _build.ptr(dk),
                  _build.ptr(dv), B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype],
                  int(causal), 0 if window is None else int(window),
                  _offset(Sq, Sk, q_offset), scale, _build.stream_of(dev))
    _build.check(code, "flash_attention_bwd")
    _build.count_launch(sys.modules[__name__])
    return dq, dk, dv


LIB.impl("flash_attention_bwd", _launch, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_bwd")
def _fake(dout, q, k, v, out, lse, causal, window, scale, q_offset=None):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flops(dout_shape, q_shape, k_shape, v_shape, o_shape, lse_shape,
           causal, window, scale, q_offset=None, *args, out_shape=None,
           **kwargs) -> int:
    """Seven products of 2·D FLOPs over the kept pairs and query heads."""
    B, Sq, Hq, D = q_shape
    return 14 * B * Hq * D * kept_pairs(Sq, k_shape[1], causal, window,
                                        q_offset)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel, keeping each row's log-sum-exp. Backward:
    the backward kernel, gradients in the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        scale, off = check_inputs(q, k, v, window, scale, q_offset,
                                  "flash_attention_train")
        out, lse = torch.ops.repro_torch.flash_attention_fwd_lse(
            q, k, v, causal, window, scale, off)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, scale, off)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, off = ctx.opts
        dq, dk, dv = flash_attention_bwd_cuda(
            dout.to(q.dtype).contiguous(), q, k, v, out, lse, causal=causal,
            window=window, scale=scale, q_offset=off)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention.flash_attention_cuda` with a gradient: the
    forward kernel, then the backward kernel for dq, dk and dv."""
    return _FlashAttention.apply(q, k, v, causal, window, scale, q_offset)
