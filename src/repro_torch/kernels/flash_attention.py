"""CUDA kernel wrapper: causal / sliding-window GQA flash attention
(``csrc/flash_attention.cu``).

Counterpart of the TPU kernel ``flash_attention_pallas``; the plain version
is :func:`repro_torch.kernels.ref.flash_attention_ref`. ``launches``
counts the kernel launches this process made.

The kernel computes the forward pass only. ``flash_attention_train`` is
the autograd path: a ``torch.autograd.Function`` whose forward launches the
kernel and saves q, k and v, and whose backward recomputes the attention
through the plain version in f32 and differentiates that (the JAX package
has no backward kernel either; a hand-written one is open work). Calling
``flash_attention_cuda`` itself on inputs that need a gradient raises, so
no path drops the gradient quietly.

The launch is the torch op ``repro_torch::flash_attention_fwd``
(``torch.library``): its CUDA implementation is the kernel, its fake
implementation gives the output's shape and dtype, so a step traced on
fake CUDA tensors (``launch/dryrun.py``) goes through it, and its FLOP
formula (``torch.utils.flop_counter``) counts ``4·B·Hq·D`` for every
(query, key) pair the causal or window mask keeps.

``q_offset`` is the position of the first query row (default ``Sk −
Sq``: the queries right-aligned, the JAX kernel's only layout). A
context-parallel rank holding query rows ``[r·c, (r+1)·c)`` of a sequence
against its whole K/V passes ``r·c``; the kernel masks by those global
positions and skips the key tiles the mask removes.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

__all__ = ["flash_attention_cuda", "flash_attention_train", "launches",
           "HEAD_DIMS", "DTYPES", "check_query", "require_aligned",
           "LIB", "kept_pairs"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 4 + (_I,) * 10 + (_F, _P)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)          # instantiated in csrc
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def check_query(q: torch.Tensor, ndim: int, what: str) -> int:
    """The query's head dim, after checking its rank, dtype and head dim
    against what the kernels are instantiated for."""
    if not isinstance(q, torch.Tensor) or q.dim() != ndim:
        raise ValueError(f"{what}: q must be a {ndim}-d tensor, got "
                         f"{getattr(q, 'shape', type(q))}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{what} takes {tuple(DTYPES)}, got {q.dtype}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not one of {HEAD_DIMS}")
    return D


def require_aligned(**tensors: torch.Tensor) -> None:
    """The kernels load four elements at a time: 16-byte aligned bases."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         q_offset: Optional[int] = None) -> torch.Tensor:
    """CUDA implementation of :func:`ref.flash_attention_ref`.

    q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), one dtype (bf16 or f32), all
    contiguous on one CUDA device; query i at position ``i + q_offset``
    (default ``Sk − Sq``: right-aligned). Returns (B, Sq, Hq, D). A query
    row that keeps no key comes out 0, as in the TPU kernel. bf16 runs
    QK^T and PV on the tensor cores and rounds the probabilities to bf16
    before PV, as the plain version does; f32 stays in full f32 on the
    FMA units.
    """
    dev = _build.require_cuda(q, "flash_attention_cuda")
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda computes no gradient: inputs that "
            "require grad go through flash_attention_train (or "
            "ops.flash_attention, which routes them there)")
    D = check_query(q, 4, "flash_attention_cuda")
    B, Sq, Hq, _ = q.shape
    if not isinstance(k, torch.Tensor) or k.dim() != 4:
        raise ValueError(f"k must be (B, Sk, Hkv, D), got "
                         f"{getattr(k, 'shape', type(k))}")
    Sk, Hkv = k.shape[1], k.shape[2]
    _build.require(q, "q", q.dtype, (B, Sq, Hq, D), dev)
    _build.require(k, "k", q.dtype, (B, Sk, Hkv, D), dev)
    _build.require(v, "v", q.dtype, (B, Sk, Hkv, D), dev)
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    scale = float(D ** -0.5 if scale is None else scale)
    return torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, causal, window, scale, _offset(Sq, Sk, q_offset))


def _offset(Sq: int, Sk: int, q_offset: Optional[int]) -> int:
    """The first query row's position (``Sk − Sq`` when not given)."""
    off = Sk - Sq if q_offset is None else int(q_offset)
    if abs(off) >= 2 ** 31:
        raise ValueError(f"q_offset {off} does not fit the kernel's int")
    return off


# ---------------------------------------------------------------------------
# the torch op: the kernel on CUDA tensors, shapes on fake ones
# ---------------------------------------------------------------------------

LIB = torch.library.Library("repro_torch", "FRAGMENT")
LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
           "int? window, float scale, int? q_offset=None) -> Tensor")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int], scale: float,
            q_offset: Optional[int] = None) -> torch.Tensor:
    """The op's CUDA implementation: one kernel launch (arguments checked
    by ``flash_attention_cuda``)."""
    require_aligned(q=q, k=k, v=v)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    dev = q.device
    fn = _build.function("flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(out), B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype],
                  int(causal), 0 if window is None else int(window),
                  _offset(Sq, Sk, q_offset), scale, _build.stream_of(dev))
    _build.check(code, "flash_attention")
    _build.count_launch(sys.modules[__name__])
    return out


LIB.impl("flash_attention_fwd", _launch, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd")
def _fake(q, k, v, causal, window, scale, q_offset=None):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def kept_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int],
               q_offset: Optional[int] = None) -> int:
    """The (query, key) pairs the mask keeps: query ``i`` at position
    ``i + q_offset`` (default ``Sk - Sq``) sees keys ``j <= pos``
    (causal) and ``j > pos - window`` (window), as
    :func:`ref.flash_attention_ref` masks."""
    pos = np.arange(Sq, dtype=np.int64) + _offset(Sq, Sk, q_offset)
    hi = np.minimum(pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq,
                                                                 np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, v_shape, causal, window, scale, q_offset=None,
           *args, out_shape=None, **kwargs) -> int:
    """QK^T and PV, two FLOPs a multiply-add each, over the kept pairs."""
    B, Sq, Hq, D = q_shape
    return 4 * B * Hq * D * kept_pairs(Sq, k_shape[1], causal, window,
                                       q_offset)


class _FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the plain version recomputed
    in f32 under autograd, gradients returned in the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        # autograd runs this with grad mode off, so the kernel takes it
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, window, scale, q_offset = ctx.opts
        with torch.enable_grad():
            qf, kf, vf = (t.detach().float().requires_grad_()
                          for t in (q, k, v))
            o = ref.flash_attention_ref(qf, kf, vf, causal=causal,
                                        window=window, scale=scale,
                                        q_offset=q_offset)
            dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf),
                                             dout.float())
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_cuda` with a gradient: the kernel forward,
    and the plain version's f32 gradient for dq, dk and dv."""
    return _FlashAttention.apply(q, k, v, causal, window, scale, q_offset)
