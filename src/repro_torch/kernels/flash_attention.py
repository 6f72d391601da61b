"""CUDA kernel wrapper: causal / sliding-window GQA flash attention
(``csrc/flash_attention.cu``).

Counterpart of the TPU kernel ``flash_attention_pallas``; the plain version
is :func:`repro_torch.kernels.ref.flash_attention_ref`. ``launches``
counts the kernel launches this process made.

The kernel computes the forward pass. The autograd path,
``flash_attention_train`` (``kernels/flash_attention_bwd.py``), launches it
through the second op, ``repro_torch::flash_attention_fwd_lse``, which also
returns each row's log-sum-exp, and its backward is the backward kernel
(``csrc/flash_attention_bwd.cu``). Calling ``flash_attention_cuda`` itself
on inputs that need a gradient raises, so no path drops the gradient
quietly.

The serving launch is the torch op ``repro_torch::flash_attention_fwd``
(``torch.library``): its CUDA implementation is the kernel, its fake
implementation gives the output's shape and dtype, so a step traced on
fake CUDA tensors (``launch/dryrun.py``) goes through it, and its FLOP
formula (``torch.utils.flop_counter``) counts ``4·B·Hq·D`` for every
(query, key) pair the causal or window mask keeps. ``flash_attention_fwd_lse``
is the same launch with ``lse`` (B, Hq, Sq) f32 written beside the output:
natural-log units, ``ref.ATTN_NEG_INF`` (−1e30) for a row that keeps no
key; the same FLOP formula. Both count in ``launches``.

``q_offset`` is the position of the first query row (default ``Sk −
Sq``: the queries right-aligned, the JAX kernel's only layout). A
context-parallel rank holding query rows ``[r·c, (r+1)·c)`` of a sequence
against its whole K/V passes ``r·c``; the kernel masks by those global
positions and skips the key tiles the mask removes.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

__all__ = ["flash_attention_cuda", "launches", "HEAD_DIMS", "DTYPES",
           "check_query", "require_aligned", "check_inputs", "LIB",
           "kept_pairs"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 5 + (_I,) * 10 + (_F, _P)
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
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda computes no gradient: inputs that "
            "require grad go through flash_attention_train (or "
            "ops.flash_attention, which routes them there)")
    scale, off = check_inputs(q, k, v, window, scale, q_offset,
                              "flash_attention_cuda")
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, window,
                                                     scale, off)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int], scale: Optional[float],
                 q_offset: Optional[int], what: str) -> Tuple[float, int]:
    """Raise unless q, k and v are what the kernels take (see
    :func:`flash_attention_cuda`); returns the scale and the first query
    row's position."""
    dev = _build.require_cuda(q, what)
    D = check_query(q, 4, what)
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
    return (float(D ** -0.5 if scale is None else scale),
            _offset(Sq, Sk, q_offset))


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
LIB.define("flash_attention_fwd_lse(Tensor q, Tensor k, Tensor v, "
           "bool causal, int? window, float scale, int? q_offset=None) "
           "-> (Tensor, Tensor)")


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: Optional[int], scale: float, q_offset: Optional[int],
         lse: Optional[torch.Tensor]) -> torch.Tensor:
    """One kernel launch (arguments checked by ``check_inputs``), writing
    ``lse`` too where it is given."""
    require_aligned(q=q, k=k, v=v)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:
        if lse is not None:
            lse.fill_(ref.ATTN_NEG_INF)
        return out.zero_()
    dev = q.device
    fn = _build.function("flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(out), _build.ptr(lse), B, Sq, Sk, Hq, Hkv, D,
                  DTYPES[q.dtype], int(causal),
                  0 if window is None else int(window),
                  _offset(Sq, Sk, q_offset), scale, _build.stream_of(dev))
    _build.check(code, "flash_attention")
    _build.count_launch(sys.modules[__name__])
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int], scale: float,
            q_offset: Optional[int] = None) -> torch.Tensor:
    """``flash_attention_fwd``'s CUDA implementation: the serving launch."""
    return _run(q, k, v, causal, window, scale, q_offset, None)


def _launch_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: Optional[int], scale: float,
                q_offset: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd_lse``'s CUDA implementation: the training
    forward, the output and each row's log-sum-exp."""
    B, Sq, Hq, _ = q.shape
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    return _run(q, k, v, causal, window, scale, q_offset, lse), lse


LIB.impl("flash_attention_fwd", _launch, "CUDA")
LIB.impl("flash_attention_fwd_lse", _launch_lse, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd")
def _fake(q, k, v, causal, window, scale, q_offset=None):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.register_fake("repro_torch::flash_attention_fwd_lse")
def _fake_lse(q, k, v, causal, window, scale, q_offset=None):
    B, Sq, Hq, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, Hq, Sq), dtype=torch.float32))


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


@register_flop_formula([torch.ops.repro_torch.flash_attention_fwd,
                        torch.ops.repro_torch.flash_attention_fwd_lse])
def _flops(q_shape, k_shape, v_shape, causal, window, scale, q_offset=None,
           *args, out_shape=None, **kwargs) -> int:
    """QK^T and PV, two FLOPs a multiply-add each, over the kept pairs."""
    B, Sq, Hq, D = q_shape
    return 4 * B * Hq * D * kept_pairs(Sq, k_shape[1], causal, window,
                                       q_offset)

