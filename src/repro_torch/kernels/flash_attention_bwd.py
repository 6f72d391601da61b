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

:func:`plan` picks the kernels of a call from its shape and dtype, and the
launch function takes what it says: the ``"wgmma"`` route (bf16 at head
dims 64 and 128: warpgroup products, TMA rings, the dK/dV pass's heads cut
into ``split`` blocks summed in a fixed order), ``"mma"`` (bf16 at the
other head dims: mma.sync) or ``"fma"`` (f32 on the FMA units). Each
route launches its own kernels or the launch raises; nothing falls back.
``route_launches`` counts calls by route beside ``launches``.
"""
from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIMS, LIB,
                                                 _offset, check_inputs,
                                                 kept_pairs, require_aligned)

__all__ = ["flash_attention_bwd_cuda", "flash_attention_train", "launches",
           "route_launches", "reset_launches", "plan", "Plan", "ROUTES",
           "SMS"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 12 + (_I,) * 14 + (_F, _P)
ROUTES = ("fma", "mma", "wgmma")   # the launch function's route numbers
SMS = 132              # streaming multiprocessors of an H100 SXM
_WG_ROWS = 64          # rows of a wgmma tile (keys or query rows)
_MMA_ROWS = 64         # rows a block of the mma kernels owns
_FMA_ROWS = 32         # rows a block of the FMA kernels owns

launches = 0
route_launches = dict.fromkeys(ROUTES, 0)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reset_launches() -> None:
    """Zero ``launches`` and every route's count."""
    global launches
    launches = 0
    for r in ROUTES:
        route_launches[r] = 0


@dataclass(frozen=True)
class Plan:
    """The kernels of one backward call. ``blocks`` gives each launch's
    thread blocks in launch order (``dkdv_sum`` only where ``split`` > 1);
    ``scratch_bytes`` is the f32 scratch the call allocates: Di (and on
    the wgmma route lse·log2 e), (B, Hq, sq_pad) each, and the split
    parts' dK and dV, (split, 2, B, Sk, Hkv, D)."""
    route: str
    split: int            # dK/dV blocks a KV group's query heads are cut into
    wg_q: int             # consumer warpgroups (query heads) of a dQ block
    sq_pad: int           # Sq rounded up to the route's row scratch
    blocks: Tuple[Tuple[str, int], ...]
    scratch_bytes: int


def plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
         dtype: torch.dtype) -> Plan:
    """The route and grid of a backward call of this shape. bf16 at head
    dim 64 or 128 takes the wgmma kernels. Their dK/dV pass cuts each KV
    group's rep query heads into the fewest ``split`` parts whose blocks
    (key tiles x KV heads x batch x split) reach the card's SMS, or into
    one head a part; a block's two warpgroups take its (head, query tile)
    steps in turn. A dQ block holds two query heads of a group where rep
    is even, one otherwise. bf16 at the other head dims takes the
    mma.sync kernels, f32 the FMA kernels."""
    if dtype not in DTYPES or D not in HEAD_DIMS:
        raise ValueError(f"no backward route for {dtype} at head dim {D}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} KV heads")
    rep = Hq // Hkv
    if dtype == torch.bfloat16 and D in (64, 128):
        sq_pad = _cdiv(Sq, _WG_ROWS) * _WG_ROWS
        wg = 2 if rep % 2 == 0 else 1
        base = _cdiv(Sk, _WG_ROWS) * Hkv * B
        splits = [s for s in range(1, rep + 1) if rep % s == 0]
        split = next((s for s in splits if base * s >= SMS), rep)
        n = B * Sk * Hkv * D
        blocks = [("di", _cdiv(B * sq_pad * Hq * 4, 128)),
                  ("dkdv", base * split)]
        if split > 1:
            blocks.append(("dkdv_sum", _cdiv(n // 4, 256)))
        blocks.append(("dq", _cdiv(Sq, _WG_ROWS) * (Hq // wg) * B))
        scratch = 4 * (2 * B * Hq * sq_pad + (2 * split * n
                                              if split > 1 else 0))
        return Plan("wgmma", split, wg, sq_pad, tuple(blocks), scratch)
    rows = _MMA_ROWS if dtype == torch.bfloat16 else _FMA_ROWS
    blocks = (("di", _cdiv(B * Sq * Hq * 4, 128)),
              ("dkdv", _cdiv(Sk, rows) * Hkv * B),
              ("dq", _cdiv(Sq, rows) * Hq * B))
    return Plan("mma" if dtype == torch.bfloat16 else "fma", 1, 1, Sq,
                blocks, 4 * B * Hq * Sq)

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
    p = plan(B, Sq, Sk, Hq, Hkv, D, q.dtype)
    dev = q.device
    wg = p.route == "wgmma"
    rows = torch.empty((2 if wg else 1, B, Hq, p.sq_pad),
                       dtype=torch.float32, device=dev)
    part = (torch.empty((p.split, 2, B, Sk, Hkv, D), dtype=torch.float32,
                        device=dev) if p.split > 1 else None)
    fn = _build.function("flash_attention_bwd_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(out), _build.ptr(dout), _build.ptr(lse),
                  _build.ptr(rows[0]), _build.ptr(rows[1]) if wg else None,
                  _build.ptr(part), _build.ptr(dq), _build.ptr(dk),
                  _build.ptr(dv), B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype],
                  int(causal), 0 if window is None else int(window),
                  _offset(Sq, Sk, q_offset), ROUTES.index(p.route), p.split,
                  p.wg_q, p.sq_pad, scale, _build.stream_of(dev))
    _build.check(code, f"flash_attention_bwd ({p.route})")
    _build.count_launch(sys.modules[__name__], p.route)
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
