"""CUDA kernel wrapper: point-in-time LAST JOIN row lookup
(``csrc/last_join.cu``).

Counterpart of the TPU kernel ``last_join_pallas``; the plain version is
:func:`repro_torch.kernels.ref.last_join_ref`. ``launches`` counts the
kernel launches this process made.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["last_join_cuda", "launches"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ((_P,) * 5 + (_I,) * 4 + (_P, _I, _I) + (_P,) * 3 + (_P,))

launches = 0


def last_join_cuda(values: torch.Tensor, ts: torch.Tensor,
                   total: torch.Tensor, req_key: torch.Tensor,
                   req_ts: torch.Tensor, *,
                   col_idx: Tuple[int, ...],
                   assume_latest: bool = False,
                   with_ts: bool = False) -> Tuple[torch.Tensor, ...]:
    """CUDA implementation of :func:`ref.last_join_ref`.

    Ring tensors as for :func:`window_agg_cuda`. Returns
    ``(row (B, len(col_idx)) f32, matched (B,) bool)`` and, with
    ``with_ts``, the selected row's timestamp ``(B,) f32``.
    """
    global launches
    if not col_idx:
        raise ValueError("last_join needs at least one value column")
    dev = _build.require_cuda(values, "last_join_cuda")
    if values.dim() != 3:
        raise ValueError(f"values must be (K, C, V), got {tuple(values.shape)}")
    K, C, V = values.shape
    B = req_key.shape[0] if isinstance(req_key, torch.Tensor) else -1
    _build.require(values, "values", torch.float32, (K, C, V), dev)
    _build.require(ts, "ts", torch.float32, (K, C), dev)
    _build.require(total, "total", torch.int32, (K,), dev)
    _build.require(req_key, "req_key", torch.int32, (B,), dev)
    _build.require(req_ts, "req_ts", torch.float32, (B,), dev)
    cols = _build.check_cols(col_idx, V)
    row = torch.empty((B, len(cols)), dtype=torch.float32, device=dev)
    matched = torch.empty((B,), dtype=torch.bool, device=dev)
    sel_ts = (torch.empty((B,), dtype=torch.float32, device=dev)
              if with_ts else None)
    if B > 0:
        fn = _build.function("last_join_launch", _ARGTYPES)
        with torch.cuda.device(dev):
            code = fn(
                _build.ptr(values), _build.ptr(ts), _build.ptr(total),
                _build.ptr(req_key), _build.ptr(req_ts), B, K, C, V,
                _build.int_array(cols), len(cols), int(assume_latest),
                _build.ptr(row), _build.ptr(matched), _build.ptr(sel_ts),
                _build.stream_of(dev))
        _build.check(code, "last_join")
        launches += 1
    return (row, matched, sel_ts) if with_ts else (row, matched)
