"""CUDA kernel wrapper: the pre-aggregated window of paper Eq. 2
(``csrc/preagg_window.cu``).

Counterpart of the TPU kernel ``preagg_window_pallas``; the plain version
is :func:`repro_torch.kernels.ref.preagg_window_ref`. ``launches`` counts
the kernel launches this process made.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["preagg_window_cuda", "launches"]

_ALL_FIELDS = ("sum", "sumsq", "count", "min", "max")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ((_P,) * 10 + (_I,) * 6 + (_P, _I, _I, _F, _I, _I)
             + (_P,) * 5 + (_P,))

launches = 0


def preagg_window_cuda(values: torch.Tensor, ts: torch.Tensor,
                       total: torch.Tensor, pa_sum: torch.Tensor,
                       pa_sumsq: torch.Tensor, pa_min: torch.Tensor,
                       pa_max: torch.Tensor, pa_count: torch.Tensor,
                       req_key: torch.Tensor, req_ts: torch.Tensor, *,
                       bucket_size: int,
                       cols: Optional[Sequence[int]] = None,
                       rows_preceding: Optional[int] = None,
                       range_preceding: Optional[float] = None,
                       assume_latest: bool = False,
                       fields: Optional[Tuple[str, ...]] = None
                       ) -> Dict[str, torch.Tensor]:
    """CUDA implementation of :func:`ref.preagg_window_ref`.

    Ring tensors as for :func:`window_agg_cuda`, plus the (K, NB, V) f32
    tiers and the (K, NB) f32 count tier, with ``NB · bucket_size == C``.
    """
    global launches
    dev = _build.require_cuda(values, "preagg_window_cuda")
    if values.dim() != 3 or pa_count.dim() != 2:
        raise ValueError("values must be (K, C, V) and pa_count (K, NB)")
    K, C, V = values.shape
    NB = pa_count.shape[1]
    if bucket_size <= 0 or NB * bucket_size != C:
        raise ValueError(f"capacity {C} / bucket {bucket_size} / NB {NB} "
                         f"mismatch")
    B = req_key.shape[0] if isinstance(req_key, torch.Tensor) else -1
    _build.require(values, "values", torch.float32, (K, C, V), dev)
    _build.require(ts, "ts", torch.float32, (K, C), dev)
    _build.require(total, "total", torch.int32, (K,), dev)
    for name, t in (("pa_sum", pa_sum), ("pa_sumsq", pa_sumsq),
                    ("pa_min", pa_min), ("pa_max", pa_max)):
        _build.require(t, name, torch.float32, (K, NB, V), dev)
    _build.require(pa_count, "pa_count", torch.float32, (K, NB), dev)
    _build.require(req_key, "req_key", torch.int32, (B,), dev)
    _build.require(req_ts, "req_ts", torch.float32, (B,), dev)
    if (rows_preceding is None) == (range_preceding is None):
        raise ValueError("exactly one of rows_preceding / range_preceding "
                         "must be given")
    if rows_preceding is not None and rows_preceding < 0:
        raise ValueError(f"rows_preceding must be >= 0, got {rows_preceding}")
    cols = _build.check_cols(cols, V)
    fields = tuple(f for f in _ALL_FIELDS if f in (fields or _ALL_FIELDS))
    out = {f: torch.empty((B,) if f == "count" else (B, len(cols)),
                          dtype=torch.float32, device=dev) for f in fields}
    if B == 0:
        return out
    fn = _build.function("preagg_window_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            _build.ptr(values), _build.ptr(ts), _build.ptr(total),
            _build.ptr(pa_sum), _build.ptr(pa_sumsq), _build.ptr(pa_min),
            _build.ptr(pa_max), _build.ptr(pa_count), _build.ptr(req_key),
            _build.ptr(req_ts), B, K, C, V, NB, int(bucket_size),
            _build.int_array(cols), len(cols),
            -1 if rows_preceding is None else int(rows_preceding),
            0.0 if range_preceding is None else float(range_preceding),
            int(assume_latest), _build.field_bits(fields),
            *(_build.ptr(out.get(f)) for f in _ALL_FIELDS),
            _build.stream_of(dev))
    _build.check(code, "preagg_window")
    launches += 1
    return out
