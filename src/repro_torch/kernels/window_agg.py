"""CUDA kernel wrapper: one window frame per request (``csrc/window_agg.cu``).

Counterpart of the TPU kernel ``window_agg_pallas``; the plain version is
:func:`repro_torch.kernels.ref.window_agg_ref`. ``launches`` counts the
kernel launches this process made.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["window_agg_cuda", "launches"]

_ALL_FIELDS = ("sum", "sumsq", "count", "min", "max", "first", "last")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 7 + (_I,) * 7 + (_F, _I, _I) + (_P,) * 7 + (_P,)

launches = 0


def window_agg_cuda(values: torch.Tensor, ts: torch.Tensor,
                    total: torch.Tensor, req_key: torch.Tensor,
                    req_ts: torch.Tensor, *,
                    cols: Optional[Sequence[int]] = None,
                    rows_preceding: Optional[int] = None,
                    range_preceding: Optional[float] = None,
                    evt_mask: Optional[torch.Tensor] = None,
                    assume_latest: bool = False,
                    fields: Optional[Tuple[str, ...]] = None
                    ) -> Dict[str, torch.Tensor]:
    """CUDA implementation of :func:`ref.window_agg_ref`.

    values (K, C, V) f32, ts (K, C) f32, total (K,) i32, req_key (B,) i32,
    req_ts (B,) f32, evt_mask (K, C) bool, all contiguous on one CUDA
    device. A ``req_key`` outside ``[0, K)`` reads as a key with no events.
    More than ``_build.MAX_COLS`` columns take one launch per slice
    (:func:`_build.launch_slices`), each writing its part of the outputs.
    """
    dev = _build.require_cuda(values, "window_agg_cuda")
    if values.dim() != 3:
        raise ValueError(f"values must be (K, C, V), got {tuple(values.shape)}")
    K, C, V = values.shape
    B = req_key.shape[0] if isinstance(req_key, torch.Tensor) else -1
    _build.require(values, "values", torch.float32, (K, C, V), dev)
    _build.require(ts, "ts", torch.float32, (K, C), dev)
    _build.require(total, "total", torch.int32, (K,), dev)
    _build.require(req_key, "req_key", torch.int32, (B,), dev)
    _build.require(req_ts, "req_ts", torch.float32, (B,), dev)
    if evt_mask is not None:
        _build.require(evt_mask, "evt_mask", torch.bool, (K, C), dev)
    if (rows_preceding is None) == (range_preceding is None):
        raise ValueError("exactly one of rows_preceding / range_preceding "
                         "must be given")
    if rows_preceding is not None and rows_preceding < 0:
        raise ValueError(f"rows_preceding must be >= 0, got {rows_preceding}")
    cols = _build.check_cols(cols, V)
    fields, bits = _build.launch_fields(
        None if fields is None else tuple(fields), _ALL_FIELDS)
    Vo = len(cols)
    out = _build.empty_outputs(
        {f: (B,) if f == "count" else (B, Vo) for f in fields}, dev)
    if B == 0:
        return out
    fn = _build.function("window_agg_launch", _ARGTYPES)
    per_col = bits & ~_build.field_bits(("count",))
    for _, _, c0, c1 in _build.launch_slices(1, Vo if per_col else 0):
        table = _build.device_table(cols[c0:c1], dev)
        with torch.cuda.device(dev):
            code = fn(
                values.data_ptr(), ts.data_ptr(), total.data_ptr(),
                req_key.data_ptr(), req_ts.data_ptr(), _build.ptr(evt_mask),
                table.data_ptr(), B, K, C, V, c1 - c0, Vo,
                -1 if rows_preceding is None else int(rows_preceding),
                0.0 if range_preceding is None else float(range_preceding),
                int(assume_latest),
                bits if c0 == 0 else per_col,     # counts: first slice only
                *(_build.ptr(out.get(f), 0 if f == "count" else c0)
                  for f in _ALL_FIELDS),
                _build.stream_of(dev))
        _build.check(code, "window_agg")
        _build.count_launch(sys.modules[__name__])
    return out
