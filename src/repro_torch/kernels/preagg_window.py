"""CUDA kernel wrapper: the pre-aggregated window of paper Eq. 2
(``csrc/preagg_window.cu``).

Counterpart of the TPU kernel ``preagg_window_pallas``; the plain version
is :func:`repro_torch.kernels.ref.preagg_window_ref`. ``launches`` counts
the kernel launches this process made. :func:`window_split` says which of
the kernel's paths a batch of requests takes (for its tests).
"""
from __future__ import annotations

import ctypes
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import window_bounds

__all__ = ["preagg_window_cuda", "launches", "window_split", "SHAPES"]

_ALL_FIELDS = ("sum", "sumsq", "count", "min", "max")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 11 + (_I,) * 9 + (_F, _I, _I) + (_P,) * 5 + (_P,)

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
    More than ``_build.MAX_COLS`` columns take one launch per slice.
    """
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
    fields, bits = _build.launch_fields(
        None if fields is None else tuple(fields), _ALL_FIELDS)
    out = _build.empty_outputs(
        {f: (B,) if f == "count" else (B, len(cols)) for f in fields}, dev)
    if B == 0:
        return out
    fn = _build.function("preagg_window_launch", _ARGTYPES)
    Vo = len(cols)
    per_col = bits & ~_build.field_bits(("count",))
    for _, _, c0, c1 in _build.launch_slices(1, Vo if per_col else 0):
        table = _build.device_table(cols[c0:c1], dev)
        with torch.cuda.device(dev):
            code = fn(
                _build.ptr(values), _build.ptr(ts), _build.ptr(total),
                _build.ptr(pa_sum), _build.ptr(pa_sumsq), _build.ptr(pa_min),
                _build.ptr(pa_max), _build.ptr(pa_count), _build.ptr(req_key),
                _build.ptr(req_ts), table.data_ptr(), B, K, C, V, NB,
                int(bucket_size), c1 - c0, Vo,
                -1 if rows_preceding is None else int(rows_preceding),
                0.0 if range_preceding is None else float(range_preceding),
                int(assume_latest),
                bits if c0 == 0 else per_col,     # counts: first slice only
                *(_build.ptr(out.get(f), 0 if f == "count" else c0)
                  for f in _ALL_FIELDS),
                _build.stream_of(dev))
        _build.check(code, "preagg_window")
        _build.count_launch(sys.modules[__name__])
    return out


SHAPES = ("head only", "one bucket", "many buckets", "head + buckets + tail")


def window_split(ts: torch.Tensor, total: torch.Tensor,
                 req_key: torch.Tensor, req_ts: torch.Tensor, *,
                 bucket_size: int, rows_preceding: Optional[int] = None,
                 range_preceding: Optional[float] = None,
                 assume_latest: bool = False) -> Dict[str, object]:
    """How the kernel splits each request's window [p0, p1): the full
    buckets [b0, b1), b0 = ceil(p0 / bucket), b1 = floor(p1 / bucket), and
    the raw head [p0, b0·bucket) and tail [b1·bucket, p1) positions (all of
    the window is head where no bucket boundary falls inside it).

    Keys must lie in ``[0, K)``. Returns the (B,) int tensors ``buckets``
    and ``raw`` (head + tail positions) and ``shapes``, the set of
    :data:`SHAPES` the windows take."""
    k = req_key.long()
    p0, p1 = window_bounds(ts[k], total[k], req_ts,
                           rows_preceding=rows_preceding,
                           range_preceding=range_preceding,
                           assume_latest=assume_latest)
    b0, b1 = (p0 + bucket_size - 1) // bucket_size, p1 // bucket_size
    has = b0 <= b1
    buckets = torch.where(has, b1 - b0, torch.zeros_like(b0))
    head = torch.where(has, b0 * bucket_size - p0, p1 - p0)
    tail = torch.where(has, p1 - b1 * bucket_size, torch.zeros_like(p1))
    found = {"head only": (buckets == 0) & (p1 > p0),
             "one bucket": buckets == 1, "many buckets": buckets >= 2,
             "head + buckets + tail": (buckets > 0) & (head > 0) & (tail > 0)}
    return {"buckets": buckets, "raw": head + tail,
            "shapes": {n for n in SHAPES if bool(found[n].any())}}
