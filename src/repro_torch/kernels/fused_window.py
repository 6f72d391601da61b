"""CUDA kernel wrapper: S window frames per request in one launch
(``csrc/fused_window.cu``).

Counterpart of the TPU kernel ``fused_window_pallas``; the plain version is
:func:`repro_torch.kernels.ref.fused_window_ref`. ``launches`` counts the
kernel launches this process made.
"""
from __future__ import annotations

import ctypes
import sys
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import FUSED_FIELDS, check_fused_specs

__all__ = ["fused_window_cuda", "spec_table", "launches"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 7 + (_I,) * 11 + (_P,) * 7 + (_P,)

launches = 0


@functools.lru_cache(maxsize=256)
def spec_table(spec_rows: Tuple[Optional[int], ...],
               spec_ranges: Tuple[Optional[float], ...],
               spec_fields: Tuple[Tuple[str, ...], ...]):
    """A validated spec table as the launches take it, built once per
    static table: ``(fields, present, any_range, specs)`` — the fields the
    call materialises (in ``FUSED_FIELDS`` order) and their bits, whether
    a spec is a RANGE frame, and per spec the ``(rows, bits, span)``
    triple :func:`_build.device_table` packs (rows -1 for RANGE, span 0.0
    for ROWS)."""
    check_fused_specs(spec_rows, spec_ranges, spec_fields)
    if any(r is not None and r < 0 for r in spec_rows):
        raise ValueError(f"ROWS frames must be >= 0, got {spec_rows}")
    fields = tuple(f for f in FUSED_FIELDS
                   if any(f in sf for sf in spec_fields))
    specs = tuple((-1 if r is None else int(r), _build.field_bits(sf),
                   0.0 if g is None else float(g))
                  for r, g, sf in zip(spec_rows, spec_ranges, spec_fields))
    return (fields, _build.field_bits(fields),
            any(r is None for r in spec_rows), specs)


def fused_window_cuda(values: torch.Tensor, ts: torch.Tensor,
                      total: torch.Tensor, req_key: torch.Tensor,
                      req_ts: torch.Tensor, *,
                      spec_rows: Tuple[Optional[int], ...],
                      spec_ranges: Tuple[Optional[float], ...],
                      spec_fields: Tuple[Tuple[str, ...], ...],
                      cols: Optional[Sequence[int]] = None,
                      evt_mask: Optional[torch.Tensor] = None,
                      assume_latest: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """CUDA implementation of :func:`ref.fused_window_ref`.

    Takes the tensors :func:`window_agg_cuda` takes. Returns field ->
    (B, S, Vo), count -> (B, S). A table of more than ``_build.MAX_SPECS``
    specs or ``_build.MAX_COLS`` columns takes one launch per slice
    (:func:`_build.launch_slices`), each writing its part of the outputs.
    """
    fields, present, any_range, specs = spec_table(
        tuple(spec_rows), tuple(spec_ranges),
        tuple(tuple(sf) for sf in spec_fields))
    S = len(spec_rows)
    dev = _build.require_cuda(values, "fused_window_cuda")
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
    cols = _build.check_cols(cols, V)
    out = _build.empty_outputs(
        {f: (B, S) if f == "count" else (B, S, len(cols)) for f in fields},
        dev)
    if B == 0:
        return out
    fn = _build.function("fused_window_launch", _ARGTYPES)
    Vo = len(cols)
    per_col = present & ~_build.field_bits(("count",))
    for s0, s1, c0, c1 in _build.launch_slices(S, Vo if per_col else 0):
        table = _build.device_table(cols[c0:c1], dev, specs[s0:s1])
        # the counts come with the first column slice
        bits = present if c0 == 0 else per_col
        with torch.cuda.device(dev):
            code = fn(
                values.data_ptr(), ts.data_ptr(), total.data_ptr(),
                req_key.data_ptr(), req_ts.data_ptr(), _build.ptr(evt_mask),
                table.data_ptr(), B, K, C, V, c1 - c0, s1 - s0, S, Vo,
                int(any_range and any(r < 0 for r, _, _ in specs[s0:s1])),
                int(assume_latest), bits,
                *(_build.ptr(out.get(f), s0 if f == "count"
                             else s0 * Vo + c0) for f in FUSED_FIELDS),
                _build.stream_of(dev))
        _build.check(code, "fused_window")
        _build.count_launch(sys.modules[__name__])
    return out
