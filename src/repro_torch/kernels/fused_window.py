"""CUDA kernel wrapper: S window frames per request in one launch
(``csrc/fused_window.cu``).

Counterpart of the TPU kernel ``fused_window_pallas``; the plain version is
:func:`repro_torch.kernels.ref.fused_window_ref`. ``launches`` counts the
kernel launches this process made.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import FUSED_FIELDS, check_fused_specs

__all__ = ["fused_window_cuda", "launches"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ((_P,) * 6 + (_I,) * 4 + (_P, _I, _I, _P, _P, _P, _I, _I)
             + (_P,) * 7 + (_P,))

launches = 0


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

    Takes the tensors :func:`window_agg_cuda` takes; at most
    ``_build.MAX_SPECS`` specs. Returns field -> (B, S, Vo), count -> (B, S).
    """
    global launches
    check_fused_specs(spec_rows, spec_ranges, spec_fields)
    S = len(spec_rows)
    if S > _build.MAX_SPECS:
        raise ValueError(f"a fused launch takes at most {_build.MAX_SPECS} "
                         f"specs, got {S}")
    if any(r is not None and r < 0 for r in spec_rows):
        raise ValueError(f"ROWS frames must be >= 0, got {spec_rows}")
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
    fields = tuple(f for f in FUSED_FIELDS
                   if any(f in sf for sf in spec_fields))
    out = {f: torch.empty((B, S) if f == "count" else (B, S, len(cols)),
                          dtype=torch.float32, device=dev) for f in fields}
    if B == 0:
        return out
    fn = _build.function("fused_window_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            _build.ptr(values), _build.ptr(ts), _build.ptr(total),
            _build.ptr(req_key), _build.ptr(req_ts), _build.ptr(evt_mask),
            B, K, C, V, _build.int_array(cols), len(cols), S,
            _build.int_array([-1 if r is None else int(r)
                              for r in spec_rows]),
            _build.float_array([0.0 if r is None else float(r)
                                for r in spec_ranges]),
            _build.int_array([_build.field_bits(sf) for sf in spec_fields]),
            int(assume_latest), _build.field_bits(fields),
            *(_build.ptr(out.get(f)) for f in FUSED_FIELDS),
            _build.stream_of(dev))
    _build.check(code, "fused_window")
    launches += 1
    return out
