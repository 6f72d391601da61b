"""Kernel entry points, dispatched by the device of the tensors.

Each op has a hand-written CUDA kernel (``repro_torch.kernels.<name>``)
and a plain PyTorch version (``repro_torch.kernels.ref``):

* tensors on a CUDA device launch the kernel (whose wrapper raises on
  anything it cannot take);
* tensors on the CPU take the plain version.

There is no switch and no fallback: a CUDA tensor never takes the plain
path. Callers that want the plain version on the card call ``ref`` by name.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_window import fused_window_cuda
from repro_torch.kernels.last_join import last_join_cuda
from repro_torch.kernels.preagg_window import preagg_window_cuda
from repro_torch.kernels.window_agg import window_agg_cuda

__all__ = ["window_agg", "fused_window", "preagg_window", "last_join"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def window_agg(values: torch.Tensor, ts: torch.Tensor, total: torch.Tensor,
               req_key: torch.Tensor, req_ts: torch.Tensor, *,
               cols: Optional[Sequence[int]] = None,
               rows_preceding: Optional[int] = None,
               range_preceding: Optional[float] = None,
               evt_mask: Optional[torch.Tensor] = None,
               assume_latest: bool = False,
               fields: Optional[Tuple[str, ...]] = None
               ) -> Dict[str, torch.Tensor]:
    """Fused multi-aggregate sliding-window scan (naive path)."""
    fn = window_agg_cuda if _on_cuda(values) else ref.window_agg_ref
    return fn(values, ts, total, req_key, req_ts, cols=cols,
              rows_preceding=rows_preceding, range_preceding=range_preceding,
              evt_mask=evt_mask, assume_latest=assume_latest, fields=fields)


def fused_window(values: torch.Tensor, ts: torch.Tensor,
                 total: torch.Tensor, req_key: torch.Tensor,
                 req_ts: torch.Tensor, *,
                 spec_rows: Tuple[Optional[int], ...],
                 spec_ranges: Tuple[Optional[float], ...],
                 spec_fields: Tuple[Tuple[str, ...], ...],
                 cols: Optional[Sequence[int]] = None,
                 evt_mask: Optional[torch.Tensor] = None,
                 assume_latest: bool = False) -> Dict[str, torch.Tensor]:
    """Single-scan fused MULTI-WINDOW aggregation: every spec of the static
    per-deployment spec table in one launch. Returns field -> (B, S, Vo)
    (count -> (B, S)); fields a spec did not request are zero."""
    fn = fused_window_cuda if _on_cuda(values) else ref.fused_window_ref
    return fn(values, ts, total, req_key, req_ts, spec_rows=spec_rows,
              spec_ranges=spec_ranges, spec_fields=spec_fields, cols=cols,
              evt_mask=evt_mask, assume_latest=assume_latest)


def last_join(values: torch.Tensor, ts: torch.Tensor, total: torch.Tensor,
              req_key: torch.Tensor, req_ts: torch.Tensor, *,
              col_idx: Tuple[int, ...],
              assume_latest: bool = False,
              with_ts: bool = False) -> Tuple[torch.Tensor, ...]:
    """Point-in-time LAST JOIN row lookup against a right table's ring:
    ``(row (B, len(col_idx)) f32, matched (B,) bool[, sel_ts (B,) f32])``."""
    fn = last_join_cuda if _on_cuda(values) else ref.last_join_ref
    return fn(values, ts, total, req_key, req_ts, col_idx=col_idx,
              assume_latest=assume_latest, with_ts=with_ts)


def preagg_window(values: torch.Tensor, ts: torch.Tensor,
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
    """Pre-aggregated window lookup (paper Eq. 2 path)."""
    fn = preagg_window_cuda if _on_cuda(values) else ref.preagg_window_ref
    return fn(values, ts, total, pa_sum, pa_sumsq, pa_min, pa_max, pa_count,
              req_key, req_ts, bucket_size=bucket_size, cols=cols,
              rows_preceding=rows_preceding, range_preceding=range_preceding,
              assume_latest=assume_latest, fields=fields)
