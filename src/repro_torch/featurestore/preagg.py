"""Pre-aggregate tier maintenance + verification (paper Eq. 2).

The *incremental* maintenance lives in ``featurestore.table.ingest`` (a
few scatters beside the raw ring-buffer update). This module holds the
non-hot-path companions, all on the state's device:

* ``rebuild_preagg``   — recompute the bucketed tier from raw state
  (retention compaction, corruption recovery);
* ``verify_preagg``    — invariant check: every bucket equals the fold of
  its covered raw slots;
* ``preagg_memory_overhead`` — the paper's materialization cost metric.

Both rebuild and verify walk the keys in chunks: a whole-table temporary
of shape ``(K, C, V)`` is 16 GiB at 2^20 keys × 1024 slots × 4 columns,
so no temporary here holds more than ``CHUNK_ELEMS`` float32 elements
(1 GiB).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.featurestore.table import (NEG_INF, POS_INF, PreAggState,
                                            TableState)

__all__ = ["rebuild_preagg", "verify_preagg", "preagg_memory_overhead",
           "CHUNK_ELEMS"]

CHUNK_ELEMS = 1 << 28      # f32 elements of the largest temporary (1 GiB)


def key_chunks(K: int, per_key: int, chunk_elems: int = CHUNK_ELEMS):
    """``(k0, k1)`` ranges of keys whose ``per_key``-element temporaries
    fit ``chunk_elems``."""
    step = max(1, chunk_elems // max(per_key, 1))
    return [(k0, min(k0 + step, K)) for k0 in range(0, K, step)]


def _live_slots(total: torch.Tensor, C: int) -> torch.Tensor:
    """(k, C) bool: ring slot ``c`` of each key holds a retained event.

    Slot ``c`` holds global position ``p = total-1 - ((total%C - 1 - c)
    % C)``; it is retained iff ``max(total-C, 0) <= p < total``."""
    tot = total.long()[:, None]
    c_idx = torch.arange(C, dtype=torch.int64, device=total.device)[None, :]
    back = torch.remainder(torch.remainder(tot, C) - 1 - c_idx, C)
    p = tot - 1 - back
    return (p >= torch.clamp(tot - C, min=0)) & (p < tot)


def rebuild_preagg(state: TableState, *, bucket_size: int,
                   chunk_elems: int = CHUNK_ELEMS) -> PreAggState:
    """Recompute the bucketed tier from the raw ring buffers.

    Bucket slot ``b`` covers raw slots ``[b*B, (b+1)*B)`` *of the ring*;
    because C % B == 0, ring slots of one bucket always belong to the same
    global bucket index, so a bucket folds exactly its live slots (count 0
    and the ±3e38 sentinels where none is live).
    """
    K, C, V = state.values.shape
    B = bucket_size
    nb = C // B
    dev = state.values.device
    f32 = torch.float32
    out = PreAggState(
        sum=torch.empty((K, nb, V), dtype=f32, device=dev),
        sumsq=torch.empty((K, nb, V), dtype=f32, device=dev),
        min=torch.empty((K, nb, V), dtype=f32, device=dev),
        max=torch.empty((K, nb, V), dtype=f32, device=dev),
        count=torch.empty((K, nb), dtype=f32, device=dev))
    for k0, k1 in key_chunks(K, C * V, chunk_elems):
        n = k1 - k0
        live = _live_slots(state.total[k0:k1], C).view(n, nb, B, 1)
        grp = state.values[k0:k1].view(n, nb, B, V)
        masked = torch.where(live, grp, 0.0)
        out.sum[k0:k1] = masked.sum(2)
        out.sumsq[k0:k1] = (masked * masked).sum(2)
        del masked
        out.min[k0:k1] = torch.where(live, grp, POS_INF).amin(2)
        out.max[k0:k1] = torch.where(live, grp, NEG_INF).amax(2)
        out.count[k0:k1] = live[..., 0].sum(2, dtype=f32)
    return out


def verify_preagg(state: TableState, preagg: PreAggState, *,
                  bucket_size: int, atol: float = 1e-3,
                  chunk_elems: int = CHUNK_ELEMS) -> Tuple[bool, float]:
    """Check the live portion of the incremental tier against a rebuild.

    Only buckets that are *fully live* (all B covered positions retained
    and in the same global bucket) are comparable — partially-overwritten
    buckets are never read by the query path either (the kernel fetches
    raw tails for them). A bucket's error is the largest absolute
    difference of its sums and of its count. Returns (ok, max_abs_err over
    compared buckets), ok iff no error exceeds ``atol``.
    """
    K, C, V = state.values.shape
    B = bucket_size
    nb = C // B
    ref = rebuild_preagg(state, bucket_size=bucket_size,
                         chunk_elems=chunk_elems)
    dev = state.values.device
    b_idx = torch.arange(nb, dtype=torch.int64, device=dev)[None, :]
    worst = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for k0, k1 in key_chunks(K, nb * V, chunk_elems):
        tot = state.total[k0:k1].long()[:, None]
        # bucket slot b holds global bucket g with g % nb == b; the live
        # one is the largest such g <= (tot-1) // B
        hi = torch.div(tot - 1, B, rounding_mode="floor")
        g = hi - torch.remainder(hi - b_idx, nb)
        start, end = g * B, (g + 1) * B
        cmp = ((tot > 0) & (g >= 0) & (start >= torch.clamp(tot - C, min=0))
               & (end <= tot))
        e = (preagg.sum[k0:k1] - ref.sum[k0:k1]).abs().amax(2)
        e = torch.maximum(e, (preagg.count[k0:k1]
                              - ref.count[k0:k1]).abs())
        e = torch.where(cmp, e, 0.0)
        worst = torch.maximum(worst, e.max())
        bad = bad | (e > atol).any()
    return not bool(bad), float(worst)


def preagg_memory_overhead(state: TableState,
                           preagg: Optional[PreAggState]) -> float:
    """Materialization bytes as a fraction of raw storage (paper's
    caching-cost accounting)."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    raw = nbytes((state.values, state.ts, state.total))
    if preagg is None:
        return 0.0
    return nbytes((preagg.sum, preagg.sumsq, preagg.min, preagg.max,
                   preagg.count)) / raw
