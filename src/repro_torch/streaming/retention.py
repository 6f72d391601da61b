"""TTL/retention: event-time expiry for the ring-buffer + preagg tiers.

The ring buffer evicts *positionally* (capacity C keeps the newest C
events per key) — OpenMLDB's ``ttl_type=latest``. Its ``ttl_type=absolute``
(drop events older than a time horizon) has no positional analogue, so it
is periodic **compaction**: rewrite each key's live events with the
expired ones removed, reset the per-key totals, and rebuild the bucketed
pre-aggregate tier from the compacted raw state via ``rebuild_preagg``.

Compaction runs on the state's device and produces fresh tensors (it
never mutates in place), so it composes with the streaming double-buffer
protocol: build the compacted state off to the side, then
``Table.publish`` it atomically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.featurestore.preagg import (CHUNK_ELEMS, key_chunks,
                                             rebuild_preagg)
from repro_torch.featurestore.table import (PreAggState, Table, TableState,
                                            empty_state)

__all__ = ["RetentionPolicy", "compact_expired", "apply_retention"]


@dataclass(frozen=True)
class RetentionPolicy:
    """``ttl`` is in event-time units (same clock as event timestamps).

    ``every_n_flushes`` throttles how often the pipeline pays the
    compaction rebuild; 0 disables time-based retention entirely.
    """

    ttl: float = 0.0
    every_n_flushes: int = 50

    @property
    def enabled(self) -> bool:
        return self.ttl > 0


def compact_expired(state: TableState, *, cutoff: float,
                    bucket_size: int = 0, with_preagg: bool = True,
                    chunk_elems: int = CHUNK_ELEMS
                    ) -> Tuple[TableState, Optional[PreAggState], int]:
    """Drop every event with ``ts < cutoff``; repack survivors at global
    positions ``[0, n_kept)`` per key. Returns ``(state, preagg | None,
    n_dropped)``.

    Per key, in chunks of keys: the retained events in position order
    (slot ``p % C`` for ``p`` in ``[total - min(total, C), total)``), their
    keep mask ``ts >= cutoff``, each survivor's new position from the
    running count of survivors before it (so the relative order is
    kept), and one scatter into a fresh ``empty_state``. The compacted
    state satisfies the same invariants as a freshly ingested one.
    """
    K, C, V = state.values.shape
    dev = state.values.device
    out = empty_state(K, C, V, dev)
    cut = torch.tensor(cutoff, dtype=torch.float32, device=dev)
    order = torch.arange(C, dtype=torch.int64, device=dev)[None, :]
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    # per key: a few (C,) int64 index rows and one (C, V) gather
    for k0, k1 in key_chunks(K, C * max(V, 2), chunk_elems):
        tot = state.total[k0:k1].long()[:, None]
        n_live = torch.clamp(tot, max=C)
        valid = order < n_live                          # (k, C)
        slot = torch.remainder(tot - n_live + order, C)
        ts = state.ts[k0:k1].gather(1, slot)
        keep = valid & (ts >= cut)
        dest = keep.cumsum(1) - 1
        kk, jj = keep.nonzero(as_tuple=True)
        rows = kk + k0
        out.ts[rows, dest[kk, jj]] = ts[kk, jj]
        out.values[rows, dest[kk, jj]] = state.values[rows, slot[kk, jj]]
        n_kept = keep.sum(1)
        out.total[k0:k1] = n_kept.to(torch.int32)
        dropped += (n_live[:, 0] - n_kept).sum()
    preagg = None
    if with_preagg and bucket_size > 0:
        preagg = rebuild_preagg(out, bucket_size=bucket_size,
                                chunk_elems=chunk_elems)
    return out, preagg, int(dropped)


def apply_retention(table: Table, policy: RetentionPolicy, *,
                    now: float) -> int:
    """Compact ``table`` (atomic publish); returns events dropped.

    ``now`` is the stream's **global** event-time clock — the pipeline
    passes the maximum released event time. Keys whose own timeline lags
    that clock lose events older than ``now - ttl`` like everyone else:
    absolute-TTL semantics (OpenMLDB ``ttl_type=absolute``), deliberately
    not per-key. Repair is unaffected — the reorder buffer's frontier,
    not table contents, decides late-event acceptance.
    """
    if not policy.enabled:
        return 0
    cutoff = now - policy.ttl
    snap = table.snapshot()
    new_state, new_preagg, n_dropped = compact_expired(
        snap.state, cutoff=cutoff, bucket_size=table.bucket_size,
        with_preagg=snap.preagg is not None)
    if n_dropped == 0:
        return 0
    table.publish(new_state, new_preagg)
    return n_dropped
