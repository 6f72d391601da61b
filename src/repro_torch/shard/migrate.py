"""Key-range migration primitives for consistent-hash resharding.

Two operations over a plain :class:`repro_torch.core.engine.Engine`:

* :func:`extract_events` — read a set of keys' **retained** events out
  of a table's published snapshot, globally ts-sorted with per-key
  arrival order preserved (stable sort), ready to re-insert elsewhere.
  The rows are gathered on the table's device for all the keys of one
  call at once, and only those rows cross to the host: a shard's table
  at production size is several GiB, and moving a key must not copy it.
* :func:`migrate_in` — insert extracted events into a target engine,
  skipping any prefix the target already holds. The skip matters because
  migration never physically deletes the source copy (stale rows are
  harmless — routing never sends readers there, and ``query_offline``
  filters by current ownership): a key that moves A→B and later back
  B→A finds its pre-move history still on A, and re-inserting it would
  both duplicate rows and violate the table's per-key non-decreasing-ts
  invariant. Events strictly newer than the target's last ts are always
  inserted; at an equal-ts boundary the target's tail count at that ts
  decides how many of the source's equal-ts events are new (exact unless
  capacity trimming split an equal-ts run — a documented edge; see
  DESIGN.md §11).

A key new on the target keeps its source's ring positions: ``extract_events``
can return each key's ``total`` beside its rows, and ``migrate_in`` seats
such a key at ``[total−n, total)`` (``Table.seat``), so a key whose ring had
wrapped keeps its slots and its pre-aggregate bucket grouping, and the
target's state for it equals the source's bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["extract_events", "migrate_in", "list_keys"]


def list_keys(eng, table: str) -> List:
    """All keys materialised in ``table`` on this engine."""
    return list(eng.tables[table].key_to_idx.keys())


def _retained(tab, idxs: Sequence[int]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The retained events of key slots ``idxs`` in the published
    snapshot: ``(counts (k,), ts (n,), rows (n, V), totals (k,))``, key by key in the
    order given, each key's events oldest first — the ring enumeration
    ``query_offline`` uses. ``total`` of the slots is read first (one
    small copy); the slots' ring rows are then gathered on the device and
    only they are copied to the host."""
    st = tab.snapshot().state
    C = st.capacity
    V = st.values.shape[2]
    kd = tab.put(np.asarray(idxs, np.int64))
    tot = st.total[kd].cpu().numpy().astype(np.int64)
    n = np.minimum(tot, C)
    N = int(n.sum())
    if N == 0:
        return (n, np.zeros((0,), np.float32),
                np.zeros((0, V), np.float32), tot)
    which = np.repeat(np.arange(len(n)), n)
    first = np.cumsum(n) - n
    pos = (tot - n)[which] + (np.arange(N) - first[which])
    kt = kd[tab.put(which)]
    slot = tab.put(pos % C)
    ts = st.ts[kt, slot].cpu().numpy().astype(np.float32)
    rows = st.values[kt, slot].cpu().numpy().astype(np.float32)
    return n, ts, rows, tot


def extract_events(eng, table: str, keys: Sequence, *,
                   with_totals: bool = False) -> Tuple:
    """Pull the retained events of ``keys`` from ``table``'s published
    snapshot. Returns ``(keys, ts, rows)`` globally ts-sorted (stable,
    so per-key order survives the merge); empty arrays when none of the
    keys have rows. ``with_totals`` adds a fourth item, ``{key: total}``
    for the keys returned: each key's count of events ever ingested,
    whose last ``n`` are its ``n`` retained rows."""
    tab = eng.tables[table]
    V = len(tab.schema.value_cols)
    k2i = tab.key_to_idx
    present = [k for k in keys if k in k2i]
    empty = ([], np.zeros((0,), np.float32), np.zeros((0, V), np.float32))
    if not present:
        return empty + ({},) if with_totals else empty
    with torch.no_grad():
        n, ts, rows, tot = _retained(tab, [k2i[k] for k in present])
    if not len(ts):
        return empty + ({},) if with_totals else empty
    out_k = [k for k, c in zip(present, n.tolist()) for _ in range(c)]
    order = np.argsort(ts, kind="stable")
    out = ([out_k[int(i)] for i in order], ts[order], rows[order])
    if not with_totals:
        return out
    return out + ({k: int(t) for k, c, t in zip(present, n.tolist(),
                                                  tot.tolist()) if c},)


def _seat_and_split(tab, keys: Sequence, idxs: np.ndarray,
                    totals: Dict) -> List[np.ndarray]:
    """Seat the keys in ``idxs`` that are new on ``tab`` at their source
    positions (``totals[key] − n``), and split ``idxs`` into the insert
    calls that keep the pre-aggregate tier equal to the source's: a new
    key whose first position is inside a bucket (its oldest bucket lost
    its head to the ring) gets those first events in a call of their own.
    In one call they would share a bucket slot with the key's newest
    bucket, whose start resets the slot before the call folds its rows,
    and so be summed into it; on the source that bucket was reset after
    them."""
    sel = [keys[int(i)] for i in idxs]
    n: Dict = {}
    for k in sel:
        n[k] = n.get(k, 0) + 1
    start = {k: totals[k] - c for k, c in n.items()
             if k in totals and k not in tab.key_to_idx}
    if not start:
        return [idxs]
    tab.seat(start)
    B = tab.bucket_size
    head = np.zeros(len(idxs), bool)
    seen: Dict = {}
    for j, k in enumerate(sel):
        p0 = start.get(k)
        if p0 is None or p0 % B == 0:
            continue
        r = seen.get(k, 0)
        seen[k] = r + 1
        head[j] = p0 + r < (p0 // B + 1) * B
    if not head.any():
        return [idxs]
    return [idxs[head], idxs[~head]]


def migrate_in(eng, table: str, keys: Sequence, ts: np.ndarray,
               rows: np.ndarray, totals: Optional[Dict] = None) -> int:
    """Insert extracted events into this engine's ``table``, skipping
    whatever prefix the target already holds (stale copy from an earlier
    migration-out). ``totals`` (``extract_events(..., with_totals=True)``)
    seats keys new on the target at their source's ring positions.
    Returns the number of events inserted."""
    if not len(keys):
        return 0
    tab = eng.tables[table]
    ts = np.asarray(ts, np.float32)
    rows = np.asarray(rows, np.float32)
    last = tab.last_ts_by_key()
    # equal-ts boundary: how many events at exactly last_ts the target
    # retains per key — that many of the source's equal-ts events are the
    # shared prefix, the rest are genuinely new
    eq_seen: Dict[object, int] = {}
    keep = np.zeros(len(keys), bool)
    for i, k in enumerate(keys):
        lt = last.get(k)
        t = float(ts[i])
        if lt is None or t > lt:
            keep[i] = True
        elif t == lt:
            if k not in eq_seen:
                _n, kts, _r, _t = _retained(tab, [tab.key_to_idx[k]])
                eq_seen[k] = int(np.sum(kts == np.float32(lt)))
            if eq_seen[k] > 0:
                eq_seen[k] -= 1          # shared-prefix event: skip it
            else:
                keep[i] = True           # new event at the boundary ts
    idxs = np.flatnonzero(keep)
    if not idxs.size:
        return 0
    parts = ([idxs] if totals is None
             else _seat_and_split(tab, keys, idxs, totals))
    # donate=False: the target engine is LIVE — a lane thread may be
    # serving off a snapshot of this table right now, and an in-place
    # ingest would change the rows under it
    for part in parts:
        eng.insert(table, [keys[int(i)] for i in part],
                   ts[part].tolist(), rows[part], donate=False)
    return int(idxs.size)
