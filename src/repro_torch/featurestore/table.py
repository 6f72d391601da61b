"""In-memory time-series event storage: per-key ring buffers + pre-aggregates.

A table is a set of **dense preallocated ring buffers** on one device:

    values : (K, C, V) float32   — V value columns for K keys, capacity C
    ts     : (K, C)    float32   — event timestamps (ingest order == ts order)
    total  : (K,)      int32     — monotone count of events ever ingested

Event ``p`` (the p-th event of a key, 0-based, over all time) lives at slot
``p % C``; retained events are ``p ∈ [max(0, total-C), total)``. This gives
O(1) append, free eviction and contiguous window scans.

Pre-aggregation (paper Eq. 2) is a second tier of **bucketed partial
aggregates**: bucket ``b`` covers positions ``[b·B, (b+1)·B)`` and is stored
at slot ``b % NB`` where ``NB = C // B``. A window ``[p0, p1)`` is then
`sum(full buckets) + head partial + tail partial`, turning O(W) scans into
O(W/B + 2B) — the tensor form of OpenMLDB's ``F(t) − F(t−W)``.

The host-side ``Table`` owns the key→index dict (hash lookups stay on the
CPU in OpenMLDB too) and the published snapshot; ingest is a handful of
PyTorch scatters on the table's device. ``donate=True`` ingest updates the
published tensors in place (a snapshot handed out earlier sees the
update); ``donate=False`` ingests into copies, so earlier snapshots stay
unchanged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.featurestore.keydir import KeyDirectory
from repro_torch.obs.sketch import CardinalityEstimator, QuantileSketch

__all__ = ["TableSchema", "TableState", "PreAggState", "Table",
           "TableSnapshot", "empty_state", "empty_preagg", "ingest",
           "resolve_device", "NEG_INF", "POS_INF"]

NEG_INF = -3.0e38
POS_INF = 3.0e38


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a CUDA card.
    The port never moves to the CPU on its own: the CPU is asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev


@dataclass(frozen=True)
class TableSchema:
    name: str
    key_col: str
    ts_col: str
    value_cols: Tuple[str, ...]

    def col_index(self, col: str) -> int:
        try:
            return self.value_cols.index(col)
        except ValueError:
            raise KeyError(
                f"table {self.name!r} has no value column {col!r}; "
                f"columns: {list(self.value_cols)}") from None


@dataclass
class TableState:
    """Device-resident ring-buffer storage."""

    values: torch.Tensor  # (K, C, V) f32
    ts: torch.Tensor      # (K, C) f32
    total: torch.Tensor   # (K,) i32

    @property
    def capacity(self) -> int:
        return self.ts.shape[1]

    @property
    def max_keys(self) -> int:
        return self.ts.shape[0]

    def clone(self) -> "TableState":
        return TableState(self.values.clone(), self.ts.clone(),
                          self.total.clone())


@dataclass
class PreAggState:
    """Bucketed partial aggregates. ``NB = C // bucket_size``."""

    sum: torch.Tensor     # (K, NB, V) f32
    sumsq: torch.Tensor   # (K, NB, V) f32
    min: torch.Tensor     # (K, NB, V) f32
    max: torch.Tensor     # (K, NB, V) f32
    count: torch.Tensor   # (K, NB)    f32  (filtered count support)

    @property
    def n_buckets(self) -> int:
        return self.count.shape[1]

    def clone(self) -> "PreAggState":
        return PreAggState(self.sum.clone(), self.sumsq.clone(),
                           self.min.clone(), self.max.clone(),
                           self.count.clone())


def empty_state(max_keys: int, capacity: int, n_cols: int,
                device) -> TableState:
    return TableState(
        values=torch.zeros((max_keys, capacity, n_cols), dtype=torch.float32,
                           device=device),
        ts=torch.full((max_keys, capacity), NEG_INF, dtype=torch.float32,
                      device=device),
        total=torch.zeros((max_keys,), dtype=torch.int32, device=device),
    )


def empty_preagg(max_keys: int, capacity: int, n_cols: int,
                 bucket_size: int, device) -> PreAggState:
    if capacity % bucket_size != 0:
        raise ValueError(f"capacity {capacity} must be a multiple of "
                         f"bucket_size {bucket_size}")
    nb = capacity // bucket_size
    shape = (max_keys, nb, n_cols)
    f32 = torch.float32
    return PreAggState(
        sum=torch.zeros(shape, dtype=f32, device=device),
        sumsq=torch.zeros(shape, dtype=f32, device=device),
        min=torch.full(shape, POS_INF, dtype=f32, device=device),
        max=torch.full(shape, NEG_INF, dtype=f32, device=device),
        count=torch.zeros((max_keys, nb), dtype=f32, device=device),
    )


def _batch_seq_numbers(key_idx: torch.Tensor) -> torch.Tensor:
    """seq[i] = #{j < i : key[j] == key[i]} — per-key arrival rank inside one
    ingest batch. O(B²) elementwise, fine for B ≤ capacity."""
    b = key_idx.shape[0]
    same = key_idx[:, None] == key_idx[None, :]
    lower = torch.ones((b, b), dtype=torch.bool,
                       device=key_idx.device).tril(-1)
    return (same & lower).sum(1)


def _to_host(t: torch.Tensor):
    """A device tensor's copy into pinned host memory, queued on the
    current stream (read it after the stream is synchronized); a CPU
    tensor as it is."""
    if t.device.type != "cuda":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, copied from pinned memory without
    blocking the host on the card."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _fold_sums(preagg: PreAggState, kl: torch.Tensor, bslot: torch.Tensor,
               vals: torch.Tensor) -> None:
    """Add each row into its bucket's sum and sumsq, the rows of one
    bucket slot in arrival order: ``((s + v1) + v2) + ...``.

    A single ``index_put_(accumulate=True)`` folds duplicate indices in
    order on the CPU but not on the card, where a bucket's sum would then
    depend on how its events were split into insert batches (a sharded
    table splits them differently from an unsharded one). Here the
    touched slots' sums and the rows come to the host in one synchronized
    copy, numpy adds the rows to them one rank per pass (float32, so each
    step rounds as the device would), and the results go back in one
    write. The tier is then a function of each key's events alone, on
    both devices. The one wait for the device lets another host thread
    run once per insert, not once per copy."""
    K, nb, V = preagg.sum.shape
    s, q = preagg.sum.view(K * nb, V), preagg.sumsq.view(K * nb, V)
    flat = kl * nb + bslot
    host = [_to_host(t) for t in (flat, vals, s[flat], q[flat])]
    if flat.device.type == "cuda":
        torch.cuda.current_stream(flat.device).synchronize()
    f, v, cur_s, cur_q = (t.numpy() for t in host)
    slots, first, inv = np.unique(f, return_index=True, return_inverse=True)
    out_s, out_q = cur_s[first], cur_q[first]
    vq = v * v
    order = np.argsort(inv, kind="stable")
    start = np.searchsorted(inv[order], np.arange(len(slots)))
    rank = np.empty(len(f), np.int64)
    rank[order] = np.arange(len(f)) - start[inv[order]]
    for r in range(int(rank.max()) + 1 if len(f) else 0):
        rows = np.flatnonzero(rank == r)
        out_s[inv[rows]] += v[rows]
        out_q[inv[rows]] += vq[rows]
    idx = _to_device(slots, s.device)
    s[idx] = _to_device(out_s, s.device)
    q[idx] = _to_device(out_q, q.device)


def ingest(state: TableState, preagg: Optional[PreAggState],
           key_idx: torch.Tensor, ts: torch.Tensor, vals: torch.Tensor,
           *, bucket_size: int = 0) -> None:
    """Append a batch of events IN PLACE. ``key_idx (B,) int``, ``ts (B,)
    f32``, ``vals (B, V) f32``, all on the state's device. Events must
    arrive in non-decreasing ts order per key, at most ``capacity`` events
    per key in one batch.

    Maintains the raw ring buffer and (if ``preagg`` given) the bucketed
    pre-aggregate tier. Several events of one key in a batch take
    consecutive positions; the tier folds them into their buckets in
    arrival order (``_fold_sums``) and takes mins and maxes.
    """
    C, K = state.capacity, state.max_keys
    kl = key_idx.long()
    pos = state.total[kl].long() + _batch_seq_numbers(kl)   # global position
    slot = pos % C
    state.values[kl, slot] = vals
    state.ts[kl, slot] = ts
    state.total.index_add_(0, kl, torch.ones_like(kl, dtype=torch.int32))
    if preagg is None:
        return
    B = bucket_size
    nb = preagg.n_buckets
    bslot = (pos // B) % nb
    # reset the slots whose bucket (re)starts in this batch, then
    # accumulate. Two bucket-start rows never share a slot in one
    # ≤capacity batch, and only start rows are written here.
    start = (pos % B) == 0
    rk, rb = kl[start], bslot[start]
    preagg.sum[rk, rb] = 0.0
    preagg.sumsq[rk, rb] = 0.0
    preagg.min[rk, rb] = POS_INF
    preagg.max[rk, rb] = NEG_INF
    preagg.count[rk, rb] = 0.0
    _fold_sums(preagg, kl, bslot, vals)
    preagg.count.index_put_((kl, bslot),
                            torch.ones_like(ts), accumulate=True)
    flat = (kl * nb + bslot)[:, None].expand_as(vals)
    V = vals.shape[1]
    preagg.min.view(K * nb, V).scatter_reduce_(0, flat, vals, "amin",
                                               include_self=True)
    preagg.max.view(K * nb, V).scatter_reduce_(0, flat, vals, "amax",
                                               include_self=True)


@dataclass(frozen=True)
class TableSnapshot:
    """A consistent (state, preagg) pair.

    ``version`` increments on every publish. ``watermark`` is the max
    event-time the state covers, ``published_at`` the wall-clock instant it
    was swapped in.
    """

    state: TableState
    preagg: Optional[PreAggState]
    version: int
    watermark: float = float("-inf")
    published_at: float = 0.0


class Table:
    """Host-side table wrapper: schema + key dictionary + device state.

    The key→dense-index map is a host hash table (as in OpenMLDB, key lookup
    happens CPU-side); all window math runs on the device over dense
    indices. ``device`` defaults to the CUDA card and raises where there is
    none; the CPU is used only when asked for.
    """

    def __init__(self, schema: TableSchema, *, max_keys: int = 1024,
                 capacity: int = 1024, bucket_size: int = 64,
                 enable_preagg: bool = True, device="cuda"):
        if capacity % bucket_size != 0:
            raise ValueError("capacity must be a multiple of bucket_size")
        self.device = resolve_device(device)
        self.schema = schema
        self.max_keys = max_keys
        self.capacity = capacity
        self.bucket_size = bucket_size
        self.key_to_idx: Dict[object, int] = {}
        # device-side mirror of the key dict for batched hot-path lookup
        # (engine._serve); deactivates itself on non-int32 keys
        self.keydir = KeyDirectory(max_keys, device=self.device)
        self._pub_lock = threading.Lock()
        V = len(schema.value_cols)
        state = empty_state(max_keys, capacity, V, self.device)
        preagg = (empty_preagg(max_keys, capacity, V, bucket_size,
                               self.device) if enable_preagg else None)
        self._published = TableSnapshot(state=state, preagg=preagg,
                                        version=0)
        self._last_ts: Dict[int, float] = {}
        # first-event positions of keys not held yet (``seat``)
        self._seats: Dict[object, int] = {}
        # freshness/drift instrumentation: the event-time write frontier
        # plus ingest-side distribution sketches — one quantile sketch
        # per value column and a KMV distinct-key estimator, updated per
        # insert from the host rows (never from the device)
        self._watermark = float("-inf")
        self._col_sketches: Dict[str, QuantileSketch] = {
            c: QuantileSketch() for c in schema.value_cols}
        self._key_card = CardinalityEstimator()

    def put(self, x) -> torch.Tensor:
        """A host array (or a tensor) as a tensor on this table's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x)).to(self.device)

    # -- versioned state ---------------------------------------------------
    @property
    def state(self) -> TableState:
        return self._published.state

    @property
    def preagg(self) -> Optional[PreAggState]:
        return self._published.preagg

    @property
    def version(self) -> int:
        return self._published.version

    def snapshot(self) -> TableSnapshot:
        """Consistent (state, preagg, version) triple for one reader."""
        return self._published

    def publish(self, state: TableState,
                preagg: Optional[PreAggState]) -> TableSnapshot:
        """Atomically swap both tiers in (one version bump). The new
        snapshot carries the current write frontier as its watermark plus
        the publish wall-time."""
        with self._pub_lock:
            snap = TableSnapshot(state, preagg,
                                 self._published.version + 1,
                                 watermark=self._watermark,
                                 published_at=time.time())
            self._published = snap
        return snap

    @property
    def watermark(self) -> float:
        """Max event-time ever ingested (``-inf`` while empty)."""
        return self._watermark

    # -- key management ----------------------------------------------------
    def key_index(self, key, create: bool = False) -> int:
        idx = self.key_to_idx.get(key)
        if idx is None:
            if not create:
                raise KeyError(f"unknown key {key!r} in table "
                               f"{self.schema.name!r}")
            idx = len(self.key_to_idx)
            if idx >= self.max_keys:
                raise RuntimeError(
                    f"table {self.schema.name!r} key space exhausted "
                    f"({self.max_keys}); resize via Table(max_keys=...)")
            self.key_to_idx[key] = idx
            self.keydir.insert(key, idx)
        return idx

    def key_indices(self, keys: Sequence, create: bool = False) -> np.ndarray:
        return np.asarray([self.key_index(k, create) for k in keys],
                          dtype=np.int32)

    @property
    def n_keys(self) -> int:
        return len(self.key_to_idx)

    def last_ts_by_key(self) -> Dict[object, float]:
        """Per-key newest ingested timestamp (the write frontier)."""
        return {k: self._last_ts.get(i, float("-inf"))
                for k, i in self.key_to_idx.items()}

    # -- ingest ------------------------------------------------------------
    def seat(self, positions: Mapping[object, int]) -> None:
        """Give keys this table does not hold yet the ring position of
        their first event (0 otherwise): the first insert that brings such
        a key places its events from there, in the same publish. A key
        migrated from another table keeps its source's positions, hence
        its ring slots and its pre-aggregate bucket grouping. Keys already
        held are left alone; nothing is written to the device here."""
        for k, p in positions.items():
            if int(p) < 0:
                raise ValueError(f"negative position {p} for key {k!r}")
            if k not in self.key_to_idx:
                self._seats[k] = int(p)

    def insert(self, keys: Sequence, ts: Sequence[float],
               rows: np.ndarray, *, donate: bool = True) -> None:
        """Append events. ``rows`` is (B, V) in schema column order. Events
        must be in non-decreasing ts order per key.

        ``donate=True`` (default) updates the device tensors in place —
        no copy of the table per batch, but a snapshot taken earlier sees
        the new events. ``donate=False`` ingests into a copy of the state,
        so snapshots already handed out stay unchanged. A new key that
        was given a position by :meth:`seat` starts there."""
        keys = list(keys)
        ts_arr = np.asarray(ts, np.float32)
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != len(self.schema.value_cols):
            raise ValueError(
                f"rows must be (B, {len(self.schema.value_cols)}), got "
                f"{rows.shape}")
        if len(keys) != len(ts_arr) or len(keys) != rows.shape[0]:
            raise ValueError("keys/ts/rows length mismatch")
        if rows.shape[0] > self.capacity:
            # Keep per-batch position spans below capacity (ring safety).
            for s in range(0, rows.shape[0], self.capacity):
                self.insert(keys[s:s + self.capacity],
                            ts_arr[s:s + self.capacity],
                            rows[s:s + self.capacity], donate=donate)
            return
        seat = {k: self._seats[k] for k in dict.fromkeys(keys)
                if k in self._seats and k not in self.key_to_idx}
        kidx = self.key_indices(keys, create=True)
        # validate first, commit _last_ts only after the device update —
        # last_ts_by_key() must reflect delivered data only
        pending: Dict[int, float] = {}
        for i, k in enumerate(kidx):
            ki = int(k)
            last = pending.get(ki, self._last_ts.get(ki, float("-inf")))
            t = float(ts_arr[i])
            if t < last:
                raise ValueError(
                    f"out-of-order ingest for key index {ki}: "
                    f"{t} < {last} (streaming tables require per-key "
                    f"non-decreasing timestamps)")
            pending[ki] = t
        B = rows.shape[0]
        snap = self.snapshot()
        state, preagg = snap.state, snap.preagg
        if not donate:
            state = state.clone()
            preagg = preagg.clone() if preagg is not None else None
        if seat:
            state.total[self.put(np.asarray(
                [self.key_to_idx[k] for k in seat], np.int64))] = \
                self.put(np.asarray(list(seat.values()), np.int32))
        if B:
            ingest(state, preagg, self.put(kidx), self.put(ts_arr),
                   self.put(rows), bucket_size=self.bucket_size)
            self._watermark = max(self._watermark, float(ts_arr.max()))
        self.publish(state, preagg)
        for k in seat:
            self._seats.pop(k, None)
        self._last_ts.update(pending)
        # the sketches commit only on success (the same contract as
        # _last_ts)
        if B:
            self._key_card.add_many(keys)
            for j, col in enumerate(self.schema.value_cols):
                self._col_sketches[col].observe_many(rows[:, j])

    def warm_ingest(self, *, max_batch: Optional[int] = None) -> int:
        """The streaming pipeline's pre-flush warm-up. Ingest here is a
        handful of eager PyTorch scatters with nothing to compile for any
        batch size, so there is no device work to do: returns 0 (the
        number of ingest shapes compiled)."""
        return 0

    # -- introspection -----------------------------------------------------
    def ingest_stats(self) -> Dict[str, Any]:
        """Ingest-side distribution snapshot: per-value-column quantile
        sketches plus the distinct-key estimate, from host state only (no
        device work). Merges exactly across shards."""
        return {
            "key_card": self._key_card.to_dict(),
            "columns": {c: sk.to_dict()
                        for c, sk in self._col_sketches.items()
                        if sk.count},
        }

    def memory_bytes(self) -> int:
        st, pa = self.state, self.preagg
        ts = [st.values, st.ts, st.total]
        if pa is not None:
            ts += [pa.sum, pa.sumsq, pa.min, pa.max, pa.count]
        return sum(t.numel() * t.element_size() for t in ts)
