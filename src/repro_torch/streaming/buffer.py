"""Watermarked reorder buffer: out-of-order event repair before ingest.

The storage tier (``featurestore.table``) requires per-key non-decreasing
timestamps — the ring-buffer position IS the time order. Real streams are
not that polite: network skew and retries deliver events late and out of
order. OpenMLDB absorbs this in its memory table's skiplist; our dense
rings cannot, so we absorb it *before* the table instead, with standard
stream-processing watermark semantics (cf. Flink / Beam):

* every key tracks a high-water mark ``hwm[k]`` = max event-time seen;
* the key's **watermark** is ``hwm[k] - lateness`` — the stream's promise
  that no event older than this will be accepted anymore;
* staged events sit in a per-key buffer until the watermark passes them,
  getting **sorted on release** — any disorder inside the lateness window
  is repaired exactly (features identical to a sorted stream);
* events older than the already-released frontier are **dropped** and
  counted (they cannot be repaired once their neighborhood reached the
  ring buffer).

The buffer is a host-side structure (pure numpy + dicts); the device only
ever sees clean, sorted batches.
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["StreamBuffer", "StreamBufferStats"]


@dataclass
class StreamBufferStats:
    """Counters over the buffer's lifetime."""

    accepted: int = 0          # staged successfully
    released: int = 0          # handed to the table
    dropped_late: int = 0      # beyond-watermark, unrepairable
    reordered: int = 0         # arrived out of order but repaired
    max_staged: int = 0        # high-water mark of staged events
    txn_auto_aborted: int = 0  # prepares dropped by the prepare TTL

    def snapshot(self) -> Dict[str, int]:
        return dict(accepted=self.accepted, released=self.released,
                    dropped_late=self.dropped_late,
                    reordered=self.reordered, max_staged=self.max_staged,
                    txn_auto_aborted=self.txn_auto_aborted)


class StreamBuffer:
    """Bounded per-key reorder window with watermark release.

    ``lateness`` is the event-time width of the reorder window: an event
    may arrive up to ``lateness`` time units behind the newest event of
    its key and still be placed correctly. ``max_staged`` bounds memory —
    when exceeded, the oldest staged events are force-released (watermark
    advance by backpressure, as in any bounded-state stream processor).
    """

    def __init__(self, *, lateness: float = 1.0,
                 max_staged: int = 65536,
                 prepare_ttl_s: float = 0.0, wal=None):
        if lateness < 0:
            raise ValueError("lateness must be >= 0")
        self.lateness = float(lateness)
        self.max_staged = int(max_staged)
        self.stats = StreamBufferStats()
        self._lock = threading.Lock()
        # per key: sorted list of (ts, insertion_seq, row) — seq breaks ts
        # ties so equal-ts events keep arrival order (stable repair)
        self._staged: Dict[object, List[Tuple[float, int, np.ndarray]]] = {}
        self._hwm: Dict[object, float] = {}       # max ts seen per key
        self._frontier: Dict[object, float] = {}  # max ts released per key
        self._n_staged = 0
        self._seq = 0
        # prepared-but-uncommitted cross-shard transactions: txn id ->
        # [(key, ts, row), ...]. While a txn is pending, ready() holds
        # each involved key's frontier at/below the txn's min ts for that
        # key, so a prepared txn can ALWAYS commit (frontier can never
        # advance past it) — the invariant 2PC ingest rests on.
        self._pending: Dict[int, List[Tuple[object, float, np.ndarray]]] = {}
        self._txn_seq = 0
        # prepare TTL: a coordinator that dies between prepare and commit
        # would otherwise hold the involved keys' watermarks FOREVER.
        # prepare_ttl_s > 0 stamps each txn with a wall deadline; expired
        # prepares are auto-aborted (frontier holds released) before any
        # release/prepare/commit decision.
        self.prepare_ttl_s = float(prepare_ttl_s)
        self._txn_deadline: Dict[int, float] = {}
        self._expired_txns: set = set()
        # write-ahead log (streaming.wal.WriteAheadLog or None): accepted
        # events are appended UNDER this lock, before ready() could ever
        # release them — nothing reaches the table without being logged
        self.wal = wal

    # ------------------------------------------------------------------ push
    def push(self, key, ts: float, row: np.ndarray) -> bool:
        """Stage one event. Returns False iff dropped (beyond watermark)."""
        with self._lock:
            ok = self._push_locked(key, float(ts), row)
            if ok and self.wal is not None:
                self.wal.append([key], np.asarray([ts], np.float32),
                                np.asarray(row, np.float32)[None])
            return ok

    def push_batch(self, keys: Sequence, ts: Sequence[float],
                   rows: np.ndarray, *, all_or_nothing: bool = False) -> int:
        """Stage a batch; returns how many were accepted.

        ``all_or_nothing`` pre-checks every event against the frontier
        under the same lock and stages none if any would be dropped —
        the synchronous insert path's atomicity guarantee."""
        rows = np.asarray(rows, np.float32)
        n_ok = 0
        with self._lock:
            if all_or_nothing:
                for i, k in enumerate(keys):
                    t = float(ts[i])
                    if (not np.isfinite(t)
                            or t < self._frontier.get(k, float("-inf"))):
                        return 0
            acc: List[int] = []
            try:
                for i, k in enumerate(keys):
                    if self._push_locked(k, float(ts[i]), rows[i]):
                        acc.append(i)
                        n_ok += 1
            finally:
                # one WAL record for the whole accepted slice — logged
                # even if a later event raised (those staged are real)
                if acc and self.wal is not None:
                    self.wal.append([keys[i] for i in acc],
                                    np.asarray([float(ts[i]) for i in acc],
                                               np.float32),
                                    rows[np.asarray(acc)])
        return n_ok

    # ------------------------------------------------------ 2PC (prepare)
    def prepare(self, keys: Sequence, ts: Sequence[float],
                rows: np.ndarray) -> Optional[int]:
        """Phase 1 of a cross-shard transactional ingest: validate every
        event against the frontier and park the batch WITHOUT staging it.
        Returns a txn id, or ``None`` if any event would be dropped (the
        whole batch is then rejected and nothing is held).

        Between ``prepare`` and ``commit``/``abort``, ``ready()`` caps
        each involved key's release at the txn's minimum pending ts, so
        the frontier cannot move past the parked events — ``commit`` is
        guaranteed to stage every event successfully."""
        rows = np.asarray(rows, np.float32)
        with self._lock:
            self._expire_txns_locked()
            for i, k in enumerate(keys):
                t = float(ts[i])
                if (not np.isfinite(t)
                        or t < self._frontier.get(k, float("-inf"))):
                    return None
            self._txn_seq += 1
            txn = self._txn_seq
            self._pending[txn] = [
                (k, float(ts[i]), np.asarray(rows[i], np.float32))
                for i, k in enumerate(keys)]
            if self.prepare_ttl_s > 0:
                self._txn_deadline[txn] = (time.monotonic()
                                           + self.prepare_ttl_s)
            return txn

    def commit(self, txn: int) -> List[Tuple[object, float, np.ndarray]]:
        """Phase 2: stage the parked batch. Cannot reject (see
        ``prepare``) unless the prepare TTL already auto-aborted it;
        returns the staged events (the pipeline logs them to the WAL as
        ONE atomic record — a crash between prepare and commit replays
        as an abort)."""
        with self._lock:
            self._expire_txns_locked()
            if txn in self._expired_txns:
                raise ValueError(
                    f"txn {txn} was auto-aborted: its prepare exceeded "
                    f"the {self.prepare_ttl_s}s prepare TTL (coordinator "
                    f"presumed dead); nothing was staged")
            events = self._pending.pop(txn)
            self._txn_deadline.pop(txn, None)
            for k, t, row in events:
                if not self._push_locked(k, t, row):
                    # unreachable by construction (frontier held); guard
                    # so a future invariant break is loud, not silent
                    raise AssertionError(
                        f"prepared event (key={k!r}, ts={t}) rejected at "
                        f"commit — frontier hold violated")
            if events and self.wal is not None:
                self.wal.append(
                    [k for k, _t, _r in events],
                    np.asarray([t for _k, t, _r in events], np.float32),
                    np.stack([r for _k, _t, r in events]))
            return events

    def abort(self, txn: int) -> None:
        """Drop a prepared batch and release its frontier holds."""
        with self._lock:
            self._pending.pop(txn, None)
            self._txn_deadline.pop(txn, None)

    def _expire_txns_locked(self) -> None:
        """Auto-abort prepares older than the TTL — a dead coordinator
        must not hold key watermarks forever (callers hold the lock)."""
        if not self._txn_deadline:
            return
        now = time.monotonic()
        for txn in [t for t, dl in self._txn_deadline.items()
                    if now > dl]:
            self._pending.pop(txn, None)
            self._txn_deadline.pop(txn, None)
            self._expired_txns.add(txn)
            self.stats.txn_auto_aborted += 1
        if len(self._expired_txns) > 4096:   # bounded tombstone set
            self._expired_txns.clear()

    def _txn_holds(self) -> Dict[object, float]:
        """Per-key minimum pending-txn ts (callers hold the lock)."""
        self._expire_txns_locked()
        holds: Dict[object, float] = {}
        for events in self._pending.values():
            for k, t, _row in events:
                if t < holds.get(k, float("inf")):
                    holds[k] = t
        return holds

    def _push_locked(self, key, ts: float, row: np.ndarray) -> bool:
        if not np.isfinite(ts):
            # NaN/inf never compares its way into a sorted buffer; a
            # garbage timestamp is a caller bug, not a late event
            raise ValueError(f"non-finite event timestamp {ts!r} for key "
                             f"{key!r}")
        frontier = self._frontier.get(key, float("-inf"))
        if ts < frontier:
            # its position in the ring is already occupied by newer events
            self.stats.dropped_late += 1
            return False
        hwm = self._hwm.get(key, float("-inf"))
        staged = self._staged.setdefault(key, [])
        if staged and ts < staged[-1][0]:
            self.stats.reordered += 1            # repaired by sorted insert
        bisect.insort(staged, (ts, self._seq, np.asarray(row, np.float32)))
        self._seq += 1
        if ts > hwm:
            self._hwm[key] = ts
        self.stats.accepted += 1
        self._n_staged += 1
        self.stats.max_staged = max(self.stats.max_staged, self._n_staged)
        return True

    # --------------------------------------------------------------- release
    def watermark(self, key) -> float:
        """Event-time below which ``key``'s events are final."""
        return self._hwm.get(key, float("-inf")) - self.lateness

    @property
    def n_staged(self) -> int:
        return self._n_staged

    def seed_frontier(self, frontiers: Dict[object, float]) -> None:
        """Raise per-key frontiers (and high-water marks) to match history
        already written to the table — called when a pipeline attaches to
        a non-empty table, so an event older than pre-attach history is
        rejected at push time instead of poisoning the flusher."""
        with self._lock:
            for k, t in frontiers.items():
                if t > self._frontier.get(k, float("-inf")):
                    self._frontier[k] = t
                if t > self._hwm.get(k, float("-inf")):
                    self._hwm[k] = t

    def restage(self, keys: Sequence, ts: Sequence[float],
                rows: np.ndarray, *,
                frontier: Optional[Dict[object, float]] = None) -> None:
        """Return events popped by ``ready`` to the staging area (flush
        failure recovery). Bypasses the late-drop check: these events were
        already accepted and their table-side neighborhood was never
        written, so re-releasing them later preserves per-key order.

        ``frontier`` (the table's ``last_ts_by_key``) rolls the release
        frontier back to what was actually delivered — ``ready`` advanced
        it optimistically, and leaving it inflated would wrongly drop
        still-repairable events as late."""
        with self._lock:
            for i, k in enumerate(keys):
                staged = self._staged.setdefault(k, [])
                bisect.insort(staged, (float(ts[i]), self._seq,
                                       np.asarray(rows[i], np.float32)))
                self._seq += 1
                self._n_staged += 1
            self.stats.released -= len(keys)
            if frontier is not None:
                for k in set(keys):
                    self._frontier[k] = frontier.get(k, float("-inf"))

    def has_ready(self) -> bool:
        """True iff some staged event is already past its watermark."""
        with self._lock:
            return any(
                staged and staged[0][0] <= (self._hwm.get(k, float("-inf"))
                                            - self.lateness)
                for k, staged in self._staged.items())

    def ready(self, *, flush_all: bool = False
              ) -> Tuple[list, np.ndarray, np.ndarray]:
        """Pop every event at/below its key's watermark, repaired (sorted
        by event time per key) and globally ts-ordered. ``flush_all``
        ignores watermarks (shutdown / end-of-stream drain).

        Returns ``(keys, ts (N,) f32, rows (N, V) f32)``; empty when
        nothing is releasable.
        """
        out: List[Tuple[float, int, object, np.ndarray]] = []
        with self._lock:
            over = (self._n_staged - self.max_staged
                    if self.max_staged else 0)
            holds = self._txn_holds() if self._pending else {}
            for key, staged in self._staged.items():
                if not staged:
                    continue
                hold = holds.get(key)
                if flush_all:
                    n = len(staged)
                    if hold is not None:
                        # even a full drain must not advance the frontier
                        # past a prepared txn's events (ts == hold may
                        # release: commit pushes ts >= frontier)
                        n = bisect.bisect_right(staged,
                                                (hold, self._seq, None))
                else:
                    wm = self._hwm[key] - self.lateness
                    if hold is not None:
                        wm = min(wm, hold)
                    n = bisect.bisect_right(staged,
                                            (wm, self._seq, None))
                    if over > 0 and n < len(staged) and hold is None:
                        # bounded state: force the oldest through (held
                        # keys exempt — 2PC windows are short)
                        extra = min(len(staged) - n, over)
                        n += extra
                        over -= extra
                if n == 0:
                    continue
                for ts, seq, row in staged[:n]:
                    out.append((ts, seq, key, row))
                del staged[:n]
                self._frontier[key] = max(
                    self._frontier.get(key, float("-inf")), out[-1][0])
                self._n_staged -= n
                self.stats.released += n
        if not out:
            return [], np.zeros((0,), np.float32), np.zeros((0, 0),
                                                            np.float32)
        # global ts order keeps cross-key batches roughly time-coherent
        # (only per-key order is required by the ring buffer)
        out.sort(key=lambda e: (e[0], e[1]))
        keys = [e[2] for e in out]
        ts = np.asarray([e[0] for e in out], np.float32)
        rows = np.stack([e[3] for e in out]).astype(np.float32)
        return keys, ts, rows
