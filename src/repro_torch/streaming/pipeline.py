"""Background ingestion: arrival is decoupled from table mutation.

``push`` stages an event into the ``StreamBuffer`` (host memory, O(log n))
and returns immediately — the serving hot path never waits on device
ingest. A flusher thread drains watermark-released events into
``Table.insert(donate=False)`` in amortized batches, using the
**copy-on-write double buffer**:

    flush:   snapshot v ──clone + ingest──▶ tensors v+1 ──publish──▶ v+1
    queries:       read snapshot v  (stays valid: nothing wrote into it)

On a CUDA table the clone copies both tiers on the device's current
stream (the default stream), which every serving thread launches on too:
a request queued behind a flush waits for its copy.

``Table.publish`` swaps the (state, preagg, version) triple atomically, so
an in-flight query that captured version ``v`` computes against one
consistent table no matter how many flushes land meanwhile — the paper's
"batch and stream processing without interference", made concrete.

Retention (TTL) piggybacks on the flusher: every ``every_n_flushes``
cycles the expired prefix is compacted out and the preagg tier rebuilt
(`streaming.retention`), published through the same atomic swap.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.featurestore.table import Table
from repro_torch.streaming.buffer import StreamBuffer
from repro_torch.streaming.retention import RetentionPolicy, apply_retention
from repro_torch.streaming.wal import WalConfig, WriteAheadLog

__all__ = ["IngestPipeline", "PipelineConfig"]


@dataclass(frozen=True)
class PipelineConfig:
    lateness: float = 1.0            # reorder window, event-time units
    flush_interval_s: float = 0.002  # max staging delay before a flush
    max_flush_batch: int = 1024      # amortization cap per ingest call
    max_staged: int = 65536          # buffer bound (backpressure)
    retention: RetentionPolicy = RetentionPolicy(ttl=0.0)
    # auto-abort prepared-but-uncommitted 2PC transactions after this
    # long (0 disables): a dead coordinator must not pin watermarks
    prepare_ttl_s: float = 0.0
    # write-ahead log config (None disables): accepted events are logged
    # before they become flushable; replaying the log reproduces the
    # table bit-identically (streaming.wal, DESIGN.md §12)
    wal: Optional[WalConfig] = None


class IngestPipeline:
    """Owns a ``Table``'s write path; queries keep reading snapshots.

    Single-writer discipline: while a pipeline is attached, all mutation
    goes through it (``push``/``push_batch``); direct ``Table.insert``
    would race the flusher and donate buffers out from under readers.
    """

    def __init__(self, table: Table, cfg: PipelineConfig = PipelineConfig(),
                 freshness=None):
        self.table = table
        self.cfg = cfg
        # ingest-to-visible tracking (DESIGN.md §14): FIFO of
        # (arrival_wall, count) cohorts, popped per flush — events leave
        # the buffer in (roughly) arrival order, so matching flushed
        # counts against arrival cohorts is exact to within one flush
        # interval. ``freshness`` is a FreshnessTracker (or None).
        self.freshness = freshness
        self._arrivals: Deque[Tuple[float, int]] = collections.deque()
        self._arr_lock = threading.Lock()
        self.wal = WriteAheadLog(cfg.wal) if cfg.wal is not None else None
        self.buffer = StreamBuffer(lateness=cfg.lateness,
                                   max_staged=cfg.max_staged,
                                   prepare_ttl_s=cfg.prepare_ttl_s,
                                   wal=self.wal)
        # attaching to a non-empty table: events older than the already-
        # written history are unrepairable and must be rejected at push
        self.buffer.seed_frontier(table.last_ts_by_key())
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._flush_mu = threading.Lock()   # single-flusher guarantee
        self._stop = False
        self._flushing = False
        self._event_clock = float("-inf")   # max event-time released
        self.stats: Dict[str, float] = {
            "flushes": 0, "events_flushed": 0, "flush_s": 0.0,
            "ttl_compactions": 0, "ttl_dropped": 0, "errors": 0}
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._flush_loop,
                                        daemon=True,
                                        name=f"ingest-{table.schema.name}")
        self._thread.start()

    # ------------------------------------------------------------------ push
    def push(self, key, ts: float, row: np.ndarray) -> bool:
        """Stage one event; never blocks on device work. Returns False iff
        the event was beyond the watermark (dropped, counted)."""
        ok = self.buffer.push(key, ts, row)
        if ok:
            self._note_arrival(1)
        with self._work:
            self._work.notify()
        return ok

    def push_batch(self, keys: Sequence, ts: Sequence[float],
                   rows: np.ndarray, *, all_or_nothing: bool = False) -> int:
        n = self.buffer.push_batch(keys, ts, rows,
                                   all_or_nothing=all_or_nothing)
        if n:
            self._note_arrival(n)
        with self._work:
            self._work.notify()
        return n

    # ------------------------------------------------------------------- 2PC
    def prepare(self, keys: Sequence, ts: Sequence[float],
                rows: np.ndarray) -> Optional[int]:
        """Phase 1 of a cross-shard transactional ingest: validate and
        park the batch (see ``StreamBuffer.prepare``). No flusher wakeup —
        nothing is staged yet."""
        return self.buffer.prepare(keys, ts, rows)

    def commit_txn(self, txn: int) -> int:
        """Phase 2: stage the parked batch (guaranteed to succeed unless
        the prepare TTL auto-aborted it) and wake the flusher. The WAL —
        when attached — gets the whole batch as ONE record at commit
        time, so replay-after-crash has 2PC atomicity for free."""
        events = self.buffer.commit(txn)
        if events:
            self._note_arrival(len(events))
        with self._work:
            self._work.notify()
        return len(events)

    def abort_txn(self, txn: int) -> None:
        self.buffer.abort(txn)

    # ------------------------------------------------------------- freshness
    def _note_arrival(self, count: int) -> None:
        if self.freshness is None:
            return
        with self._arr_lock:
            self._arrivals.append((time.time(), count))

    def _note_visible(self, n: int) -> None:
        """``n`` events just PUBLISHED: pop arrival cohorts covering them
        and record arrival→visible wall latency per cohort."""
        if self.freshness is None or n <= 0:
            return
        now = time.time()
        name = self.table.schema.name
        cohorts = []
        with self._arr_lock:
            while n > 0 and self._arrivals:
                t0, c = self._arrivals[0]
                take = min(c, n)
                cohorts.append((t0, take))
                n -= take
                if take == c:
                    self._arrivals.popleft()
                else:
                    self._arrivals[0] = (t0, c - take)
        for t0, c in cohorts:
            self.freshness.observe_ingest_visibility(
                name, max(now - t0, 0.0), count=c)

    # ----------------------------------------------------------------- flush
    def _flush_once(self, *, flush_all: bool = False) -> int:
        with self._flush_mu:
            return self._flush_once_locked(flush_all=flush_all)

    def _flush_once_locked(self, *, flush_all: bool) -> int:
        keys, ts, rows = self.buffer.ready(flush_all=flush_all)
        if not keys:
            return 0
        n = len(keys)
        t0 = time.perf_counter()
        step = self.cfg.max_flush_batch
        done = 0
        try:
            for s in range(0, n, step):
                self.table.insert(keys[s:s + step], ts[s:s + step],
                                  rows[s:s + step], donate=False)
                done = min(s + step, n)
        except ValueError as e:
            # data error (per-key order violated by out-of-band table
            # writes, bad shapes): retrying the chunk can never succeed —
            # eject it, restage only the chunks after it
            self.last_error = e
            self.stats["errors"] += 1
            skip = min(done + step, n)
            self.buffer.restage(keys[skip:], ts[skip:], rows[skip:],
                                frontier=self.table.last_ts_by_key())
            n = done
            if n == 0:
                return 0
        except BaseException as e:           # keep the flusher alive
            self.last_error = e
            self.stats["errors"] += 1
            # transient failure: the undelivered tail goes back to staging
            # (globally ts-sorted, so per-key order survives the retry),
            # and the frontier rolls back to what the table actually holds
            self.buffer.restage(keys[done:], ts[done:], rows[done:],
                                frontier=self.table.last_ts_by_key())
            n = done
            if n == 0:
                return 0
        self._event_clock = max(self._event_clock, float(ts[n - 1]))
        self._note_visible(n)
        self.stats["flushes"] += 1
        self.stats["events_flushed"] += n
        self.stats["flush_s"] += time.perf_counter() - t0
        ret = self.cfg.retention
        if (ret.enabled and ret.every_n_flushes > 0
                and self.stats["flushes"] % ret.every_n_flushes == 0):
            self._compact()
        return n

    def _compact(self) -> None:
        if self._event_clock == float("-inf"):
            return
        dropped = apply_retention(self.table, self.cfg.retention,
                                  now=self._event_clock)
        if dropped:
            self.stats["ttl_compactions"] += 1
            self.stats["ttl_dropped"] += dropped
        if self.wal is not None and self.cfg.retention.enabled:
            # segments whose newest event fell behind the TTL horizon
            # hold only rows a replay would immediately compact away
            self.wal.truncate(self._event_clock - self.cfg.retention.ttl)

    def _flush_loop(self) -> None:
        while True:
            with self._work:
                if self._stop:
                    return
                if not self.buffer.has_ready():
                    # nothing releasable (empty, or all staged events are
                    # still inside the reorder window): park instead of
                    # spinning ready() scans
                    self._work.wait(timeout=0.05)
                if self._stop:
                    return
                self._flushing = True
            try:
                self._flush_once()
            except BaseException as e:     # the daemon thread must never
                self.last_error = e        # die silently mid-stream
                self.stats["errors"] += 1
                time.sleep(0.05)           # don't spin on a hard error
            finally:
                with self._idle:
                    self._flushing = False
                    self._idle.notify_all()
            # amortization window: let pushes accumulate so each ingest
            # (one clone of the table) carries a worthwhile batch
            if self.cfg.flush_interval_s > 0:
                time.sleep(self.cfg.flush_interval_s)

    def flush(self, *, flush_all: bool = True) -> None:
        """Synchronously drain everything staged (ignores watermarks when
        ``flush_all`` — end-of-stream / checkpoint barrier)."""
        self.wait_idle()
        with self._flush_mu:
            self._flush_once_locked(flush_all=flush_all)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until nothing releasable remains in flight. Events still
        inside the reorder window stay staged (use ``flush`` to force)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._idle:
                busy = self._flushing
            has_ready = False
            if not busy:
                has_ready = self.buffer.has_ready()
            if not busy and not has_ready:
                return True
            time.sleep(0.001)
        return False

    # ------------------------------------------------------------ lifecycle
    def warm(self) -> int:
        """Prepare the flusher's ingest before serving (``Table.
        warm_ingest``: the port's ingest compiles nothing, so this does no
        device work). Returns the number of ingest shapes compiled."""
        return self.table.warm_ingest(max_batch=self.cfg.max_flush_batch)

    @property
    def version(self) -> int:
        return self.table.version

    def metrics(self) -> Dict[str, float]:
        out = dict(self.stats)
        out.update(self.buffer.stats.snapshot())
        out["staged"] = self.buffer.n_staged
        out["table_version"] = self.table.version
        if self.wal is not None:
            out.update({f"wal_{k}": v
                        for k, v in self.wal.metrics().items()})
        return out

    def close(self, *, drain: bool = True) -> None:
        """Idempotent: a second close (e.g. context-manager exit after an
        explicit close, or Engine.close after FeatureServer teardown) is a
        no-op instead of re-draining a stopped pipeline."""
        with self._work:
            already = self._stop
            self._stop = True
            self._work.notify_all()
        self._thread.join(timeout=5.0)
        if drain and not already:
            self._flush_once(flush_all=True)
        if self.wal is not None and not already:
            self.wal.close()

    def __enter__(self) -> "IngestPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
