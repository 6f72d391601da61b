"""Scatter/gather request routing across hash-partitioned shard engines.

The router is the data plane of the sharded serving runtime
(DESIGN.md §9): a request batch is **scattered** by key hash into
per-shard sub-batches, each shard's queue is served by an execution
**lane** (worker thread) over the shard's tables and executors on its
device, and the rows are **gathered** back into one result
in the original request order.

Key properties:

* **Stable routing.** ``shard_of`` is a pure function of ``(key,
  n_shards)`` — the same multiplicative hash the device key directory
  uses — so a key's owning shard never changes across publishes,
  redeploys, or process restarts.
* **Shards ≠ lanes.** Shards are data partitions (one queue + one
  engine each); lanes are execution threads, one per available device.
  When shards outnumber devices, a lane serves several shard queues
  round-robin — running more execution threads than physical lanes just
  thrashes (4 streams on 2 cores measured ~35% slower than 2), exactly
  like tablets sharing a tablet-server's executor pool.
* **Coalescing lanes.** A lane drains one shard queue at a time, fusing
  consecutive sub-batches **of the same deployment handle** into
  fixed-size dispatch chunks (``dispatch_rows``, tails padded to a
  power-of-two bucket). Sub-batch sizes vary wildly under scatter
  (binomial around B/S); the chunks keep the batch shapes a shard's
  kernels see to one per bucket, and coalescing several small
  sub-batches into one dispatch pays the per-batch host work once.
* **Deadline-aware shedding.** A sub-batch whose request context expired
  while queued is completed with ``shed=True`` at dequeue, before any
  feature computation — a saturated shard drops late work instead of
  stalling every batch behind it (the gather side then returns a
  whole-batch shed status, never a mix of shed and computed rows).
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["shard_of", "shard_ids", "SubBatch", "ShardRouter",
           "ShardDownError"]


class ShardDownError(RuntimeError):
    """A shard cannot serve right now: a retired shard, or (process
    backend) a dead or respawning worker. Lanes translate this into a
    whole-batch SHED: the caller sees ``STATUS_SHED``, never a hang or a
    raw exception, while the supervisor respawns the worker."""

# Knuth multiplicative constant — the same one featurestore.keydir hashes
# with, so routing and key-directory slot math share one hash family
_MULT = 2654435761
_MASK32 = 0xFFFFFFFF


def shard_of(key, n_shards: int) -> int:
    """Owning shard of ``key`` — pure in (key, n_shards), stable forever."""
    if n_shards <= 1:
        return 0
    if isinstance(key, np.generic):
        # normalize numpy scalars to their Python value BEFORE hashing:
        # repr(np.str_('x')) differs between numpy majors (and from
        # repr('x')), which would route the same key differently on the
        # scalar vs vectorized path
        key = key.item()
    if isinstance(key, int) and not isinstance(key, bool):
        return ((key & _MASK32) * _MULT & _MASK32) % n_shards
    return zlib.crc32(repr(key).encode()) % n_shards


def shard_ids(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Vectorised ``shard_of`` over a key batch -> (B,) int32 shard ids."""
    if n_shards <= 1:
        return np.zeros(len(keys), np.int32)
    if keys.dtype.kind in "iu":
        h = (keys.astype(np.uint64) & _MASK32) * _MULT & _MASK32
        return (h % n_shards).astype(np.int32)
    # tolist() yields Python values, keeping the per-element hash
    # identical to the scalar path's
    return np.asarray([shard_of(k, n_shards) for k in keys.tolist()],
                      np.int32)


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


class SubBatch:
    """One shard's slice of a client batch, in flight through a lane."""

    __slots__ = ("handle", "keys", "ts", "rows", "ctx", "done",
                 "columns", "status", "table_version", "error", "shed",
                 "shed_reason", "watermark", "feature_age")

    def __init__(self, handle, keys: np.ndarray, ts: np.ndarray,
                 rows: Optional[np.ndarray], ctx=None):
        self.handle = handle
        self.keys = keys
        self.ts = ts
        self.rows = rows
        self.ctx = ctx
        self.done = threading.Event()
        self.columns: Optional[Dict[str, np.ndarray]] = None
        self.status: Optional[np.ndarray] = None
        self.table_version: int = -1
        self.error: Optional[BaseException] = None
        self.shed = False
        self.shed_reason: Optional[str] = None
        # freshness stamps from the serving shard (DESIGN.md §14):
        # snapshot watermark and worst per-row feature age of the slice
        self.watermark: Optional[float] = None
        self.feature_age: Optional[float] = None

    def __len__(self) -> int:
        return len(self.keys)


class _ShardQueue:
    """One shard's pending sub-batches (drained by its lane)."""

    def __init__(self, shard_id: int, lane: "_Lane"):
        self.shard_id = shard_id
        self.lane = lane
        self.q: deque = deque()
        # a retired shard's runtime is (about to be) closed: late submits
        # — scatters that read the pre-reshard route table — must shed,
        # not execute against deleted buffers
        self.retired = False
        self.stats = {"sub_batches": 0, "shed_sub_batches": 0,
                      "max_queue_depth": 0}

    def submit(self, item: SubBatch) -> SubBatch:
        lane = self.lane
        with lane.cv:
            if lane.stop or not lane.accepting:
                raise RuntimeError("shard router is closed")
            if self.retired:
                item.shed = True
                item.shed_reason = "worker_down"
                self.stats["shed_sub_batches"] += 1
                item.done.set()
                return item
            self.q.append(item)
            self.stats["max_queue_depth"] = max(
                self.stats["max_queue_depth"], len(self.q))
            lane.cv.notify()
        return item

    @property
    def queue_depth(self) -> int:
        return len(self.q)


class _Lane:
    """One execution thread serving one or more shard queues round-robin:
    drain -> coalesce -> chunk -> execute."""

    def __init__(self, lane_id: int, dispatch_rows: int,
                 coalesce_delay_s: float = 0.002):
        self.lane_id = lane_id
        self.dispatch_rows = dispatch_rows
        # a drain may carry several chunks' worth — full chunks slice out
        # of a big concat with zero pad waste
        self.max_drain_rows = 4 * dispatch_rows
        self.coalesce_delay_s = coalesce_delay_s
        self.queues: List[_ShardQueue] = []
        self.cv = threading.Condition()
        self.stop = False
        # shutdown(drain=True) flips this first so new submits fail fast
        # while already-queued work still completes
        self.accepting = True
        # True while the lane thread holds drained-but-unfinished items
        # (between _drain and the end of _execute) — the drain wait in
        # shutdown() needs it: empty queues alone don't mean idle
        self.busy = False
        # the queue whose items the lane holds while busy: a shard being
        # retired waits for its own work, not for other shards' on the
        # same lane
        self.active: Optional[_ShardQueue] = None
        self._rr = 0
        self.stats = {"dispatches": 0, "rows": 0}
        self.thread: Optional[threading.Thread] = None
        # assigned by ShardRouter.tracer = ... (sharded engine wiring)
        self.tracer = None

    def start(self) -> None:
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=f"shard-lane-{self.lane_id}")
        self.thread.start()

    # ------------------------------------------------------------- worker
    def _pick_queue(self) -> Optional[_ShardQueue]:
        n = len(self.queues)
        for i in range(n):
            sq = self.queues[(self._rr + i) % n]
            if sq.q:
                self._rr = (self._rr + i + 1) % n
                return sq
        return None

    def _pending_rows(self) -> int:
        return sum(len(it) for sq in self.queues for it in sq.q)

    def _drain(self) -> Tuple[Optional[_ShardQueue], List[SubBatch]]:
        """Pop a run of same-handle sub-batches from the next non-empty
        queue, up to ``max_drain_rows`` (full ``dispatch_rows`` chunks
        slice out of one concat with no pad waste; the first item is
        always taken and oversized items are chunked downstream). When
        less than one full chunk is available AND the lane is otherwise
        idle, wait up to ``coalesce_delay_s`` for more arrivals — under
        scatter, sub-batch sizes are binomial around B/S and a lone
        sub-batch just above a bucket boundary would waste up to half its
        dispatch on padding. Different handles (deployment versions)
        never coalesce into one dispatch."""
        with self.cv:
            while not self.stop:
                sq = self._pick_queue()
                if sq is not None:
                    break
                self.cv.wait(0.1)
            if self.stop:
                items = []
                for q in self.queues:
                    items.extend(q.q)
                    q.q.clear()
                for it in items:   # fail fast instead of hanging waiters
                    it.error = RuntimeError("shard router closed")
                    it.done.set()
                return None, []
            items: List[SubBatch] = []
            n = 0
            handle = sq.q[0].handle
            # flagged BEFORE the coalesce wait can release the cv: a
            # drain-waiter that sees empty queues must also see busy=True
            # for the items this drain is about to pop
            self.busy = True
            self.active = sq
            deadline: Optional[float] = None
            while True:
                while sq.q and sq.q[0].handle is handle:
                    if items and n + len(sq.q[0]) > self.max_drain_rows:
                        break
                    it = sq.q.popleft()
                    items.append(it)
                    n += len(it)
                if (n >= self.dispatch_rows or self.stop
                        or self.coalesce_delay_s <= 0
                        or self._pending_rows() > 0):
                    break
                now = time.monotonic()
                if deadline is None:
                    deadline = now + self.coalesce_delay_s
                if now >= deadline:
                    break
                self.cv.wait(deadline - now)
            return sq, items

    def _loop(self) -> None:
        while True:
            sq, items = self._drain()
            if not items:
                if self.stop:
                    return
                continue
            try:
                self._execute(sq, items)
            except BaseException as e:          # the lane must never die
                for it in items:
                    if not it.done.is_set():
                        it.error = e
                        it.done.set()
            finally:
                with self.cv:
                    self.busy = False
                    self.active = None
                    self.cv.notify_all()

    def _execute(self, sq: _ShardQueue, items: List[SubBatch]) -> None:
        # shed expired work at dequeue — BEFORE concat/compute; the whole
        # client batch will come back shed, so computing the rest of the
        # sub-batch would be wasted work on the saturated path
        live: List[SubBatch] = []
        for it in items:
            if it.ctx is not None and it.ctx.expired:
                it.shed = True
                it.shed_reason = "deadline"
                sq.stats["shed_sub_batches"] += 1
                it.done.set()
            else:
                live.append(it)
        if not live:
            return
        handle = live[0].handle
        # per-RPC deadline (process backend): the serve RPC gets the
        # tightest remaining request budget among the coalesced items,
        # so a wedged worker turns into a bounded TimeoutError → shed
        # instead of pinning the lane for the transport's default 120 s
        timeout_s: Optional[float] = None
        if getattr(handle, "supports_rpc_deadline", False):
            for it in live:
                if it.ctx is not None and it.ctx.deadline is not None:
                    rem = it.ctx.remaining()
                    if rem is not None:
                        timeout_s = rem if timeout_s is None \
                            else min(timeout_s, rem)
            if timeout_s is not None:
                timeout_s = max(timeout_s, 0.05)
        keys = np.concatenate([it.keys for it in live])
        ts = np.concatenate([it.ts for it in live])
        rows = None
        if any(it.rows is not None for it in live):
            V = len(handle.table.schema.value_cols)
            rows = np.concatenate(
                [it.rows if it.rows is not None
                 else np.zeros((len(it), V), np.float32) for it in live])
        B = len(keys)
        step = self.dispatch_rows
        # tracing: one exemplar span per coalesced dispatch — the first
        # live item with a sampled trace lends its context; the shard
        # engine's serve re-parents under this span through a forwarded
        # context without a deadline
        span = None
        ctx_fwd = None
        tracer = self.tracer
        if tracer is not None:
            ex = next((it.ctx for it in live
                       if it.ctx is not None and it.ctx.trace_id
                       and tracer.sampled(it.ctx.trace_id)), None)
            if ex is not None:
                span = tracer.start(
                    "lane.execute", ex.trace_id, parent_id=ex.parent_span,
                    tags={"lane": self.lane_id, "shard": sq.shard_id,
                          "n_coalesced": len(live)})
            if span is not None:
                from repro_torch.core.results import RequestContext
                ctx_fwd = RequestContext(trace_id=ex.trace_id,
                                         parent_span=span.span_id)
        col_parts: List[Dict[str, np.ndarray]] = []
        st_parts: List[np.ndarray] = []
        tver = -1
        wm_min: Optional[float] = None
        age_max: Optional[float] = None
        try:
            for s0 in range(0, B, step):
                ke = keys[s0:s0 + step]
                te = ts[s0:s0 + step]
                re = rows[s0:s0 + step] if rows is not None else None
                nb = len(ke)
                bk = _bucket(nb)
                if bk > nb:
                    # edge-pad: repeat the last row so pad rows carry KNOWN
                    # keys (no unknown-key status pollution) and the
                    # batch shapes stay one per bucket
                    pad = bk - nb
                    ke = np.concatenate([ke, np.repeat(ke[-1:], pad)])
                    te = np.concatenate([te, np.repeat(te[-1:], pad)])
                    if re is not None:
                        re = np.concatenate(
                            [re, np.repeat(re[-1:], pad, axis=0)])
                # pad rows are shape filler: the engine serves them but
                # leaves them out of the freshness, drift and flight
                # observations
                kw = {"n_live": nb}
                if timeout_s is not None:
                    kw["timeout_s"] = timeout_s
                if ctx_fwd is not None:
                    kw["ctx"] = ctx_fwd
                frame = handle.request(ke, te, re, **kw)
                col_parts.append(
                    {k: np.asarray(v)[:nb] for k, v in frame.columns.items()})
                st_parts.append(np.asarray(frame.status)[:nb])
                tver = max(tver, frame.table_version)
                if frame.watermark is not None:
                    wm = frame.watermark
                    wm_min = wm if wm_min is None else min(wm_min, wm)
                if frame.feature_age is not None:
                    age = frame.feature_age
                    age_max = age if age_max is None \
                        else max(age_max, age)
                self.stats["dispatches"] += 1
                self.stats["rows"] += nb
        except (ShardDownError, TimeoutError) as e:
            # a shard that cannot serve, or a serve that blew its
            # deadline: shed, don't error — the caller gets a clean
            # whole-batch STATUS_SHED
            reason = "worker_down" if isinstance(e, ShardDownError) \
                else "deadline"
            # the span closes before any caller wakes, so a returned
            # request finds its whole trace
            if span is not None:
                tracer.finish(span, tags={"shed": reason})
            for it in live:
                it.shed = True
                it.shed_reason = reason
                sq.stats["shed_sub_batches"] += 1
                it.done.set()
            return
        except BaseException as e:
            if span is not None:
                tracer.finish(span, tags={"error": type(e).__name__})
            for it in live:
                it.error = e
                it.done.set()
            return
        if span is not None:
            tracer.finish(span, tags={"rows": B})
        cols = {k: (np.concatenate([p[k] for p in col_parts])
                    if len(col_parts) > 1 else col_parts[0][k])
                for k in col_parts[0]}
        status = (np.concatenate(st_parts) if len(st_parts) > 1
                  else st_parts[0])
        s = 0
        for it in live:
            e = s + len(it)
            it.columns = {k: v[s:e] for k, v in cols.items()}
            it.status = status[s:e]
            it.table_version = tver
            it.watermark = wm_min
            it.feature_age = age_max
            sq.stats["sub_batches"] += 1
            it.done.set()
            s = e

    def close(self) -> None:
        with self.cv:
            self.stop = True
            self.cv.notify_all()
        if self.thread is not None:
            self.thread.join(timeout=5.0)


class ShardRouter:
    """Owns the per-shard queues, the execution lanes that serve them,
    and the scatter/gather plumbing."""

    def __init__(self, n_shards: int, *, dispatch_rows: int = 256,
                 coalesce_delay_s: float = 0.002,
                 n_lanes: Optional[int] = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.dispatch_rows = dispatch_rows
        n_lanes = min(n_shards, max(1, n_lanes or n_shards))
        self.lanes = [_Lane(i, dispatch_rows,
                            coalesce_delay_s=coalesce_delay_s)
                      for i in range(n_lanes)]
        # shard s -> lane s % L: aligned with the engine's device
        # placement (shard s -> device s % D), so a lane's queues all
        # target the same device when L == D
        self.queues = [_ShardQueue(s, self.lanes[s % n_lanes])
                       for s in range(n_shards)]
        for sq in self.queues:
            sq.lane.queues.append(sq)
        for lane in self.lanes:
            lane.start()
        self._closed = False
        self._tracer = None

    # ------------------------------------------------------------- tracing
    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, t) -> None:
        """Share one tracer with every lane (sharded-engine wiring);
        lanes open one ``lane.execute`` span per coalesced dispatch."""
        self._tracer = t
        for lane in self.lanes:
            lane.tracer = t

    # ------------------------------------------------------------- scatter
    def submit(self, shard: int, item: SubBatch) -> SubBatch:
        return self.queues[shard].submit(item)

    def scatter(self, handles: Sequence, keys: np.ndarray, ts: np.ndarray,
                rows: Optional[np.ndarray], ctx=None,
                owners: Optional[np.ndarray] = None
                ) -> List[Tuple[np.ndarray, SubBatch]]:
        """Split a batch by key hash and enqueue one SubBatch per owning
        shard (``handles[s]`` serves shard ``s``). Returns
        ``[(original_row_indices, sub_batch), ...]``. ``owners`` lets the
        caller supply a precomputed (B,) shard-id array — the sharded
        engine passes its consistent-hash route table's answer; the
        default stays the pure modulo partitioner."""
        sid = owners if owners is not None \
            else shard_ids(keys, self.n_shards)
        out: List[Tuple[np.ndarray, SubBatch]] = []
        for s in np.unique(sid):
            idx = np.flatnonzero(sid == s)
            item = SubBatch(handles[s], keys[idx], ts[idx],
                            rows[idx] if rows is not None else None,
                            ctx=ctx)
            out.append((idx, self.queues[s].submit(item)))
        return out

    @staticmethod
    def gather(parts: List[Tuple[np.ndarray, SubBatch]], B: int,
               timeout: float = 120.0):
        """Wait for every sub-batch and reassemble columns/status in the
        original request order. Returns ``(columns, status,
        table_versions_by_part, any_shed)``; raises the first sub-batch
        error."""
        for _, it in parts:
            if not it.done.wait(timeout):
                raise TimeoutError(
                    f"shard {it.handle} did not answer within {timeout}s")
        for _, it in parts:
            if it.error is not None:
                raise it.error
        if any(it.shed for _, it in parts):
            return None, None, [], True
        columns: Dict[str, np.ndarray] = {}
        status = np.zeros(B, np.int8)
        tvers = []
        for idx, it in parts:
            for k, v in it.columns.items():
                col = columns.get(k)
                if col is None:
                    col = np.zeros((B,) + v.shape[1:], v.dtype)
                    columns[k] = col
                col[idx] = v
            status[idx] = it.status
            tvers.append(it.table_version)
        return columns, status, tvers, False

    # ----------------------------------------------------------------- tune
    def set_dispatch_rows(self, rows: int) -> int:
        """Retune the coalescing chunk size live (control-plane knob).
        Lanes read it per drain/execute, so the next dispatch uses the
        new chunking; ``max_drain_rows`` keeps its 4x relation. Returns
        the previous value."""
        if rows < 1:
            raise ValueError(f"dispatch_rows must be >= 1, got {rows}")
        prev = self.dispatch_rows
        self.dispatch_rows = rows
        for lane in self.lanes:
            with lane.cv:
                lane.dispatch_rows = rows
                lane.max_drain_rows = 4 * rows
                lane.cv.notify_all()
        return prev

    def set_coalesce_delay(self, seconds: float) -> float:
        """Retune how long an otherwise-idle lane waits to fill a chunk.
        Returns the previous value."""
        if seconds < 0:
            raise ValueError(f"coalesce_delay_s must be >= 0, got {seconds}")
        prev = self.lanes[0].coalesce_delay_s if self.lanes else 0.0
        for lane in self.lanes:
            with lane.cv:
                lane.coalesce_delay_s = seconds
                lane.cv.notify_all()
        return prev

    # -------------------------------------------------------------- elastic
    def add_queue(self) -> int:
        """Grow by one shard queue (consistent-hash resharding): the new
        queue rides an existing lane round-robin (``s % n_lanes``), so no
        new execution thread is needed. Returns the new shard id."""
        s = len(self.queues)
        lane = self.lanes[s % len(self.lanes)]
        sq = _ShardQueue(s, lane)
        with lane.cv:
            if lane.stop or not lane.accepting:
                raise RuntimeError("shard router is closed")
            lane.queues.append(sq)
            self.queues.append(sq)
        self.n_shards = len(self.queues)
        return s

    # --------------------------------------------------------------- intro
    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    def queue_depths(self) -> List[int]:
        return [sq.queue_depth for sq in self.queues]

    def stats(self) -> Dict[str, float]:
        agg = {"dispatches": 0, "rows": 0, "sub_batches": 0,
               "shed_sub_batches": 0, "max_queue_depth": 0,
               "n_lanes": len(self.lanes)}
        for lane in self.lanes:
            agg["dispatches"] += lane.stats["dispatches"]
            agg["rows"] += lane.stats["rows"]
        for sq in self.queues:
            agg["sub_batches"] += sq.stats["sub_batches"]
            agg["shed_sub_batches"] += sq.stats["shed_sub_batches"]
            agg["max_queue_depth"] = max(agg["max_queue_depth"],
                                         sq.stats["max_queue_depth"])
        agg["rows_per_dispatch"] = (agg["rows"] / agg["dispatches"]
                                    if agg["dispatches"] else 0.0)
        return agg

    def retire_queue(self, s: int) -> None:
        """Flip shard ``s`` to shed-on-submit. Items already queued were
        submitted before retirement and still execute (the runtime stays
        open through the following ``drain_shard``); anything arriving
        later — a scatter that routed on the pre-reshard table — sheds
        as ``worker_down`` instead of racing the runtime close."""
        sq = self.queues[s]
        with sq.lane.cv:
            sq.retired = True

    def drain_shard(self, s: int, timeout: float = 30.0) -> bool:
        """Wait until shard ``s``'s queue is empty and its lane holds none
        of its items — a shard runtime about to be retired must not be
        closed with sub-batches still queued/executing against it. The
        lane's ``active`` queue covers a *popped* item (its ``busy`` flag
        would also wait out other shards' work on a shared lane, which
        under steady traffic never ends); requiring two consecutive idle
        observations closes the narrow window between an owners_of()
        read and the submit it feeds."""
        sq = self.queues[s]
        lane = sq.lane
        deadline = time.monotonic() + timeout
        idle_seen = 0
        while time.monotonic() < deadline:
            with lane.cv:
                idle = not sq.q and lane.active is not sq
            idle_seen = idle_seen + 1 if idle else 0
            if idle_seen >= 2:
                return True
            time.sleep(0.005)
        return False

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0
                 ) -> None:
        """Stop the router. With ``drain=True`` (the graceful path —
        mirrors ``DynamicBatcher.close()``): new submits fail fast
        immediately, but every already-queued sub-batch COMPLETES before
        any lane thread stops — an in-flight gather can never race a
        closing queue. ``drain=False`` is the old fail-fast close: queued
        items error out with "shard router closed"."""
        if self._closed:
            return
        self._closed = True
        # 1) stop accepting new work everywhere, atomically per lane
        for lane in self.lanes:
            with lane.cv:
                lane.accepting = False
                lane.cv.notify_all()
        # 2) drain: wait until every queue is empty AND every lane has
        #    finished the items it already popped
        if drain:
            deadline = time.monotonic() + timeout
            for lane in self.lanes:
                with lane.cv:
                    while ((lane.busy or any(sq.q for sq in lane.queues))
                           and time.monotonic() < deadline):
                        lane.cv.wait(0.05)
        # 3) only now stop the lane threads (fail-fasting any remainder —
        #    none on the drain path unless the timeout was hit)
        for lane in self.lanes:
            with lane.cv:
                lane.stop = True
                lane.cv.notify_all()
        for lane in self.lanes:
            if lane.thread is not None:
                lane.thread.join(timeout=5.0)

    def close(self) -> None:
        """Fail-fast close (legacy semantics): queued-but-unstarted work
        errors out instead of completing. Prefer ``shutdown()``."""
        self.shutdown(drain=False)
