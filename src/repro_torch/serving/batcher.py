"""Dynamic request batcher (paper O5, resource management).

Requests arrive one at a time; executing them one at a time wastes the
vector unit, executing huge batches blows the latency SLO. The batcher
forms batches by a deadline/size policy:

* flush when ``max_batch`` requests are waiting, or
* when the oldest request has waited ``max_delay_s`` (its deadline).

The batch is served at its own size; the engine records its power-of-2
bucket, which a hot-swap redeploy warms before it publishes.

Admission control: a bounded queue — when the system is saturated the
caller sees backpressure instead of unbounded latency (the "balancing
CPU and memory under high concurrency" knob from the paper, adapted).

Requests may carry a :class:`~repro_torch.core.results.RequestContext`. Its
``version_pin`` is the **batch grouping key**: one batch never mixes
requests pinned to different deployment versions, so a batch is always
served end-to-end by a single version even while a hot-swap redeploy is
in flight. Requests whose context deadline has already passed are
expired in the queue (``DeadlineExceeded``) instead of occupying batch
slots.
"""
from __future__ import annotations

import collections
import dataclasses
import inspect
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.results import DeadlineExceeded, RequestContext
from repro_torch.obs.sketch import RollingSketch

__all__ = ["BatcherConfig", "DynamicBatcher", "Request", "BatcherClosed"]


class BatcherClosed(RuntimeError):
    """The batcher was shut down with this request still queued or in
    flight — the caller gets a definite error instead of a hung
    ``Request.wait()``."""


@dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 64
    max_delay_s: float = 0.002
    max_queue: int = 4096               # admission control bound
    num_dispatchers: int = 1


@dataclass
class Request:
    key: Any
    ts: float
    payload: Optional[np.ndarray] = None
    ctx: Optional[RequestContext] = None
    enqueued_at: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Any] = None
    error: Optional[Exception] = None

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self.done.wait(timeout):
            raise TimeoutError("request timed out")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result

    @property
    def group(self):
        """Batch grouping key: requests in one batch must share it."""
        return None if self.ctx is None else self.ctx.version_pin


class DynamicBatcher:
    """Groups requests and dispatches them to ``serve_batch``.

    ``serve_batch(keys, ts, payloads) -> {name: (B,) np.ndarray}``; a
    serve function that also accepts ``ctx=`` receives the batch's shared
    :class:`RequestContext` (version pin) and may return a
    ``FeatureFrame`` — its ``row(i)`` split keeps per-request metadata.
    """

    def __init__(self, serve_batch: Callable,
                 cfg: BatcherConfig = BatcherConfig(), *,
                 tracer=None):
        self.serve_batch = serve_batch
        self.cfg = cfg
        # optional repro_torch.obs.trace.Tracer: queue-wait spans and the
        # exemplar trace carried into the batch context
        self.tracer = tracer
        try:
            self._wants_ctx = "ctx" in inspect.signature(
                serve_batch).parameters
        except (TypeError, ValueError):
            self._wants_ctx = False
        self._q: Deque[Request] = collections.deque()
        # taken from the queue, not yet completed (close() must fail
        # these too); id-keyed because Request is an eq-dataclass
        self._inflight: Dict[int, Request] = {}
        self._lock = threading.Lock()
        self._new = threading.Condition(self._lock)
        self._stop = False
        self.stats = {"batches": 0, "requests": 0, "rejected": 0,
                      "expired": 0, "sum_batch": 0, "max_batch_seen": 0}
        # CLIENT-observed per-request latency (submit -> result), i.e.
        # queueing INCLUDED — the engine-side serve timer cannot see a
        # queue building up in front of it, this sketch can. A rolling
        # sketch (DESIGN.md §14) instead of the old 512-sample deque:
        # bounded memory AND bounded recency at any traffic level
        self._client_lat = RollingSketch(window_s=5.0)
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True)
            for _ in range(cfg.num_dispatchers)]
        for t in self._threads:
            t.start()

    # ---------------------------------------------------------------- client
    def submit(self, key, ts: float,
               payload: Optional[np.ndarray] = None,
               ctx: Optional[RequestContext] = None) -> Request:
        if ctx is not None and ctx.expired:
            with self._lock:
                self.stats["expired"] += 1
            raise DeadlineExceeded("deadline expired before enqueue")
        r = Request(key=key, ts=ts, payload=payload, ctx=ctx)
        with self._lock:
            if self._stop:
                raise BatcherClosed("batcher is closed")
            if len(self._q) >= self.cfg.max_queue:
                self.stats["rejected"] += 1
                raise RuntimeError("admission control: queue full")
            self._q.append(r)
            self._new.notify()
        return r

    def __call__(self, key, ts: float,
                 payload: Optional[np.ndarray] = None,
                 timeout: float = 5.0,
                 ctx: Optional[RequestContext] = None) -> Any:
        return self.submit(key, ts, payload, ctx=ctx).wait(timeout)

    # -------------------------------------------------------------- dispatch
    def _take_batch(self) -> List[Request]:
        cfg = self.cfg
        with self._new:
            while not self._q and not self._stop:
                self._new.wait(0.1)
            if self._stop:
                # close() fails whatever is still queued — dispatching it
                # here would race the shutdown (and a stuck serve_batch is
                # exactly what close() must not wait on)
                return []
            # deadline policy: wait for more work until the oldest
            # request's deadline, then take up to max_batch. cfg is
            # re-read each pass so a live retune (``reconfigure``) moves
            # even the deadline of the batch currently forming
            oldest = self._q[0].enqueued_at
            while True:
                cfg = self.cfg
                deadline = oldest + cfg.max_delay_s
                if (len(self._q) >= cfg.max_batch or self._stop
                        or time.perf_counter() >= deadline):
                    break
                self._new.wait(max(deadline - time.perf_counter(), 0.0001))
            if not self._q:
                # another dispatcher drained the queue while we waited
                # (the wait releases the lock)
                return []
            # one group per batch: take the head's group, skip (and keep
            # queued, in order) requests pinned to a different version
            group = self._q[0].group
            out: List[Request] = []
            kept: List[Request] = []
            while self._q and len(out) < cfg.max_batch:
                r = self._q.popleft()
                if r.ctx is not None and r.ctx.expired:
                    r.error = DeadlineExceeded(
                        "deadline expired while queued")
                    r.done.set()
                    self.stats["expired"] += 1
                    continue
                if r.group == group:
                    out.append(r)
                else:
                    kept.append(r)
            for r in reversed(kept):
                self._q.appendleft(r)
            # register as in-flight BEFORE releasing the lock: a close()
            # racing the dequeue must see every request in either the
            # queue or the in-flight set, or its wait() could hang
            self._inflight.update({id(r): r for r in out})
            return out

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop:
                    return
                continue
            keys = [r.key for r in batch]
            ts = np.asarray([r.ts for r in batch], np.float32)
            # A batch may mix payload and payload-less requests; absent
            # payloads become zero rows (the engine's own no-row default)
            # so one np.stack shape fits all.
            payloads = None
            proto = next((r.payload for r in batch
                          if r.payload is not None), None)
            if proto is not None:
                zero = np.zeros_like(proto)
                payloads = np.stack([r.payload if r.payload is not None
                                     else zero for r in batch])
            tracer = self.tracer
            if tracer is not None:
                # queue-wait spans recorded after the fact: enqueue ->
                # dispatch, per traced request (enqueued_at and the
                # tracer share the perf_counter clock)
                t_disp = time.perf_counter()
                for r in batch:
                    c = r.ctx
                    if (c is not None and c.trace_id
                            and tracer.sampled(c.trace_id)):
                        tracer.record("batch.queue_wait", c.trace_id,
                                      c.parent_span, r.enqueued_at,
                                      t_disp, tags={"batch": len(batch)})
            try:
                if self._wants_ctx:
                    bctx = self._batch_ctx(batch)
                    res = self.serve_batch(keys, ts, payloads, ctx=bctx)
                else:
                    res = self.serve_batch(keys, ts, payloads)
                if hasattr(res, "row"):
                    for i, r in enumerate(batch):
                        row = res.row(i)
                        if r.ctx is not None and r.ctx.trace_id:
                            # the batch frame carries the exemplar's
                            # trace id; each split row gets its own
                            # request's id back
                            row.trace_id = r.ctx.trace_id
                        r.result = row
                        r.done.set()
                else:
                    for i, r in enumerate(batch):
                        r.result = {k: v[i] for k, v in res.items()}
                        r.done.set()
            except Exception as e:
                for r in batch:
                    r.error = e
                    r.done.set()
            finally:
                now = time.perf_counter()
                with self._lock:
                    for r in batch:
                        self._inflight.pop(id(r), None)
                        self._client_lat.observe(now - r.enqueued_at)
                    st = self.stats      # dispatchers share the counters
                    st["batches"] += 1
                    st["requests"] += len(batch)
                    st["sum_batch"] += len(batch)
                    st["max_batch_seen"] = max(st["max_batch_seen"],
                                               len(batch))

    def _batch_ctx(self, batch: List[Request]
                   ) -> Optional[RequestContext]:
        """The batch's shared downstream context: its version pin (every
        request of a batch shares one pin group) plus, when a tracer is
        attached, an exemplar trace: the first request with a sampled
        trace lends its ``trace_id``/``parent_span`` (the engine opens
        one serve span per batch, so one request stands for the whole
        dispatch)."""
        pin = batch[0].group
        trace_id = parent = None
        tracer = self.tracer
        if tracer is not None:
            ex = next((r.ctx for r in batch
                       if r.ctx is not None and r.ctx.trace_id
                       and tracer.sampled(r.ctx.trace_id)), None)
            if ex is not None:
                trace_id, parent = ex.trace_id, ex.parent_span
        if pin is None and trace_id is None:
            return None
        return RequestContext(version_pin=pin, trace_id=trace_id,
                              parent_span=parent)

    # ------------------------------------------------------------------ tune
    def reconfigure(self, **changes) -> BatcherConfig:
        """Replace batching policy knobs live (control-plane surface).
        ``num_dispatchers`` cannot change (threads are fixed at
        construction). Dispatchers re-read the config per wait pass, so a
        shorter ``max_delay_s`` even shortens the batch currently
        forming. Returns the previous config."""
        if "num_dispatchers" in changes:
            raise ValueError("num_dispatchers is fixed at construction")
        with self._lock:
            prev = self.cfg
            self.cfg = dataclasses.replace(prev, **changes)
            self._new.notify_all()     # wake waiters onto the new policy
            return prev

    # ----------------------------------------------------------------- intro
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    def client_latency_percentile(self, pct: float) -> float:
        """Percentile of client-observed request latency (enqueue ->
        completion; queueing delay included). NaN until a request has
        completed. This is the load signal the control plane prefers:
        under saturation the serve-side p99 stays flat while THIS one
        grows by the queueing delay."""
        return self._client_lat.percentile(pct)

    def oldest_age_s(self) -> float:
        """Age of the oldest queued request (0 when the queue is empty) —
        the batcher-side queueing-delay signal the knob controller reads."""
        with self._lock:
            if not self._q:
                return 0.0
            return time.perf_counter() - self._q[0].enqueued_at

    def close(self) -> None:
        """Shut down the dispatchers and FAIL whatever is still pending.

        Every queued request — and any request inside a dispatch that did
        not finish within the join grace period (e.g. a blocked
        ``serve_batch``) — has its ``wait()`` raised with
        :class:`BatcherClosed` instead of hanging until timeout. A
        concurrently-completing dispatch may still deliver its result
        first; completion and close-failure race benignly (first write to
        ``done`` wins from the caller's perspective)."""
        with self._lock:
            self._stop = True
            self._new.notify_all()
        for t in self._threads:
            t.join(timeout=1.0)
        with self._lock:
            leftovers = list(self._q) + list(self._inflight.values())
            self._q.clear()
            self._inflight.clear()
        for r in leftovers:
            if not r.done.is_set():
                r.error = BatcherClosed(
                    "batcher closed before this request was served")
                r.done.set()

    @property
    def mean_batch(self) -> float:
        b = self.stats["batches"]
        return self.stats["sum_batch"] / b if b else 0.0
