"""Distributed tracing: spans, trace ids, bounded storage (DESIGN.md §13).

One request's path — server admission → batcher queue → router lane →
shard engine serve → kernel launches — is recorded as a tree of
:class:`Span`\\ s sharing one trace id. Design points:

* **Monotonic clock.** Span times are ``time.perf_counter()`` values,
  meaningful only within one process. Spans exported by another
  process's tracer carry that process's clock; the adopter **re-bases**
  them onto its own clock before adoption (``rebase`` argument of
  :meth:`Tracer.adopt`).
* **Deterministic sampling.** ``sampled(trace_id)`` hashes the trace id
  (crc32 / 2^32 < rate), so every tier — client, batcher, router,
  worker — makes the SAME keep/drop decision with zero coordination; a
  trace is never half-recorded because one tier flipped a coin
  differently.
* **Bounded ring storage.** Traces live in an LRU-bounded ordered map
  (``max_traces``), each capped at ``max_spans_per_trace`` spans; a
  tracer can run forever under load without growing.
* **Idempotent adoption.** Spans are keyed by globally-unique span id
  (pid-prefixed counter); adopting the same exported span twice — the
  at-least-once transport's dup/retry path re-delivers worker spans
  verbatim — is a counted no-op, never a duplicate tree node.
* **Slow-query log.** Finishing a root span updates a duration
  reservoir; a root beyond the running p99 (after ``slow_min_samples``
  warmup) captures its full exported trace into a bounded exemplar log.
"""
from __future__ import annotations

import collections
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

__all__ = ["new_trace_id", "Span", "Tracer"]

# Crockford base32 (no I/L/O/U) — the ULID alphabet
_B32 = "0123456789ABCDEFGHJKMNPQRSTVWXYZ"


def _b32(value: int, n_chars: int) -> str:
    out = []
    for _ in range(n_chars):
        out.append(_B32[value & 31])
        value >>= 5
    return "".join(reversed(out))


def new_trace_id() -> str:
    """ULID-style id: 48-bit unix-ms timestamp + 80 random bits in 26
    Crockford-base32 chars — lexically sortable by creation time and
    collision-safe across processes (the random half comes from
    ``os.urandom``, so forked workers can't repeat a sequence)."""
    ms = int(time.time() * 1000) & ((1 << 48) - 1)
    rnd = int.from_bytes(os.urandom(10), "big")
    return _b32(ms, 10) + _b32(rnd, 16)


@dataclass
class Span:
    """One timed node of a trace tree. ``start``/``end`` are
    ``perf_counter`` seconds in the RECORDING process's clock domain."""

    trace_id: str
    span_id: str
    name: str
    parent_id: Optional[str] = None
    start: float = 0.0
    end: float = 0.0
    tags: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(self.end - self.start, 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "name": self.name, "parent_id": self.parent_id,
                "start": self.start, "end": self.end,
                "duration_s": self.duration_s, "tags": dict(self.tags)}


class Tracer:
    """Thread-safe span recorder with bounded storage and sampling.

    The zero-sampling fast path costs one float compare per call site
    (``start``/``record`` return ``None`` immediately), which is what
    keeps tracing's serving overhead inside the ≤5% budget even when
    left compiled into every tier.
    """

    def __init__(self, sample_rate: float = 1.0, *, max_traces: int = 256,
                 max_spans_per_trace: int = 512, slow_log_size: int = 32,
                 slow_min_samples: int = 30):
        self.sample_rate = float(sample_rate)
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.slow_min_samples = int(slow_min_samples)
        # trace_id -> {span_id -> Span}; LRU order, oldest evicted
        self._traces: "collections.OrderedDict[str, Dict[str, Span]]" = \
            collections.OrderedDict()
        self._root_durations: "collections.deque" = \
            collections.deque(maxlen=512)
        # cached p99 threshold, refreshed every 16 roots — an
        # np.percentile over the full reservoir on EVERY root finish
        # would put an O(reservoir) sort on the per-batch serving path
        self._slow_p99 = float("inf")
        self._roots_seen = 0
        self._slow: "collections.deque" = \
            collections.deque(maxlen=slow_log_size)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._seq = 0
        self.counters: Dict[str, int] = {
            "spans_started": 0, "spans_recorded": 0, "spans_adopted": 0,
            "spans_deduped": 0, "spans_dropped": 0, "traces_evicted": 0,
            "slow_queries": 0}

    # ---------------------------------------------------------- sampling
    def set_sample_rate(self, rate: float) -> None:
        self.sample_rate = float(rate)

    def sampled(self, trace_id: Optional[str]) -> bool:
        """Deterministic per-trace keep/drop — identical in every
        process that sees the same trace id."""
        if trace_id is None or self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        return (zlib.crc32(trace_id.encode("ascii", "replace"))
                / 2.0 ** 32) < self.sample_rate

    def _next_span_id(self) -> str:
        # pid prefix: ids stay unique across worker respawns (a fresh
        # incarnation restarts its counter but not its pid... and even a
        # recycled pid restarts the RANDOM trace, not the span storage)
        with self._lock:
            self._seq += 1
            return f"{self._pid:x}-{self._seq:x}"

    # --------------------------------------------------------- recording
    def start(self, name: str, trace_id: Optional[str],
              parent_id: Optional[str] = None,
              tags: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Open a span (``None`` when the trace isn't sampled — every
        other method accepts ``None`` spans as no-ops)."""
        if not self.sampled(trace_id):
            return None
        self.counters["spans_started"] += 1
        return Span(trace_id=trace_id, span_id=self._next_span_id(),
                    name=name, parent_id=parent_id,
                    start=time.perf_counter(),
                    tags=dict(tags) if tags else {})

    def finish(self, span: Optional[Span],
               tags: Optional[Dict[str, Any]] = None) -> None:
        if span is None:
            return
        span.end = time.perf_counter()
        if tags:
            span.tags.update(tags)
        self._store(span)
        if span.parent_id is None:
            self._observe_root(span)

    def record(self, name: str, trace_id: Optional[str],
               parent_id: Optional[str], start: float, end: float,
               tags: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Retroactive span: the interval already happened (e.g. a
        batcher queue wait measured from the request's enqueue time)."""
        if not self.sampled(trace_id):
            return None
        span = Span(trace_id=trace_id, span_id=self._next_span_id(),
                    name=name, parent_id=parent_id, start=float(start),
                    end=float(end), tags=dict(tags) if tags else {})
        self.counters["spans_recorded"] += 1
        self._store(span)
        return span

    def _store(self, span: Span) -> None:
        with self._lock:
            tr = self._traces.get(span.trace_id)
            if tr is None:
                tr = self._traces[span.trace_id] = {}
            if span.span_id in tr:
                self.counters["spans_deduped"] += 1
                return
            if len(tr) >= self.max_spans_per_trace:
                self.counters["spans_dropped"] += 1
                return
            tr[span.span_id] = span
            self._traces.move_to_end(span.trace_id)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
                self.counters["traces_evicted"] += 1

    # ---------------------------------------------------------- adoption
    def adopt(self, spans: Iterable[Dict[str, Any]],
              rebase: float = 0.0) -> int:
        """Insert spans exported by ANOTHER tracer (a worker subprocess),
        shifting their times by ``rebase`` seconds into this process's
        clock domain. Keyed by span id: re-adopting the same export (the
        at-least-once transport's dup path) is a counted no-op. Returns
        spans newly adopted."""
        n = 0
        for d in spans:
            span = Span(trace_id=d["trace_id"], span_id=d["span_id"],
                        name=d["name"], parent_id=d.get("parent_id"),
                        start=float(d["start"]) + rebase,
                        end=float(d["end"]) + rebase,
                        tags=dict(d.get("tags") or {}))
            before = self.counters["spans_deduped"] \
                + self.counters["spans_dropped"]
            self._store(span)
            if (self.counters["spans_deduped"]
                    + self.counters["spans_dropped"]) == before:
                n += 1
        self.counters["spans_adopted"] += n
        return n

    # ------------------------------------------------------------- query
    def trace(self, trace_id: str) -> List[Span]:
        """Spans of one trace, by start time."""
        with self._lock:
            tr = self._traces.get(trace_id, {})
            return sorted(tr.values(), key=lambda s: (s.start, s.span_id))

    def export_trace(self, trace_id: str) -> List[Dict[str, Any]]:
        return [s.to_dict() for s in self.trace(trace_id)]

    def tree(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The trace as a nested dict (root = the parentless span; spans
        whose parent was recorded elsewhere attach under the root)."""
        spans = self.trace(trace_id)
        if not spans:
            return None
        nodes = {s.span_id: {"name": s.name, "span_id": s.span_id,
                             "start": s.start, "duration_s": s.duration_s,
                             "tags": dict(s.tags), "children": []}
                 for s in spans}
        root = None
        for s in spans:
            if s.parent_id is None and root is None:
                root = nodes[s.span_id]
        orphans = []
        for s in spans:
            if s.parent_id is None:
                # sibling parentless spans (a tier called without an
                # enclosing server root) hang under the first root
                if root is not None and nodes[s.span_id] is not root:
                    orphans.append(nodes[s.span_id])
                continue
            parent = nodes.get(s.parent_id)
            if parent is not None:
                parent["children"].append(nodes[s.span_id])
            else:
                orphans.append(nodes[s.span_id])
        if root is None:
            root = (orphans or list(nodes.values()))[0]
        for o in orphans:
            if o is not root:
                root["children"].append(o)
        return root

    @staticmethod
    def walk(tree: Optional[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Flatten a :meth:`tree` into a pre-order node list."""
        out: List[Dict[str, Any]] = []
        stack = [tree] if tree else []
        while stack:
            node = stack.pop()
            out.append(node)
            stack.extend(reversed(node["children"]))
        return out

    # -------------------------------------------------------- slow query
    def _observe_root(self, span: Span) -> None:
        dur = span.duration_s
        with self._lock:
            self._root_durations.append(dur)
            self._roots_seen += 1
            n = len(self._root_durations)
            if n < self.slow_min_samples:
                return
            if (self._slow_p99 == float("inf")
                    or self._roots_seen % 16 == 0):
                self._slow_p99 = float(np.percentile(
                    np.asarray(self._root_durations, np.float64), 99))
            p99 = self._slow_p99
        if dur > p99:
            self.counters["slow_queries"] += 1
            self._slow.append({"trace_id": span.trace_id,
                               "duration_s": dur, "root": span.name,
                               "spans": self.export_trace(span.trace_id)})

    def slow_queries(self) -> List[Dict[str, Any]]:
        return list(self._slow)

    # ---------------------------------------------------------- export
    def snapshot(self) -> Dict[str, float]:
        """Monotonic counters + gauges (unified-export group)."""
        with self._lock:
            n_traces = len(self._traces)
            n_spans = sum(len(tr) for tr in self._traces.values())
        out: Dict[str, float] = dict(self.counters)
        out["sample_rate"] = self.sample_rate
        out["traces_stored"] = n_traces
        out["spans_stored"] = n_spans
        out["slow_log_size"] = len(self._slow)
        return out
