"""Mergeable observability sketches (DESIGN.md §14).

The freshness/SLO tier needs percentiles that (a) use bounded memory no
matter how long a deployment serves, (b) merge EXACTLY across shards —
a process-backed shard ships its sketch over a pickle boundary and the
parent must recover the same percentile a single engine would have
computed — and (c) are deterministic, so two runs over the same stream
agree bit for bit.

:class:`QuantileSketch` is a DDSketch-style log-bucketed quantile
sketch: a value ``v > 0`` lands in bucket ``ceil(log(v)/log(gamma))``
with ``gamma = (1+a)/(1-a)`` for relative error ``a``, negatives mirror
into their own bucket map, and near-zeros collapse into a dedicated
zero bucket. Buckets hold integer counts, so merging is integer
addition — exact, associative, and commutative — and any quantile is
recovered within relative error ``a`` by walking the buckets in value
order. Every observation (scalar included) routes through ONE
vectorized ``np.log`` path so scalar-vs-batch bucketing can never
diverge in the last ulp: equal value multisets produce equal sketches,
which is what makes the cross-shard-merged p99 bit-identical to the
single-engine p99 (tests/test_freshness.py).

:class:`RollingSketch` bounds RECENCY as well as memory: two pane
sketches rotate every ``window_s``, queries merge both panes. It
replaces the fixed-length deque reservoirs in ``HandleMetrics`` and the
batcher — those were bounded in samples (stale forever at low traffic);
this is bounded in time.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = ["QuantileSketch", "RollingSketch", "ZERO_EPS", "DEFAULT_REL_ERR"]

# |v| below this collapses into the zero bucket (log of a denormal would
# otherwise mint an absurdly-negative bucket index)
ZERO_EPS = 1e-12
DEFAULT_REL_ERR = 0.01


class QuantileSketch:
    """Deterministic log-bucketed quantile sketch with exact merge.

    Thread-safe; all mutation and query methods take the internal lock.
    ``sum`` is tracked for mean/export convenience but is NOT part of the
    bit-for-bit contract (float addition is not associative across merge
    orders) — quantiles, counts, min and max are.
    """

    __slots__ = ("rel_err", "gamma", "_log_gamma", "pos", "neg", "zero",
                 "count", "sum", "vmin", "vmax", "_lock")

    def __init__(self, rel_err: float = DEFAULT_REL_ERR):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = float(rel_err)
        self.gamma = (1.0 + self.rel_err) / (1.0 - self.rel_err)
        self._log_gamma = math.log(self.gamma)
        self.pos: Dict[int, int] = {}
        self.neg: Dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    # ------------------------------------------------------------- observe
    def observe(self, value: float) -> int:
        """Observe one value (routed through the vectorized path — see
        module docstring for why there is no scalar fast path)."""
        return self.observe_many((value,))

    def observe_many(self, values) -> int:
        """Observe a batch; returns how many finite values were added
        (NaN/inf are skipped, they have no bucket)."""
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return 0
        v = v[np.isfinite(v)]
        if v.size == 0:
            return 0
        with self._lock:
            self.count += int(v.size)
            self.sum += float(v.sum())
            self.vmin = min(self.vmin, float(v.min()))
            self.vmax = max(self.vmax, float(v.max()))
            neg = v < -ZERO_EPS
            pos = v > ZERO_EPS
            self.zero += int(v.size - int(neg.sum()) - int(pos.sum()))
            for store, part in ((self.pos, v[pos]), (self.neg, -v[neg])):
                if not part.size:
                    continue
                idx = np.ceil(np.log(part)
                              / self._log_gamma).astype(np.int64)
                if part.size <= 512:
                    # small batches (the per-serve path): a plain dict
                    # loop beats np.unique's sort + two array round trips
                    for i in idx.tolist():
                        store[i] = store.get(i, 0) + 1
                else:
                    uniq, cnt = np.unique(idx, return_counts=True)
                    for i, c in zip(uniq.tolist(), cnt.tolist()):
                        store[i] = store.get(i, 0) + c
        return int(v.size)

    # ------------------------------------------------------------- queries
    def _rep(self, idx: int) -> float:
        """Representative value of positive bucket ``idx`` (midpoint of
        ``(gamma^(idx-1), gamma^idx]`` in relative terms)."""
        return 2.0 * self.gamma ** idx / (self.gamma + 1.0)

    def _clip(self, v: float) -> float:
        # observed extremes bound every representative: the p0/p100 of a
        # sketch are the true min/max, and merged extremes are exact
        return max(self.vmin, min(self.vmax, v))

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; NaN when empty."""
        with self._lock:
            if self.count == 0:
                return float("nan")
            q = min(max(q, 0.0), 1.0)
            rank = q * (self.count - 1)
            acc = 0
            for i in sorted(self.neg, reverse=True):  # most negative first
                acc += self.neg[i]
                if acc > rank:
                    return self._clip(-self._rep(i))
            acc += self.zero
            if acc > rank:
                return self._clip(0.0)
            for i in sorted(self.pos):
                acc += self.pos[i]
                if acc > rank:
                    return self._clip(self._rep(i))
            return self.vmax

    def percentile(self, pct: float) -> float:
        """``quantile(pct / 100)`` — drop-in for ``np.percentile``."""
        return self.quantile(pct / 100.0)

    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else float("nan")

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:            # empty sketch is falsy, like
        return self.count > 0              # the deques it replaces

    @property
    def n_buckets(self) -> int:
        with self._lock:
            return len(self.pos) + len(self.neg) + (1 if self.zero else 0)

    # --------------------------------------------------------------- merge
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into ``self`` (exact: integer bucket adds).
        Accepts a sketch or a ``to_dict()`` snapshot."""
        data = other if isinstance(other, dict) else other.to_dict()
        if abs(data["rel_err"] - self.rel_err) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different rel_err "
                f"({data['rel_err']} vs {self.rel_err})")
        with self._lock:
            for i, c in data["pos"]:
                self.pos[int(i)] = self.pos.get(int(i), 0) + int(c)
            for i, c in data["neg"]:
                self.neg[int(i)] = self.neg.get(int(i), 0) + int(c)
            self.zero += int(data["zero"])
            self.count += int(data["count"])
            self.sum += float(data["sum"])
            self.vmin = min(self.vmin, float(data["min"]))
            self.vmax = max(self.vmax, float(data["max"]))
        return self

    @classmethod
    def merged(cls, sketches: Sequence) -> "QuantileSketch":
        """New sketch = exact merge of ``sketches`` (sketches or
        ``to_dict()`` snapshots; empties and ``None`` are skipped)."""
        live = [s for s in sketches if s is not None]
        rel = None
        for s in live:
            rel = s["rel_err"] if isinstance(s, dict) else s.rel_err
            break
        out = cls(rel_err=rel if rel is not None else DEFAULT_REL_ERR)
        for s in live:
            out.merge(s)
        return out

    # ----------------------------------------------------------- serialize
    def to_dict(self) -> Dict[str, Any]:
        """Picklable/JSON-able snapshot; bucket lists are index-sorted, so
        equal sketches serialize identically regardless of observation
        order (deterministic-serialization test)."""
        with self._lock:
            return {
                "kind": "qsketch", "rel_err": self.rel_err,
                "count": self.count, "zero": self.zero, "sum": self.sum,
                "min": self.vmin, "max": self.vmax,
                "pos": sorted([int(i), int(c)]
                              for i, c in self.pos.items()),
                "neg": sorted([int(i), int(c)]
                              for i, c in self.neg.items()),
            }

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "QuantileSketch":
        out = cls(rel_err=float(data["rel_err"]))
        out.merge(dict(data))
        return out

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "QuantileSketch":
        return cls.from_dict(json.loads(blob.decode()))

    @staticmethod
    def is_sketch_dict(v) -> bool:
        return isinstance(v, dict) and v.get("kind") == "qsketch"

    def histogram(self) -> List[Tuple[float, int]]:
        """Cumulative ``(upper_bound, count_le)`` pairs in ascending bound
        order — the native-histogram exposition for Prometheus. The last
        pair's count equals ``count``."""
        with self._lock:
            neg = sorted(self.neg.items(), reverse=True)
            pos = sorted(self.pos.items())
            zero, g = self.zero, self.gamma
        out: List[Tuple[float, int]] = []
        acc = 0
        for i, c in neg:       # bucket -(g^(i-1), g^i] has upper -g^(i-1)
            acc += c
            out.append((-(g ** (i - 1)), acc))
        if zero:
            acc += zero
            out.append((ZERO_EPS, acc))
        for i, c in pos:
            acc += c
            out.append((g ** i, acc))
        return out

    def __repr__(self) -> str:
        return (f"QuantileSketch(rel_err={self.rel_err}, n={self.count}, "
                f"buckets={self.n_buckets})")


class RollingSketch:
    """Two-pane rotating :class:`QuantileSketch` — recency-bounded
    percentiles in bounded memory.

    The current pane accumulates observations; every ``window_s`` it
    becomes the previous pane and a fresh one opens, so a percentile
    query (which merges both panes) reflects between ``window_s`` and
    ``2·window_s`` of history. This replaces the fixed-length deque
    reservoirs: those displaced by SAMPLE count, which at low traffic
    kept stale outliers alive indefinitely; panes displace by TIME.

    ``len()`` is the MONOTONIC total observed (it never rotates away) —
    the replan health gate counts batches-since-swap with it, exactly
    what the old ``len(deque)`` provided while the reservoir filled.
    """

    __slots__ = ("rel_err", "window_s", "_clock", "_cur", "_prev",
                 "_start", "total", "_lock")

    def __init__(self, rel_err: float = DEFAULT_REL_ERR,
                 window_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.rel_err = float(rel_err)
        self.window_s = float(window_s)
        self._clock = clock
        self._cur = QuantileSketch(rel_err)
        self._prev = QuantileSketch(rel_err)
        self._start = clock()
        self.total = 0
        self._lock = threading.Lock()

    def _rotate_locked(self, now: float) -> None:
        dt = now - self._start
        if dt < self.window_s:
            return
        if dt < 2.0 * self.window_s:
            self._prev = self._cur
        else:                              # idle past both panes
            self._prev = QuantileSketch(self.rel_err)
        self._cur = QuantileSketch(self.rel_err)
        self._start = now

    def observe(self, value: float) -> None:
        self.observe_many((value,))

    def observe_many(self, values) -> int:
        now = self._clock()
        with self._lock:
            self._rotate_locked(now)
            n = self._cur.observe_many(values)
            self.total += n
        return n

    def sketch(self) -> QuantileSketch:
        """Merged copy of both panes (what exports/merges see)."""
        now = self._clock()
        with self._lock:
            self._rotate_locked(now)
            panes = (self._prev, self._cur)
        return QuantileSketch.merged(panes)

    def percentile(self, pct: float) -> float:
        """Percentile over the rolling window; NaN when empty."""
        return self.sketch().percentile(pct)

    def quantile(self, q: float) -> float:
        return self.sketch().quantile(q)

    def window_count(self) -> int:
        """Samples currently inside the rolling window."""
        now = self._clock()
        with self._lock:
            self._rotate_locked(now)
            return self._prev.count + self._cur.count

    def clear(self) -> None:
        """Drop all history (panes AND the monotonic total) — same
        contract as ``deque.clear()`` on the reservoirs this replaces."""
        with self._lock:
            self._cur = QuantileSketch(self.rel_err)
            self._prev = QuantileSketch(self.rel_err)
            self._start = self._clock()
            self.total = 0

    def __len__(self) -> int:
        return self.total

    def __bool__(self) -> bool:
        return self.total > 0

    def __repr__(self) -> str:
        return (f"RollingSketch(window_s={self.window_s}, "
                f"total={self.total}, in_window={self.window_count()})")
