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

:class:`CardinalityEstimator` is a k-minimum-values distinct counter
over splitmix64 hashes (exact below k, unbiased ``(k-1)/h_k`` above,
merge = union-then-truncate). :func:`psi_distance` +
:class:`DriftMonitor` turn per-column sketches into an online/offline
feature-skew detector (population stability index over the aligned log
buckets two same-``rel_err`` sketches share by construction).
"""
from __future__ import annotations

import json
import math
import threading
import time
import zlib
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

__all__ = ["QuantileSketch", "RollingSketch", "CardinalityEstimator",
           "psi_distance", "DriftMonitor", "ZERO_EPS", "DEFAULT_REL_ERR"]

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


# --------------------------------------------------------- cardinality
_SM_GOLD = np.uint64(0x9E3779B97F4B7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 (wrapping math)."""
    z = x + _SM_GOLD
    z = (z ^ (z >> np.uint64(30))) * _SM_M1
    z = (z ^ (z >> np.uint64(27))) * _SM_M2
    return z ^ (z >> np.uint64(31))


class CardinalityEstimator:
    """k-minimum-values distinct-key counter (exact below ``k``).

    Keeps the ``k`` smallest splitmix64 hashes seen; with the hash space
    normalized to [0, 1), the kth minimum ``h_k`` estimates density and
    ``(k-1)/h_k`` the distinct count. Merge = union then truncate — the
    same invariant a single estimator over the union would hold, so
    cross-shard merges are exact in distribution.
    """

    __slots__ = ("k", "_kmv", "_lock")

    def __init__(self, k: int = 256):
        self.k = int(k)
        self._kmv: set = set()
        self._lock = threading.Lock()

    @staticmethod
    def _hash(keys) -> np.ndarray:
        arr = np.asarray(keys)
        if arr.size == 0:
            return np.zeros((0,), np.uint64)
        if arr.dtype.kind not in "iu":
            # non-integer keys: stable content hash (NOT Python's salted
            # hash() — shards in different processes must agree)
            arr = np.asarray([zlib.crc32(repr(k).encode())
                              for k in arr.ravel().tolist()], np.uint64)
        return _splitmix64(arr.astype(np.uint64, copy=False).ravel())

    def add(self, key) -> None:
        self.add_many((key,))

    def add_many(self, keys) -> None:
        h = self._hash(keys)
        if h.size == 0:
            return
        with self._lock:
            self._kmv.update(h.tolist())
            if len(self._kmv) > 4 * self.k:
                self._truncate_locked()

    def _truncate_locked(self) -> None:
        if len(self._kmv) > self.k:
            self._kmv = set(sorted(self._kmv)[:self.k])

    def estimate(self) -> float:
        with self._lock:
            self._truncate_locked()
            mv = sorted(self._kmv)
        if not mv:
            return 0.0
        if len(mv) < self.k:
            return float(len(mv))
        return (self.k - 1) * 2.0 ** 64 / float(mv[-1])

    def merge(self, other) -> "CardinalityEstimator":
        data = other if isinstance(other, dict) else other.to_dict()
        with self._lock:
            self._kmv.update(int(h) for h in data["kmv"])
            self._truncate_locked()
        return self

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            self._truncate_locked()
            return {"kind": "kmv", "k": self.k,
                    "kmv": sorted(self._kmv)}

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "CardinalityEstimator":
        out = cls(k=int(data["k"]))
        out.merge(dict(data))
        return out

    def __repr__(self) -> str:
        return f"CardinalityEstimator(k={self.k}, est={self.estimate():.0f})"


# ----------------------------------------------------------------- drift
def _bucket_fracs(d: Mapping[str, Any]) -> Dict[Tuple[str, int], float]:
    total = float(d["count"]) or 1.0
    out: Dict[Tuple[str, int], float] = {}
    for i, c in d["neg"]:
        out[("n", int(i))] = c / total
    if d["zero"]:
        out[("z", 0)] = d["zero"] / total
    for i, c in d["pos"]:
        out[("p", int(i))] = c / total
    return out


def psi_distance(ref, live, *, eps: float = 1e-4) -> float:
    """Population stability index between two same-``rel_err`` sketches.

    Log buckets with equal gamma are ALIGNED bins by construction, so no
    re-binning step is needed — PSI is summed over the union of occupied
    buckets with ``eps`` smoothing for empty cells. Conventional reading:
    < 0.1 stable, 0.1–0.25 moderate shift, > 0.25 drifted. NaN when
    either side is empty (no distribution to compare).
    """
    rd = ref if isinstance(ref, dict) else ref.to_dict()
    ld = live if isinstance(live, dict) else live.to_dict()
    if abs(rd["rel_err"] - ld["rel_err"]) > 1e-12:
        raise ValueError("PSI needs equal rel_err (aligned buckets), got "
                         f"{rd['rel_err']} vs {ld['rel_err']}")
    if rd["count"] == 0 or ld["count"] == 0:
        return float("nan")
    p = _bucket_fracs(rd)
    q = _bucket_fracs(ld)
    psi = 0.0
    for k in set(p) | set(q):
        pe = max(p.get(k, 0.0), eps)
        qe = max(q.get(k, 0.0), eps)
        psi += (qe - pe) * math.log(qe / pe)
    return psi


class DriftMonitor:
    """Online/offline feature-skew detector over per-column sketches.

    The serve path feeds the LIVE side (output feature columns, pad rows
    excluded); the reference side is either observed directly from an
    offline/training materialisation (:meth:`observe_reference`) or
    pinned from the current live window (:meth:`pin_reference` — e.g. at
    deploy time, "what serving looked like when the model shipped").
    :meth:`report` scores each column's live-vs-reference PSI. Snapshots
    are plain dicts so per-shard monitors merge across the worker RPC
    boundary exactly like the freshness sketches.
    """

    MAX_PENDING = 256        # serve batches buffered before a forced fold

    def __init__(self, rel_err: float = 0.02,
                 psi_threshold: float = 0.25):
        self.rel_err = float(rel_err)
        self.psi_threshold = float(psi_threshold)
        self._live: Dict[str, QuantileSketch] = {}
        self._ref: Dict[str, QuantileSketch] = {}
        # serve-path batches are BUFFERED (column-array references) and
        # folded into the live sketches lazily — on any read, or when
        # MAX_PENDING batches pile up. The hot path pays one list append
        # instead of a per-column sketch insert; fold order can't change
        # the result (sketch insertion is commutative).
        self._pending: List[Tuple[Mapping[str, Any], Optional[int]]] = []
        self._lock = threading.Lock()

    def _store(self, store: Dict[str, QuantileSketch],
               columns: Mapping[str, Any], n: Optional[int]) -> None:
        for name, vals in columns.items():
            if name.startswith("__"):       # hidden/meta columns
                continue
            with self._lock:
                sk = store.get(name)
                if sk is None:
                    sk = store[name] = QuantileSketch(self.rel_err)
            arr = np.asarray(vals)
            sk.observe_many(arr[:n] if n is not None else arr)

    def _drain(self) -> None:
        """Fold every buffered serve batch into the live sketches."""
        with self._lock:
            if not self._pending:
                return
            pending, self._pending = self._pending, []
        for cols, n in pending:
            self._store(self._live, cols, n)

    def observe(self, columns: Mapping[str, Any],
                n: Optional[int] = None) -> None:
        """Feed served feature columns into the live side (``n`` caps to
        the first n rows — lane edge-pad rows must not skew the
        distribution). O(1) on the serve path: the batch is buffered and
        folded on the next read (or after MAX_PENDING batches)."""
        with self._lock:
            self._pending.append((columns, n))
            full = len(self._pending) >= self.MAX_PENDING
        if full:
            self._drain()

    def observe_reference(self, columns: Mapping[str, Any],
                          n: Optional[int] = None) -> None:
        self._store(self._ref, columns, n)

    def pin_reference(self) -> List[str]:
        """Adopt the current live window as the reference and restart
        live accumulation; returns the pinned column names."""
        self._drain()
        with self._lock:
            self._ref = self._live
            self._live = {}
            return sorted(self._ref)

    def psi(self, column: str) -> float:
        self._drain()
        with self._lock:
            ref = self._ref.get(column)
            live = self._live.get(column)
        if ref is None or live is None:
            return float("nan")
        return psi_distance(ref, live)

    def columns(self) -> List[str]:
        self._drain()
        with self._lock:
            return sorted(set(self._live) | set(self._ref))

    def report(self) -> Dict[str, Dict[str, float]]:
        self._drain()
        out: Dict[str, Dict[str, float]] = {}
        for col in self.columns():
            with self._lock:
                ref = self._ref.get(col)
                live = self._live.get(col)
            psi = (psi_distance(ref, live)
                   if ref is not None and live is not None
                   else float("nan"))
            out[col] = {
                "psi": psi,
                "drifted": bool(psi > self.psi_threshold)
                if math.isfinite(psi) else False,
                "live_count": live.count if live is not None else 0,
                "ref_count": ref.count if ref is not None else 0,
            }
        return out

    def max_psi(self) -> float:
        """Worst finite column PSI (NaN if nothing is comparable) — the
        scalar the SLO engine watches."""
        vals = [r["psi"] for r in self.report().values()
                if math.isfinite(r["psi"])]
        return max(vals) if vals else float("nan")

    def export(self) -> Dict[str, float]:
        """Flat metrics for the registry ``drift`` group."""
        out: Dict[str, float] = {}
        for col, r in self.report().items():
            out[f"{col}/psi"] = r["psi"]
            out[f"{col}/drifted"] = 1.0 if r["drifted"] else 0.0
            out[f"{col}/live_count"] = float(r["live_count"])
            out[f"{col}/ref_count"] = float(r["ref_count"])
        return out

    # ------------------------------------------------------ shard merging
    def snapshot(self) -> Dict[str, Any]:
        self._drain()
        with self._lock:
            live = dict(self._live)
            ref = dict(self._ref)
        return {"rel_err": self.rel_err,
                "psi_threshold": self.psi_threshold,
                "live": {c: s.to_dict() for c, s in live.items()},
                "ref": {c: s.to_dict() for c, s in ref.items()}}

    @classmethod
    def merge(cls, snapshots: Sequence[Optional[Mapping[str, Any]]]
              ) -> "DriftMonitor":
        """New monitor = exact per-column merge of per-shard snapshots."""
        live = [s for s in snapshots if s]
        rel = live[0]["rel_err"] if live else 0.02
        thr = live[0].get("psi_threshold", 0.25) if live else 0.25
        out = cls(rel_err=rel, psi_threshold=thr)
        for s in live:
            for side, store in (("live", out._live), ("ref", out._ref)):
                for col, d in s.get(side, {}).items():
                    sk = store.get(col)
                    if sk is None:
                        sk = store[col] = QuantileSketch(rel_err=rel)
                    sk.merge(dict(d))
        return out
