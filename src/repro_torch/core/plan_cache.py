"""Compiled-execution-plan cache — the paper's O2 "caching" layer.

OpenMLDB caches LLVM-JIT'd plans per deployed query; the port caches the
executor built for a plan, keyed by ``(plan fingerprint, flags, model)``.
PyTorch runs eagerly, so nothing is traced or padded to a batch bucket; the
cache still owns executor construction and the hit/miss accounting.
``bucket_batch`` rounds batch sizes to the power-of-two buckets a
deployment records as served and warms before a hot swap.
Entries are LRU-evicted under a bounded count (resource management, O5).

Deployment lifecycle hooks (DESIGN.md §6):

* ``invalidate(prefix)`` drops every entry whose plan fingerprint starts
  with ``prefix`` — called on hot-swap redeploys so a retired version's
  executables don't squat in the LRU until eviction;
* ``tag=`` on ``get_or_compile`` attributes hits/misses/compile-time to a
  deployment version (``name@vN``), so per-deployment cache behaviour is
  observable (``tag_stats``). Handle-owned first-level lookups report
  through ``record_hit`` so the hit-rate bookkeeping stays truthful.

The cache also keeps the latency bookkeeping the paper's Eq. 3 decomposes:
``L = L_parse + L_plan + L_exec`` — compile time is charged to L_plan on
miss and amortised to ~0 on hit.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

__all__ = ["PlanCache", "CacheStats", "TagStats", "bucket_batch"]

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_batch(n: int) -> int:
    """Round a request-batch size up to its power-of-two bucket (the
    shapes a deployment warms before it goes live)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    compile_seconds: float = 0.0

    _FIELDS = ("hits", "misses", "evictions", "invalidations",
               "compile_seconds")

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        """Monotonic-counters copy (plus the derived hit_rate) — what the
        control plane's collector diffs across sampling intervals."""
        out = {f: getattr(self, f) for f in self._FIELDS}
        out["hit_rate"] = self.hit_rate
        return out


@dataclass
class TagStats:
    """Per-deployment-version slice of the cache counters."""

    hits: int = 0
    misses: int = 0
    compile_seconds: float = 0.0


@dataclass
class _Entry:
    fn: Callable
    compile_seconds: float
    hits: int = 0


class PlanCache:
    def __init__(self, max_entries: int = 128, enabled: bool = True):
        self.max_entries = max_entries
        self.enabled = enabled
        self._entries: "collections.OrderedDict[Hashable, _Entry]" = (
            collections.OrderedDict())
        self.stats = CacheStats()
        self._by_tag: Dict[str, TagStats] = {}
        # serving threads look up / insert while deploy threads
        # invalidate — every _entries mutation happens under this lock
        # (compiles themselves run outside it)
        self._mu = threading.Lock()

    def _tag(self, tag: Optional[str]) -> Optional[TagStats]:
        if tag is None:
            return None
        ts = self._by_tag.get(tag)
        if ts is None:
            ts = self._by_tag[tag] = TagStats()
        return ts

    def get_or_compile(self, key: Hashable, make: Callable[[], Callable],
                       tag: Optional[str] = None) -> Tuple[Callable, float]:
        """Return (compiled_fn, plan_seconds). ``make`` must return an
        ready-to-call executor."""
        with self._mu:
            tstats = self._tag(tag)
            if self.enabled:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    ent.hits += 1
                    self.stats.hits += 1
                    if tstats is not None:
                        tstats.hits += 1
                    return ent.fn, 0.0
        t0 = time.perf_counter()
        fn = make()               # build outside the lock: a slow build
        dt = time.perf_counter() - t0   # must not block lookups
        with self._mu:
            self.stats.misses += 1
            self.stats.compile_seconds += dt
            if tstats is not None:
                tstats.misses += 1
                tstats.compile_seconds += dt
            if self.enabled:
                self._entries[key] = _Entry(fn=fn, compile_seconds=dt)
                self._entries.move_to_end(key)
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                    self.stats.evictions += 1
        return fn, dt

    def record_hit(self, tag: Optional[str] = None) -> None:
        """Count a hit served from a first-level (handle-owned) table.

        Deployment handles memoise their own executables; without this the
        cache's hit-rate would undercount every warmed-path request."""
        with self._mu:
            self.stats.hits += 1
            tstats = self._tag(tag)
            if tstats is not None:
                tstats.hits += 1

    def invalidate(self, prefix: str) -> int:
        """Drop every entry whose plan-fingerprint component (the first
        element of a tuple key, or a plain string key) starts with
        ``prefix``. Returns the number of entries removed."""
        removed = 0
        with self._mu:
            for key in list(self._entries):
                fp = key[0] if isinstance(key, tuple) and key else key
                if isinstance(fp, str) and fp.startswith(prefix):
                    del self._entries[key]
                    removed += 1
            self.stats.invalidations += removed
        return removed

    def tag_stats(self, tag: str) -> TagStats:
        """Counters attributed to one deployment version (empty if unseen)."""
        with self._mu:
            return self._by_tag.get(tag, TagStats())

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)
