"""Telemetry layer: bounded time series over the runtime's counters.

The collector never reads a mutating field twice to compute a rate —
every source exposes a *monotonic counters snapshot* (``EngineStats
.snapshot``, ``CacheStats.snapshot``, ``HandleMetrics.snapshot``, the
admission/batcher stats dicts) and the collector diffs consecutive
snapshots into **interval deltas**. Deltas, not cumulative totals, are
what the calibrator and the knob controller consume: "this tick saw 40
requests at p99 9 ms and 3 sheds", not "1.2 M requests since boot".

Engine duck-typing: anything with ``latency_decomposition()`` and
``deployments`` works — both :class:`repro_torch.core.engine.Engine` and
:class:`repro_torch.shard.engine.ShardedEngine`; sharded extras (router,
admission) are picked up when present.

The raw counter surfaces are read through the unified
:class:`repro_torch.obs.export.MetricsRegistry` (one collector per surface,
shared with the Prometheus/JSONL exporters) — the collector's job here
is the part the registry deliberately does not do: baselines, interval
deltas and bounded ring series.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.export import registry_from_engine

__all__ = ["RingSeries", "MetricsCollector"]


def _jsonable(v):
    """Coerce numpy scalars/containers into plain JSON-serializable
    Python values (NaN stays NaN — json emits it and the consumers here
    treat it as 'no sample')."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, int):
        return v
    if hasattr(v, "item"):      # numpy scalar
        return v.item()
    if isinstance(v, float):
        return v
    return v


class RingSeries:
    """Bounded ``(t, value)`` time series — the collector's storage unit.
    Appending beyond ``maxlen`` drops the oldest point (FIFO), so memory
    is O(maxlen) per metric no matter how long the plane runs."""

    __slots__ = ("t", "v")

    def __init__(self, maxlen: int = 512):
        self.t: Deque[float] = collections.deque(maxlen=maxlen)
        self.v: Deque[float] = collections.deque(maxlen=maxlen)

    def append(self, t: float, value: float) -> None:
        self.t.append(float(t))
        self.v.append(float(value))

    def __len__(self) -> int:
        return len(self.v)

    def last(self) -> Optional[float]:
        return self.v[-1] if self.v else None

    def values(self) -> List[float]:
        return list(self.v)

    def mean(self, n: Optional[int] = None) -> float:
        vals = list(self.v)[-n:] if n else list(self.v)
        return sum(vals) / len(vals) if vals else 0.0

    def to_json(self) -> Dict[str, List[float]]:
        return {"t": list(self.t), "v": list(self.v)}


# counter fields of a HandleMetrics/ShardedHandleMetrics snapshot the
# collector diffs into interval deltas (gauges like p99 are NOT diffed)
_HANDLE_COUNTERS = ("requests", "batches", "serve_s", "unknown_keys",
                    "shed_requests", "shed_batches")
_CACHE_COUNTERS = ("hits", "misses", "evictions", "invalidations",
                   "compile_seconds")
# the sharded decomposition's counters that the recovery series diff
_RECOVERY_COUNTERS = ("worker_restarts", "transport_retries",
                      "transport_frame_corrupt")


class MetricsCollector:
    """Samples the runtime into ring-buffer series + interval deltas.

    ``sample()`` returns one JSON-serializable sample dict (and appends
    the headline metrics to the named series); ``snapshot()`` returns
    the whole per-deployment state for export. The first ``sample()``
    establishes the baselines, so its deltas are the totals so far.
    """

    def __init__(self, engine, *, server=None, maxlen: int = 512):
        self.engine = engine
        self.server = server       # FeatureServer (its batcher), optional
        self.maxlen = maxlen
        # the same registry the Prometheus/JSONL exporters walk; the
        # collector reads its raw counter groups through it
        self.registry = registry_from_engine(engine, server=server)
        self.series: Dict[str, RingSeries] = {}
        self.samples: Deque[Dict[str, Any]] = collections.deque(maxlen=maxlen)
        self._prev_engine: Dict[str, float] = {}
        self._prev_cache: Dict[str, float] = {}
        self._prev_handles: Dict[str, Dict[str, float]] = {}
        self._prev_admission: Dict[str, float] = {}
        self._prev_batcher: Dict[str, float] = {}
        self._prev_decomp: Dict[str, float] = {}

    # ------------------------------------------------------------- sources
    def _engine_stats(self) -> Dict[str, float]:
        return self.registry.collect("engine")["engine"]

    def _cache_stats(self) -> Dict[str, float]:
        return self.registry.collect("cache")["cache"]

    # ----------------------------------------------------------- exporters
    def render_prometheus(self) -> str:
        """Prometheus text exposition over the shared registry."""
        return self.registry.render_prometheus()

    def render_jsonl(self, now: Optional[float] = None) -> str:
        """One JSON snapshot line over the shared registry."""
        return self.registry.render_jsonl(now)

    @staticmethod
    def _delta(now: Dict[str, float], prev: Dict[str, float],
               fields=None) -> Dict[str, float]:
        keys = fields if fields is not None else [
            k for k, v in now.items() if isinstance(v, (int, float))]
        return {k: max(now.get(k, 0) - prev.get(k, 0), 0) for k in keys
                if isinstance(now.get(k, 0), (int, float))}

    # -------------------------------------------------------------- sample
    def sample(self, now: Optional[float] = None) -> Dict[str, Any]:
        t = time.monotonic() if now is None else now
        eng = self.engine

        decomp = eng.latency_decomposition()
        eng_snap = self._engine_stats()
        eng_delta = self._delta(eng_snap, self._prev_engine)
        self._prev_engine = eng_snap

        cache_snap = self._cache_stats()
        cache_delta = self._delta(cache_snap, self._prev_cache,
                                  _CACHE_COUNTERS)
        self._prev_cache = cache_snap

        deployments: Dict[str, Dict[str, Any]] = {}
        for name, dep in getattr(eng, "deployments", {}).items():
            snap = dep.metrics.snapshot()
            prev = self._prev_handles.get(name, {})
            delta = self._delta(snap, prev, _HANDLE_COUNTERS)
            self._prev_handles[name] = snap
            joins = dep.join_staleness()     # {} for join-free plans
            deployments[name] = {"version": dep.version, "snapshot": snap,
                                 "delta": delta, "joins": joins}
            self._push(t, f"dep.{name}.p99_s",
                       snap.get("latency_p99_s", float("nan")))
            self._push(t, f"dep.{name}.requests", delta.get("requests", 0))
            for table, st in joins.items():
                self._push(t, f"dep.{name}.join.{table}.match_rate",
                           st.get("match_rate", 0.0))
                self._push(t, f"dep.{name}.join.{table}.age_p99",
                           st.get("age_p99", float("nan")))

        batcher: Optional[Dict[str, Any]] = None
        b = getattr(self.server, "batcher", None) if self.server else None
        if b is not None:
            stats = dict(b.stats)
            client_p99 = float("nan")
            if hasattr(b, "client_latency_percentile"):
                client_p99 = b.client_latency_percentile(99)
            batcher = {
                "queue_depth": b.queue_depth(),
                "oldest_age_s": b.oldest_age_s(),
                # queueing-INCLUSIVE latency the caller actually saw —
                # the serve-side p99 goes blind exactly when a queue
                # builds in front of the engine; this signal doesn't
                "client_p99_s": client_p99,
                "max_delay_s": b.cfg.max_delay_s,
                "max_batch": b.cfg.max_batch,
                "stats": stats,
                "delta": self._delta(stats, self._prev_batcher),
            }
            self._prev_batcher = stats
            self._push(t, "batcher.queue_depth", batcher["queue_depth"])
            self._push(t, "batcher.oldest_age_s", batcher["oldest_age_s"])
            self._push(t, "batcher.client_p99_s", client_p99)

        admission: Optional[Dict[str, Any]] = None
        res = getattr(eng, "resources", None)
        if res is not None:
            stats = res.metrics()
            admission = {"stats": stats,
                         "delta": self._delta(stats, self._prev_admission)}
            self._prev_admission = stats
            self._push(t, "admission.shed",
                       admission["delta"].get("shed_deadline", 0))
            self._push(t, "admission.shed_worker_down",
                       admission["delta"].get("shed_worker_down", 0))
            self._push(t, "admission.served_degraded",
                       admission["delta"].get("served_degraded", 0))

        router = getattr(eng, "router", None)
        if router is not None:
            self._push(t, "router.max_queue_depth",
                       max(router.queue_depths() or [0]))

        self._push(t, "engine.exec_s", eng_delta.get("exec_s", 0.0))
        self._push(t, "engine.kernel_launches",
                   eng_delta.get("kernel_launches", 0))
        self._push(t, "cache.hit_rate", cache_snap.get("hit_rate", 0.0))

        # durability / chaos tier (ShardedEngine only; keys absent on a
        # single Engine's decomposition). Counters are diffed into
        # per-tick deltas; replay lag is a gauge (last recovery's value)
        if "worker_restarts" in decomp:
            dd = self._delta(decomp, self._prev_decomp,
                             _RECOVERY_COUNTERS)
            self._prev_decomp = {k: decomp.get(k, 0)
                                 for k in _RECOVERY_COUNTERS}
            self._push(t, "engine.worker_restarts",
                       dd.get("worker_restarts", 0))
            self._push(t, "transport.retries",
                       dd.get("transport_retries", 0))
            self._push(t, "transport.frame_corrupt",
                       dd.get("transport_frame_corrupt", 0))
            self._push(t, "recovery.wal_replay_lag_s",
                       decomp.get("recovery_wal_replay_lag_s", 0.0))

        sample = _jsonable({
            "t": t,
            "latency_decomposition": decomp,
            "engine": eng_snap, "engine_delta": eng_delta,
            "cache": cache_snap, "cache_delta": cache_delta,
            "deployments": deployments,
            "batcher": batcher,
            "admission": admission,
        })
        self.samples.append(sample)
        return sample

    def _push(self, t: float, name: str, value) -> None:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = RingSeries(self.maxlen)
        try:
            s.append(t, float(value))
        except (TypeError, ValueError):
            pass

    # ------------------------------------------------------------ snapshot
    def last(self) -> Optional[Dict[str, Any]]:
        return self.samples[-1] if self.samples else None

    def snapshot(self) -> Dict[str, Any]:
        """Full JSON-serializable export: every series plus the latest
        sample (per-deployment)."""
        return {
            "series": {k: s.to_json() for k, s in self.series.items()},
            "latest": self.last(),
            "n_samples": len(self.samples),
        }
