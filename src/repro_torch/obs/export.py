"""Unified metrics export: one registry over every counter surface.

Before this module each consumer sampled the runtime ad hoc —
``MetricsCollector`` reached into ``EngineStats`` / ``CacheStats`` /
``HandleMetrics`` / ``ResourceManager`` / batcher objects
directly. :class:`MetricsRegistry` inverts that: each surface registers
ONE collector callable returning a flat ``{key: number}`` dict, and
every consumer — the control plane's telemetry, the Prometheus text
endpoint, JSONL snapshot logs — walks the same registry.

Key convention: a ``/`` in a key separates an item label from the
metric (``"fraud/requests"`` in group ``deployment`` renders as
``repro_deployment_requests{item="fraud"}``); everything else renders
as ``repro_<group>_<key>``. Non-finite and non-numeric values are
skipped in the Prometheus text (the JSONL snapshot keeps them — NaN is
a meaningful "no sample yet" there).
"""
from __future__ import annotations

import json
import math
import re
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["MetricsRegistry", "registry_from_engine"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote and
    newline are the three characters the text format requires escaped."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v) -> str:
    return f"{int(v)}" if isinstance(v, int) else repr(float(v))


class MetricsRegistry:
    """Named groups of collector callables; collection is pull-based —
    nothing is cached, a collect reads the live counters."""

    def __init__(self, prefix: str = "repro"):
        self.prefix = prefix
        self._groups: Dict[str, Callable[[], Dict[str, Any]]] = {}

    def register(self, group: str,
                 collector: Callable[[], Dict[str, Any]]) -> None:
        self._groups[group] = collector

    def unregister(self, group: str) -> None:
        self._groups.pop(group, None)

    def groups(self) -> List[str]:
        return sorted(self._groups)

    def collect(self, group: Optional[str] = None
                ) -> Dict[str, Dict[str, Any]]:
        """``{group: {key: value}}`` for one group or all. A collector
        raising (e.g. a surface torn down mid-collect) yields an empty
        group rather than poisoning the rest."""
        names = [group] if group is not None else self.groups()
        out: Dict[str, Dict[str, Any]] = {}
        for g in names:
            fn = self._groups.get(g)
            if fn is None:
                out[g] = {}
                continue
            try:
                out[g] = dict(fn())
            except Exception:
                out[g] = {}
        return out

    # ---------------------------------------------------------- renderers
    def render_prometheus(self) -> str:
        """Prometheus text exposition: one gauge per numeric key, plus a
        native histogram per quantile-sketch value (``*_sketch`` entries
        in a collector dict render as cumulative ``_bucket`` series with
        ``le`` labels, ``_sum`` and ``_count``). Label values are escaped
        per the text-format rules; ``# HELP``/``# TYPE`` headers precede
        the first sample of each metric family."""
        from repro_torch.obs.sketch import QuantileSketch
        lines: List[str] = []
        for group, metrics in self.collect().items():
            seen = set()
            for key in sorted(metrics):
                v = metrics[key]
                if "/" in key:
                    item, metric = key.split("/", 1)
                    mname = (f"{self.prefix}_{_sanitize(group)}_"
                             f"{_sanitize(metric)}")
                    item_label = f'item="{_escape_label(item)}"'
                else:
                    metric = key
                    mname = (f"{self.prefix}_{_sanitize(group)}_"
                             f"{_sanitize(key)}")
                    item_label = ""
                if QuantileSketch.is_sketch_dict(v):
                    if mname not in seen:
                        lines.append(f"# HELP {mname} {group} {metric} "
                                     f"(quantile sketch)")
                        lines.append(f"# TYPE {mname} histogram")
                        seen.add(mname)
                    sk = QuantileSketch.from_dict(v)
                    pre = f"{item_label}," if item_label else ""
                    for ub, cum in sk.histogram():
                        lines.append(f'{mname}_bucket{{{pre}le='
                                     f'"{_fmt(float(ub))}"}} {cum}')
                    lines.append(
                        f'{mname}_bucket{{{pre}le="+Inf"}} {sk.count}')
                    lab = f"{{{item_label}}}" if item_label else ""
                    lines.append(f"{mname}_sum{lab} {_fmt(sk.sum)}")
                    lines.append(f"{mname}_count{lab} {sk.count}")
                    continue
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if isinstance(v, float) and not math.isfinite(v):
                    continue
                if mname not in seen:
                    lines.append(f"# HELP {mname} {group} {metric}")
                    lines.append(f"# TYPE {mname} gauge")
                    seen.add(mname)
                lab = f"{{{item_label}}}" if item_label else ""
                lines.append(f"{mname}{lab} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def render_jsonl(self, now: Optional[float] = None) -> str:
        """One JSON line: ``{"t": ..., "<group>": {...}, ...}`` — append
        to a file and you have a snapshot log."""
        snap: Dict[str, Any] = {
            "t": time.time() if now is None else float(now)}
        snap.update(self.collect())
        return json.dumps(snap, default=_json_default)


def _json_default(v):
    if hasattr(v, "item"):            # numpy scalar
        return v.item()
    return str(v)


# --------------------------------------------------------------- wiring
def registry_from_engine(engine, *, server=None, slo=None,
                         prefix: str = "repro") -> MetricsRegistry:
    """Wire a registry over every surface ``engine`` (an ``Engine`` or a
    ``ShardedEngine``) and the optional ``FeatureServer`` expose. Groups
    appear only when their surface exists; the per-deployment collector
    enumerates at collect time, so deploys after wiring are picked up
    automatically. A sharded engine adds ``recovery`` (WAL replays) and,
    under the process backend, ``transport`` (retries, corrupt frames,
    RPC timeouts summed over the workers) with the respawns in
    ``recovery``."""
    reg = MetricsRegistry(prefix=prefix)
    shards = getattr(engine, "shards", None)

    def engine_stats() -> Dict[str, float]:
        if hasattr(engine, "stats"):                 # single Engine
            return engine.stats.snapshot()
        agg: Dict[str, float] = {}
        for sub in (shards or ()):                   # ShardedEngine
            for k, v in sub.stats.snapshot().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def cache_stats() -> Dict[str, float]:
        if shards is None:
            return engine.cache.stats.snapshot()
        agg: Dict[str, float] = {}
        for sub in shards:
            for k, v in sub.cache.stats.snapshot().items():
                if k == "hit_rate":
                    continue
                agg[k] = agg.get(k, 0) + v
        total = agg.get("hits", 0) + agg.get("misses", 0)
        agg["hit_rate"] = agg.get("hits", 0) / total if total else 0.0
        return agg

    def deployment_stats() -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dep in getattr(engine, "deployments", {}).items():
            for k, v in dep.metrics.snapshot().items():
                out[f"{name}/{k}"] = v
            out[f"{name}/version"] = dep.version
        return out

    reg.register("engine", engine_stats)
    reg.register("cache", cache_stats)
    reg.register("deployment", deployment_stats)

    res = getattr(engine, "resources", None)
    if res is not None:
        reg.register("admission", res.metrics)
    router = getattr(engine, "router", None)
    if router is not None:
        reg.register("router", router.stats)

    if getattr(engine, "backend", None) is not None:
        reg.register("transport", engine.transport_stats)
    if hasattr(engine, "recovery_snapshot"):
        reg.register("recovery", engine.recovery_snapshot)

    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        reg.register("tracer", tracer.snapshot)

    if hasattr(engine, "freshness_export"):
        reg.register("freshness", engine.freshness_export)
    if hasattr(engine, "drift_export"):
        reg.register("drift", engine.drift_export)
    flight = getattr(engine, "flight", None)
    if flight is not None:
        reg.register("flight", flight.stats)
    if slo is not None:
        reg.register("slo", slo.export)

    batcher = getattr(server, "batcher", None) if server else None
    if batcher is not None:
        def batcher_stats() -> Dict[str, float]:
            out = dict(batcher.stats)
            out["queue_depth"] = batcher.queue_depth()
            out["oldest_age_s"] = batcher.oldest_age_s()
            out["client_p99_s"] = \
                batcher.client_latency_percentile(99)
            out["max_delay_s"] = batcher.cfg.max_delay_s
            out["max_batch"] = batcher.cfg.max_batch
            return out
        reg.register("batcher", batcher_stats)
    return reg
