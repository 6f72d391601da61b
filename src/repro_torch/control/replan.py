"""Closed-loop re-planning over the versioned hot-swap machinery.

When calibration moves the cost model enough to *flip an optimizer
decision* — a window's naive/preagg choice, the fusion grouping, or the
LAST JOIN probe order — the currently-live plan is stale. The
:class:`Replanner` turns that into a safe swap:

1. **Probe**: install the calibrated model and ``build_version`` a
   candidate. If its plan fingerprint equals the live one (the flip
   didn't materialise), discard the candidate — no swap, no risk.
2. **Swap**: otherwise pre-warm and ``publish_version`` — the same
   atomic path as a manual redeploy, so in-flight batches finish on the
   old version and zero requests fail during the cut-over.
3. **Monitor**: the new handle's latency reservoir fills with post-swap
   batches only. Once ``min_health_batches`` have landed, compare its
   p99 against the pre-swap baseline; regress beyond
   ``regress_factor``× and the swap auto-rolls back through
   ``Engine.rollback`` (and the previous cost model is restored so the
   next calibration pass doesn't immediately re-propose the same swap).

State machine: ``idle`` → (probe) → ``monitoring`` → ``idle`` with the
outcome recorded as ``committed`` or ``rolled_back`` in ``events``.

Works against both the single :class:`~repro_torch.core.engine.Engine`
(build → warm → publish) and the :class:`~repro_torch.shard.engine
.ShardedEngine` (probe on shard 0, swap via the atomic all-shard
``deploy``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.core.optimizer import CostModel

__all__ = ["Replanner"]


class Replanner:
    IDLE = "idle"
    MONITORING = "monitoring"

    def __init__(self, engine, deployment: str, *,
                 regress_factor: float = 1.5,
                 min_health_batches: int = 16,
                 warm_buckets: Optional[List[int]] = None):
        self.engine = engine
        self.deployment = deployment
        self.regress_factor = regress_factor
        self.min_health_batches = min_health_batches
        self.warm_buckets = warm_buckets
        self.state = self.IDLE
        self._swap: Optional[Dict[str, Any]] = None
        self.events: List[Dict[str, Any]] = []   # JSON-serializable audit

    # ------------------------------------------------------------- helpers
    def _live(self):
        return self.engine.handle(self.deployment)

    @staticmethod
    def _query_of(handle):
        # single-engine handles carry the query; sharded ones delegate
        # to their shard-0 inner handle
        if hasattr(handle, "query"):
            return handle.query
        return handle.handles[0].query

    def _probe_fingerprint(self, query) -> str:
        """Fingerprint of the plan the CURRENT cost model produces,
        without touching any live version. Single engine: a warming
        build (discarded if unchanged). Sharded: probe on shard 0 only —
        every shard compiles the same plan, so one shard answers the
        would-it-change question at 1/S of the build cost."""
        eng = self.engine
        if hasattr(eng, "build_version"):
            probe = eng.build_version(self.deployment, query)
            return probe, probe.plan.fingerprint()
        probe = eng.shards[0].build_version(self.deployment, query)
        return probe, probe.plan.fingerprint()

    def _discard_probe(self, probe) -> None:
        eng = self.engine
        if hasattr(eng, "build_version"):
            eng.discard_version(probe)
        else:
            eng.shards[0].discard_version(probe)

    def _event(self, action: str, **kw) -> Dict[str, Any]:
        ev = {"action": action, "deployment": self.deployment, **kw}
        self.events.append(ev)
        return ev

    # --------------------------------------------------------------- replan
    def maybe_replan(self, model: CostModel) -> Dict[str, Any]:
        """Install ``model``; if it flips the plan, swap to the re-planned
        version (returns the action report either way)."""
        if self.state == self.MONITORING:
            # never stack swaps — the in-flight one must resolve first,
            # or a rollback could land on the wrong baseline
            return self._event("deferred", reason="swap in flight")
        eng = self.engine
        live = self._live()
        query = self._query_of(live)
        prev_model = eng.set_cost_model(model)
        probe, new_fp = self._probe_fingerprint(query)
        if new_fp == live.plan.fingerprint():
            self._discard_probe(probe)
            # keep the calibrated model installed: same plan, truer costs
            return self._event("no_change", version=live.version,
                              model=repr(model))
        baseline_p99 = live.metrics.latency_percentile(99)
        if hasattr(eng, "build_version"):
            if self.warm_buckets:
                probe.warm(self.warm_buckets)
            eng.publish_version(probe)
            new = probe
        else:
            # sharded: the probe was shard-0-only; discard it and roll
            # the real swap through the atomic all-shard deploy
            self._discard_probe(probe)
            new = eng.deploy(self.deployment, query,
                             warm_buckets=self.warm_buckets)
        self.state = self.MONITORING
        self._swap = {
            "old_version": live.version, "new_version": new.version,
            "baseline_p99_s": baseline_p99,
            "prev_model": prev_model,
        }
        return self._event("swapped", old_version=live.version,
                           new_version=new.version,
                           baseline_p99_s=baseline_p99,
                           model=repr(model))

    # --------------------------------------------------------------- health
    def check_health(self) -> Dict[str, Any]:
        """Post-swap p99 gate: commit or auto-rollback. Call every tick;
        no-op while idle or while the reservoir is still filling."""
        if self.state != self.MONITORING:
            return {"action": "idle"}
        rec = self._swap
        new = self._live()
        if new.version != rec["new_version"]:
            # someone else swapped underneath us — abandon the watch
            self.state = self.IDLE
            self._swap = None
            return self._event("superseded", expected=rec["new_version"],
                               found=new.version)
        m = new.metrics
        if len(m.latency_s) < self.min_health_batches:
            return {"action": "monitoring",
                    "batches": len(m.latency_s),
                    "need": self.min_health_batches}
        new_p99 = m.latency_percentile(99)
        baseline = rec["baseline_p99_s"]
        self.state = self.IDLE
        self._swap = None
        if (not math.isnan(baseline)
                and new_p99 > self.regress_factor * baseline):
            self.engine.rollback(self.deployment)
            # restore the pre-swap cost model too, or the next tick
            # would re-propose the exact swap we just rejected
            self.engine.set_cost_model(rec["prev_model"])
            return self._event("rolled_back",
                               new_version=rec["new_version"],
                               restored_version=rec["old_version"],
                               new_p99_s=new_p99,
                               baseline_p99_s=baseline,
                               regress_factor=self.regress_factor)
        return self._event("committed", version=rec["new_version"],
                           new_p99_s=new_p99, baseline_p99_s=baseline)
