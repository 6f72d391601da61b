"""ControlPlane: the tick loop that closes the loop.

One ``tick()`` runs the whole feedback cycle, in order:

1. **Sample** — ``MetricsCollector.sample()`` turns the runtime's
   monotonic counters into interval deltas.
2. **Attribute + calibrate** — the tick's measured serve time is split
   across the live plan's element profile (scan/preagg/join shares under
   the current model) and fed to the :class:`CostCalibrator`.
3. **Replan** — when the fitted model differs materially from the
   installed one, hand it to the :class:`Replanner` (probe → swap →
   monitor); every tick also runs the post-swap health check so a
   regressed swap rolls back within ``min_health_batches``.
4. **Tune** — build a :class:`LoadObservation` from the sample and apply
   the :class:`KnobController`'s decisions to whichever knob surfaces
   exist (batcher, router, admission).

``tick()`` is synchronous and deterministic given the underlying
metrics; ``start()``/``stop()`` wrap it in a daemon thread for
deployments that want a live loop. Every tick returns (and records) a
JSON-serializable report.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional

from repro_torch.control.calibrate import (CostCalibrator, differs_materially,
                                           plan_element_profile)
from repro_torch.control.knobs import (KnobConfig, KnobController,
                                       LoadObservation)
from repro_torch.control.replan import Replanner
from repro_torch.control.telemetry import MetricsCollector
from repro_torch.obs.freshness import FreshnessTracker
from repro_torch.obs.slo import ALERTING, SLOEngine

__all__ = ["ControlPlane"]


class ControlPlane:
    """Telemetry → calibration → re-planning → knob tuning, per tick."""

    def __init__(self, engine, deployment: str, *, server=None,
                 collector: Optional[MetricsCollector] = None,
                 calibrator: Optional[CostCalibrator] = None,
                 knobs: Optional[KnobController] = None,
                 replanner: Optional[Replanner] = None,
                 knob_cfg: KnobConfig = KnobConfig(),
                 replan: bool = True,
                 rel_tol: float = 0.2,
                 seed: int = 0,
                 slo: Optional[SLOEngine] = None,
                 flight=None):
        self.engine = engine
        self.deployment = deployment
        self.server = server
        self.collector = collector or MetricsCollector(engine,
                                                       server=server)
        self.calibrator = calibrator or CostCalibrator()
        self.replanner = replanner or Replanner(engine, deployment)
        self.replan_enabled = replan
        self.rel_tol = rel_tol
        self.knobs = knobs if knobs is not None else self._default_knobs(
            knob_cfg, seed)
        self.slo = slo
        self.flight = flight if flight is not None \
            else getattr(engine, "flight", None)
        self.reports: List[Dict[str, Any]] = []
        self._tick = 0
        self._prev_restarts = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _default_knobs(self, cfg: KnobConfig, seed: int) -> KnobController:
        """Manage whichever knobs the wired components actually expose."""
        delay = None
        b = getattr(self.server, "batcher", None) if self.server else None
        if b is not None:
            delay = b.cfg.max_delay_s
        router = getattr(self.engine, "router", None)
        rows = router.dispatch_rows if router is not None else None
        if delay is None and router is not None and router.lanes:
            delay = router.lanes[0].coalesce_delay_s
        res = getattr(self.engine, "resources", None)
        inflight = res.cfg.max_inflight if res is not None else None
        return KnobController(cfg, seed=seed, delay_s=delay,
                              dispatch_rows=rows, max_inflight=inflight)

    # ------------------------------------------------------------ calibrate
    def _drain_profile(self) -> List[Dict[str, Any]]:
        obs_fn = getattr(self.engine, "drain_profile_observations", None)
        return obs_fn(self.deployment) if obs_fn is not None else []

    def _feed_calibrator(self, sample: Dict[str, Any]) -> int:
        """Feed the calibrator this tick's observations. Preferred
        source: the operator profiler's MEASURED per-operator exec times
        (``drain_profile_observations`` — exec-clock seconds split per
        unit-cost element, host/plan residuals excluded). Fallback when
        no profile is available (e.g. process-backend shards keep their
        profilers worker-side): the original EM-style split of the
        tick's serve seconds under the current model's weighted shares.
        Returns observations fed."""
        prof_obs = self._drain_profile()
        if prof_obs:
            for o in prof_obs:
                self.calibrator.observe(o["kind"], o["elements"],
                                        o["seconds"],
                                        table=o.get("table"))
            return len(prof_obs)
        dep = sample["deployments"].get(self.deployment)
        if dep is None:
            return 0
        delta = dep["delta"]
        reqs = delta.get("requests", 0)
        serve_s = delta.get("serve_s", 0.0)
        if reqs <= 0 or serve_s <= 0:
            return 0
        handle = self.engine.handle(self.deployment)
        prof = plan_element_profile(handle)
        model = self.engine.cost_model
        weights = {"scan": model.scan_el, "preagg": model.preagg_el,
                   "join": model.join_el}
        kinds = {k: v for k, v in prof.items() if k in weights and v > 0}
        total_w = sum(weights[k] * v for k, v in kinds.items())
        if total_w <= 0:
            return 0
        sec_per_req = serve_s / reqs
        fed = 0
        for kind, el in kinds.items():
            share = (weights[kind] * el) / total_w
            self.calibrator.observe(kind, el, sec_per_req * share)
            fed += 1
        # per-table join split, proportional to each table's elements
        join_el = kinds.get("join", 0.0)
        if join_el > 0:
            join_sec = sec_per_req * (weights["join"] * join_el) / total_w
            for key, el in prof.items():
                if key.startswith("join:") and el > 0:
                    self.calibrator.observe(
                        "join", el, join_sec * el / join_el,
                        table=key.split(":", 1)[1])
                    fed += 1
        return fed

    # ----------------------------------------------------------------- knob
    def _load_observation(self, sample: Dict[str, Any]) -> LoadObservation:
        dep = sample["deployments"].get(self.deployment, {})
        snap = dep.get("snapshot", {})
        delta = dep.get("delta", {})
        shed = int(delta.get("shed_requests", 0) or 0)
        rejected = 0
        adm = sample.get("admission")
        if adm is not None:
            shed += int(adm["delta"].get("shed_deadline", 0))
            rejected += int(adm["delta"].get("rejected_inflight", 0))
            rejected += int(adm["delta"].get("rejected_queue_depth", 0))
        depth, age = 0, 0.0
        p99 = float(snap.get("latency_p99_s", float("nan")))
        b = sample.get("batcher")
        if b is not None:
            depth = int(b["queue_depth"])
            age = float(b["oldest_age_s"])
            rejected += int(b["delta"].get("rejected", 0))
            shed += int(b["delta"].get("expired", 0))
            # prefer the CLIENT-observed (queueing-inclusive) p99 when a
            # batcher fronts the engine: the serve-side p99 stays flat
            # while a queue builds in front of it, so a controller fed
            # only serve latency would sleep through the buildup
            client_p99 = float(b.get("client_p99_s", float("nan")))
            if math.isfinite(client_p99):
                p99 = client_p99
        return LoadObservation(
            p99_s=p99,
            queue_depth=depth, oldest_age_s=age, shed=shed,
            rejected=rejected, requests=int(delta.get("requests", 0)))

    # ------------------------------------------------------------------ slo
    def _slo_metrics(self, obs: LoadObservation) -> Dict[str, float]:
        """The metric names SLO specs bind to: interval latency/shed from
        the load observation, freshness/drift pulled live from the
        engine's exports."""
        served = max(obs.requests + obs.shed + obs.rejected, 1)
        metrics: Dict[str, float] = {
            "latency_p99_s": obs.p99_s,
            "shed_ratio": (obs.shed + obs.rejected) / served,
        }
        fexp = getattr(self.engine, "freshness_export", None)
        if fexp is not None:
            try:
                exp = fexp()
            except Exception:
                exp = {}
            metrics["feature_age_p99"] = \
                FreshnessTracker.worst_age_p99(exp)
            i2v = [v for k, v in exp.items()
                   if k.endswith("/ingest_visible_p99_s")
                   and isinstance(v, float) and math.isfinite(v)]
            metrics["ingest_visible_p99_s"] = \
                max(i2v) if i2v else float("nan")
        drep = getattr(self.engine, "drift_report", None)
        if drep is not None:
            try:
                psis = [c.get("psi", float("nan"))
                        for c in drep().values()]
            except Exception:
                psis = []
            finite = [p for p in psis if math.isfinite(p)]
            metrics["drift_psi_max"] = \
                max(finite) if finite else float("nan")
        return metrics

    def _evaluate_slo(self, obs: LoadObservation
                      ) -> (bool, Optional[Dict[str, Any]]):
        if self.slo is None:
            return False, None
        metrics = self._slo_metrics(obs)
        events = self.slo.evaluate(metrics)
        if self.flight is not None:
            for ev in events:
                self.flight.record("slo_transition", **ev)
                if ev["state"] == ALERTING:
                    # breach: persist the ring NOW — the offending
                    # batches' trace ids are still in it
                    self.flight.dump(f"slo-{ev['slo']}")
        burning = bool(self.slo.active_alerts(action="tune"))
        return burning, {
            "events": events,
            "alerting": sorted(s.name
                               for s in self.slo.active_alerts()),
            "metrics": metrics,
        }

    def _apply(self, decisions) -> List[Dict[str, Any]]:
        applied = []
        b = getattr(self.server, "batcher", None) if self.server else None
        router = getattr(self.engine, "router", None)
        res = getattr(self.engine, "resources", None)
        for d in decisions:
            ok = False
            if d.knob == "delay_s":
                if b is not None:
                    b.reconfigure(max_delay_s=float(d.new))
                    ok = True
                if router is not None:
                    router.set_coalesce_delay(float(d.new))
                    ok = True
            elif d.knob == "dispatch_rows" and router is not None:
                router.set_dispatch_rows(int(d.new))
                ok = True
            elif d.knob == "max_inflight" and res is not None:
                res.reconfigure(max_inflight=int(d.new))
                ok = True
            applied.append({"knob": d.knob, "old": d.old, "new": d.new,
                            "reason": d.reason, "applied": ok})
        return applied

    # ------------------------------------------------------------- recovery
    def _recovering(self, sample: Dict[str, Any]) -> bool:
        """True while the runtime is absorbing a worker death: a restart
        happened since the last tick, or a shard client is still not
        ready (catalog/WAL replay in flight). A recovery tick's latency
        and shed counters describe the FAILURE, not the workload — fitting
        the cost model or moving knobs on them would tune the steady
        state to a transient."""
        decomp = sample.get("latency_decomposition", {})
        restarts = float(decomp.get("worker_restarts", 0) or 0)
        prev, self._prev_restarts = self._prev_restarts, restarts
        return restarts > prev or getattr(self.engine, "recovering", False)

    # ----------------------------------------------------------------- tick
    def tick(self) -> Dict[str, Any]:
        t = self._tick
        self._tick += 1
        sample = self.collector.sample()

        if self._recovering(sample):
            # sample was still taken (baselines advance: the recovery
            # interval's deltas are consumed here, not leaked into the
            # next steady tick) but nothing is fitted, replanned or tuned
            self._drain_profile()    # discard: recovery-interval timings
            report = {
                "tick": t, "recovering": True, "observations_fed": 0,
                "replan": {"action": "recovering"},
                "health": {"action": "recovering"},
                "load": None, "slo": None, "knob_decisions": [],
                "knobs": dict(self.knobs.knobs),
            }
            self.reports.append(report)
            return report

        fed = self._feed_calibrator(sample)

        replan_report: Dict[str, Any] = {"action": "disabled"}
        health: Dict[str, Any] = {"action": "idle"}
        if self.replan_enabled:
            health = self.replanner.check_health()
            if self.replanner.state == Replanner.IDLE:
                fitted = self.calibrator.fit(base=self.engine.cost_model)
                if fitted is not None and differs_materially(
                        fitted, self.engine.cost_model, self.rel_tol):
                    replan_report = self.replanner.maybe_replan(fitted)
                else:
                    replan_report = {"action": "steady",
                                     "fitted": fitted is not None}
            else:
                replan_report = {"action": "monitoring"}

        obs = self._load_observation(sample)
        burning, slo_report = self._evaluate_slo(obs)
        if burning:
            obs = dataclasses.replace(obs, slo_burning=True)
        decisions = self.knobs.step(obs)
        applied = self._apply(decisions)

        report = {
            "tick": t,
            "recovering": False,
            "observations_fed": fed,
            "replan": replan_report,
            "health": health,
            "load": {"p99_s": obs.p99_s, "queue_depth": obs.queue_depth,
                     "shed": obs.shed, "rejected": obs.rejected,
                     "requests": obs.requests,
                     "slo_burning": obs.slo_burning},
            "slo": slo_report,
            "knob_decisions": applied,
            "knobs": dict(self.knobs.knobs),
        }
        self.reports.append(report)
        return report

    # ------------------------------------------------------------ lifecycle
    def start(self, interval_s: float = 0.1) -> None:
        """Run ``tick()`` on a daemon thread every ``interval_s``."""
        if self._thread is not None:
            raise RuntimeError("control plane already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:      # noqa: BLE001 — the loop survives
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="control-plane")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self) -> "ControlPlane":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable plane state: telemetry, knob log, replan
        events, last report."""
        return {
            "deployment": self.deployment,
            "telemetry": self.collector.snapshot(),
            "knobs": self.knobs.snapshot(),
            "knob_log": self.knobs.log,
            "replan_events": self.replanner.events,
            "slo": self.slo.snapshot() if self.slo is not None else None,
            "last_report": self.reports[-1] if self.reports else None,
        }
