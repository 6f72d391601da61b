"""Knob controller: AIMD, hysteresis-bounded tuning of the serving knobs.

Three knobs (each optional — pass ``None`` to leave one unmanaged):

* ``delay_s``        — batching deadline (``BatcherConfig.max_delay_s``
  or the router's ``coalesce_delay_s``). The latency/throughput trade:
  longer delay = fuller batches = fewer launches, at queueing cost.
* ``dispatch_rows``  — the router's coalescing chunk size.
* ``max_inflight``   — the admission bound.

Control law (classic AIMD with hysteresis, DESIGN.md §10):

* **Overload** (p99 over target, or any shed/reject this tick) sustained
  for ``hysteresis_ticks``: *multiplicative decrease* of the delay
  (halve it — stop trading latency for batching) and, when the breach
  was backpressure, *additive increase* of ``max_inflight``.
* **Underload** (p99 under ``low_load_fraction``·target, shallow queue,
  no sheds) sustained: *additive increase* of the delay (claw back
  batching efficiency) and of ``dispatch_rows``.
* Anything else: do nothing. Hysteresis means one noisy tick never moves
  a knob, and the two regions are separated by a dead band so the
  controller cannot oscillate between them on the same signal.

``step()`` is a pure function of (internal counters, observation) — no
clocks, no RNG — so a recorded ``(seed, observations)`` log replays to
the identical decision sequence (``KnobController.replay``), which is
how the tests pin controller behaviour.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

__all__ = ["KnobConfig", "LoadObservation", "KnobDecision",
           "KnobController"]


@dataclass(frozen=True)
class KnobConfig:
    target_p99_s: float = 0.010      # the latency SLO the loop chases
    low_load_fraction: float = 0.3   # under-target dead-band edge
    hysteresis_ticks: int = 2        # consecutive ticks before acting
    backoff: float = 0.5             # multiplicative decrease factor
    delay_step_s: float = 0.0005     # additive delay increase
    rows_step: int = 64              # additive dispatch_rows increase
    inflight_step: int = 2           # additive max_inflight increase
    min_delay_s: float = 0.0
    max_delay_s: float = 0.010
    min_dispatch_rows: int = 32
    max_dispatch_rows: int = 2048
    min_inflight: int = 2
    max_inflight: int = 128


@dataclass(frozen=True)
class LoadObservation:
    """One tick's interval signals (deltas, not cumulative totals)."""

    p99_s: float = float("nan")   # NaN = no latency samples this tick
    queue_depth: int = 0
    oldest_age_s: float = 0.0
    shed: int = 0                 # sheds this interval
    rejected: int = 0             # backpressure rejections this interval
    requests: int = 0             # requests served this interval
    slo_burning: bool = False     # an action="tune" SLO is ALERTING


@dataclass(frozen=True)
class KnobDecision:
    tick: int
    knob: str        # "delay_s" | "dispatch_rows" | "max_inflight"
    old: float
    new: float
    reason: str


@dataclass
class _State:
    hot: int = 0     # consecutive overload ticks
    cool: int = 0    # consecutive underload ticks


class KnobController:
    """Deterministic AIMD knob tuner with a replayable decision log."""

    def __init__(self, cfg: KnobConfig = KnobConfig(), *, seed: int = 0,
                 delay_s: Optional[float] = None,
                 dispatch_rows: Optional[int] = None,
                 max_inflight: Optional[int] = None):
        self.cfg = cfg
        self.seed = seed            # recorded in the log for replay id
        self.knobs: Dict[str, float] = {}
        if delay_s is not None:
            self.knobs["delay_s"] = float(delay_s)
        if dispatch_rows is not None:
            self.knobs["dispatch_rows"] = int(dispatch_rows)
        if max_inflight is not None:
            self.knobs["max_inflight"] = int(max_inflight)
        self._state = _State()
        self._tick = 0
        # the replayable record: one entry per step, observation included
        self.log: List[Dict[str, Any]] = []

    # ----------------------------------------------------------------- step
    def step(self, obs: LoadObservation) -> List[KnobDecision]:
        """Advance one tick. Pure in (state, obs): same construction +
        same observation sequence ⇒ same decisions, bit for bit."""
        cfg = self.cfg
        tick = self._tick
        self._tick += 1
        has_p99 = not math.isnan(obs.p99_s)
        overload = (obs.shed > 0 or obs.rejected > 0 or obs.slo_burning
                    or (has_p99 and obs.p99_s > cfg.target_p99_s))
        underload = (not overload and obs.shed == 0 and obs.rejected == 0
                     and obs.queue_depth <= 1 and has_p99
                     and obs.p99_s < cfg.low_load_fraction * cfg.target_p99_s)
        st = self._state
        if overload:
            st.hot, st.cool = st.hot + 1, 0
        elif underload:
            st.cool, st.hot = st.cool + 1, 0
        else:
            st.hot = st.cool = 0

        decisions: List[KnobDecision] = []

        def move(knob: str, new: float, reason: str) -> None:
            old = self.knobs[knob]
            if new != old:
                self.knobs[knob] = new
                decisions.append(KnobDecision(tick, knob, old, new, reason))

        if st.hot >= cfg.hysteresis_ticks:
            st.hot = 0     # re-arm: act once per sustained breach
            if "delay_s" in self.knobs:
                move("delay_s",
                     max(cfg.min_delay_s,
                         self.knobs["delay_s"] * cfg.backoff),
                     f"overload: p99={obs.p99_s:.4f}s shed={obs.shed} "
                     f"rejected={obs.rejected} -> delay x{cfg.backoff}")
            if obs.rejected > 0 and "max_inflight" in self.knobs:
                move("max_inflight",
                     min(cfg.max_inflight,
                         int(self.knobs["max_inflight"])
                         + cfg.inflight_step),
                     f"backpressure: rejected={obs.rejected} "
                     f"-> inflight +{cfg.inflight_step}")
        elif st.cool >= cfg.hysteresis_ticks:
            st.cool = 0
            if "delay_s" in self.knobs:
                move("delay_s",
                     min(cfg.max_delay_s,
                         self.knobs["delay_s"] + cfg.delay_step_s),
                     f"underload: p99={obs.p99_s:.4f}s "
                     f"-> delay +{cfg.delay_step_s}")
            if "dispatch_rows" in self.knobs:
                move("dispatch_rows",
                     min(cfg.max_dispatch_rows,
                         int(self.knobs["dispatch_rows"]) + cfg.rows_step),
                     f"underload -> dispatch_rows +{cfg.rows_step}")

        self.log.append({
            "tick": tick, "seed": self.seed,
            "obs": asdict(obs),
            "decisions": [asdict(d) for d in decisions],
            "knobs": dict(self.knobs),
        })
        return decisions

    # --------------------------------------------------------------- replay
    @classmethod
    def replay(cls, cfg: KnobConfig, seed: int,
               initial: Dict[str, float],
               log: List[Dict[str, Any]]) -> "KnobController":
        """Reconstruct a controller from a recorded log's observations.
        The returned controller's ``log`` must equal the input log —
        the determinism contract the tests assert."""
        c = cls(cfg, seed=seed,
                delay_s=initial.get("delay_s"),
                dispatch_rows=initial.get("dispatch_rows"),
                max_inflight=initial.get("max_inflight"))
        for entry in log:
            c.step(LoadObservation(**entry["obs"]))
        return c

    def snapshot(self) -> Dict[str, Any]:
        return {"seed": self.seed, "tick": self._tick,
                "knobs": dict(self.knobs),
                "hot": self._state.hot, "cool": self._state.cool,
                "decisions": sum(len(e["decisions"]) for e in self.log)}
