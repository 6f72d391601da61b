"""Declarative SLOs with multi-window burn-rate alerting (DESIGN.md §14).

An :class:`SLOSpec` declares a bound over one exported metric (latency
p99, feature-age p99, shed ratio, drift PSI — any key of the metrics
dict fed to :meth:`SLOEngine.evaluate`) and an error budget: the
allowed fraction of BAD evaluation samples. Burn rate is the classic
SRE quantity ``bad_fraction / budget`` — burn 1.0 spends the budget
exactly, burn N spends it N× too fast.

Alerting uses the standard fast+slow multi-window rule: a spec flips to
``ALERTING`` only when BOTH windows burn above ``burn_threshold`` (the
slow window filters blips, the fast window guarantees the alert fires
promptly on a real regression and RESOLVES promptly after it clears —
the fast window alone drops below threshold as soon as recent samples
are good again).

State transitions are recorded (and exported via :meth:`export`) and
the control plane delivers active ``action="tune"`` alerts into
``ControlPlane.tick()`` as a first-class ``LoadObservation`` input;
``action="report"`` alerts (drift) never steer knobs. ``evaluate``
takes an explicit ``now`` so tests drive the windows deterministically
without sleeping.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

__all__ = ["SLOSpec", "SLOEngine", "OK", "ALERTING"]

OK = "ok"
ALERTING = "alerting"


@dataclass(frozen=True)
class SLOSpec:
    """One service-level objective over one exported metric.

    A sample is GOOD when ``value <= bound``. ``budget`` is the allowed
    bad fraction (0.01 = 99% of samples must be good). ``action`` is
    what the control plane may do with an active alert: ``"tune"`` lets
    the knob controller treat the burn as overload pressure;
    ``"report"`` is observe-only (drift SLOs must never steer knobs —
    a skewed feature distribution is a modeling problem, not a capacity
    problem)."""

    name: str
    metric: str
    bound: float
    budget: float = 0.01
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 2.0
    action: str = "tune"

    def __post_init__(self):
        if self.action not in ("tune", "report"):
            raise ValueError(
                f"SLOSpec action must be 'tune' or 'report', "
                f"got {self.action!r}")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed slow window")


class _SpecState:
    __slots__ = ("samples", "state", "since", "transitions")

    def __init__(self):
        # (t, bad) evaluation samples, pruned past the slow window
        self.samples: Deque[Tuple[float, bool]] = collections.deque()
        self.state = OK
        self.since = 0.0
        self.transitions = 0


class SLOEngine:
    """Evaluates every spec against a metrics dict; tracks burn rates,
    alert state, and the transition log."""

    MAX_TRANSITIONS = 256

    def __init__(self, specs: Optional[List[SLOSpec]] = None):
        self._specs: Dict[str, SLOSpec] = {}
        self._states: Dict[str, _SpecState] = {}
        self.transitions: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        for s in (specs or ()):
            self.add(s)

    def add(self, spec: SLOSpec) -> SLOSpec:
        with self._lock:
            self._specs[spec.name] = spec
            self._states[spec.name] = _SpecState()
        return spec

    def specs(self) -> List[SLOSpec]:
        with self._lock:
            return list(self._specs.values())

    # ------------------------------------------------------------ evaluate
    @staticmethod
    def _burn(samples, spec: SLOSpec, window_s: float,
              now: float) -> Tuple[float, int]:
        bad = n = 0
        cutoff = now - window_s
        for t, is_bad in samples:
            if t >= cutoff:
                n += 1
                bad += is_bad
        if n == 0:
            return 0.0, 0
        return (bad / n) / spec.budget, n

    def evaluate(self, metrics: Mapping[str, float],
                 now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one sample of every watched metric; returns the state
        TRANSITIONS this evaluation caused (empty list = no change).
        Metrics missing or non-finite contribute no sample (an unserved
        deployment must not look healthy OR unhealthy)."""
        now = time.monotonic() if now is None else float(now)
        events: List[Dict[str, Any]] = []
        with self._lock:
            specs = list(self._specs.values())
        for spec in specs:
            st = self._states[spec.name]
            v = metrics.get(spec.metric)
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and math.isfinite(float(v)):
                st.samples.append((now, float(v) > spec.bound))
            cutoff = now - spec.slow_window_s
            while st.samples and st.samples[0][0] < cutoff:
                st.samples.popleft()
            fast, n_fast = self._burn(st.samples, spec,
                                      spec.fast_window_s, now)
            slow, n_slow = self._burn(st.samples, spec,
                                      spec.slow_window_s, now)
            new_state = st.state
            if st.state == OK:
                if (n_fast > 0 and fast >= spec.burn_threshold
                        and slow >= spec.burn_threshold):
                    new_state = ALERTING
            else:
                if fast < spec.burn_threshold:
                    new_state = OK
            if new_state != st.state:
                st.state = new_state
                st.since = now
                st.transitions += 1
                ev = {"t": now, "slo": spec.name, "state": new_state,
                      "metric": spec.metric, "action": spec.action,
                      "fast_burn": fast, "slow_burn": slow,
                      "value": metrics.get(spec.metric)}
                events.append(ev)
                with self._lock:
                    self.transitions.append(ev)
                    if len(self.transitions) > self.MAX_TRANSITIONS:
                        del self.transitions[:len(self.transitions)
                                             - self.MAX_TRANSITIONS]
        return events

    # -------------------------------------------------------------- status
    def state(self, name: str) -> str:
        return self._states[name].state

    def active_alerts(self, action: Optional[str] = None
                      ) -> List[SLOSpec]:
        with self._lock:
            specs = list(self._specs.values())
        return [s for s in specs
                if self._states[s.name].state == ALERTING
                and (action is None or s.action == action)]

    def snapshot(self, now: Optional[float] = None
                 ) -> Dict[str, Dict[str, Any]]:
        now = time.monotonic() if now is None else float(now)
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            specs = list(self._specs.values())
        for spec in specs:
            st = self._states[spec.name]
            fast, n_fast = self._burn(st.samples, spec,
                                      spec.fast_window_s, now)
            slow, n_slow = self._burn(st.samples, spec,
                                      spec.slow_window_s, now)
            out[spec.name] = {
                "state": st.state, "metric": spec.metric,
                "bound": spec.bound, "action": spec.action,
                "fast_burn": fast, "slow_burn": slow,
                "fast_samples": n_fast, "slow_samples": n_slow,
                "transitions": st.transitions,
            }
        return out

    def export(self) -> Dict[str, float]:
        """Flat metrics for the registry ``slo`` group."""
        out: Dict[str, float] = {}
        for name, st in self.snapshot().items():
            out[f"{name}/alerting"] = 1.0 if st["state"] == ALERTING \
                else 0.0
            out[f"{name}/fast_burn"] = st["fast_burn"]
            out[f"{name}/slow_burn"] = st["slow_burn"]
            out[f"{name}/transitions"] = float(st["transitions"])
        return out
