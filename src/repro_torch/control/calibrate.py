"""Cost-model calibration: refit the optimizer's per-element weights
against measured execution time.

The optimizer prices a plan in *elements touched* (``estimate_window_cost``
/ ``estimate_join_cost``) with one weight per access class — sequential
ring scan, pre-agg tier walk, join probe. The defaults assume every
element costs the same; on real hardware they don't (a tier walk is
pointer-chasing, a fused scan is a coalesced read), and the paper's 35%
plan-optimization gain depends on the choices those weights drive.

``CostCalibrator`` accumulates ``(kind, elements, seconds)`` observations
and fits one coefficient per kind by least squares through the origin::

    coeff_k = Σ(sec·el) / Σ(el²)        over kind-k observations

then normalizes so scan keeps weight 1.0 — the optimizer only ever
compares costs, so only the *ratios* matter, and normalizing keeps the
calibrated model's numbers commensurate with the uncalibrated one.
Per-table join weights come from grouping join observations by right
table. The fit is deterministic: plain sums in insertion order, no RNG.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.optimizer import (CostModel, TableMeta,
                                        estimate_join_cost,
                                        estimate_window_cost)

__all__ = ["CostObservation", "CostCalibrator", "plan_element_profile",
           "differs_materially"]

KINDS = ("scan", "preagg", "join")


@dataclass(frozen=True)
class CostObservation:
    """One measured unit of work: ``elements`` model-units (priced at
    weight 1.0) took ``seconds`` of execution."""

    kind: str                      # "scan" | "preagg" | "join"
    elements: float                # unit-model elements touched
    seconds: float                 # measured execution seconds
    table: Optional[str] = None    # join right table (kind == "join")


def plan_element_profile(handle) -> Dict[str, float]:
    """Per-request unit-model elements of a deployed plan, by access
    class — the attribution weights that split a measured per-request
    latency across kinds. Keys: subset of ``{"scan", "preagg", "join"}``
    plus ``"join:<table>"`` per joined right table."""
    phys = handle.phys
    table = handle.table
    meta = TableMeta(capacity=table.capacity, bucket_size=table.bucket_size,
                     n_value_cols=len(table.schema.value_cols),
                     has_preagg=table.preagg is not None)
    unit = CostModel()
    prof: Dict[str, float] = {}
    n_fused = sum(1 for g in phys.groups if g.impl == "fused") or 1
    for g in phys.groups:
        n_cols = max(1, len(g.plain_cols) + len(g.derived_args))
        share = n_fused if g.impl == "fused" else 1
        el = estimate_window_cost(g.spec, meta, impl=g.impl, n_cols=n_cols,
                                  needs_ts_scan=True, shared_scan=share,
                                  model=unit)
        kind = "preagg" if g.impl == "preagg" else "scan"
        prof[kind] = prof.get(kind, 0.0) + el
    engine = getattr(handle, "engine", None)
    tables = getattr(engine, "tables", {}) if engine is not None else {}
    for j in handle.plan.joins:
        right = tables.get(j.table)
        cap = right.capacity if right is not None else meta.capacity
        el = estimate_join_cost(cap, max(1, len(j.columns)),
                                assume_latest=True, model=unit)
        prof["join"] = prof.get("join", 0.0) + el
        prof[f"join:{j.table}"] = prof.get(f"join:{j.table}", 0.0) + el
    return prof


class CostCalibrator:
    """Bounded-window regression of per-element cost weights.

    ``observe()`` feeds measurements (the control plane attributes
    interval latency across the live plan's element profile; tests inject
    skewed observations directly). ``fit()`` returns a calibrated
    :class:`CostModel` once every *observed* kind has ``min_samples``
    samples, else ``None`` — never a model fitted from noise.
    """

    def __init__(self, min_samples: int = 8, max_samples: int = 512):
        self.min_samples = min_samples
        self._obs: Dict[str, collections.deque] = {}
        self._table_obs: Dict[str, collections.deque] = {}
        self.max_samples = max_samples
        self.total_observed = 0

    def observe(self, kind: str, elements: float, seconds: float,
                table: Optional[str] = None) -> None:
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if elements <= 0 or seconds < 0:
            return
        q = self._obs.setdefault(
            kind, collections.deque(maxlen=self.max_samples))
        q.append((float(elements), float(seconds)))
        self.total_observed += 1
        if kind == "join" and table is not None:
            tq = self._table_obs.setdefault(
                table, collections.deque(maxlen=self.max_samples))
            tq.append((float(elements), float(seconds)))

    def observe_obs(self, obs: CostObservation) -> None:
        self.observe(obs.kind, obs.elements, obs.seconds, table=obs.table)

    def n_samples(self, kind: str) -> int:
        return len(self._obs.get(kind, ()))

    @staticmethod
    def _lsq(pairs) -> Optional[float]:
        """Least squares through the origin: sec ≈ coeff · el."""
        num = sum(el * sec for el, sec in pairs)
        den = sum(el * el for el, sec in pairs)
        return num / den if den > 0 else None

    def fit(self, base: CostModel = CostModel()) -> Optional[CostModel]:
        """Calibrated model, or ``None`` when under-sampled. Kinds with
        no observations keep ``base``'s weight (you can't calibrate a
        path that never ran); ``launch_overhead`` carries over."""
        observed = {k: q for k, q in self._obs.items() if q}
        if not observed:
            return None
        if any(len(q) < self.min_samples for q in observed.values()):
            return None
        coeff: Dict[str, float] = {}
        for kind, q in observed.items():
            c = self._lsq(q)
            if c is not None and c > 0:
                coeff[kind] = c
        if not coeff:
            return None
        # normalize: scan stays 1.0 (ratios are all the optimizer uses)
        scale = coeff.get("scan")
        if scale is None or scale <= 0:
            # no scan observations — anchor on whichever kind we have,
            # preserving its base weight
            k0 = next(iter(coeff))
            base_w = {"scan": base.scan_el, "preagg": base.preagg_el,
                      "join": base.join_el}[k0]
            scale = coeff[k0] / max(base_w, 1e-12)
        table_el: List[Tuple[str, float]] = []
        join_c = coeff.get("join")
        if join_c is not None and join_c > 0:
            for tname, tq in sorted(self._table_obs.items()):
                if len(tq) < self.min_samples:
                    continue
                tc = self._lsq(tq)
                if tc is not None and tc > 0:
                    table_el.append((tname, tc / join_c))
        return CostModel(
            scan_el=coeff.get("scan", base.scan_el * scale) / scale,
            preagg_el=coeff.get("preagg", base.preagg_el * scale) / scale,
            join_el=coeff.get("join", base.join_el * scale) / scale,
            launch_overhead=base.launch_overhead,
            table_el=tuple(table_el),
        )

    def reset(self) -> None:
        self._obs.clear()
        self._table_obs.clear()


def differs_materially(a: CostModel, b: CostModel,
                       rel_tol: float = 0.2) -> bool:
    """True when two models disagree by more than ``rel_tol`` on any
    weight ratio — the replan trigger threshold (re-planning on 2% noise
    would churn builds forever)."""
    def rel(x: float, y: float) -> float:
        m = max(abs(x), abs(y), 1e-12)
        return abs(x - y) / m
    if (rel(a.scan_el, b.scan_el) > rel_tol
            or rel(a.preagg_el, b.preagg_el) > rel_tol
            or rel(a.join_el, b.join_el) > rel_tol):
        return True
    ta, tb = dict(a.table_el), dict(b.table_el)
    for t in set(ta) | set(tb):
        if rel(ta.get(t, 1.0), tb.get(t, 1.0)) > rel_tol:
            return True
    return False
