"""EXPLAIN ANALYZE: attribute measured serve time to plan operators.

The paper's headline table attributes its speedup 35% to plan
optimization, 25% to caching, 20% to parallelism — an attribution over
MEASURED time, not model estimates. This module is the runtime half of
that: :class:`OperatorProfiler` accumulates, per deployment, the
measured per-batch stage times the engine already captures (``exec``
from the kernel-dispatch clock, ``host`` as the serve-wall residual,
``plan`` from the compile clock) and splits the exec portion across the
physical plan's operators.

Attribution math (DESIGN.md §13): per-operator **element counts** come
from the same unit-cost model the optimizer prices plans with
(``estimate_window_cost`` / ``estimate_join_cost`` at weight 1.0 — one
row per fused-scan set, per non-fused group, per join probe), then one
batch's measured ``exec_s`` is split proportionally to
``weight(kind) · elements(op)`` under the engine's CURRENT cost model.
The executor's kernels are not timed one by one (the exec clock ends in
one device sync for the whole batch, and on the card that window is
mostly the host's dispatch of the executor's small ops), so per-operator
seconds are *attributed*, not clocked — but they always sum to the
measured total by construction, and the attribution sharpens as the
:class:`~repro_torch.control.calibrate.CostCalibrator` refits the weights from
these same profiles (measured-per-operator feedback replacing the
plane's old EM-style split).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.optimizer import (CostModel, TableMeta,
                                        estimate_join_cost,
                                        estimate_window_cost)

__all__ = ["OperatorProfiler", "operator_rows", "attribute_exec"]

# non-operator rows every profile carries: host-side work (keydir
# resolve, masking, padding) and amortized plan/compile time
HOST_ROW = "host/keydir"
PLAN_ROW = "plan/compile"


def operator_rows(handle) -> List[Dict[str, Any]]:
    """Per-operator unit-cost element rows for one deployed version —
    the per-operator refinement of
    :func:`repro_torch.control.calibrate.plan_element_profile` (same meta,
    same unit model, same fused-scan sharing), keeping one row per
    physical operator instead of one total per kind."""
    phys = handle.phys
    table = handle.table
    meta = TableMeta(capacity=table.capacity,
                     bucket_size=table.bucket_size,
                     n_value_cols=len(table.schema.value_cols),
                     has_preagg=table.preagg is not None)
    unit = CostModel()
    rows: List[Dict[str, Any]] = []
    fused = [g for g in phys.groups if g.impl == "fused"]
    n_fused = len(fused) or 1
    fused_el = 0.0
    for g in phys.groups:
        n_cols = max(1, len(g.plain_cols) + len(g.derived_args))
        share = n_fused if g.impl == "fused" else 1
        el = estimate_window_cost(g.spec, meta, impl=g.impl,
                                  n_cols=n_cols, needs_ts_scan=True,
                                  shared_scan=share, model=unit)
        if g.impl == "fused":
            fused_el += el
            continue
        kind = "preagg" if g.impl == "preagg" else "scan"
        rows.append({"op": f"{kind}:{g.name}", "kind": kind,
                     "elements": float(el), "table": None})
    if fused:
        label = "+".join(g.name for g in fused)
        rows.insert(0, {"op": f"scan:fused[{label}]", "kind": "scan",
                       "elements": float(fused_el), "table": None})
    engine = getattr(handle, "engine", None)
    tables = getattr(engine, "tables", {}) if engine is not None else {}
    for j in handle.plan.joins:
        right = tables.get(j.table)
        cap = right.capacity if right is not None else meta.capacity
        el = estimate_join_cost(cap, max(1, len(j.columns)),
                                assume_latest=True, model=unit)
        rows.append({"op": f"join:{j.table}", "kind": "join",
                     "elements": float(el), "table": j.table})
    return rows


def attribute_exec(rows: Sequence[Dict[str, Any]], model: CostModel,
                   exec_s: float) -> List[Dict[str, Any]]:
    """Split ``exec_s`` across operator rows proportionally to
    ``weight(kind) · elements`` under ``model``. Returns copies with a
    ``seconds`` field; the seconds sum to ``exec_s`` exactly."""
    weights = {"scan": model.scan_el, "preagg": model.preagg_el,
               "join": model.join_el}
    table_w = dict(getattr(model, "table_el", ()) or ())
    def w(r):
        base = weights.get(r["kind"], 1.0) * r["elements"]
        if r["kind"] == "join" and r["table"] in table_w:
            base *= table_w[r["table"]]
        return base
    total = sum(w(r) for r in rows)
    out = []
    for r in rows:
        share = (w(r) / total) if total > 0 else 0.0
        out.append({**r, "seconds": exec_s * share, "share": share})
    return out


class OperatorProfiler:
    """Per-deployment accumulator of measured, operator-attributed serve
    time — the data behind ``EXPLAIN ANALYZE`` and the calibrator's
    measured-per-operator observations.

    ``record()`` is called once per served batch with the batch's
    measured stage times; totals and a drainable interval accumulator
    advance together. All state is plain dicts so per-shard snapshots
    merge across a pickle boundary (:meth:`merge`).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (name) -> profile dict; "ops": op -> accumulated row
        self._totals: Dict[str, Dict[str, Any]] = {}
        # interval accumulator drained by the control plane
        self._interval: Dict[str, Dict[str, Any]] = {}
        # (name, version) -> operator rows (element profile is a pure
        # function of the compiled plan; never recompute per batch)
        self._rows_cache: Dict[Any, List[Dict[str, Any]]] = {}

    def rows_for(self, handle) -> List[Dict[str, Any]]:
        key = (handle.name, handle.version)
        rows = self._rows_cache.get(key)
        if rows is None:
            rows = self._rows_cache[key] = operator_rows(handle)
        return rows

    @staticmethod
    def _blank() -> Dict[str, Any]:
        return {"ops": {}, "requests": 0, "batches": 0, "exec_s": 0.0,
                "host_s": 0.0, "plan_s": 0.0, "serve_s": 0.0}

    def record(self, handle, n_requests: int, *, exec_s: float,
               host_s: float, plan_s: float, serve_s: float,
               model: CostModel) -> List[Dict[str, Any]]:
        """Accumulate one served batch; returns this batch's attributed
        operator rows (the engine turns them into kernel child spans)."""
        attributed = attribute_exec(self.rows_for(handle), model, exec_s)
        with self._lock:
            for acc in (self._totals.setdefault(handle.name,
                                                self._blank()),
                        self._interval.setdefault(handle.name,
                                                  self._blank())):
                acc["requests"] += int(n_requests)
                acc["batches"] += 1
                acc["exec_s"] += float(exec_s)
                acc["host_s"] += float(host_s)
                acc["plan_s"] += float(plan_s)
                acc["serve_s"] += float(serve_s)
                for r in attributed:
                    op = acc["ops"].setdefault(
                        r["op"], {"kind": r["kind"], "table": r["table"],
                                  "elements": r["elements"],
                                  "seconds": 0.0})
                    op["seconds"] += r["seconds"]
        return attributed

    # ----------------------------------------------------------- export
    def snapshot(self, name: str) -> Optional[Dict[str, Any]]:
        """Deep-copied totals for ``name`` (picklable; ``None`` if the
        deployment never served)."""
        with self._lock:
            acc = self._totals.get(name)
            if acc is None:
                return None
            out = {k: v for k, v in acc.items() if k != "ops"}
            out["ops"] = {op: dict(row)
                          for op, row in acc["ops"].items()}
            return out

    def deployments(self) -> List[str]:
        with self._lock:
            return sorted(self._totals)

    @staticmethod
    def merge(snapshots: Sequence[Optional[Dict[str, Any]]]
              ) -> Optional[Dict[str, Any]]:
        """Sum per-shard snapshots (counters add; per-op ``elements``
        stays per-request so it is maxed, not summed)."""
        live = [s for s in snapshots if s]
        if not live:
            return None
        out = OperatorProfiler._blank()
        for s in live:
            for k in ("requests", "batches", "exec_s", "host_s",
                      "plan_s", "serve_s"):
                out[k] += s.get(k, 0)
            for op, row in s.get("ops", {}).items():
                acc = out["ops"].setdefault(
                    op, {"kind": row["kind"], "table": row.get("table"),
                         "elements": 0.0, "seconds": 0.0})
                acc["seconds"] += row["seconds"]
                acc["elements"] = max(acc["elements"], row["elements"])
        return out

    # -------------------------------------------------------- calibrator
    def drain_observations(self, name: str) -> List[Dict[str, Any]]:
        """Pop the interval accumulator as calibrator observations:
        per kind ``(elements-per-request, attributed-seconds-per-
        request)``, plus per-table join splits. MEASURED exec time only —
        host/plan residuals never pollute the per-element fit the way the
        plane's old EM attribution (serve_s incl. host) did."""
        with self._lock:
            acc = self._interval.pop(name, None)
        if not acc or acc["requests"] <= 0:
            return []
        reqs = acc["requests"]
        by_kind: Dict[str, Dict[str, float]] = {}
        obs: List[Dict[str, Any]] = []
        for row in acc["ops"].values():
            k = by_kind.setdefault(row["kind"],
                                   {"elements": 0.0, "seconds": 0.0})
            k["elements"] += row["elements"]
            k["seconds"] += row["seconds"]
            if row["kind"] == "join" and row.get("table"):
                obs.append({"kind": "join", "table": row["table"],
                            "elements": row["elements"],
                            "seconds": row["seconds"] / reqs})
        for kind, k in by_kind.items():
            obs.append({"kind": kind, "table": None,
                        "elements": k["elements"],
                        "seconds": k["seconds"] / reqs})
        return obs

    # ------------------------------------------------------------ render
    @staticmethod
    def render(name: str, version: int, prof: Optional[Dict[str, Any]],
               *, n_shards: int = 1) -> str:
        """The ``EXPLAIN ANALYZE`` text block for one deployment."""
        hdr = f"EXPLAIN ANALYZE deployment {name!r} v{version}"
        if n_shards > 1:
            hdr += f" (merged across {n_shards} shards)"
        if not prof or prof["batches"] <= 0:
            return hdr + "\n  (no batches served yet)"
        B, reqs = prof["batches"], max(prof["requests"], 1)
        lines = [hdr,
                 f"  served: {prof['requests']} requests in {B} "
                 f"batch(es)",
                 f"  measured per batch: serve "
                 f"{prof['serve_s'] / B * 1e3:.3f} ms = exec "
                 f"{prof['exec_s'] / B * 1e3:.3f} + host "
                 f"{prof['host_s'] / B * 1e3:.3f} + plan "
                 f"{prof['plan_s'] / B * 1e3:.3f} (amortized)",
                 "  operators (measured exec time, attributed per "
                 "unit-cost element):"]
        ops = sorted(prof["ops"].items(),
                     key=lambda kv: -kv[1]["seconds"])
        exec_s = prof["exec_s"] or 1e-12
        width = max((len(op) for op, _ in ops), default=8)
        for op, row in ops:
            lines.append(
                f"    {op:<{width}}  el/req={row['elements']:>8.1f}  "
                f"{row['seconds'] / reqs * 1e6:>9.2f} us/req  "
                f"{row['seconds'] / exec_s * 100:5.1f}% of exec")
        lines.append(
            f"    {HOST_ROW:<{width}}  {'':>12}  "
            f"{prof['host_s'] / reqs * 1e6:>9.2f} us/req  (residual)")
        lines.append(
            f"    {PLAN_ROW:<{width}}  {'':>12}  "
            f"{prof['plan_s'] / reqs * 1e6:>9.2f} us/req  (amortized)")
        attributed = (sum(r["seconds"] for _, r in ops)
                      + prof["host_s"] + prof["plan_s"])
        lines.append(
            f"  attributed total {attributed / B * 1e3:.3f} ms/batch "
            f"vs measured serve {prof['serve_s'] / B * 1e3:.3f} ms/batch"
            f" ({attributed / max(prof['serve_s'], 1e-12) * 100:.1f}%)")
        return "\n".join(lines)
