"""Logical-plan optimizer — the paper's O1 "query/plan optimization" layer.

Pass pipeline (each individually toggleable so the Figure-2 ablation can
attribute gains):

1.  ``constant_folding``      — fold literal arithmetic.
2.  ``simplify_filter``       — drop always-true WHERE; detect always-false.
3.  ``window_merge``          — windows with identical frames collapse into
                                one (shared scan + fused aggregation).
4.  ``decompose_aggregates``  — AVG→SUM/COUNT, STD/VAR→moments, so shared
                                moments are computed once (enables CSE).
5.  ``cse``                   — deduplicate identical aggregate subtrees.
6.  ``column_pruning``        — narrow the storage scan to referenced cols.
7.  ``select_window_impl``    — cost-based choice of naive scan vs
                                pre-aggregated execution per window (O3).
8.  ``fuse_windows``          — windows left on the raw-scan path join ONE
                                fused multi-window launch (shared ring
                                scan); preagg windows whose columns the
                                shared scan already reads are pulled in
                                when that is marginally cheaper.

Passes are pure ``LogicalPlan -> LogicalPlan`` rewrites; ``optimize``
returns the new plan plus a human-readable rewrite log (surfaced by
``Engine.explain`` and the benchmarks).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import expr as E
from repro_torch.core.logical import (Filter, Join, LogicalPlan, Scan,
                                WindowProject, validate)

__all__ = ["OptFlags", "TableMeta", "CostModel", "optimize",
           "estimate_window_cost", "estimate_join_cost",
           "pass_fuse_windows", "pass_resolve_joins",
           "pass_prune_join_columns", "pass_order_joins"]


@dataclass(frozen=True)
class TableMeta:
    """Catalog info the cost model needs about a storage table."""

    capacity: int
    bucket_size: int
    n_value_cols: int
    has_preagg: bool


@dataclass(frozen=True)
class CostModel:
    """Calibratable constants of the elements-touched cost model.

    The defaults reproduce the original hard-coded model exactly: every
    access class costs 1.0 per f32 element and launches are free. The
    adaptive control plane (``repro.control``) regresses these against
    *measured* per-launch times and re-plans deployments when the
    calibrated constants flip a decision (DESIGN.md §10) — the
    coefficients are relative weights, so only their ratios matter to the
    optimizer's comparisons.

    * ``scan_el``   — per-element weight of raw ring-scan reads (naive and
      fused window execution, and timestamp scans);
    * ``preagg_el`` — per-element weight of pre-aggregate tier reads;
    * ``join_el``   — per-element weight of LAST JOIN right-ring reads;
    * ``launch_overhead`` — fixed per-kernel-launch cost in scan-element
      units (amortised across the members of a fused launch);
    * ``table_el``  — per-right-table multiplicative overrides on top of
      ``join_el`` (sorted name/weight pairs so the model stays hashable
      and its repr is stable for fingerprints/logs).
    """

    scan_el: float = 1.0
    preagg_el: float = 1.0
    join_el: float = 1.0
    launch_overhead: float = 0.0
    table_el: Tuple[Tuple[str, float], ...] = ()

    def table_weight(self, table: Optional[str]) -> float:
        if table is not None:
            for t, w in self.table_el:
                if t == table:
                    return self.join_el * w
        return self.join_el

    def with_table(self, table: str, weight: float) -> "CostModel":
        kept = tuple((t, w) for t, w in self.table_el if t != table)
        return dataclasses.replace(
            self, table_el=tuple(sorted(kept + ((table, float(weight)),))))


@dataclass(frozen=True)
class OptFlags:
    """Optimization switches (paper Fig. 2 ablation axes)."""

    query_opt: bool = True        # passes 1–6
    preagg: bool = True           # pass 7 may pick pre-aggregation
    plan_cache: bool = True       # consumed by the engine, carried here
    vectorized: bool = True       # engine: batched vs per-row execution
    assume_latest: bool = True    # engine: online fast path (req_ts is newest)
    parallel_workers: int = 1     # engine: worker-pool fan-out (paper Fig. 2)
    fuse_windows: bool = True     # pass 8: single-scan multi-window launch


# ---------------------------------------------------------------------------
# Expression rewriting helpers
# ---------------------------------------------------------------------------

def _rewrite(e: E.Expr, fn: Callable[[E.Expr], E.Expr]) -> E.Expr:
    """Bottom-up rewrite."""
    kids = tuple(_rewrite(c, fn) for c in E.children(e))
    return fn(E.replace_children(e, kids))


_FOLDABLE_BIN = {"+", "-", "*", "/", ">", ">=", "<", "<=", "==", "!="}
_FOLDABLE_FN = {"log", "log1p", "abs", "sqrt", "exp", "neg", "floor", "ceil"}

import math as _math

_PY_BIN = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b if b != 0 else float("inf"),
    ">": lambda a, b: float(a > b), ">=": lambda a, b: float(a >= b),
    "<": lambda a, b: float(a < b), "<=": lambda a, b: float(a <= b),
    "==": lambda a, b: float(a == b), "!=": lambda a, b: float(a != b),
}
_PY_FN = {
    "log": _math.log, "log1p": _math.log1p, "abs": abs,
    "sqrt": _math.sqrt, "exp": _math.exp, "neg": lambda x: -x,
    "floor": _math.floor, "ceil": _math.ceil,
}


def _fold(e: E.Expr) -> E.Expr:
    if (isinstance(e, E.BinOp) and e.op in _FOLDABLE_BIN
            and isinstance(e.lhs, E.Lit) and isinstance(e.rhs, E.Lit)):
        try:
            return E.Lit(float(_PY_BIN[e.op](e.lhs.value, e.rhs.value)))
        except (ValueError, OverflowError):
            return e
    if (isinstance(e, E.Func) and e.name in _FOLDABLE_FN
            and len(e.args) == 1 and isinstance(e.args[0], E.Lit)):
        try:
            return E.Lit(float(_PY_FN[e.name](e.args[0].value)))
        except (ValueError, OverflowError):
            return e
    # algebraic identities
    if isinstance(e, E.BinOp):
        if e.op == "+" and isinstance(e.rhs, E.Lit) and e.rhs.value == 0.0:
            return e.lhs
        if e.op == "+" and isinstance(e.lhs, E.Lit) and e.lhs.value == 0.0:
            return e.rhs
        if e.op == "*" and isinstance(e.rhs, E.Lit) and e.rhs.value == 1.0:
            return e.lhs
        if e.op == "*" and isinstance(e.lhs, E.Lit) and e.lhs.value == 1.0:
            return e.rhs
        if e.op == "and":
            if isinstance(e.lhs, E.Lit):
                return e.rhs if e.lhs.value else E.Lit(0.0)
            if isinstance(e.rhs, E.Lit):
                return e.lhs if e.rhs.value else E.Lit(0.0)
    return e


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------

def pass_constant_folding(plan: LogicalPlan, log: List[str]) -> LogicalPlan:
    n_before = sum(len(list(E.walk(e))) for _, e in plan.project.outputs)
    outs = tuple((n, _rewrite(e, _fold)) for n, e in plan.project.outputs)
    pred = (_rewrite(plan.filter.pred, _fold)
            if plan.filter.pred is not None else None)
    n_after = sum(len(list(E.walk(e))) for _, e in outs)
    if n_after < n_before:
        log.append(f"constant_folding: {n_before - n_after} nodes folded")
    return plan.with_(project=dataclasses.replace(plan.project, outputs=outs),
                      filter=Filter(pred))


def pass_simplify_filter(plan: LogicalPlan, log: List[str]) -> LogicalPlan:
    pred = plan.filter.pred
    if isinstance(pred, E.Lit):
        if pred.value:
            log.append("simplify_filter: dropped always-true WHERE")
            return plan.with_(filter=Filter(None))
        log.append("simplify_filter: WHERE is always-false (empty windows)")
    return plan


def pass_window_merge(plan: LogicalPlan, log: List[str]) -> LogicalPlan:
    """Windows with identical frames share one name (one fused scan)."""
    canon: Dict[str, str] = {}   # frame fingerprint -> canonical window name
    rename: Dict[str, str] = {}  # old name -> canonical name
    keep: List[Tuple[str, E.WindowSpec]] = []
    for name, spec in plan.project.windows:
        fp = spec.frame_fingerprint()
        if fp in canon:
            rename[name] = canon[fp]
        else:
            canon[fp] = name
            keep.append((name, spec))
    if not rename:
        return plan

    def fix(e: E.Expr) -> E.Expr:
        if isinstance(e, E.Agg) and e.window in rename:
            return dataclasses.replace(e, window=rename[e.window])
        return e

    outs = tuple((n, _rewrite(e, fix)) for n, e in plan.project.outputs)
    log.append(f"window_merge: merged {len(rename)} duplicate window(s) "
               f"({', '.join(f'{a}->{b}' for a, b in rename.items())})")
    return plan.with_(project=WindowProject(outs, tuple(keep)))


def pass_decompose_aggregates(plan: LogicalPlan, log: List[str]) -> LogicalPlan:
    """AVG(x) -> safe_div(SUM(x), COUNT(x)); STD/VAR -> moment form."""
    n = [0]

    def fix(e: E.Expr) -> E.Expr:
        if not isinstance(e, E.Agg):
            return e
        if e.func == E.AggFunc.AVG:
            n[0] += 1
            return E.Func("safe_div", (
                E.Agg(E.AggFunc.SUM, e.arg, e.window),
                E.Agg(E.AggFunc.COUNT, e.arg, e.window)))
        if e.func in (E.AggFunc.STD, E.AggFunc.VAR):
            n[0] += 1
            fname = "safe_std" if e.func == E.AggFunc.STD else "safe_var"
            sq = E.Agg(E.AggFunc.SUM, E.BinOp("*", e.arg, e.arg), e.window)
            s = E.Agg(E.AggFunc.SUM, e.arg, e.window)
            c = E.Agg(E.AggFunc.COUNT, e.arg, e.window)
            return E.Func(fname, (sq, s, c))
        return e

    outs = tuple((name, _rewrite(e, fix)) for name, e in plan.project.outputs)
    if n[0]:
        log.append(f"decompose_aggregates: {n[0]} compound aggregate(s) "
                   f"rewritten to shared moments")
    return plan.with_(project=dataclasses.replace(plan.project, outputs=outs))


def pass_cse(plan: LogicalPlan, log: List[str]) -> LogicalPlan:
    """Count duplicate aggregate subtrees (dedup happens in the physical
    planner via fingerprint keying; this pass records the win)."""
    seen: Dict[str, int] = {}
    for _, e in plan.project.outputs:
        for agg in E.collect_aggs(e):
            seen[agg.fingerprint()] = seen.get(agg.fingerprint(), 0) + 1
    dups = sum(c - 1 for c in seen.values() if c > 1)
    if dups:
        log.append(f"cse: {dups} duplicate aggregate(s) shared "
                   f"({len(seen)} unique)")
    return plan


def pass_column_pruning(plan: LogicalPlan, log: List[str]) -> LogicalPlan:
    cols: Dict[str, None] = {}
    for _, e in plan.project.outputs:
        for c in E.collect_columns(e):
            cols.setdefault(c)
    if plan.filter.pred is not None:
        for c in E.collect_columns(plan.filter.pred):
            cols.setdefault(c)
    pruned = tuple(c for c in plan.scan.columns if c in cols)
    if len(pruned) < len(plan.scan.columns):
        dropped = set(plan.scan.columns) - set(pruned)
        log.append(f"column_pruning: dropped {sorted(dropped)}")
    return plan.with_(scan=Scan(plan.scan.table, pruned))


def sumsq_col(arg: E.Expr) -> Optional[str]:
    """Match the ``x*x`` pattern — maps onto the materialized sumsq tier."""
    if (isinstance(arg, E.BinOp) and arg.op == "*"
            and isinstance(arg.lhs, E.Col) and isinstance(arg.rhs, E.Col)
            and arg.lhs.name == arg.rhs.name):
        return arg.lhs.name
    return None


def _tiered_arg(a: E.Agg) -> bool:
    """True if the aggregate can be served from pre-aggregate tiers."""
    if isinstance(a.arg, E.Col):
        return True
    if isinstance(a.arg, E.Lit) and a.func == E.AggFunc.COUNT:
        return True
    if a.func == E.AggFunc.SUM and sumsq_col(a.arg) is not None:
        return True   # SUM(x*x) == the sumsq tier (STD/VAR decomposition)
    return False


def estimate_window_cost(spec: E.WindowSpec, meta: TableMeta, *,
                         impl: str, n_cols: int,
                         needs_ts_scan: bool,
                         shared_scan: int = 1,
                         model: CostModel = CostModel()) -> float:
    """Rough elements-touched cost model (f32 reads per request).

    ``shared_scan`` is the number of windows sharing one fused launch
    (``impl in ("naive", "fused")``): the timestamp scan and the
    window-bound math are computed once per launch, so their C-sized cost
    amortises across the members — the shared-scan discount that makes
    fusing a window into an existing launch cheaper than running it alone.
    For a raw-scan impl, ``needs_ts_scan=False`` prices the *marginal*
    member of an existing launch (the ts scan is already paid for).

    ``model`` scales each access class by its calibrated per-element
    weight (defaults reproduce the uncalibrated model bit-for-bit).
    """
    C, B = meta.capacity, meta.bucket_size
    nb = C // B
    share = max(shared_scan, 1)
    if impl in ("naive", "fused"):
        ts_cost = C / share if needs_ts_scan else 0.0
        return (model.scan_el * (C * n_cols + ts_cost)   # values + shared ts
                + model.launch_overhead / share)
    ts_cost = C if needs_ts_scan else 0
    return (model.preagg_el * (nb * (n_cols + 1) + 2 * B * n_cols)
            + model.scan_el * ts_cost + model.launch_overhead)


def pass_select_window_impl(plan: LogicalPlan, log: List[str], *,
                            meta: TableMeta,
                            flags: OptFlags,
                            model: CostModel = CostModel()) -> LogicalPlan:
    """Cost-based naive-vs-preagg choice per window (paper O3)."""
    by_window: Dict[str, List[E.Agg]] = {}
    for _, e in plan.project.outputs:
        for agg in E.collect_aggs(e):
            by_window.setdefault(agg.window, []).append(agg)
    impl: Dict[str, str] = {}
    for wname, spec in plan.project.windows:
        aggs = by_window.get(wname, [])
        reasons = []
        if not flags.preagg or not meta.has_preagg:
            reasons.append("preagg disabled")
        if plan.filter.pred is not None:
            reasons.append("WHERE filter present (tiers are unfiltered)")
        if any(a.func in (E.AggFunc.FIRST, E.AggFunc.LAST) for a in aggs):
            reasons.append("FIRST/LAST need raw scan")
        if any(not _tiered_arg(a) for a in aggs):
            reasons.append("derived aggregate argument (no materialized tier)")
        if spec.is_rows and spec.rows_preceding > meta.capacity - meta.bucket_size:
            reasons.append("window exceeds pre-agg retention safety margin")
        if reasons:
            impl[wname] = "naive"
            log.append(f"window {wname!r}: naive ({'; '.join(reasons)})")
            continue
        n_cols = len({a.arg.name for a in aggs if isinstance(a.arg, E.Col)}) or 1
        needs_ts = (not spec.is_rows) or (not flags.assume_latest)
        c_naive = estimate_window_cost(spec, meta, impl="naive",
                                       n_cols=n_cols, needs_ts_scan=True,
                                       model=model)
        c_pre = estimate_window_cost(spec, meta, impl="preagg",
                                     n_cols=n_cols, needs_ts_scan=needs_ts,
                                     model=model)
        chosen = "preagg" if c_pre < c_naive else "naive"
        impl[wname] = chosen
        log.append(f"window {wname!r}: {chosen} "
                   f"(cost naive={c_naive:.0f} preagg={c_pre:.0f})")
    return plan.with_(window_impl=tuple(sorted(impl.items())))


def _window_colset(aggs: List[E.Agg]) -> set:
    """Distinct value columns a window's aggregates read from the scan.

    Derived (non-Col) arguments count as virtual columns keyed by their
    expression fingerprint — they occupy one stacked column in the fused
    scan exactly like a storage column does."""
    cols: set = set()
    for a in aggs:
        if isinstance(a.arg, E.Col):
            cols.add(a.arg.name)
        elif isinstance(a.arg, E.Lit):
            continue                      # COUNT(*) reads no column
        else:
            cols.add(a.arg.fingerprint())
    return cols


def pass_fuse_windows(plan: LogicalPlan, log: List[str], *,
                      meta: TableMeta,
                      flags: OptFlags,
                      model: CostModel = CostModel()) -> LogicalPlan:
    """Mark windows for single-scan fused execution (multi-window launch).

    Every window the impl-selection pass left on the raw-scan path joins
    ONE fused launch when there are at least two of them: the launch, the
    ring-block read, the timestamp scan and the window-bound math are all
    shared (the ``shared_scan`` discount in ``estimate_window_cost``).
    Pre-aggregated windows are then pulled into the shared scan when the
    marginal cost of adding their columns to the union undercuts their
    tier lookup — e.g. a window over columns the scan already streams.
    """
    impl = dict(plan.window_impl)
    naive = sorted(w for w, v in impl.items() if v == "naive")
    if not flags.fuse_windows:
        if len(naive) >= 2:
            log.append(f"fuse_windows disabled: {len(naive)} raw-scan "
                       f"window(s) execute per-group")
        return plan
    if len(naive) < 2:
        return plan                       # nothing to share a scan with

    by_window: Dict[str, List[E.Agg]] = {}
    for _, e in plan.project.outputs:
        for agg in E.collect_aggs(e):
            by_window.setdefault(agg.window, []).append(agg)
    specs = plan.project.window_map()
    naive = [w for w in naive if by_window.get(w)]
    if len(naive) < 2:
        return plan

    cost_sep = sum(
        estimate_window_cost(specs[w], meta, impl="naive",
                             n_cols=len(_window_colset(by_window[w])) or 1,
                             needs_ts_scan=True, model=model)
        for w in naive)
    union: set = set()
    for w in naive:
        union |= _window_colset(by_window[w])
        impl[w] = "fused"
    fused_set = list(naive)
    # whole-launch cost: union scan + ONE shared ts read
    cost_fused = estimate_window_cost(
        specs[naive[0]], meta, impl="fused",
        n_cols=len(union) or 1, needs_ts_scan=True, shared_scan=1,
        model=model)

    # pull preagg windows into the shared scan when marginally cheaper
    for w in sorted(w for w, v in impl.items() if v == "preagg"):
        cols = _window_colset(by_window.get(w, []))
        # marginal member of an existing launch: only its NEW columns
        # cost anything (the ts scan is already paid by the fused set)
        marginal = estimate_window_cost(
            specs[w], meta, impl="fused", n_cols=len(cols - union),
            needs_ts_scan=False, shared_scan=len(fused_set) + 1,
            model=model)
        needs_ts = (not specs[w].is_rows) or (not flags.assume_latest)
        c_pre = estimate_window_cost(specs[w], meta, impl="preagg",
                                     n_cols=len(cols) or 1,
                                     needs_ts_scan=needs_ts, model=model)
        if marginal < c_pre:
            impl[w] = "fused"
            union |= cols
            fused_set.append(w)
            log.append(f"fuse_windows: pulled {w!r} into the shared scan "
                       f"(marginal={marginal:.0f} < preagg={c_pre:.0f})")

    log.append(f"fuse_windows: {len(fused_set)} window(s) -> ONE fused "
               f"launch ({', '.join(sorted(fused_set))}; "
               f"cost separate={cost_sep:.0f} fused={cost_fused:.0f})")
    return plan.with_(window_impl=tuple(sorted(impl.items())))


# ---------------------------------------------------------------------------
# Relational passes (LAST JOIN)
# ---------------------------------------------------------------------------

def _main_columns(schema) -> set:
    return set(schema.value_cols) | {schema.ts_col, schema.key_col}


def pass_resolve_joins(plan: LogicalPlan, log: List[str], *,
                       catalog) -> LogicalPlan:
    """Validate every LAST JOIN against the catalog and resolve column
    references.

    * the right table must be registered; ``on`` must be one of its
      *declared* join keys AND a main-table value column (the left side
      supplies the probe values);
    * ``order_by`` must be the right table's timestamp column — the ring
      buffer is physically ordered by it, which is what makes the
      point-in-time lookup a masked argmax instead of a sort;
    * unqualified column names that live only on one joined table are
      qualified to ``"table.col"``; ambiguous names are rejected;
    * window aggregates and WHERE may not reference joined columns
      (windows scan the main ring; WHERE filters raw events).
    """
    if not plan.joins:
        return plan
    try:
        main = catalog.get(plan.scan.table).schema
    except KeyError as e:
        raise ValueError(str(e)) from None
    jmap = {}
    for j in plan.joins:
        try:
            entry = catalog.get(j.table)
        except KeyError:
            raise ValueError(
                f"LAST JOIN references unknown table {j.table!r}; "
                f"registered tables: {list(catalog.tables())} "
                f"(create_table first)") from None
        if j.on not in entry.join_keys:
            raise ValueError(
                f"LAST JOIN {j.table!r} ON {j.on!r}: {j.on!r} is not a "
                f"declared join key of {j.table!r} (declared: "
                f"{sorted(entry.join_keys)}); joins must probe a declared "
                f"key so they resolve through the table's key directory")
        if j.on not in main.value_cols:
            raise ValueError(
                f"LAST JOIN {j.table!r} ON {j.on!r}: the main table "
                f"{main.name!r} has no value column {j.on!r} to supply the "
                f"probe keys (columns: {list(main.value_cols)})")
        if j.order_by != entry.schema.ts_col:
            raise ValueError(
                f"LAST JOIN {j.table!r} ORDER BY {j.order_by!r}: the "
                f"point-in-time ordering must be the right table's "
                f"timestamp column {entry.schema.ts_col!r} — the ring "
                f"buffer is physically ordered by it")
        jmap[j.table] = entry.schema

    main_cols = _main_columns(main)

    def owners(name: str) -> List[str]:
        return [t for t, rs in jmap.items() if name in rs.value_cols]

    def check_no_join_cols(e: E.Expr, what: str) -> None:
        for c in E.collect_columns(e):
            if "." in c:
                t = c.split(".", 1)[0]
                if t in jmap:
                    raise ValueError(
                        f"{what} references joined column {c!r}; "
                        f"{what.split()[0]} evaluates over main-table "
                        f"events — joined columns are per-request values "
                        f"and are out of scope there")
            elif c not in main_cols and owners(c):
                raise ValueError(
                    f"{what} references column {c!r}, which only exists "
                    f"on joined table(s) {owners(c)}; {what.split()[0]} "
                    f"evaluates over main-table events — joined columns "
                    f"are per-request values and are out of scope there")

    def resolve(e: E.Expr) -> E.Expr:
        if isinstance(e, E.Agg):
            check_no_join_cols(
                e.arg, f"window aggregate {e.func.value.upper()} over "
                       f"{e.window!r}")
            return e
        if isinstance(e, E.Col):
            n = e.name
            if "." in n:
                t, c = n.split(".", 1)
                if t not in jmap:
                    raise ValueError(
                        f"qualified column {n!r} references table {t!r}, "
                        f"which is not LAST JOINed in this query (joined: "
                        f"{sorted(jmap)})")
                if c not in jmap[t].value_cols:
                    raise ValueError(
                        f"joined table {t!r} has no value column {c!r}; "
                        f"columns: {list(jmap[t].value_cols)}")
                return e
            if n in main_cols:
                return e
            own = owners(n)
            if len(own) > 1:
                raise ValueError(
                    f"column {n!r} is ambiguous across joined tables "
                    f"{sorted(own)}; qualify it as <table>.{n}")
            if own:
                return E.Col(f"{own[0]}.{n}")
            return e
        kids = tuple(resolve(c) for c in E.children(e))
        return E.replace_children(e, kids)

    n_qual = [0]

    def resolve_counting(e: E.Expr) -> E.Expr:
        before = sum(1 for x in E.walk(e)
                     if isinstance(x, E.Col) and "." in x.name)
        out = resolve(e)
        after = sum(1 for x in E.walk(out)
                    if isinstance(x, E.Col) and "." in x.name)
        n_qual[0] += after - before
        return out

    outs = tuple((n, resolve_counting(e)) for n, e in plan.project.outputs)
    if plan.filter.pred is not None:
        check_no_join_cols(plan.filter.pred,
                           "WHERE (raw-event filter before the join)")
    for wname, spec in plan.project.windows:
        for role, c in (("PARTITION BY", spec.partition_by),
                        ("ORDER BY", spec.order_by)):
            if c not in main_cols and (owners(c) or "." in c):
                raise ValueError(
                    f"window {wname!r} {role} references joined-table "
                    f"column {c!r}; windows index the main table's "
                    f"(key, ts) only — LAST JOIN results are per-request "
                    f"values and cannot partition or order a window")
    if n_qual[0]:
        log.append(f"resolve_joins: qualified {n_qual[0]} joined column "
                   f"reference(s)")
    return plan.with_(project=dataclasses.replace(plan.project,
                                                  outputs=outs))


def pass_prune_join_columns(plan: LogicalPlan, log: List[str], *,
                            catalog) -> LogicalPlan:
    """Join-aware column pruning: each join carries only the right-table
    columns the query references; a join nothing references is dropped
    entirely (its probe + launch would be pure waste)."""
    if not plan.joins:
        return plan
    used: Dict[str, Dict[str, None]] = {j.table: {} for j in plan.joins}
    for _, e in plan.project.outputs:
        for c in E.collect_columns(e):
            if "." in c:
                t, cc = c.split(".", 1)
                if t in used:
                    used[t].setdefault(cc)
    joins: List[Join] = []
    for j in plan.joins:
        cols = tuple(used[j.table])
        if not cols:
            log.append(f"join_prune: dropped unused join {j.table!r} "
                       f"(no joined column referenced)")
            continue
        full = catalog.get(j.table).schema.value_cols
        dropped = [c for c in full if c not in cols]
        if dropped:
            log.append(f"join_prune: {j.table!r} -> {list(cols)} "
                       f"(dropped {dropped})")
        joins.append(dataclasses.replace(j, columns=cols))
    return plan.with_(joins=tuple(joins))


def estimate_join_cost(capacity: int, n_cols: int, *,
                       assume_latest: bool,
                       model: CostModel = CostModel(),
                       table: Optional[str] = None) -> float:
    """Elements-touched probe cost of one LAST JOIN (f32 reads/request):
    the right ring block (C·n_cols), the timestamp scan (skipped on the
    online fast path where the newest row wins), and the key-directory
    probe. ``model.table_weight(table)`` lets calibration price one right
    table's probes differently from another's (e.g. a cold replica) — the
    lever that flips the probe order in ``pass_order_joins``."""
    ts_cost = 0.0 if assume_latest else float(capacity)
    return (model.table_weight(table) * float(capacity) * n_cols
            + model.scan_el * ts_cost + 2.0 + model.launch_overhead)


def pass_order_joins(plan: LogicalPlan, log: List[str], *,
                     catalog, flags: OptFlags,
                     model: CostModel = CostModel()) -> LogicalPlan:
    """Order joins by estimated right-table probe cost (cheapest first).

    LAST JOINs here are independent probes off the request row (no join
    chains yet), so ordering does not change results — it fixes the
    launch order so the cheapest lookups complete first and the probe
    order in EXPLAIN reflects the cost model.
    """
    if len(plan.joins) < 2:
        return plan
    costed = []
    for j in plan.joins:
        entry = catalog.get(j.table)
        n_cols = len(j.columns or entry.schema.value_cols)
        cost = estimate_join_cost(entry.table.capacity, n_cols,
                                  assume_latest=flags.assume_latest,
                                  model=model, table=j.table)
        costed.append((cost, j.table, j))
    costed.sort(key=lambda x: (x[0], x[1]))
    ordered = tuple(j for _, _, j in costed)
    if ordered != plan.joins:
        log.append("join_order: probe order "
                   + " -> ".join(f"{t}({c:.0f})" for c, t, _ in costed))
    return plan.with_(joins=ordered)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def optimize(plan: LogicalPlan, meta: TableMeta,
             flags: OptFlags = OptFlags(),
             catalog=None,
             cost_model: Optional[CostModel] = None
             ) -> Tuple[LogicalPlan, List[str]]:
    log: List[str] = []
    model = cost_model if cost_model is not None else CostModel()
    if model != CostModel():
        log.append(f"cost_model: calibrated {model}")
    if plan.joins:
        if catalog is None:
            raise ValueError(
                "plan contains LAST JOIN(s) but no relational catalog was "
                "provided; joins validate against Catalog-declared join "
                "keys (Engine passes its catalog automatically)")
        # resolution is semantics (name binding + validation), not an
        # optimization — it runs even with query_opt ablated
        plan = pass_resolve_joins(plan, log, catalog=catalog)
    if flags.query_opt:
        plan = pass_constant_folding(plan, log)
        plan = pass_simplify_filter(plan, log)
        plan = pass_window_merge(plan, log)
        plan = pass_decompose_aggregates(plan, log)
        plan = pass_cse(plan, log)
        plan = pass_column_pruning(plan, log)
        if plan.joins:
            plan = pass_prune_join_columns(plan, log, catalog=catalog)
            plan = pass_order_joins(plan, log, catalog=catalog, flags=flags,
                                    model=model)
            if plan.filter.pred is not None and plan.joins:
                # WHERE references main-table event columns only (resolve
                # enforced it), so it stays pushed below every join on the
                # raw scan — joined rows never widen the filtered set
                log.append(f"filter_pushdown: WHERE stays on the main-table "
                           f"scan below {len(plan.joins)} join(s)")
    else:
        log.append("query_opt disabled: plan executed as written")
    plan = pass_select_window_impl(plan, log, meta=meta, flags=flags,
                                   model=model)
    plan = pass_fuse_windows(plan, log, meta=meta, flags=flags, model=model)
    validate(plan)
    return plan, log
