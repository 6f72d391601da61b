"""Logical plan for SQL+ML feature queries.

A query compiles to a small tree of logical operators:

    Scan -> [Filter] -> WindowProject -> [Predict] -> Output

``WindowProject`` is the workhorse: a set of named output expressions over
request columns and window aggregates (OpenMLDB's "window union" stage).
``Predict`` embeds an ML model invocation over computed features (the
paper's PREDICT_CHURN / DETECT_FRAUD style SQL+ML functions).

The logical plan is immutable; optimizer passes rewrite it functionally.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core import expr as E

__all__ = [
    "LogicalPlan",
    "Scan",
    "Filter",
    "Join",
    "WindowProject",
    "Predict",
    "Query",
    "validate",
]


@dataclass(frozen=True)
class Scan:
    """Scan of one event table; ``columns`` narrowed by column pruning."""

    table: str
    columns: Tuple[str, ...]  # value columns needed from storage

    def __repr__(self) -> str:
        return f"Scan({self.table},cols={list(self.columns)})"


@dataclass(frozen=True)
class Filter:
    """Row-level predicate applied to events before window aggregation
    (WHERE clause over event columns)."""

    pred: Optional[E.Expr]

    def __repr__(self) -> str:
        return f"Filter({self.pred!r})"


@dataclass(frozen=True)
class Join:
    """Point-in-time ``LAST JOIN`` against one right-hand table.

    For every request the engine resolves ``on`` (a main-table column
    holding right-table keys) through the right table's key directory and
    selects the **latest** right row with ``order_by``-timestamp ≤ the
    request timestamp — OpenMLDB's LAST JOIN semantics on ring buffers.
    Joined columns enter the slot environment as ``"<table>.<col>"`` and
    behave exactly like request-row columns downstream.

    ``order_by`` is the right table's timestamp column; it is mandatory
    (LAST JOIN without an ordering is ambiguous) and must equal the right
    table's ``ts_col`` — the ring buffer is physically ordered by it.
    ``columns`` is narrowed by the optimizer's join-aware column pruning;
    ``()`` means "not yet pruned" (all right value columns).
    """

    table: str
    on: str
    order_by: Optional[str] = None
    columns: Tuple[str, ...] = ()

    def __repr__(self) -> str:
        return (f"LastJoin({self.table},on={self.on},"
                f"order_by={self.order_by},cols={list(self.columns)})")


@dataclass(frozen=True)
class WindowProject:
    """Named output expressions over request columns + window aggregates.

    ``outputs``   — (name, expr) pairs; exprs may contain Agg nodes.
    ``windows``   — window name -> WindowSpec.
    """

    outputs: Tuple[Tuple[str, E.Expr], ...]
    windows: Tuple[Tuple[str, E.WindowSpec], ...]

    def window_map(self) -> Dict[str, E.WindowSpec]:
        return dict(self.windows)

    def __repr__(self) -> str:
        outs = ",".join(f"{n}={e!r}" for n, e in self.outputs)
        wins = ",".join(f"{n}:{w!r}" for n, w in self.windows)
        return f"WindowProject([{outs}],windows=[{wins}])"


@dataclass(frozen=True)
class Predict:
    """ML inference over a subset of the projected features.

    ``model`` names a model registered with the engine;
    ``features`` are output names from the WindowProject stage;
    ``output`` is the name of the prediction column.
    """

    model: str
    features: Tuple[str, ...]
    output: str

    def __repr__(self) -> str:
        return f"Predict({self.model},{list(self.features)}->{self.output})"


@dataclass(frozen=True)
class LogicalPlan:
    scan: Scan
    filter: Filter
    project: WindowProject
    predict: Optional[Predict] = None
    # LAST JOINs in probe order (the optimizer's join-ordering pass sorts
    # them by estimated right-table probe cost)
    joins: Tuple[Join, ...] = field(default=())
    # Physical hints attached by the optimizer (not part of SQL semantics).
    # window name -> "naive" | "preagg" | "fused" (fused = member of the
    # deployment's single-scan multi-window launch)
    window_impl: Tuple[Tuple[str, str], ...] = field(default=())

    def fingerprint(self) -> str:
        """Stable structural fingerprint — the plan-cache key component."""
        return (f"{self.scan!r}|{self.filter!r}|{self.joins!r}|"
                f"{self.project!r}|{self.predict!r}|"
                f"{dict(self.window_impl)!r}")

    def with_(self, **kw) -> "LogicalPlan":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Query:
    """A parsed-but-unoptimized query (the DSL/SQL front-end output)."""

    table: str
    outputs: Tuple[Tuple[str, E.Expr], ...]
    windows: Tuple[Tuple[str, E.WindowSpec], ...]
    where: Optional[E.Expr] = None
    predict: Optional[Predict] = None
    joins: Tuple[Join, ...] = ()

    def to_logical(self) -> LogicalPlan:
        # Before optimization, scan conservatively requests every column
        # referenced anywhere (pruning narrows this later). Qualified
        # "table.col" references belong to joined tables, never to the
        # main scan.
        cols: Dict[str, None] = {}
        for _, e in self.outputs:
            for c in E.collect_columns(e):
                if "." not in c:
                    cols.setdefault(c)
        if self.where is not None:
            for c in E.collect_columns(self.where):
                if "." not in c:
                    cols.setdefault(c)
        plan = LogicalPlan(
            scan=Scan(self.table, tuple(cols)),
            filter=Filter(self.where),
            project=WindowProject(self.outputs, self.windows),
            predict=self.predict,
            joins=self.joins,
        )
        validate(plan)
        return plan


def validate(plan: LogicalPlan) -> None:
    """Check window references + predict feature references resolve."""
    # -- joins: structural checks that need no catalog ---------------------
    seen_tables = set()
    for j in plan.joins:
        if j.table == plan.scan.table:
            raise ValueError(
                f"LAST JOIN of table {j.table!r} with itself is not "
                f"supported; the right side must be a different table")
        if j.table in seen_tables:
            raise ValueError(
                f"table {j.table!r} is LAST JOINed twice; join each right "
                f"table at most once (alias support is a ROADMAP item)")
        seen_tables.add(j.table)
        if not j.order_by:
            raise ValueError(
                f"last_join on table {j.table!r} requires order_by: LAST "
                f"JOIN is point-in-time — it selects the latest right-table "
                f"row with timestamp <= the request timestamp, so the "
                f"ordering column is part of the semantics. Pass "
                f"order_by=<the right table's timestamp column>")
    # Windows index the main table's (key, ts) only: a joined table's
    # columns are per-request values and can neither partition nor order
    # a window over the main ring buffer.
    for wname, spec in plan.project.windows:
        for role, c in (("partition_by", spec.partition_by),
                        ("order_by", spec.order_by)):
            if "." in c and c.split(".", 1)[0] in seen_tables:
                raise ValueError(
                    f"window {wname!r} {role.upper().replace('_', ' ')} "
                    f"references joined-table column {c!r}; windows index "
                    f"the main table's (key, ts) only — LAST JOIN results "
                    f"are per-request values and cannot partition or order "
                    f"a window. Partition/order by main-table columns, or "
                    f"deploy the window query on {c.split('.', 1)[0]!r} "
                    f"directly")
    # Every qualified "table.col" reference must name a LAST JOINed table
    # — deploy-time error, never a KeyError on the serving path.
    for where, exprs in (("SELECT", [e for _, e in plan.project.outputs]),
                         ("WHERE", [plan.filter.pred]
                          if plan.filter.pred is not None else [])):
        for e in exprs:
            for c in E.collect_columns(e):
                if "." in c and c.split(".", 1)[0] not in seen_tables:
                    raise ValueError(
                        f"{where} references qualified column {c!r}, but "
                        f"table {c.split('.', 1)[0]!r} is not LAST JOINed "
                        f"in this query (joined: {sorted(seen_tables)})")
    wmap = plan.project.window_map()
    for name, e in plan.project.outputs:
        for agg in E.collect_aggs(e):
            if agg.window not in wmap:
                raise ValueError(
                    f"output {name!r} references undefined window "
                    f"{agg.window!r}; defined: {sorted(wmap)}")
    if plan.filter.pred is not None:
        # WHERE filters raw events BEFORE window aggregation: windowed
        # outputs (and window aggregates themselves) are out of scope.
        if E.collect_aggs(plan.filter.pred):
            raise ValueError(
                "WHERE cannot contain window aggregates; it filters raw "
                "events before window aggregation (filter on event "
                "columns, or post-filter the feature outputs)")
        # any non-identity SELECT alias (windowed or derived) is out of
        # scope in WHERE; identity aliases (SELECT user_id) still name
        # the underlying event column and stay legal
        aliased = {n for n, e in plan.project.outputs
                   if not (isinstance(e, E.Col) and e.name == n)}
        bad = sorted(c for c in E.collect_columns(plan.filter.pred)
                     if c in aliased)
        if bad:
            raise ValueError(
                f"WHERE references SELECT alias(es) {bad}; WHERE filters "
                f"raw events before projection and window aggregation — "
                f"reference event columns instead")
    if plan.predict is not None:
        out_names = {n for n, _ in plan.project.outputs}
        missing = [f for f in plan.predict.features if f not in out_names]
        if missing:
            raise ValueError(
                f"Predict references unknown features {missing}; "
                f"available: {sorted(out_names)}")
    # Every window must share the table's partition/order columns — the
    # storage layer indexes one (key, ts) pair per table.
    parts = {w.partition_by for _, w in plan.project.windows}
    orders = {w.order_by for _, w in plan.project.windows}
    if len(parts) > 1 or len(orders) > 1:
        raise ValueError(
            f"all windows in one query must share PARTITION BY / ORDER BY "
            f"columns (got partitions={sorted(parts)}, orders={sorted(orders)})")
