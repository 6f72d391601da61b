"""Physical planning: LogicalPlan → executor over PyTorch tensors.

The physical plan materialises every *unique* aggregate once (CSE), groups
aggregates by window so each window runs ONE fused scan (window merge),
and lowers the window groups through three execution paths chosen by the
optimizer (``plan.window_impl``):

* ``fused``  — every group in this set executes in ONE multi-window kernel
  launch (``ops.fused_window``): a per-deployment spec table (per-group
  ROWS/RANGE bounds + field masks) over the UNION of the groups' columns,
  scanned once. Column positions are remapped group→union at compile time
  (``_FusedScan.posmaps``).
* ``naive``  — per-group single-window scan (``ops.window_agg``); only
  reached when a plan has exactly one raw-scan group or fusion is off.
* ``preagg`` — bucketed pre-aggregate lookup (``ops.preagg_window``).

The emitted executor is a function

    executor(state, preagg, key_idx, req_ts, req_row, model_params,
             join_inputs)
        -> {output_name: (B,) or (B, k) tensor}

``join_inputs`` carries one ``(right_state, right_kidx, found)`` triple
per LAST JOIN in plan order (empty tuple for single-table plans); each
join costs exactly one extra kernel launch (``ops.last_join``) and its
columns enter the scalar env as ``"table.col"`` request-level values.

The kernels read storage columns straight out of the table through
``cols``, so no launch copies the table. Only a WHERE filter or a derived
aggregate argument (``SUM(x*y)``) needs event-level values the table does
not hold; those are evaluated on the batch's own ring rows
(``state.values[key_idx]``, (B, C, V)), and the raw-scan launches then read
that batch-local copy with key indices ``0..B-1`` — the same answer, at
the cost of the batch's rows instead of the whole table.
``PhysicalPlan.n_kernel_launches`` counts the kernel invocations of one
batch (surfaced by ``Engine.latency_decomposition``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import expr as E
from repro_torch.core.logical import LogicalPlan
from repro_torch.core.optimizer import OptFlags, sumsq_col
from repro_torch.featurestore.table import (PreAggState, TableSchema,
                                            TableState)
from repro_torch.kernels import ops

__all__ = ["PhysicalPlan", "compile_plan", "AggSlot", "WindowGroup"]

# Aggregate function -> raw moment fields required from the window kernel.
_FIELD_OF = {
    E.AggFunc.SUM: "sum",
    E.AggFunc.COUNT: "count",
    E.AggFunc.MIN: "min",
    E.AggFunc.MAX: "max",
    E.AggFunc.FIRST: "first",
    E.AggFunc.LAST: "last",
    # AVG/STD/VAR survive only if decompose_aggregates was disabled; the
    # physical layer then derives them from moments itself.
    E.AggFunc.AVG: "avg",
    E.AggFunc.STD: "std",
    E.AggFunc.VAR: "var",
}

_DERIVED = {E.AggFunc.AVG, E.AggFunc.STD, E.AggFunc.VAR}
_MOMENTS_FOR = {
    E.AggFunc.AVG: ("sum", "count"),
    E.AggFunc.STD: ("sum", "sumsq", "count"),
    E.AggFunc.VAR: ("sum", "sumsq", "count"),
}


@dataclass(frozen=True)
class AggSlot:
    internal: str          # env name of the materialised aggregate
    func: E.AggFunc
    arg: E.Expr
    window: str
    col_pos: int           # position in the window group's stacked columns
    field: str = ""        # kernel output field this slot reads


@dataclass(frozen=True)
class WindowGroup:
    name: str
    spec: E.WindowSpec
    impl: str                         # "naive" | "preagg" | "fused"
    plain_cols: Tuple[int, ...]       # storage column indices gathered
    derived_args: Tuple[E.Expr, ...]  # virtual columns (raw-scan impls only)
    slots: Tuple[AggSlot, ...]
    fields: Tuple[str, ...]           # kernel fields to materialise


@dataclass(frozen=True)
class _FusedScan:
    """Compile-time layout of the single-scan multi-window launch.

    ``idx`` are group indices (into ``PhysicalPlan.groups``) in spec-table
    order; the union column stack is [plain storage columns][derived
    virtual columns], and ``posmaps[gi]`` maps a member group's local
    stacked-column position to its union position.
    """

    idx: Tuple[int, ...]
    union_plain: Tuple[int, ...]          # storage column indices
    union_derived: Tuple[E.Expr, ...]     # virtual columns (WHERE-side env)
    spec_rows: Tuple[Optional[int], ...]
    spec_ranges: Tuple[Optional[float], ...]
    spec_fields: Tuple[Tuple[str, ...], ...]
    posmaps: Tuple[Tuple[int, ...], ...]  # parallel to ``idx``


@dataclass
class PhysicalPlan:
    plan: LogicalPlan
    groups: Tuple[WindowGroup, ...]
    outputs: Tuple[Tuple[str, E.Expr], ...]   # aggs replaced by Col refs
    executor: Callable
    feature_names: Tuple[str, ...]
    # assume_latest is a *request-time* property (online fast path vs
    # point-in-time offline), so the executor is built per mode
    executor_factory: Optional[Callable] = None
    # window-kernel invocations per batch: all fused groups count as ONE
    n_kernel_launches: int = 0

    def executor_for(self, assume_latest: bool) -> Callable:
        if self.executor_factory is None:
            return self.executor
        return self.executor_factory(assume_latest)

    def fingerprint(self) -> str:
        return self.plan.fingerprint()


_where0 = E._where0


def _internal_name(agg: E.Agg) -> str:
    import hashlib
    h = hashlib.md5(agg.fingerprint().encode()).hexdigest()[:10]
    return f"__agg_{h}"


def _fill_slots(env: Dict[str, torch.Tensor], grp: WindowGroup,
                get: Callable[[str, int], torch.Tensor]) -> None:
    """Materialise a group's aggregate slots into the scalar env.

    ``get(field, pos)`` reads one (B,)-shaped kernel output column for
    this group — the indirection is what lets fused groups (indexed
    ``[:, spec, union_pos]``) and per-group launches (``[:, pos]``) share
    the empty-window masking and derived-moment math below.
    """
    cnt = get("count", -1) if "count" in grp.fields else None
    nonempty = (cnt > 0) if cnt is not None else None
    for s in grp.slots:
        if s.func == E.AggFunc.COUNT:
            env[s.internal] = cnt
            continue
        if s.func in _DERIVED:
            c = torch.clamp(cnt, min=1.0)
            mean = get("sum", s.col_pos) / c
            if s.func == E.AggFunc.AVG:
                val = mean
            else:
                var = torch.clamp(
                    get("sumsq", s.col_pos) / c - mean * mean, min=0.0)
                val = var if s.func == E.AggFunc.VAR else torch.sqrt(var)
            env[s.internal] = _where0(nonempty, val)
            continue
        val = get(s.field or _FIELD_OF[s.func], s.col_pos)
        if s.func in (E.AggFunc.MIN, E.AggFunc.MAX,
                      E.AggFunc.FIRST, E.AggFunc.LAST):
            val = _where0(nonempty, val)
        env[s.internal] = val


def compile_plan(plan: LogicalPlan, schema: TableSchema, *,
                 flags: OptFlags = OptFlags(),
                 bucket_size: int,
                 model_fns: Optional[Dict[str, Callable]] = None,
                 join_schemas: Optional[Dict[str, TableSchema]] = None
                 ) -> PhysicalPlan:
    """Lower an optimized logical plan to an executor function."""
    model_fns = model_fns or {}
    join_schemas = join_schemas or {}
    impl_map = dict(plan.window_impl)
    wmap = plan.project.window_map()

    # ---- 0. LAST JOIN layout: per join, the right columns to gather and
    # the slot-env names they land under (one kernel launch per join) ----
    join_layout: List[Tuple[str, Tuple[int, ...], Tuple[str, ...]]] = []
    for j in plan.joins:
        rs = join_schemas.get(j.table)
        if rs is None:
            raise KeyError(
                f"compile_plan: no schema supplied for joined table "
                f"{j.table!r} (join_schemas has {sorted(join_schemas)})")
        cols = j.columns or rs.value_cols
        gather = tuple(rs.col_index(c) for c in cols)
        names = tuple(f"{j.table}.{c}" for c in cols)
        join_layout.append((j.table, gather, names))
    join_layout_t = tuple(join_layout)

    # ---- 1. unique aggregates (CSE) -------------------------------------
    uniq: Dict[str, E.Agg] = {}
    for _, e in plan.project.outputs:
        for agg in E.collect_aggs(e):
            uniq.setdefault(agg.fingerprint(), agg)

    # ---- 2. group by window; assign stacked-column positions ------------
    groups: List[WindowGroup] = []
    slot_by_fp: Dict[str, AggSlot] = {}
    for wname, spec in plan.project.windows:
        waggs = [a for a in uniq.values() if a.window == wname]
        if not waggs:
            continue
        impl = impl_map.get(wname, "naive")
        plain: List[int] = []
        plain_seen: Dict[int, int] = {}
        derived: List[E.Expr] = []
        derived_seen: Dict[str, int] = {}
        slots: List[AggSlot] = []
        fields: List[str] = []
        for agg in sorted(waggs, key=lambda a: a.fingerprint()):
            field = _FIELD_OF[agg.func]
            sq_col = (sumsq_col(agg.arg)
                      if agg.func == E.AggFunc.SUM else None)
            if isinstance(agg.arg, E.Col) or (sq_col is not None
                                              and impl == "preagg"):
                # plain storage column — SUM(x*x) reads the sumsq tier
                cname = sq_col if sq_col is not None else agg.arg.name
                if sq_col is not None:
                    field = "sumsq"
                ci = schema.col_index(cname)
                if ci not in plain_seen:
                    plain_seen[ci] = len(plain)
                    plain.append(ci)
                pos = plain_seen[ci]
            elif isinstance(agg.arg, E.Lit) and agg.func == E.AggFunc.COUNT:
                pos = -1   # COUNT(*) — no column needed
            else:
                if impl == "preagg":
                    raise AssertionError(
                        f"optimizer chose preagg for window {wname!r} with "
                        f"derived aggregate argument {agg.arg!r}")
                fp = agg.arg.fingerprint()
                if fp not in derived_seen:
                    derived_seen[fp] = len(derived)
                    derived.append(agg.arg)
                pos = len(plain_seen) + derived_seen[fp]  # provisional
            if agg.func in _DERIVED:
                for m in _MOMENTS_FOR[agg.func]:
                    if m not in fields:
                        fields.append(m)
            elif field not in fields:
                fields.append(field)
            slot = AggSlot(internal=_internal_name(agg), func=agg.func,
                           arg=agg.arg, window=wname, col_pos=pos,
                           field=field)
            slots.append(slot)
            slot_by_fp[agg.fingerprint()] = slot
        # MIN/MAX/FIRST/LAST zero-fill empty windows via the count field
        if ("count" not in fields
                and any(s.func in (E.AggFunc.MIN, E.AggFunc.MAX,
                                   E.AggFunc.FIRST, E.AggFunc.LAST)
                        for s in slots)):
            fields.append("count")
        # fix provisional derived positions now that plain count is final
        n_plain = len(plain)
        fixed = []
        for s in slots:
            if (not isinstance(s.arg, E.Col) and s.col_pos >= 0
                    and s.arg.fingerprint() in derived_seen):
                # recompute: derived columns come after all plain ones
                fp = s.arg.fingerprint()
                pos = n_plain + derived_seen[fp]
                s = AggSlot(s.internal, s.func, s.arg, s.window, pos,
                            s.field)
            fixed.append(s)
        groups.append(WindowGroup(
            name=wname, spec=spec, impl=impl, plain_cols=tuple(plain),
            derived_args=tuple(derived), slots=tuple(fixed),
            fields=tuple(fields)))

    # ---- 3. rewrite outputs: Agg -> Col(internal) ------------------------
    def sub(e: E.Expr) -> E.Expr:
        if isinstance(e, E.Agg):
            return E.Col(slot_by_fp[e.fingerprint()].internal)
        kids = tuple(sub(c) for c in E.children(e))
        return E.replace_children(e, kids)

    outputs = tuple((n, sub(e)) for n, e in plan.project.outputs)
    feature_names = tuple(n for n, _ in outputs)
    filter_pred = plan.filter.pred
    scan_cols = plan.scan.columns
    predict = plan.predict
    ts_col = schema.ts_col
    groups_t = tuple(groups)

    # ---- 3b. fused-scan layout: union columns + group→union remaps ------
    fused_idx = tuple(i for i, g in enumerate(groups_t)
                      if g.impl == "fused")
    fused: Optional[_FusedScan] = None
    if fused_idx:
        union_plain: List[int] = []
        plain_upos: Dict[int, int] = {}
        union_derived: List[E.Expr] = []
        derived_upos: Dict[str, int] = {}
        for i in fused_idx:
            g = groups_t[i]
            for ci in g.plain_cols:
                if ci not in plain_upos:
                    plain_upos[ci] = len(union_plain)
                    union_plain.append(ci)
            for a in g.derived_args:
                fp = a.fingerprint()
                if fp not in derived_upos:
                    derived_upos[fp] = len(union_derived)
                    union_derived.append(a)
        n_up = len(union_plain)
        posmaps = []
        for i in fused_idx:
            g = groups_t[i]
            pm = [plain_upos[ci] for ci in g.plain_cols]
            pm += [n_up + derived_upos[a.fingerprint()]
                   for a in g.derived_args]
            posmaps.append(tuple(pm))
        fused = _FusedScan(
            idx=fused_idx,
            union_plain=tuple(union_plain),
            union_derived=tuple(union_derived),
            spec_rows=tuple(groups_t[i].spec.rows_preceding
                            for i in fused_idx),
            spec_ranges=tuple(groups_t[i].spec.range_preceding
                              for i in fused_idx),
            spec_fields=tuple(groups_t[i].fields for i in fused_idx),
            posmaps=tuple(posmaps))
    n_launches = (1 if fused_idx else 0) + sum(
        1 for g in groups_t if g.impl != "fused") + len(join_layout_t)

    # ---- 3c. column layouts and whether the batch needs its own rows ----
    scan_col_idx = tuple((c, schema.col_index(c)) for c in scan_cols
                         if c in schema.value_cols)
    raw_groups = [g for g in groups_t if g.impl != "preagg"]
    # a WHERE mask or a derived argument is evaluated on the batch's rows
    batch_rows = filter_pred is not None or any(
        g.derived_args for g in raw_groups)

    # ---- 4. the executor --------------------------------------------------
    # assume_latest is request-time (online fast path vs point-in-time
    # offline materialisation), so the executor is a factory over it.
    @functools.lru_cache(maxsize=2)
    def make_executor(assume_latest: bool) -> Callable:
     def executor(state: TableState, preagg: Optional[PreAggState],
                 key_idx: torch.Tensor, req_ts: torch.Tensor,
                 req_row: torch.Tensor,
                 model_params: Optional[Dict] = None,
                 join_inputs: Tuple = ()
                 ) -> Dict[str, torch.Tensor]:
        # raw-scan launch inputs: the table itself, or (with WHERE or a
        # derived argument) the batch's own ring rows under keys 0..B-1
        evt_mask = None
        if batch_rows:
            kl = key_idx.long()
            rows_v = state.values[kl]                        # (B, C, V)
            rows_ts = state.ts[kl]
            ev = {c: rows_v[:, :, ci] for c, ci in scan_col_idx}
            ev[ts_col] = rows_ts
            raw = (rows_ts, state.total[kl],
                   torch.arange(key_idx.shape[0], dtype=torch.int32,
                                device=key_idx.device))
            if filter_pred is not None:
                evt_mask = E.eval_scalar(filter_pred, ev).to(torch.bool)
                evt_mask = evt_mask.expand(rows_ts.shape).contiguous()
        else:
            raw = (state.ts, state.total, key_idx)

        def raw_values(gather: Tuple[int, ...],
                       derived: Tuple[E.Expr, ...]):
            """(values, cols) a raw-scan launch reads: storage columns by
            index, derived columns appended to the batch's rows."""
            if not batch_rows:
                return state.values, gather
            if not derived:
                return rows_v, gather
            dv = torch.stack([E.eval_scalar(a, ev).to(torch.float32)
                              for a in derived], dim=-1)
            stacked = torch.cat([rows_v[:, :, list(gather)], dv], dim=-1)
            return stacked.contiguous(), None

        env: Dict[str, torch.Tensor] = {}
        # request-row columns + request timestamp
        for j, c in enumerate(schema.value_cols):
            env[c] = req_row[:, j]
        env[ts_col] = req_ts

        # LAST JOINs: one kernel launch per joined table resolves the
        # latest right row as of req_ts; joined columns land in the slot
        # env exactly like request-row columns (zeroed when the probe key
        # is unknown or no right row qualifies — the empty-window policy).
        # The selected row's ts rides along as hidden ``__join_*`` outputs
        # (stripped by the engine into per-deployment join metrics).
        join_extras: Dict[str, torch.Tensor] = {}
        for ji, (_jt, jgather, jnames) in enumerate(join_layout_t):
            jstate, jkidx, jfound = join_inputs[ji]
            jrow, jmatched, jsel_ts = ops.last_join(
                jstate.values, jstate.ts, jstate.total, jkidx, req_ts,
                col_idx=jgather, assume_latest=assume_latest, with_ts=True)
            okf = (jfound & jmatched).to(torch.float32)
            for t_i, nm in enumerate(jnames):
                env[nm] = jrow[:, t_i] * okf
            join_extras[f"__join_match_{_jt}"] = okf
            join_extras[f"__join_age_{_jt}"] = (req_ts - jsel_ts) * okf

        # ONE launch for the whole fused set: every plain window spec of
        # the deployment is answered from a single scan of the union
        # columns (the multi-window optimization this plan layer is for).
        fused_raw = None
        if fused is not None:
            vals, cols = raw_values(fused.union_plain, fused.union_derived)
            fused_raw = ops.fused_window(
                vals, *raw, req_ts, cols=cols,
                spec_rows=fused.spec_rows,
                spec_ranges=fused.spec_ranges,
                spec_fields=fused.spec_fields,
                evt_mask=evt_mask, assume_latest=assume_latest)

        for gi, grp in enumerate(groups_t):
            spec = grp.spec
            if grp.impl == "fused":
                si = fused.idx.index(gi)
                pm = fused.posmaps[si]
                def get(field, pos, _si=si, _pm=pm):
                    if field == "count":
                        return fused_raw["count"][:, _si]
                    return fused_raw[field][:, _si, _pm[pos]]
            else:
                kw = dict(rows_preceding=spec.rows_preceding,
                          range_preceding=spec.range_preceding,
                          assume_latest=assume_latest)
                if grp.impl == "preagg":
                    if preagg is None:
                        raise ValueError(
                            f"window {grp.name!r} runs on the "
                            f"pre-aggregate tier, which this table lacks")
                    res = ops.preagg_window(
                        state.values, state.ts, state.total,
                        preagg.sum, preagg.sumsq, preagg.min, preagg.max,
                        preagg.count, key_idx, req_ts,
                        bucket_size=bucket_size, cols=grp.plain_cols,
                        fields=grp.fields, **kw)
                else:
                    vals, cols = raw_values(grp.plain_cols,
                                            grp.derived_args)
                    res = ops.window_agg(
                        vals, *raw, req_ts, cols=cols, evt_mask=evt_mask,
                        fields=grp.fields, **kw)
                def get(field, pos, _res=res):
                    if field == "count":
                        return _res["count"]
                    return _res[field][:, pos]
            _fill_slots(env, grp, get)

        out = {n: E.eval_scalar(e, env) for n, e in outputs}
        out.update(join_extras)
        if predict is not None:
            feats = torch.stack([out[f] for f in predict.features], dim=-1)
            fn = model_fns.get(predict.model)
            if fn is None:
                raise KeyError(f"model {predict.model!r} not registered")
            out[predict.output] = fn(model_params, feats.to(torch.float32))
        return out

     return executor

    return PhysicalPlan(plan=plan, groups=groups_t, outputs=outputs,
                        executor=make_executor(flags.assume_latest),
                        executor_factory=make_executor,
                        feature_names=feature_names,
                        n_kernel_launches=n_launches)
