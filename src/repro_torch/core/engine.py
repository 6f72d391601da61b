"""Engine facade: deploy SQL+ML feature queries, serve them online, run them
offline — one definition, two execution modes (the paper's core promise).

Hot path anatomy (paper Eq. 3: ``L = L_parse + L_plan + L_exec``):

* ``deploy``  — parse (L_parse) + optimize + lower (L_plan, amortised by the
  plan cache across deployments);
* ``request`` — key lookup (device-resident hash directory for integer key
  batches, host dict otherwise), run the executor's kernels, then the
  output expressions and PREDICT (L_exec), and return a ``FeatureFrame``.

This is the main path of the feature engine on one device. ``deploy``
builds a version and publishes it; a name is deployed once (redeploys,
canaries and rollback are not part of this engine yet), and requests run
vectorised on the calling thread.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dsl
from repro_torch.core.logical import LogicalPlan, Query
from repro_torch.core.optimizer import CostModel, OptFlags, TableMeta, optimize
from repro_torch.core.physical import PhysicalPlan, compile_plan
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.results import (STATUS_OK, STATUS_UNKNOWN_KEY,
                                      FeatureFrame)
from repro_torch.featurestore.registry import FeatureRegistry, FeatureSet
from repro_torch.featurestore.table import (Table, TableSchema, TableSnapshot,
                                            resolve_device)
from repro_torch.relational.catalog import Catalog

__all__ = ["Engine", "DeploymentHandle", "HandleMetrics", "EngineStats"]


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the exec clock ends there)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class EngineStats:
    """Cumulative latency decomposition (seconds) + counters.

    Every field is a monotonic counter, so two ``snapshot()`` dicts taken
    at different instants can be subtracted to get an interval's work."""

    parse_s: float = 0.0
    plan_s: float = 0.0
    exec_s: float = 0.0
    # host-side serve residual: key resolve, transfers, unknown-key
    # masking — serve wall minus exec minus the batch's plan charge
    host_s: float = 0.0
    serve_s: float = 0.0
    n_requests: int = 0
    n_batches: int = 0
    # kernel invocations dispatched (fused multi-window plans count ONE
    # per batch for their whole plain-window set)
    kernel_launches: int = 0

    _FIELDS = ("parse_s", "plan_s", "exec_s", "host_s", "serve_s",
               "n_requests", "n_batches", "kernel_launches")

    def snapshot(self) -> Dict[str, float]:
        return {f: getattr(self, f) for f in self._FIELDS}


@dataclass
class HandleMetrics:
    """Per-deployment serving counters."""

    requests: int = 0
    batches: int = 0
    serve_s: float = 0.0
    unknown_keys: int = 0
    # LAST JOIN probes per right table and how many found a right row,
    # online only — offline materialisation doesn't count
    join_probes: Dict[str, int] = dataclasses.field(default_factory=dict)
    join_matches: Dict[str, int] = dataclasses.field(default_factory=dict)


class DeploymentHandle:
    """One deployment of a query: the serving endpoint."""

    LIVE = "live"

    def __init__(self, engine: "Engine", name: str, version: int,
                 query: Query, plan: LogicalPlan, phys: PhysicalPlan,
                 opt_log: List[str], table: Table):
        self.engine = engine
        self.name = name
        self.version = version
        self.query = query
        self.plan = plan
        self.phys = phys
        self.opt_log = opt_log
        self.table = table
        # right tables of the plan's LAST JOINs, in probe order (the
        # optimizer ordered them); resolved once so the hot path never
        # touches the catalog
        self.join_tables: Tuple[Table, ...] = tuple(
            engine.catalog.get(j.table).table for j in plan.joins)
        self.state = self.LIVE
        self.metrics = HandleMetrics()
        self._fns: Dict[bool, Callable] = {}
        self._lock = threading.Lock()

    @property
    def tag(self) -> str:
        """Plan-cache attribution tag for this version."""
        return f"{self.name}@v{self.version}"

    def __repr__(self) -> str:
        return (f"DeploymentHandle({self.name!r} v{self.version} "
                f"[{self.state}] on {self.table.schema.name!r})")

    # ------------------------------------------------------ executor lookup
    def _compiled(self, assume_latest: bool) -> Callable:
        eng = self.engine
        fn = self._fns.get(assume_latest)
        if fn is not None:
            eng.cache.record_hit(self.tag)
            return fn
        key = (self.phys.fingerprint(), assume_latest,
               self.name if self.plan.predict else "")
        fn, plan_dt = eng.cache.get_or_compile(
            key, lambda: self.phys.executor_for(assume_latest), tag=self.tag)
        eng.stats.plan_s += plan_dt
        if eng.cache.enabled:
            self._fns[assume_latest] = fn
        return fn

    # ---------------------------------------------------------------- joins
    def _record_join_stats(self, res: Dict[str, np.ndarray], B: int,
                           record: bool = True) -> None:
        """Strip the executor's hidden ``__join_*`` outputs from ``res``
        and (online only) count probes and matches per right table."""
        for j in self.plan.joins:
            m = res.pop(f"__join_match_{j.table}", None)
            res.pop(f"__join_age_{j.table}", None)
            if not record or m is None:
                continue
            n_match = int((np.asarray(m) > 0.5).sum())
            with self._lock:
                mt = self.metrics
                mt.join_probes[j.table] = mt.join_probes.get(j.table, 0) + B
                mt.join_matches[j.table] = (
                    mt.join_matches.get(j.table, 0) + n_match)

    def join_snapshots(self) -> Tuple[TableSnapshot, ...]:
        """One consistent snapshot per joined table (probe order)."""
        return tuple(jt.snapshot() for jt in self.join_tables)

    def _resolve_join_keys(self, row_arr: np.ndarray) -> List[Tuple]:
        """Per join: ``(right_key_index (B,) i32, found (B,) bool)``.

        Probe values come from the request rows' ``on`` column; integer
        key batches resolve through the right table's device-resident
        key directory (one probe), anything else through the host dict —
        the same contract as the main-table lookup. Unknown keys come
        back ``found=False`` and are masked to zero joined columns by the
        executor.
        """
        out: List[Tuple] = []
        for j, jt in zip(self.plan.joins, self.join_tables):
            ci = self.table.schema.col_index(j.on)
            vals = np.asarray(row_arr[:, ci], np.float64)
            ki = np.rint(vals).astype(np.int64)
            integral = np.abs(vals - ki) < 1e-6
            kd = jt.keydir
            if bool(integral.all()) and kd.covers(ki):
                kidx, found = kd.lookup(ki)
            else:
                B = len(ki)
                kidx = np.zeros(B, np.int32)
                found = np.zeros(B, np.bool_)
                k2i = jt.key_to_idx
                for i in range(B):
                    if integral[i]:
                        idx = k2i.get(int(ki[i]))
                        if idx is not None:
                            kidx[i] = idx
                            found[i] = True
            out.append((kidx, found))
        return out

    # --------------------------------------------------------------- serve
    def request(self, keys: Sequence, ts: Sequence[float],
                rows: Optional[np.ndarray] = None) -> FeatureFrame:
        """Serve a batch of online feature requests on this deployment."""
        return self._serve(keys, ts, rows)

    def _serve(self, keys: Sequence, ts: Sequence[float],
               rows: Optional[np.ndarray]) -> FeatureFrame:
        eng = self.engine
        table = self.table
        B = len(keys)
        if B == 0:
            return FeatureFrame(
                {n: np.zeros((0,), np.float32)
                 for n in self.phys.feature_names},
                status=np.zeros((0,), np.int8), deployment=self.name,
                version=self.version, table_version=table.version)
        t_start = time.perf_counter()
        # unknown keys are masked (index 0, empty history) instead of
        # raising: the caller gets per-request status, the rest of the
        # batch is unaffected. Integer key batches resolve through the
        # device-resident directory (kidx never leaves the device and the
        # found-mask is read only after the executor ran); anything else
        # goes through the host dict.
        karr = np.asarray(keys)
        kd = table.keydir
        found = None
        if karr.dtype.kind in "iu" and kd.covers(karr):
            kidx, found = kd.lookup(karr)
        else:
            kidx = np.zeros(B, np.int32)
            status = np.zeros(B, np.int8)
            k2i = table.key_to_idx
            for i, k in enumerate(keys):
                idx = k2i.get(k)
                if idx is None:
                    status[i] = STATUS_UNKNOWN_KEY
                else:
                    kidx[i] = idx
        ts_arr = np.asarray(ts, np.float32)
        V = len(table.schema.value_cols)
        if rows is None and self.plan.joins:
            # the no-row zero default would silently probe right-table
            # key 0 for every request — plausible-but-wrong joined
            # features, so joined deployments require the request row
            raise ValueError(
                f"deployment {self.name!r} has {len(self.plan.joins)} "
                f"LAST JOIN(s); online requests must pass rows= — the "
                f"join probes read the request row's "
                f"{sorted({j.on for j in self.plan.joins})} column(s), "
                f"and the zero-row default would probe key 0 instead")
        row_arr = (np.asarray(rows, np.float32) if rows is not None
                   else np.zeros((B, V), np.float32))
        plan_before = eng.cache.tag_stats(self.tag).compile_seconds
        # one snapshot per request, joined tables included
        snap = table.snapshot()
        out = eng._request_batched(self, kidx, ts_arr, row_arr, snap=snap,
                                   join_snaps=self.join_snapshots(),
                                   assume_latest=eng.flags.assume_latest)
        exec_dt = float(out.pop("__exec_s", 0.0))
        if found is not None:
            status = np.where(found.cpu().numpy(), STATUS_OK,
                              STATUS_UNKNOWN_KEY).astype(np.int8)
        unknown = status == STATUS_UNKNOWN_KEY
        n_unknown = int(unknown.sum())
        if n_unknown:
            for v in out.values():
                v[unknown] = 0.0
        wall = time.perf_counter() - t_start
        plan_dt = max(eng.cache.tag_stats(self.tag).compile_seconds
                      - plan_before, 0.0)
        with self._lock:
            m = self.metrics
            m.requests += B
            m.batches += 1
            m.serve_s += wall
            m.unknown_keys += n_unknown
        eng.stats.serve_s += wall
        eng.stats.host_s += max(wall - exec_dt - plan_dt, 0.0)
        wm = snap.watermark
        batch_age = (float((ts_arr.astype(np.float64) - wm).max())
                     if np.isfinite(wm) else None)
        return FeatureFrame(
            out, status=status, deployment=self.name, version=self.version,
            table_version=snap.version,
            latency={"serve_s": wall, "plan_s": plan_dt},
            watermark=float(wm) if np.isfinite(wm) else None,
            feature_age=batch_age)


class Engine:
    """The feature engine on one device (``"cuda"`` by default; raises
    where CUDA is absent — ask for ``device="cpu"`` explicitly)."""

    OFFLINE_BATCH = 1024     # requests per executor call in query_offline

    def __init__(self, flags: OptFlags = OptFlags(), *, device="cuda"):
        if flags.parallel_workers > 1 or not flags.vectorized:
            raise NotImplementedError(
                "the worker-pool and per-row execution modes are not "
                "ported yet; use parallel_workers=1, vectorized=True")
        self.flags = flags
        self.device = resolve_device(device)
        self.cost_model = CostModel()
        self.tables: Dict[str, Table] = {}
        self.catalog = Catalog()        # relational tier
        self.models: Dict[str, Callable] = {}
        self.model_params: Dict[str, object] = {}
        self.deployments: Dict[str, DeploymentHandle] = {}
        self.registry = FeatureRegistry()
        self.cache = PlanCache(enabled=flags.plan_cache)
        self.stats = EngineStats()

    # ------------------------------------------------------------------ DDL
    def create_table(self, schema: TableSchema, *, max_keys: int = 1024,
                     capacity: int = 1024, bucket_size: int = 64,
                     join_keys: Sequence[str] = ()) -> Table:
        """Create a table on the engine's device and register it in the
        relational catalog. ``join_keys`` declares which columns LAST JOIN
        may probe; the partition key is always declared."""
        if schema.name in self.tables:
            raise ValueError(f"table {schema.name!r} exists")
        t = Table(schema, max_keys=max_keys, capacity=capacity,
                  bucket_size=bucket_size, enable_preagg=self.flags.preagg,
                  device=self.device)
        self.catalog.register(t, join_keys=join_keys)
        self.tables[schema.name] = t
        self.registry.register_schema(schema)
        return t

    def insert(self, table: str, keys: Sequence, ts: Sequence[float],
               rows: np.ndarray) -> None:
        """Synchronous bulk insert, in place (``Table.insert``)."""
        self.tables[table].insert(keys, ts, rows)

    def register_model(self, name: str, fn: Callable,
                       params: object = None) -> None:
        """``fn(params, features (B, F) f32 tensor) -> (B,) or (B, k)``."""
        self.models[name] = fn
        self.model_params[name] = params

    # --------------------------------------------------------------- deploy
    def deploy(self, name: str,
               query: Union[str, Query, dsl.QueryBuilder]
               ) -> DeploymentHandle:
        """Parse, optimize and lower a query, then publish it as ``name``."""
        if name in self.deployments:
            raise ValueError(
                f"deployment {name!r} exists; redeploying a name (hot "
                f"swap) is not ported yet")
        t0 = time.perf_counter()
        if isinstance(query, str):
            q = dsl.parse_sql(query)
        elif isinstance(query, dsl.QueryBuilder):
            q = query.build()
        else:
            q = query
        self.stats.parse_s += time.perf_counter() - t0

        table = self.tables.get(q.table)
        if table is None:
            raise KeyError(f"unknown table {q.table!r}; create_table first")
        t1 = time.perf_counter()
        meta = TableMeta(capacity=table.capacity,
                         bucket_size=table.bucket_size,
                         n_value_cols=len(table.schema.value_cols),
                         has_preagg=table.preagg is not None)
        plan, log = optimize(q.to_logical(), meta, self.flags,
                             catalog=self.catalog,
                             cost_model=self.cost_model)
        phys = compile_plan(plan, table.schema, flags=self.flags,
                            bucket_size=table.bucket_size,
                            model_fns=self.models,
                            join_schemas={j.table:
                                          self.catalog.schema(j.table)
                                          for j in plan.joins})
        self.stats.plan_s += time.perf_counter() - t1
        h = DeploymentHandle(self, name, 1, q, plan, phys, log, table)
        self.registry.register(FeatureSet(name=name, query=q, version=1))
        self.deployments[name] = h
        self.registry.set_active(name, 1)
        return h

    def handle(self, name: str) -> DeploymentHandle:
        dep = self.deployments.get(name)
        if dep is None:
            raise KeyError(f"unknown deployment {name!r}; deployed: "
                           f"{sorted(self.deployments)}")
        return dep

    def explain(self, name: str) -> str:
        dep = self.handle(name)
        lines = [f"deployment {name!r} v{dep.version} [{dep.state}] "
                 f"on table {dep.table.schema.name!r}"]
        lines += [f"  plan: {dep.plan.fingerprint()[:160]}"]
        lines += [f"  opt : {l}" for l in dep.opt_log]
        if dep.plan.joins:
            lines.append(f"  join probe order: "
                         f"{' -> '.join(j.table for j in dep.plan.joins)}")
            for j, jt in zip(dep.plan.joins, dep.join_tables):
                kd = ("device-keydir" if jt.keydir.active
                      else "host-dict(fallback)")
                kept = j.columns or jt.schema.value_cols
                pruned = [c for c in jt.schema.value_cols if c not in kept]
                lines.append(
                    f"  join {j.table}: LAST JOIN on={j.on} "
                    f"order_by={j.order_by} cols={list(kept)} "
                    f"pruned={pruned} keydir={kd}")
        for g in dep.phys.groups:
            lines.append(f"  window {g.name}: impl={g.impl} "
                         f"cols={g.plain_cols} fields={g.fields} "
                         f"aggs={len(g.slots)}")
        fused = [g.name for g in dep.phys.groups if g.impl == "fused"]
        if fused:
            lines.append(f"  fused scan: {len(fused)} window(s) in ONE "
                         f"launch ({', '.join(fused)})")
        elif not self.flags.fuse_windows:
            lines.append("  fused scan: disabled (fuse_windows=False)")
        lines.append(f"  kernel launches/batch: "
                     f"{dep.phys.n_kernel_launches}")
        return "\n".join(lines)

    def _predict_params(self, dep: DeploymentHandle):
        if dep.plan.predict is None:
            return None
        return self.model_params.get(dep.plan.predict.model)

    # --------------------------------------------------------------- online
    def request(self, name: str, keys: Sequence, ts: Sequence[float],
                rows: Optional[np.ndarray] = None) -> FeatureFrame:
        """Serve a batch of online feature requests (delegating shim)."""
        return self.handle(name).request(keys, ts, rows)

    def _request_batched(self, dep: DeploymentHandle, kidx, ts_arr, row_arr,
                         *, snap: TableSnapshot,
                         join_snaps: Tuple[TableSnapshot, ...],
                         assume_latest: bool,
                         record_joins: bool = True) -> Dict[str, np.ndarray]:
        B = len(kidx)
        fn = dep._compiled(assume_latest)
        put = dep.table.put
        jin = ()
        if dep.join_tables:
            jin = tuple((jsnap.state, put(jk), put(jf))
                        for (jk, jf), jsnap in zip(
                            dep._resolve_join_keys(row_arr), join_snaps))
        t0 = time.perf_counter()
        out = fn(snap.state, snap.preagg, put(kidx), put(ts_arr), put(row_arr),
                 self._predict_params(dep), jin)
        _sync(dep.table.device)
        exec_dt = time.perf_counter() - t0
        self.stats.exec_s += exec_dt
        self.stats.n_requests += B
        self.stats.n_batches += 1
        self.stats.kernel_launches += dep.phys.n_kernel_launches
        # copies: on the CPU a tensor's array would alias the executor's
        # inputs (a feature that is a request column is a view of it)
        res = {n: a.cpu().numpy().copy() for n, a in out.items()}
        if dep.join_tables:
            dep._record_join_stats(res, B, record=record_joins)
        # hidden per-dispatch exec clock; _serve pops it before the
        # FeatureFrame is built
        res["__exec_s"] = exec_dt
        return res

    # -------------------------------------------------------------- offline
    def query_offline(self, name: str) -> Dict[str, np.ndarray]:
        """Run the deployed query over EVERY retained event (training-set
        materialisation). Point-in-time: each event sees only history up to
        its own timestamp — exactly the online semantics, which is the
        training-serving-skew guarantee."""
        dep = self.handle(name)
        table = dep.table
        # one snapshot for BOTH enumeration and execution, and one per
        # joined table: every offline row joins against ONE right version
        offline_snap = table.snapshot()
        offline_jsnaps = dep.join_snapshots()
        st = offline_snap.state
        totals = st.total.cpu().numpy()
        C = table.capacity
        req_keys: List[int] = []
        req_slots: List[int] = []
        for k in range(table.n_keys):
            tot = int(totals[k])
            n = min(tot, C)
            for p in range(tot - n, tot):
                req_keys.append(k)
                req_slots.append(p % C)
        if not req_keys:
            return {n: np.zeros((0,), np.float32)
                    for n in dep.phys.feature_names}
        kidx = np.asarray(req_keys, np.int32)
        slots = np.asarray(req_slots, np.int32)
        kt, stt = table.put(kidx).long(), table.put(slots).long()
        ts_all = st.ts[kt, stt].cpu().numpy()
        rows_all = st.values[kt, stt].cpu().numpy()
        # offline must not assume the request ts is the newest
        outs: List[Dict[str, np.ndarray]] = []
        for s in range(0, len(kidx), self.OFFLINE_BATCH):
            sl = slice(s, s + self.OFFLINE_BATCH)
            outs.append(self._request_batched(
                dep, kidx[sl], ts_all[sl], rows_all[sl],
                snap=offline_snap, join_snaps=offline_jsnaps,
                assume_latest=False, record_joins=False))
        for o in outs:
            o.pop("__exec_s", None)
        res = {n: np.concatenate([o[n] for o in outs]) for n in outs[0]}
        res["__key"] = kidx
        res["__ts"] = ts_all
        return res

    # ---------------------------------------------------------------- stats
    def latency_decomposition(self) -> Dict[str, float]:
        s = self.stats
        out = {"parse_s": s.parse_s, "plan_s": s.plan_s, "exec_s": s.exec_s,
               "host_s": s.host_s, "serve_s": s.serve_s,
               "n_requests": s.n_requests,
               "kernel_launches": s.kernel_launches,
               "cache_hit_rate": self.cache.stats.hit_rate}
        probes = sum(sum(d.metrics.join_probes.values())
                     for d in self.deployments.values())
        matches = sum(sum(d.metrics.join_matches.values())
                      for d in self.deployments.values())
        if probes:
            out["join_probes"] = probes
            out["join_match_rate"] = matches / probes
        return out

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Drop deployments and tables so their device memory can be freed
        once no caller holds a snapshot. Idempotent."""
        self.deployments.clear()
        self.tables.clear()
        self.catalog = Catalog()
        self.cache.clear()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
