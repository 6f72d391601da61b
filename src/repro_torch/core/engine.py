"""Engine facade: deploy SQL+ML feature queries, serve them online, run them
offline — one definition, two execution modes (the paper's core promise).

Hot path anatomy (paper Eq. 3: ``L = L_parse + L_plan + L_exec``):

* ``deploy``  — parse (L_parse) + optimize + lower (L_plan, amortised by the
  plan cache across deployments);
* ``request`` — key lookup (device-resident hash directory for integer key
  batches, host dict otherwise), run the executor's kernels, then the
  output expressions and PREDICT (L_exec), and return a ``FeatureFrame``.

``deploy`` returns a versioned :class:`DeploymentHandle` that owns its
executors. Redeploying an existing name is a **hot swap**: version N+1 is
built and warmed (its executor run once at every batch bucket the
retired version served) before an atomic publish, the retired version's
plan-cache entries are invalidated by fingerprint, and ``rollback``
restores the prior version by a swap alone. A redeploy with ``canary=``
serves a fraction of batches on the candidate beside the incumbent until
``promote`` or ``rollback`` decides.

"Parallel processing" (paper O4) has two forms here: vectorised batch
execution (the default), a worker-pool mode (``flags.parallel_workers >
1``) that splits a batch over threads, and a per-row mode
(``flags.vectorized=False``) — the paper's ablation axes. On a CUDA
table every thread launches on the device's default stream.

A table with a streaming pipeline attached (``attach_stream``) has one
writer, the pipeline's flusher, which publishes copy-on-write snapshots;
every request reads one snapshot of each table it touches.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dsl
from repro_torch.core.logical import LogicalPlan, Query
from repro_torch.core.optimizer import CostModel, OptFlags, TableMeta, optimize
from repro_torch.core.physical import PhysicalPlan, compile_plan
from repro_torch.core.plan_cache import PlanCache, bucket_batch
from repro_torch.core.results import (STATUS_OK, STATUS_UNKNOWN_KEY,
                                      DeadlineExceeded, FeatureFrame,
                                      RequestContext)
from repro_torch.featurestore.registry import FeatureRegistry, FeatureSet
from repro_torch.featurestore.table import (Table, TableSchema, TableSnapshot,
                                            resolve_device)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.freshness import FreshnessTracker
from repro_torch.obs.sketch import DriftMonitor, QuantileSketch, RollingSketch
from repro_torch.obs.trace import Tracer
from repro_torch.relational.catalog import Catalog

__all__ = ["Engine", "Deployment", "DeploymentHandle", "HandleMetrics",
           "EngineStats"]


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the exec clock ends there)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class EngineStats:
    """Cumulative latency decomposition (seconds) + counters.

    Every field is a monotonic counter, so two ``snapshot()`` dicts taken
    at different instants can be subtracted (``delta``) to get an
    interval's work — what the control plane's ``MetricsCollector``
    samples."""

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
    # the per-request latency stages (paper Eq. 3 + the host residual):
    # serve_s ≈ Σ STAGES over any serve-only interval. Every timing field
    # is a stage, serve_s itself, or parse_s (deploy time, outside the
    # serve wall)
    STAGES = ("plan_s", "exec_s", "host_s")
    # pool workers, the async pool, batcher dispatchers and serving
    # threads update these at once: every update goes through ``add``
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def add(self, **deltas: float) -> None:
        with self._lock:
            for f, d in deltas.items():
                setattr(self, f, getattr(self, f) + d)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}

    def delta(self, prev: Dict[str, float]) -> Dict[str, float]:
        """Interval counters since ``prev`` (an earlier ``snapshot()``),
        clamped at 0 so a counter reset never yields negative work."""
        now = self.snapshot()
        return {f: max(now[f] - prev.get(f, 0), 0) for f in self._FIELDS}


@dataclass
class HandleMetrics:
    """Per-deployment-version serving counters."""

    requests: int = 0
    batches: int = 0
    serve_s: float = 0.0
    unknown_keys: int = 0
    # batches this version served as a canary, and the largest absolute
    # difference from the incumbent's answer to the same batch
    canary_batches: int = 0
    canary_max_abs_diff: float = 0.0
    # LAST JOIN probes per right table and how many found a right row,
    # online only — offline materialisation doesn't count
    join_probes: Dict[str, int] = dataclasses.field(default_factory=dict)
    join_matches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # rolling sketch of recent per-batch serve latencies (seconds), what
    # the replan health gate computes p99 over: bounded memory, displaced
    # by time, merged exactly across shards. ``len(latency_s)`` is the
    # monotonic batch count the gate counts.
    latency_s: RollingSketch = dataclasses.field(
        default_factory=lambda: RollingSketch(
            window_s=HandleMetrics.LATENCY_WINDOW_S))

    LATENCY_WINDOW_S = 5.0

    def observe_latency(self, seconds: float) -> None:
        self.latency_s.observe(float(seconds))

    def latency_percentile(self, pct: float) -> float:
        """Percentile (e.g. 99) over the rolling latency window; NaN with
        no samples."""
        return self.latency_s.percentile(pct)

    def snapshot(self) -> Dict[str, float]:
        """JSON-serializable copy. The latency sketch rides along under
        ``latency_sketch`` so the sharded rollup merges percentiles
        exactly."""
        sk = self.latency_s.sketch()
        return {
            "requests": self.requests, "batches": self.batches,
            "serve_s": self.serve_s, "unknown_keys": self.unknown_keys,
            "canary_batches": self.canary_batches,
            "canary_max_abs_diff": self.canary_max_abs_diff,
            "join_probes": dict(self.join_probes),
            "join_matches": dict(self.join_matches),
            "latency_samples": len(self.latency_s),
            "latency_p50_s": sk.percentile(50),
            "latency_p99_s": sk.percentile(99),
            "latency_sketch": sk.to_dict(),
        }


class DeploymentHandle:
    """One versioned deployment of a query: the serving endpoint.

    Lifecycle: ``building -> warming -> live -> retired`` (a redeploy with
    a canary fraction parks the new version in ``canary`` between warming
    and live). The handle owns its executors in ``_fns`` — the first-level
    lookup on the hot path — so plan-cache invalidation of a retired
    version can never stall an in-flight batch, and ``rollback`` re-lives
    a retired version without rebuilding it.
    """

    BUILDING = "building"
    WARMING = "warming"
    CANARY = "canary"
    LIVE = "live"
    RETIRED = "retired"

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
        self.state = self.BUILDING
        self.metrics = HandleMetrics()
        # batch buckets this version served online: a redeploy warms them
        self.buckets_seen: Set[int] = set()
        self._fns: Dict[bool, Callable] = {}
        self._canary: Optional[Tuple["DeploymentHandle", float]] = None
        self._canary_counter = 0
        self._lock = threading.Lock()
        # matched right-row ages (req_ts − joined row ts, event-time
        # units), one quantile sketch per joined table
        self._join_ages: Dict[str, QuantileSketch] = {
            j.table: QuantileSketch() for j in plan.joins}

    # ------------------------------------------------------------ identity
    @property
    def tag(self) -> str:
        """Plan-cache attribution tag for this version."""
        return f"{self.name}@v{self.version}"

    @property
    def live(self) -> bool:
        return self.state == self.LIVE

    def __repr__(self) -> str:
        return (f"DeploymentHandle({self.name!r} v{self.version} "
                f"[{self.state}] on {self.table.schema.name!r})")

    # ------------------------------------------------------ executor lookup
    def _compiled(self, bucket: int, record: bool = True,
                  assume_latest: Optional[bool] = None) -> Callable:
        """The executor for ``assume_latest`` (the engine's flag unless
        given). ``bucket`` is the request's batch bucket: online buckets
        (``record``) join ``buckets_seen``, which a redeploy warms. The
        executor itself takes any batch size, so the cache key holds no
        bucket."""
        eng = self.engine
        if assume_latest is None:
            assume_latest = eng.flags.assume_latest
        # warm() and query_offline pass record=False: their shapes must
        # not propagate into every future swap
        if record and bucket not in self.buckets_seen:
            with self._lock:  # deploy/rollback snapshot this set mid-swap
                self.buckets_seen.add(bucket)
        fn = self._fns.get(assume_latest)
        if fn is not None:
            # first-level hit: still a plan-cache hit for Eq. 3 accounting
            eng.cache.record_hit(self.tag)
            return fn
        key = (self.phys.fingerprint(), assume_latest,
               self.name if self.plan.predict else "")
        fn, plan_dt = eng.cache.get_or_compile(
            key, lambda: self.phys.executor_for(assume_latest), tag=self.tag)
        eng.stats.add(plan_s=plan_dt)
        if eng.cache.enabled:
            # the handle owns its executors; disabled-cache ablations keep
            # paying the build, so no memo there
            self._fns[assume_latest] = fn
        return fn

    def warm(self, buckets: Sequence[int]) -> int:
        """Prepare every listed batch bucket now, off the serving path:
        sizes are rounded through ``bucket_batch`` and deduplicated, the
        executor for the engine's ``assume_latest`` is built once, then
        run once per bucket on zero inputs against the current snapshot.
        Nothing is compiled; the runs fill the kernel wrappers'
        per-static-table caches (spec tables, device tables) before the
        version takes traffic. Returns the number of buckets warmed."""
        rounded = sorted({bucket_batch(int(b)) for b in buckets})
        if not rounded:
            return 0
        eng, table = self.engine, self.table
        V = len(table.schema.value_cols)
        put = table.put
        snap = table.snapshot()
        jsnaps = self.join_snapshots()
        for b in rounded:
            fn = self._compiled(b, record=False)
            fn(snap.state, snap.preagg, put(np.zeros((b,), np.int32)),
               put(np.zeros((b,), np.float32)),
               put(np.zeros((b, V), np.float32)), eng._predict_params(self),
               tuple((js.state, put(np.zeros((b,), np.int32)),
                      put(np.zeros((b,), np.bool_))) for js in jsnaps))
        del snap, jsnaps
        _sync(table.device)
        return len(rounded)

    def release(self) -> None:
        """Drop owned executors (memory reclamation for old versions)."""
        self._fns.clear()

    # ---------------------------------------------------------------- joins
    def _record_join_stats(self, res: Dict[str, np.ndarray], B: int,
                           record: bool = True) -> None:
        """Strip the executor's hidden ``__join_*`` outputs from ``res``
        and (online only) count probes and matches per right table and
        sketch the matched right rows' ages."""
        for j in self.plan.joins:
            m = res.pop(f"__join_match_{j.table}", None)
            age = res.pop(f"__join_age_{j.table}", None)
            if not record or m is None:
                continue
            matched = np.asarray(m) > 0.5
            n_match = int(matched.sum())
            with self._lock:
                mt = self.metrics
                mt.join_probes[j.table] = mt.join_probes.get(j.table, 0) + B
                mt.join_matches[j.table] = (
                    mt.join_matches.get(j.table, 0) + n_match)
                if age is not None and n_match:
                    self._join_ages[j.table].observe_many(
                        np.asarray(age)[matched])

    def join_staleness(self) -> Dict[str, Dict[str, float]]:
        """Per joined table: probe match rate and right-row age
        percentiles (event-time units) of the online traffic."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for j in self.plan.joins:
                probes = self.metrics.join_probes.get(j.table, 0)
                matches = self.metrics.join_matches.get(j.table, 0)
                sk = self._join_ages[j.table]
                out[j.table] = {
                    "probes": probes,
                    "matches": matches,
                    "match_rate": matches / probes if probes else 0.0,
                    "age_p50": sk.percentile(50),
                    "age_p99": sk.percentile(99),
                    "age_samples": sk.count,
                    "age_sketch": sk.to_dict(),
                }
        return out

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
                rows: Optional[np.ndarray] = None,
                ctx: Optional[RequestContext] = None,
                n_live: Optional[int] = None) -> FeatureFrame:
        """Serve a batch of online feature requests on THIS version.

        ``n_live`` marks how many leading rows are real when the caller
        edge-padded the batch to a shape bucket (the shard lanes repeat
        the last row). Every row is served as usual; the frame's
        ``feature_age`` and the freshness, drift and flight observations
        read the live rows alone, so equal request multisets produce
        equal sketches however they were batched."""
        if ctx is not None and ctx.expired:
            raise DeadlineExceeded(
                f"deadline expired before serving {self.tag}")
        cand = None
        # pinned traffic asked for THIS version: never reroute it to a
        # canary (it would both violate the pin and pollute the
        # candidate's promote-decision metrics)
        pinned = ctx is not None and ctx.version_pin is not None
        canary = None if pinned else self._canary   # read once:
        if canary is not None:      # promote/rollback/deploy clear it
            cand_handle, frac = canary
            with self._lock:
                self._canary_counter += 1
                n = self._canary_counter
            if int(n * frac) > int((n - 1) * frac):
                cand = cand_handle
        if cand is None:
            return self._serve(keys, ts, rows, ctx, n_live=n_live)
        # canary slice: the new version serves the batch; the incumbent
        # computes the same batch as reference and the divergence is
        # recorded on the candidate (promote/rollback evidence)
        base = self._serve(keys, ts, rows, ctx, n_live=n_live)
        new = cand._serve(keys, ts, rows, ctx, n_live=n_live)
        diff = 0.0
        for nme, v in new.columns.items():
            ref = base.columns.get(nme)
            if ref is not None and np.size(v):
                diff = max(diff, float(np.max(np.abs(
                    np.asarray(v, np.float64) - np.asarray(ref, np.float64)))))
        with cand._lock:
            cand.metrics.canary_batches += 1
            cand.metrics.canary_max_abs_diff = max(
                cand.metrics.canary_max_abs_diff, diff)
        return new

    def request_async(self, keys: Sequence, ts: Sequence[float],
                      rows: Optional[np.ndarray] = None,
                      ctx: Optional[RequestContext] = None) -> cf.Future:
        """``request`` on a background thread; returns a
        ``Future[FeatureFrame]``."""
        return self.engine._ensure_async_pool().submit(
            self.request, keys, ts, rows, ctx)

    def _serve(self, keys: Sequence, ts: Sequence[float],
               rows: Optional[np.ndarray],
               ctx: Optional[RequestContext] = None,
               n_live: Optional[int] = None) -> FeatureFrame:
        eng = self.engine
        table = self.table
        B = len(keys)
        nl = B if n_live is None else max(0, min(int(n_live), B))
        trace = ctx.trace_id if ctx is not None else None
        if B == 0:
            return FeatureFrame(
                {n: np.zeros((0,), np.float32)
                 for n in self.phys.feature_names},
                status=np.zeros((0,), np.int8), deployment=self.name,
                version=self.version, table_version=table.version,
                trace_id=trace)
        t_start = time.perf_counter()
        span = eng.tracer.start(
            "engine.serve", trace,
            parent_id=ctx.parent_span if ctx is not None else None,
            tags={"deployment": self.tag, "rows": B})
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
        # one snapshot per request, joined tables included, whatever the
        # execution mode: a pooled or per-row request must not mix table
        # versions mid-response
        snap = table.snapshot()
        jsnaps = self.join_snapshots()
        flags = eng.flags
        if flags.parallel_workers > 1 and eng._pool is not None:
            run = eng._request_pooled
        elif not flags.vectorized:
            run = eng._request_rowwise
        else:
            run = eng._request_batched
        out = run(self, kidx, ts_arr, row_arr, snap=snap, join_snaps=jsnaps,
                  assume_latest=flags.assume_latest)
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
        # serve = plan + exec + host, host the measured residual (clamped
        # so a clock glitch can never push a stage negative)
        host_dt = max(wall - exec_dt - plan_dt, 0.0)
        with self._lock:
            m = self.metrics
            m.requests += B
            m.batches += 1
            m.serve_s += wall
            m.unknown_keys += n_unknown
            m.observe_latency(wall)
        eng.stats.add(serve_s=wall, host_s=host_dt)
        # data-plane observability, all on host values (the request's
        # ts, the snapshot's float watermark, the numpy feature columns
        # already copied back): per-row feature age against the served
        # snapshot's watermark, the live feature distributions for
        # drift, and a flight-recorder record. Pad rows beyond ``nl``
        # are excluded.
        batch_age = None
        wm = snap.watermark
        if nl and np.isfinite(wm):
            ages = ts_arr[:nl].astype(np.float64) - wm
            batch_age = float(ages.max())
            eng.freshness.observe_age(table.schema.name, ages)
        if nl:
            eng.drift.observe(out, n=nl)
        eng.flight.record(
            "serve", trace=trace, deployment=self.tag, rows=nl,
            unknown=n_unknown, table_version=snap.version,
            watermark=wm if np.isfinite(wm) else None,
            feature_age=batch_age, serve_ms=wall * 1e3)
        attributed = eng.profiler.record(
            self, B, exec_s=exec_dt, host_s=host_dt, plan_s=plan_dt,
            serve_s=wall, model=eng.cost_model)
        if span is not None:
            # the kernel children are ATTRIBUTED, not clocked: the exec
            # clock ends in one device sync for the whole batch, so each
            # operator's share of it is laid out in turn across the exec
            # window
            t_op = t_start + wall - exec_dt
            for r in attributed:
                if r["seconds"] <= 0:
                    continue
                eng.tracer.record(
                    f"kernel.{r['op']}", trace, span.span_id,
                    t_op, t_op + r["seconds"],
                    tags={"attributed": True,
                          "share": round(r["share"], 4)})
                t_op += r["seconds"]
            eng.tracer.finish(span, tags={
                "exec_s": exec_dt, "host_s": host_dt, "plan_s": plan_dt})
        return FeatureFrame(
            out, status=status, deployment=self.name, version=self.version,
            table_version=snap.version,
            latency={"serve_s": wall, "plan_s": plan_dt},
            trace_id=trace,
            watermark=float(wm) if np.isfinite(wm) else None,
            feature_age=batch_age)

    # ----------------------------------------------------------- lifecycle
    def rollback(self) -> "DeploymentHandle":
        """Restore the previous version of this deployment name."""
        return self.engine.rollback(self.name)


# the JAX package's name for the handle
Deployment = DeploymentHandle


class Engine:
    """The feature engine on one device (``"cuda"`` by default; raises
    where CUDA is absent — ask for ``device="cpu"`` explicitly)."""

    OFFLINE_BATCH = 1024     # query_offline's default batch_size

    def __init__(self, flags: OptFlags = OptFlags(), *,
                 max_cache_entries: int = 128,
                 warm_buckets: Sequence[int] = (),
                 max_retained_versions: int = 2,
                 cost_model: Optional[CostModel] = None,
                 device="cuda"):
        self.flags = flags
        self.device = resolve_device(device)
        # every build_version plans against the CURRENT model
        self.cost_model = cost_model if cost_model is not None \
            else CostModel()
        self.tables: Dict[str, Table] = {}
        self.catalog = Catalog()        # relational tier
        self.models: Dict[str, Callable] = {}
        self.model_params: Dict[str, object] = {}
        self.deployments: Dict[str, DeploymentHandle] = {}
        self.registry = FeatureRegistry()
        self.cache = PlanCache(max_entries=max_cache_entries,
                               enabled=flags.plan_cache)
        self.streams: Dict[str, object] = {}   # table -> IngestPipeline
        self.stats = EngineStats()
        # observability: the tracer samples nothing unless
        # REPRO_TRACE_SAMPLE (or set_sample_rate) says so; the profiler
        # always accumulates (it rides the timings the stats path already
        # takes). Freshness, drift and the flight recorder merge across
        # shards. None of them touches the device. (obs.profile imports
        # repro_torch.core, so it is imported here, not at module level.)
        from repro_torch.obs.profile import OperatorProfiler
        self.tracer = Tracer(sample_rate=float(
            os.environ.get("REPRO_TRACE_SAMPLE", "0") or 0))
        self.profiler = OperatorProfiler()
        self.freshness = FreshnessTracker()
        self.drift = DriftMonitor()
        self.flight = FlightRecorder()
        # batch buckets every new deployment version warms before going
        # live (redeploys also warm the buckets the retired version served)
        self.warm_buckets: Tuple[int, ...] = tuple(warm_buckets)
        self.max_retained_versions = max_retained_versions
        self._versions: Dict[str, Dict[int, DeploymentHandle]] = {}
        self._next_version: Dict[str, int] = {}   # monotonic even after
        self._history: Dict[str, List[DeploymentHandle]] = {}  # pruning
        self._deploy_lock = threading.RLock()
        self._async_lock = threading.Lock()
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._async_pool: Optional[cf.ThreadPoolExecutor] = None
        self._closed = False
        if flags.parallel_workers > 1:
            self._pool = cf.ThreadPoolExecutor(flags.parallel_workers)

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
               rows: np.ndarray, *, donate: bool = True) -> None:
        """Synchronous bulk insert (``Table.insert``). Routes through an
        attached stream when one exists — a table with a live pipeline
        has a single writer, so a direct in-place insert would race the
        flusher.

        ``donate=False`` takes the copy-on-write ingest (snapshots already
        handed out stay unchanged) — required whenever another thread may
        hold a snapshot of this table mid-serve.

        Atomic: if any event is unrepairably late (beyond the stream's
        released frontier), nothing is staged and ValueError is raised —
        matching the direct path's validate-before-ingest contract. The
        flush acts as a stream **barrier**: everything staged becomes
        queryable, which forfeits the reorder window for events at or
        below the barrier."""
        stream = self.streams.get(table)
        if stream is not None:
            keys = list(keys)
            n = stream.push_batch(keys, np.asarray(ts, np.float32),
                                  np.asarray(rows, np.float32),
                                  all_or_nothing=True)
            if n < len(keys):
                raise ValueError(
                    f"insert on table {table!r} rejected atomically: the "
                    f"batch contains event(s) beyond the stream's "
                    f"released frontier (unrepairably late) or with "
                    f"non-finite timestamps; nothing was staged")
            errs_before = stream.stats["errors"]
            stream.flush()
            # raise only for failures that left events undelivered: a
            # transient background-flusher error that the flush retried
            # successfully is not THIS insert's failure
            if (stream.stats["errors"] > errs_before
                    and stream.buffer.n_staged > 0):
                raise stream.last_error
            return
        self.tables[table].insert(keys, ts, rows, donate=donate)

    # ------------------------------------------------------------ streaming
    def attach_stream(self, table: str, cfg=None, **cfg_kw):
        """Attach a streaming ingest pipeline to an existing table.

        ``cfg`` is a ``streaming.PipelineConfig`` (or pass its fields as
        keywords: ``lateness=..., flush_interval_s=..., retention=...``).
        Returns the ``IngestPipeline``; from now on events arrive via
        ``pipeline.push`` / ``Engine.insert`` (which routes to it).
        """
        from repro_torch.streaming.pipeline import (IngestPipeline,
                                                    PipelineConfig)
        if table not in self.tables:
            raise KeyError(f"unknown table {table!r}; create_table first")
        if table in self.streams:
            raise ValueError(f"table {table!r} already has a stream")
        if cfg is None:
            cfg = PipelineConfig(**cfg_kw)
        elif cfg_kw:
            raise ValueError("pass cfg or keywords, not both")
        pipe = IngestPipeline(self.tables[table], cfg,
                              freshness=self.freshness)
        self.streams[table] = pipe
        return pipe

    def create_stream(self, schema: TableSchema, *, max_keys: int = 1024,
                      capacity: int = 1024, bucket_size: int = 64,
                      **cfg_kw):
        """``create_table`` + ``attach_stream`` in one call.

        Returns ``(table, pipeline)``."""
        t = self.create_table(schema, max_keys=max_keys, capacity=capacity,
                              bucket_size=bucket_size)
        return t, self.attach_stream(schema.name, **cfg_kw)

    def register_model(self, name: str, fn: Callable,
                       params: object = None) -> None:
        """``fn(params, features (B, F) f32 tensor) -> (B,) or (B, k)``."""
        self.models[name] = fn
        self.model_params[name] = params

    def set_cost_model(self, model: CostModel) -> CostModel:
        """Install optimizer constants. Takes effect on the NEXT
        ``build_version`` — live handles keep the plan they were built
        with. Returns the previous model."""
        with self._deploy_lock:
            prev = self.cost_model
            self.cost_model = model
            return prev

    # --------------------------------------------------------------- deploy
    def build_version(self, name: str,
                      query: Union[str, Query, dsl.QueryBuilder], *,
                      warm_buckets: Optional[Sequence[int]] = None
                      ) -> DeploymentHandle:
        """Parse, optimize, lower and warm a NEW version of ``name``
        WITHOUT publishing it — the handle comes back in the ``warming``
        state and serves only direct calls until ``publish_version`` flips
        it live. This is the build half of ``deploy``."""
        t0 = time.perf_counter()
        if isinstance(query, str):
            q = dsl.parse_sql(query)
        elif isinstance(query, dsl.QueryBuilder):
            q = query.build()
        else:
            q = query
        self.stats.add(parse_s=time.perf_counter() - t0)

        table = self.tables.get(q.table)
        if table is None:
            raise KeyError(f"unknown table {q.table!r}; create_table first")
        with self._deploy_lock:
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
            self.stats.add(plan_s=time.perf_counter() - t1)

            prev = self.deployments.get(name)
            versions = self._versions.setdefault(name, {})
            version = self._next_version.get(name, 0) + 1
            self._next_version[name] = version
            h = DeploymentHandle(self, name, version, q, plan, phys, log,
                                 table)
            h.state = DeploymentHandle.WARMING
            if self.cache.enabled:
                # with the plan cache ablated nothing retains an executor,
                # so warming would be discarded work
                warm = set(self.warm_buckets)
                if warm_buckets is not None:
                    warm |= {int(b) for b in warm_buckets}
                if prev is not None:
                    with prev._lock:   # serving threads add concurrently
                        warm |= prev.buckets_seen
                h.warm(sorted(warm))
            versions[version] = h
            self.registry.register(FeatureSet(name=name, query=q,
                                              version=version))
            return h

    def publish_version(self, handle: DeploymentHandle
                        ) -> DeploymentHandle:
        """Atomically make a built (or previously retired) version the
        live one. Re-warms a version whose executors were released, off
        the serving path — the publish itself is one dict store."""
        with self._deploy_lock:
            prev = self.deployments.get(handle.name)
            if prev is handle:
                return handle
            hist = self._history.get(handle.name)
            if hist and handle in hist:
                hist.remove(handle)
            if not handle._fns and self.cache.enabled:
                with handle._lock:
                    buckets = sorted(handle.buckets_seen)
                handle.warm(buckets)
            self._swap(handle.name, handle, prev)
            return handle

    def discard_version(self, handle: DeploymentHandle) -> None:
        """Retire a built-but-never-published version: invalidate its
        cache entries unless shared with a live version, and drop it from
        the version map."""
        with self._deploy_lock:
            if self.deployments.get(handle.name) is handle:
                raise ValueError(
                    f"{handle.tag} is the live version; use rollback")
            handle.state = DeploymentHandle.RETIRED
            self._invalidate_if_unused(handle)
            self._versions.get(handle.name, {}).pop(handle.version, None)

    def deploy(self, name: str, query: Union[str, Query, dsl.QueryBuilder],
               *, warm_buckets: Optional[Sequence[int]] = None,
               canary: float = 0.0) -> DeploymentHandle:
        """Deploy (or hot-swap redeploy) a query as a versioned handle.

        Redeploying an existing name builds version N+1, warms every
        configured batch bucket (``warm_buckets`` ∪ engine defaults ∪ the
        retired version's served buckets), then atomically publishes the
        new version; in-flight batches finish on the old one. With
        ``canary > 0`` the new version instead serves that fraction of
        batches (outputs compared against the incumbent) until
        ``promote``/``rollback`` decides.
        """
        if canary:
            if not (0.0 < canary <= 1.0):
                raise ValueError(f"canary fraction must be in (0, 1], "
                                 f"got {canary}")
            if name not in self.deployments:
                # fail BEFORE the plan build
                raise ValueError(
                    f"canary deploy of {name!r} requires an existing live "
                    f"deployment to compare against; deploy without "
                    f"canary= first")
        with self._deploy_lock:
            prev = self.deployments.get(name)
            if canary > 0.0 and prev is None:
                raise ValueError(
                    f"canary deploy of {name!r} requires an existing live "
                    f"deployment to compare against; deploy without "
                    f"canary= first")
            h = self.build_version(name, query, warm_buckets=warm_buckets)
            if canary > 0.0:
                # attach the new canary BEFORE retiring a displaced one:
                # _invalidate_if_unused must see h as a live user of a
                # shared fingerprint, or it would evict the entries h was
                # just warmed from
                displaced = prev._canary[0] if prev._canary else None
                h.state = DeploymentHandle.CANARY
                prev._canary = (h, float(canary))
                if displaced is not None:
                    displaced.state = DeploymentHandle.RETIRED
                    self._invalidate_if_unused(displaced)
                    self._versions.get(name, {}).pop(
                        displaced.version, None)
            else:
                self._swap(name, h, prev)
            return h

    def _retire_canary(self, holder: Optional[DeploymentHandle]) -> None:
        """Detach and retire ``holder``'s active canary (aborted or
        displaced): drop its cache entries and its version-map entry. Its
        executors stay on the handle, so a batch that already chose the
        canary finishes without a rebuild."""
        if holder is None or holder._canary is None:
            return
        cand, _ = holder._canary
        holder._canary = None
        cand.state = DeploymentHandle.RETIRED
        self._invalidate_if_unused(cand)
        self._versions.get(cand.name, {}).pop(cand.version, None)

    def _swap(self, name: str, new: DeploymentHandle,
              prev: Optional[DeploymentHandle]) -> None:
        """Atomic publish: one dict store flips the live version."""
        new._canary = None
        new.state = DeploymentHandle.LIVE
        self.deployments[name] = new
        self.registry.set_active(name, new.version)
        if prev is not None:
            if prev._canary is not None and prev._canary[0] is not new:
                self._retire_canary(prev)     # displaced, never promoted
            prev._canary = None
            prev.state = DeploymentHandle.RETIRED
            hist = self._history.setdefault(name, [])
            hist.append(prev)
            self._invalidate_if_unused(prev)
            while len(hist) > self.max_retained_versions:
                # beyond the retention window a version is gone for good:
                # executors dropped AND the handle unpinnable
                dropped = hist.pop(0)
                dropped.release()
                self._versions.get(name, {}).pop(dropped.version, None)

    def _invalidate_if_unused(self, retired: DeploymentHandle) -> None:
        """Drop a retired version's plan-cache entries unless a live or
        canary deployment shares the same plan fingerprint (a same-query
        redeploy must not evict the entries it was just warmed from)."""
        fp = retired.phys.fingerprint()
        for h in self.deployments.values():
            if h.phys.fingerprint() == fp:
                return
            if h._canary is not None and \
                    h._canary[0].phys.fingerprint() == fp:
                return
        self.cache.invalidate(fp)

    def handle(self, name: str, version: Optional[int] = None
               ) -> DeploymentHandle:
        """The live handle for ``name``, or a specific pinned version."""
        if version is None:
            dep = self.deployments.get(name)
            if dep is None:
                raise KeyError(f"unknown deployment {name!r}; deployed: "
                               f"{sorted(self.deployments)}")
            return dep
        try:
            return self._versions[name][version]
        except KeyError:
            raise KeyError(
                f"deployment {name!r} has no version {version}; known: "
                f"{sorted(self._versions.get(name, {}))}") from None

    def promote(self, name: str) -> DeploymentHandle:
        """Make the canary version the live one (atomic swap)."""
        with self._deploy_lock:
            live = self.handle(name)
            if live._canary is None:
                raise ValueError(f"deployment {name!r} has no active canary")
            cand, _ = live._canary
            live._canary = None
            self._swap(name, cand, live)
            return cand

    def rollback(self, name: str) -> DeploymentHandle:
        """Undo: abort an active canary, or restore the previous version.

        Retired handles keep their executors, so restoring one is a swap
        alone (a handle released under ``max_retained_versions`` is
        re-warmed here, off the hot path, before the swap)."""
        with self._deploy_lock:
            live = self.deployments.get(name)
            if live is not None and live._canary is not None:
                self._retire_canary(live)
                return live
            hist = self._history.get(name)
            if not hist:
                raise ValueError(
                    f"no prior version of {name!r} to roll back to")
            prev = hist.pop()
            if not prev._fns and self.cache.enabled:
                with prev._lock:       # pinned traffic may still add
                    buckets = sorted(prev.buckets_seen)
                prev.warm(buckets)
            self._swap(name, prev, live)
            return prev

    def explain(self, name: str) -> str:
        dep = self.handle(name)
        lines = [f"deployment {name!r} v{dep.version} [{dep.state}] "
                 f"on table {dep.table.schema.name!r}"]
        lines += [f"  plan: {dep.plan.fingerprint()[:160]}"]
        lines += [f"  opt : {l}" for l in dep.opt_log]
        if dep.plan.joins:
            lines.append(f"  join probe order: "
                         f"{' -> '.join(j.table for j in dep.plan.joins)}")
            stale = dep.join_staleness()
            for j, jt in zip(dep.plan.joins, dep.join_tables):
                kd = ("device-keydir" if jt.keydir.active
                      else "host-dict(fallback)")
                kept = j.columns or jt.schema.value_cols
                pruned = [c for c in jt.schema.value_cols if c not in kept]
                lines.append(
                    f"  join {j.table}: LAST JOIN on={j.on} "
                    f"order_by={j.order_by} cols={list(kept)} "
                    f"pruned={pruned} keydir={kd}")
                st = stale.get(j.table, {})
                if st.get("probes"):
                    lines.append(
                        f"  join {j.table} staleness: "
                        f"match_rate={st['match_rate']:.3f} "
                        f"age_p50={st['age_p50']:.3f} "
                        f"age_p99={st['age_p99']:.3f} "
                        f"({st['age_samples']} age samples)")
                else:
                    lines.append(
                        f"  join {j.table} staleness: no online traffic")
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

    def explain_analyze(self, target: str) -> str:
        """Measured-runtime EXPLAIN: render the operator profiler's
        accumulated attribution for a deployment. ``target`` is a
        deployment name or a full ``EXPLAIN ANALYZE SELECT ...``
        statement, matched against the deployed queries by parse
        equality."""
        from repro_torch.obs.profile import OperatorProfiler
        name = self._resolve_analyze_target(target)
        dep = self.handle(name)
        return OperatorProfiler.render(name, dep.version,
                                       self.profiler.snapshot(name))

    def _resolve_analyze_target(self, target: str) -> str:
        sql = dsl.strip_explain_analyze(target)
        if sql is None:
            return target                  # plain deployment name
        q = dsl.parse_sql(sql)
        for nm, dep in self.deployments.items():
            if dep.query == q:
                return nm
        raise KeyError(
            f"EXPLAIN ANALYZE: no live deployment serves this query "
            f"(deploy it first); deployed: {sorted(self.deployments)}")

    def drain_profile_observations(self, name: str) -> List[Dict]:
        """The control plane's measured-per-operator calibrator feed
        (``OperatorProfiler.drain_observations``)."""
        return self.profiler.drain_observations(name)

    def _predict_params(self, dep: DeploymentHandle):
        if dep.plan.predict is None:
            return None
        return self.model_params.get(dep.plan.predict.model)

    def _ensure_async_pool(self) -> cf.ThreadPoolExecutor:
        # dedicated lock: piggybacking on _deploy_lock would stall the
        # first request_async behind an in-flight deploy's build+warm
        if self._async_pool is None:
            with self._async_lock:
                if self._closed:
                    raise RuntimeError("engine is closed")
                if self._async_pool is None:
                    self._async_pool = cf.ThreadPoolExecutor(
                        2, thread_name_prefix="req-async")
        return self._async_pool

    # --------------------------------------------------------------- online
    def request(self, name: str, keys: Sequence, ts: Sequence[float],
                rows: Optional[np.ndarray] = None,
                ctx: Optional[RequestContext] = None) -> FeatureFrame:
        """Serve a batch of online feature requests (delegating shim);
        honours ``ctx.version_pin``."""
        pin = ctx.version_pin if ctx is not None else None
        return self.handle(name, pin).request(keys, ts, rows, ctx=ctx)

    def _request_batched(self, dep: DeploymentHandle, kidx, ts_arr, row_arr,
                         *, snap: TableSnapshot,
                         join_snaps: Tuple[TableSnapshot, ...],
                         assume_latest: bool, record_bucket: bool = True,
                         record_joins: bool = True) -> Dict[str, np.ndarray]:
        B = len(kidx)
        fn = dep._compiled(bucket_batch(B), record=record_bucket,
                           assume_latest=assume_latest)
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
        self.stats.add(exec_s=exec_dt, n_requests=B, n_batches=1,
                       kernel_launches=dep.phys.n_kernel_launches)
        # copies: on the CPU a tensor's array would alias the executor's
        # inputs (a feature that is a request column is a view of it)
        res = {n: a.cpu().numpy().copy() for n, a in out.items()}
        if dep.join_tables:
            dep._record_join_stats(res, B, record=record_joins)
        # hidden per-dispatch exec clock; _serve pops it before the
        # FeatureFrame is built
        res["__exec_s"] = exec_dt
        return res

    @staticmethod
    def _merge(outs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Concatenate per-slice results and sum their exec clocks."""
        exec_s = sum(o.pop("__exec_s", 0.0) for o in outs)
        res = {n: np.concatenate([o[n] for o in outs]) for n in outs[0]}
        res["__exec_s"] = exec_s
        return res

    def _request_rowwise(self, dep: DeploymentHandle, kidx, ts_arr, row_arr,
                         **kw) -> Dict[str, np.ndarray]:
        """Paper-faithful per-request execution (ablation: vectorized
        off): one executor call, and so one launch of each kernel, per
        row."""
        return self._merge([self._request_batched(
            dep, kidx[i:i + 1], ts_arr[i:i + 1], row_arr[i:i + 1], **kw)
            for i in range(len(kidx))])

    def _request_pooled(self, dep: DeploymentHandle, kidx, ts_arr, row_arr,
                        **kw) -> Dict[str, np.ndarray]:
        """Worker-pool fan-out (paper O4 'parallel processing'): the batch
        split into ``parallel_workers`` slices served on pool threads,
        each batched or per-row as ``flags.vectorized`` says."""
        W = self.flags.parallel_workers
        n = len(kidx)
        shard = max(1, (n + W - 1) // W)
        run = (self._request_batched if self.flags.vectorized
               else self._request_rowwise)
        futs = [self._pool.submit(run, dep, kidx[s:s + shard],
                                  ts_arr[s:s + shard], row_arr[s:s + shard],
                                  **kw)
                for s in range(0, n, shard)]
        return self._merge([f.result() for f in futs])

    # -------------------------------------------------------------- offline
    def query_offline(self, name: str, *, batch_size: int = OFFLINE_BATCH,
                      point_in_time: bool = True) -> Dict[str, np.ndarray]:
        """Run the deployed query over EVERY retained event (training-set
        materialisation), ``batch_size`` events per executor call.
        Point-in-time (the default): each event sees only history up to
        its own timestamp — exactly the online semantics, which is the
        training-serving-skew guarantee. ``point_in_time=False`` runs with
        the engine's ``assume_latest`` flag instead."""
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
        assume_latest = self.flags.assume_latest and not point_in_time
        outs: List[Dict[str, np.ndarray]] = []
        for s in range(0, len(kidx), batch_size):
            sl = slice(s, s + batch_size)
            outs.append(self._request_batched(
                dep, kidx[sl], ts_all[sl], rows_all[sl],
                snap=offline_snap, join_snaps=offline_jsnaps,
                assume_latest=assume_latest, record_bucket=False,
                record_joins=False))
        res = self._merge(outs)
        res.pop("__exec_s")
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
        # join staleness rollup across live deployments: total probes and
        # matches, and the worst per-table age p99 observed
        probes = matches = 0
        ages = []
        for dep in self.deployments.values():
            for st in dep.join_staleness().values():
                probes += st["probes"]
                matches += st["matches"]
                if st["age_samples"]:
                    ages.append(st["age_p99"])
        if probes:
            out["join_probes"] = probes
            out["join_match_rate"] = matches / probes
            out["join_age_p99"] = max(ages) if ages else float("nan")
        return out

    # ------------------------------------------------------------ freshness
    def freshness_snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-table freshness snapshot: serving sketches from the
        tracker plus stamps read off each table's current snapshot
        (watermark, publish time, version) and its ingest-side sketches —
        host state only, so a control-plane thread may call it while
        requests are served. ``FreshnessTracker.merge`` folds these
        across shards."""
        snap = self.freshness.snapshot()
        for name, t in self.tables.items():
            ent = snap.get(name)
            if ent is None:
                ent = snap[name] = dict(FreshnessTracker.blank_entry())
            ts = t.snapshot()
            ent["watermark"] = float(ts.watermark)
            ent["published_at"] = float(ts.published_at)
            ent["table_version"] = int(ts.version)
            ent.update(t.ingest_stats())
        return snap

    def freshness_export(self) -> Dict[str, object]:
        """Flat ``freshness`` metrics group for the registry."""
        return FreshnessTracker.export(self.freshness_snapshot())

    def profile_snapshot(self, name: str) -> Optional[Dict[str, object]]:
        """The operator profiler's totals for deployment ``name``
        (``OperatorProfiler.merge`` folds these across shards)."""
        return self.profiler.snapshot(name)

    def drift_snapshot(self) -> Dict[str, object]:
        """The drift monitor's sketches (``DriftMonitor.merge`` folds
        these across shards)."""
        return self.drift.snapshot()

    def drift_report(self) -> Dict[str, Dict[str, float]]:
        """Per-column live-vs-reference PSI scores."""
        return self.drift.report()

    def drift_export(self) -> Dict[str, float]:
        """Flat ``drift`` metrics group for the registry."""
        return self.drift.export()

    def pin_drift_reference(self) -> List[str]:
        """Adopt the current live serving distribution as the drift
        reference (e.g. at model-deploy time); returns pinned columns."""
        return self.drift.pin_reference()

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Idempotent shutdown: streams (each drains what it staged),
        worker pool, async pool; then drop deployments and tables so their
        device memory can be freed once no caller holds a snapshot."""
        with self._async_lock:     # a racing request_async must not
            if self._closed:       # create the pool after this point
                return
            self._closed = True
            if self._async_pool is not None:
                self._async_pool.shutdown(wait=False)
                self._async_pool = None
        for pipe in self.streams.values():
            pipe.close()
        self.streams.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self.deployments.clear()
        self._versions.clear()
        self._history.clear()
        self.tables.clear()
        self.catalog = Catalog()
        self.cache.clear()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
