"""ShardedEngine: horizontal scale-out behind the single-engine API.

DESIGN.md §9/§11. N key-hash-partitioned **shard engines** — each a full
:class:`repro_torch.core.engine.Engine` with its own tables, key
directory, plan cache and (when streams are attached) ingest pipeline
with its own watermarks — behind the familiar ``create_table / insert /
attach_stream / deploy / request / query_offline`` surface.

Every shard's tables sit on the device the caller asks for
(``ShardedEngine(device=...)``, ``"cuda"`` by default, raising where CUDA
is absent); with ``ShardConfig.pin_devices`` and more than one CUDA
device, shard ``s`` sits on ``cuda:{s % D}`` (:func:`shard_device`). Two
backends host the shard set (``ShardedEngine(backend=...)``,
``ShardConfig.backend`` or the ``REPRO_SHARD_BACKEND`` env var):

* ``"inprocess"`` (default) — the shard engines are objects in this
  process. One execution lane serves each device in use, so on one card
  the shards' sub-batches run one after another, on one GIL.
* ``"process"`` — each shard engine lives in its OWN subprocess
  (``shard/proc/``) with its own interpreter and CUDA context (its card
  pinned by ``CUDA_VISIBLE_DEVICES`` where the host has several), one
  lane per shard. Sub-batches, control RPCs and telemetry snapshots
  cross a CRC-framed pickle channel; worker death is supervised (shed →
  respawn → catalog replay → WAL replay), with warm standbys and a
  seeded fault plan for the transport (DESIGN.md §11–§12).

* **Routing** (``shard/ring.py``): a consistent-hash ring (virtual
  nodes) replaces the bare ``hash % N`` partitioner, so the shard count
  can grow/shrink under live traffic — ``add_shard``/``remove_shard``
  migrate only the key ranges adjacent to the moved virtual nodes,
  interval by interval, while reads keep routing consistently (the old
  owner retains a stale copy until its range flips; readers are never
  sent to a shard that does not yet hold the data).
  ``ShardConfig(partitioner="modulo")`` keeps the pure modulo routing
  as an escape hatch (it cannot reshard).
* **Deployments**: ``deploy`` builds one version per shard
  (``Engine.build_version``) and then publishes the whole set under ONE
  :class:`ShardedDeploymentHandle` — hot swap, counter-based canary and
  rollback operate on the set atomically; a batch is always served by a
  single (version, shard-set).
* **Tables**: partitioned by default; ``replicate=True`` broadcasts a
  table to every shard (dimension tables — LAST JOIN probes then
  resolve through the owning shard's local replica, no cross-shard
  hop).
* **Transactional ingest**: a multi-shard ``insert`` into a
  stream-attached table is all-or-nothing — phase 1 ``prepare``s the
  per-shard slices against every involved stream buffer (validating
  frontiers), phase 2 ``commit``s them (the buffers hold their
  watermarks so a prepared slice can never become late in between);
  any reject aborts every prepared slice with nothing staged.
* **Offline parity**: ``query_offline`` runs per shard against pinned
  snapshots and stamps the result with the cross-shard **version
  vector**; rows are filtered by CURRENT ring ownership so stale
  migration copies never surface, keeping outputs equal to the
  unsharded engine before/during/after a reshard.
* **Admission control** (``shard/resource.py``): per-deployment
  in-flight and queue-depth bounds plus deadline shedding; a retired
  shard or a dead worker sheds with an explicit ``worker_down`` reason
  instead of hanging gathers, and the stale tier answers its keys
  DEGRADED where it can.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, \
    Union

import numpy as np
import torch

from repro_torch.core import dsl
from repro_torch.core.engine import DeploymentHandle, Engine, HandleMetrics
from repro_torch.core.logical import Query
from repro_torch.core.optimizer import CostModel, OptFlags
from repro_torch.core.results import (STATUS_DEGRADED, STATUS_OK,
                                      STATUS_SHED, FeatureFrame,
                                      RequestContext)
from repro_torch.featurestore.table import TableSchema
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.freshness import FreshnessTracker
from repro_torch.obs.sketch import DriftMonitor, QuantileSketch, RollingSketch
from repro_torch.obs.trace import Tracer
from repro_torch.shard import migrate as _migrate
# stdlib-only module: importing the plan type does not pull the proc
# backend into in-process users
from repro_torch.shard.proc.faults import FaultPlan
from repro_torch.shard.resource import AdmissionConfig, ResourceManager
from repro_torch.shard.ring import HashRing, ModuloRouting, RouteTable, \
    key_hashes
from repro_torch.shard.router import ShardDownError, ShardRouter
from repro_torch.streaming.wal import WalConfig, read_dir as wal_read_dir, \
    resolve_shard as wal_resolve_shard

__all__ = ["ShardConfig", "ShardedEngine", "ShardedDeploymentHandle",
           "ShardedPipeline", "ShardedHandleMetrics", "shard_device"]

# max time _reshard keeps retrying one arc batch across worker deaths
# before giving up (a respawn + WAL replay fits many times)
_RESHARD_RETRY_S = 60.0


def shard_device(base, shard: int, pin_devices: bool,
                 n_devices: int) -> torch.device:
    """The device shard ``shard`` lives on: ``cuda:{shard % n_devices}``
    when ``pin_devices`` is set, ``base`` is a CUDA device and there is
    more than one; ``base`` otherwise."""
    base = torch.device(base)
    if pin_devices and base.type == "cuda" and n_devices > 1:
        return torch.device("cuda", shard % n_devices)
    return base


@dataclass(frozen=True)
class ShardConfig:
    n_shards: int = 2
    dispatch_rows: int = 256          # coalesced rows per shard dispatch
    # max wait for a lane to fill one dispatch chunk (batcher-style
    # deadline policy; 0 disables waiting)
    coalesce_delay_s: float = 0.002
    # execution lanes (worker threads). None = one per distinct device in
    # use for the in-process backend (more execution threads than devices
    # just contend) and one per shard for the process backend (lanes block
    # on channel I/O with the GIL released, so a lane per worker keeps
    # every subprocess busy)
    n_lanes: Optional[int] = None
    admission: AdmissionConfig = AdmissionConfig()
    # pin shard s to cuda:{s % D} when more than one CUDA device exists
    # (process backend: its worker's CUDA_VISIBLE_DEVICES); False keeps
    # every shard on the engine's device
    pin_devices: bool = True
    # "inprocess" | "process"; None resolves REPRO_SHARD_BACKEND, then
    # "inprocess"
    backend: Optional[str] = None
    # "ring" (consistent hash, elastic) | "modulo" (pure hash % N,
    # cannot reshard)
    partitioner: str = "ring"
    vnodes: int = 64                  # ring points per shard
    migrate_batch_arcs: int = 8       # arcs copied per migration step
    # --- durability / chaos tier (DESIGN.md §12) -------------------------
    # base directory for per-shard write-ahead ingest logs; None disables.
    # Partitioned stream-attached tables get a WAL at
    # ``<wal_dir>/shard-<s>/<table>/`` injected into their PipelineConfig;
    # on worker death (process backend) the dead shard's log is archived,
    # then replayed through the live route table after respawn
    wal_dir: Optional[str] = None
    # pre-spawned workers kept past their imports, CUDA context and
    # kernel library load, for fast adoption on respawn (process backend;
    # 0 disables the pool)
    standby_workers: int = 0
    # the JAX package's workers share a persistent XLA compilation cache
    # here. The port compiles nothing per process but the kernel library,
    # which is already kept by digest in build/kernels/<digest>/: no
    # counterpart, and any value but None raises
    compile_cache_dir: None = None
    # stale-tier cache: last served feature row per key, used to answer
    # STATUS_DEGRADED while a shard is down/replaying (0 disables)
    degraded_cache_keys: int = 4096
    # chaos: fault plan for the worker transport (process backend); None
    # falls back to the REPRO_FAULT_PLAN env var, then no faults
    fault_plan: Optional[FaultPlan] = None


@dataclass
class ShardedHandleMetrics:
    requests: int = 0
    batches: int = 0
    shed_requests: int = 0
    shed_batches: int = 0
    degraded_requests: int = 0     # rows answered from the stale tier
    degraded_batches: int = 0      # batches with >= 1 DEGRADED row
    serve_s: float = 0.0
    canary_batches: int = 0
    canary_max_abs_diff: float = 0.0
    # end-to-end (scatter -> gather) per-batch latency in the rolling
    # sketch HandleMetrics uses: the replan health gate works the same
    # when sharded, and the sketch merges exactly with the shards' own
    latency_s: RollingSketch = dataclasses.field(
        default_factory=lambda: RollingSketch(
            window_s=HandleMetrics.LATENCY_WINDOW_S))

    def observe_latency(self, seconds: float) -> None:
        self.latency_s.observe(float(seconds))

    def latency_percentile(self, pct: float) -> float:
        return self.latency_s.percentile(pct)

    def snapshot(self) -> Dict[str, float]:
        """JSON-serializable copy (the latency sketch rides along,
        mergeable)."""
        sk = self.latency_s.sketch()
        return {
            "requests": self.requests, "batches": self.batches,
            "shed_requests": self.shed_requests,
            "shed_batches": self.shed_batches,
            "degraded_requests": self.degraded_requests,
            "degraded_batches": self.degraded_batches,
            "serve_s": self.serve_s,
            "canary_batches": self.canary_batches,
            "canary_max_abs_diff": self.canary_max_abs_diff,
            "latency_samples": len(self.latency_s),
            "latency_p50_s": sk.percentile(50),
            "latency_p99_s": sk.percentile(99),
            "latency_sketch": sk.to_dict(),
        }


@dataclass
class _TableSpec:
    schema: TableSchema
    replicated: bool
    # resolved per-shard creation kwargs, replayed when a shard is added
    create_kw: Dict[str, object] = dataclasses.field(default_factory=dict)


class ShardedDeploymentHandle:
    """One version of a deployment across every shard — the sharded
    serving endpoint. Owns the per-shard :class:`DeploymentHandle`s; the
    router dispatches against THESE handles directly, so a mid-redeploy
    inner-engine state is invisible to in-flight batches (same
    handle-owned-executor argument as the single-engine swap).

    ``handles[s]`` may be ``None`` for shard slots retired before this
    version was deployed — routing never selects a retired slot."""

    def __init__(self, engine: "ShardedEngine", name: str, version: int,
                 handles: Sequence[Optional[DeploymentHandle]]):
        self.engine = engine
        self.name = name
        self.version = version
        self.handles: Tuple[Optional[DeploymentHandle], ...] = \
            tuple(handles)
        self.state = DeploymentHandle.WARMING
        self.metrics = ShardedHandleMetrics()
        # the deploy-time inputs, kept so a respawned worker (or a newly
        # added shard) can rebuild this exact version
        self.query: Optional[Query] = None
        self.warm_buckets: Optional[Tuple[int, ...]] = None
        self._canary: Optional[Tuple["ShardedDeploymentHandle", float]] = \
            None
        self._canary_counter = 0
        self._lock = threading.Lock()
        # stale tier (degradation ladder OK→DEGRADED→SHED): the last
        # feature row served per key, LRU-bounded. While a shard cannot
        # serve (retired, dead or replaying), its keys answer from here
        # with STATUS_DEGRADED instead of shedding the whole batch —
        # possibly stale, never wrong-key
        self._stale: "collections.OrderedDict" = collections.OrderedDict()
        self._stale_cap = int(engine.cfg.degraded_cache_keys)
        # each output column's per-row shape, from the last fresh batch
        self._widths: Dict[str, Tuple[int, ...]] = {}
        # the table versions of slots retired under this handle (their
        # handles and tables are released, their entries stay)
        self._retired_versions: Dict[int, int] = {}

    # ------------------------------------------------------------ identity
    @property
    def tag(self) -> str:
        return f"{self.name}@v{self.version}x{len(self.handles)}"

    @property
    def live(self) -> bool:
        return self.state == DeploymentHandle.LIVE

    def _first(self) -> DeploymentHandle:
        return next(h for h in self.handles if h is not None)

    @property
    def plan(self):
        return self._first().plan

    @property
    def phys(self):
        return self._first().phys

    @property
    def table(self):
        """A live shard's table — schema/introspection only; mutation
        must go through the sharded engine (routing)."""
        return self._first().table

    def __repr__(self) -> str:
        return (f"ShardedDeploymentHandle({self.name!r} v{self.version} "
                f"[{self.state}] x{len(self.handles)} shards)")

    # ------------------------------------------------------------ warm etc
    def warm(self, buckets: Sequence[int]) -> int:
        return sum(h.warm(buckets) for h in self.handles
                   if h is not None)

    def version_vector(self) -> Tuple[int, ...]:
        """Per-shard table versions in slot order: each active slot's
        now, and a slot retired under this handle with the version its
        table had when it was retired."""
        return tuple(h.table.version if h is not None
                     else self._retired_versions[s]
                     for s, h in enumerate(self.handles)
                     if h is not None or s in self._retired_versions)

    def _release_slot(self, s: int) -> None:
        """Drop retired slot ``s``'s handle, and with it its tables and
        executors, keeping its version-vector entry."""
        with self._lock:
            h = self.handles[s] if s < len(self.handles) else None
            if h is None:
                return
            self._retired_versions[s] = h.table.version
            self.handles = self.handles[:s] + (None,) + self.handles[s + 1:]

    def join_staleness(self) -> Dict[str, Dict[str, float]]:
        """Cross-shard rollup of the per-shard staleness metrics. Age
        percentiles come from the EXACT merge of per-shard sketches —
        the merged p99 is what one engine observing the union would
        report, not a worst-shard max."""
        out: Dict[str, Dict[str, float]] = {}
        sketches: Dict[str, list] = {}
        for h in self.handles:
            if h is None:
                continue
            for t, st in h.join_staleness().items():
                agg = out.setdefault(t, {"probes": 0, "matches": 0,
                                         "age_samples": 0})
                agg["probes"] += st["probes"]
                agg["matches"] += st["matches"]
                agg["age_samples"] += st["age_samples"]
                sk = st.get("age_sketch")
                if sk is not None:
                    sketches.setdefault(t, []).append(sk)
        for t, agg in out.items():
            agg["match_rate"] = (agg["matches"] / agg["probes"]
                                 if agg["probes"] else 0.0)
            merged = QuantileSketch.merged(sketches.get(t, ()))
            agg["age_p50"] = merged.percentile(50)
            agg["age_p99"] = merged.percentile(99)
            agg["age_sketch"] = merged.to_dict()
        return out

    # --------------------------------------------------------------- serve
    def request(self, keys: Sequence, ts: Sequence[float],
                rows: Optional[np.ndarray] = None,
                ctx: Optional[RequestContext] = None) -> FeatureFrame:
        """Serve one batch: admit -> (canary pick) -> scatter -> gather.

        Shedding is all-or-nothing: an expired deadline (at admission or
        while queued on any shard) returns a frame whose EVERY row is
        ``STATUS_SHED`` — never a mix of shed and computed rows."""
        eng = self.engine
        B = len(keys)
        trace = ctx.trace_id if ctx is not None else None
        if B == 0:
            return FeatureFrame(
                {n: np.zeros((0,), np.float32)
                 for n in self.phys.feature_names},
                status=np.zeros((0,), np.int8), deployment=self.name,
                version=self.version, trace_id=trace,
                version_vector=self.version_vector())
        if rows is None and self.plan.joins:
            raise ValueError(
                f"deployment {self.name!r} has {len(self.plan.joins)} "
                f"LAST JOIN(s); online requests must pass rows= — the "
                f"join probes read the request row's join-key column(s)")
        aspan = eng.tracer.start(
            "admission", trace,
            parent_id=ctx.parent_span if ctx is not None else None,
            tags={"deployment": self.name, "rows": B})
        adm = eng.resources.admit(self.name, ctx,
                                  queue_depths=eng.router.queue_depths)
        if aspan is not None:
            eng.tracer.finish(aspan, tags={"shed": adm.shed})
        if adm.shed:
            return self._shed_frame(B, trace, kind="admission")
        try:
            cand = None
            pinned = ctx is not None and ctx.version_pin is not None
            canary = None if pinned else self._canary
            if canary is not None:
                cand_handle, frac = canary
                with self._lock:
                    self._canary_counter += 1
                    n = self._canary_counter
                if int(n * frac) > int((n - 1) * frac):
                    cand = cand_handle
            if cand is None:
                return self._scatter_gather(keys, ts, rows, ctx, trace)
            # canary slice: candidate serves; incumbent recomputes as the
            # reference and the divergence lands on the candidate
            base = self._scatter_gather(keys, ts, rows, ctx, trace)
            new = cand._scatter_gather(keys, ts, rows, ctx, trace)
            diff = 0.0
            for nme, v in new.columns.items():
                ref = base.columns.get(nme)
                if ref is not None and np.size(v):
                    diff = max(diff, float(np.max(np.abs(
                        np.asarray(v, np.float64)
                        - np.asarray(ref, np.float64)))))
            with cand._lock:
                cand.metrics.canary_batches += 1
                cand.metrics.canary_max_abs_diff = max(
                    cand.metrics.canary_max_abs_diff, diff)
            return new
        finally:
            adm.release()

    def _scatter_gather(self, keys, ts, rows, ctx, trace) -> FeatureFrame:
        eng = self.engine
        t0 = time.perf_counter()
        karr = np.asarray(keys)
        ts_arr = np.asarray(ts, np.float32)
        row_arr = (np.asarray(rows, np.float32) if rows is not None
                   else None)
        B = len(karr)
        span = eng.tracer.start(
            "router.scatter_gather", trace,
            parent_id=ctx.parent_span if ctx is not None else None,
            tags={"deployment": self.name, "rows": B})
        if span is not None:
            # re-parent the downstream spans (lane.execute, the shard
            # engine's serve) under this one
            ctx = (dataclasses.replace(ctx, parent_span=span.span_id)
                   if ctx is not None else
                   RequestContext(trace_id=trace,
                                  parent_span=span.span_id))
        try:
            owners = eng.owners_of(karr)
            parts = self._rerouted(
                eng.router.scatter(self.handles, karr, ts_arr, row_arr,
                                   ctx=ctx, owners=owners),
                owners, karr, ts_arr, row_arr, ctx)
            columns, status, _tvers, any_shed = \
                eng.router.gather(parts, B)
        except BaseException as e:
            if span is not None:
                eng.tracer.finish(span,
                                  tags={"error": type(e).__name__})
            raise
        if span is not None:
            eng.tracer.finish(
                span, tags={"n_sub_batches": len(parts),
                            "shed": bool(any_shed)})
        if any_shed:
            reasons = {it.shed_reason for _, it in parts if it.shed}
            if reasons == {"worker_down"} and self._stale_cap > 0:
                # degradation ladder: ONLY the retired shard's rows went
                # missing — try the stale tier before giving up on the
                # whole batch
                deg = self._degraded_frame(parts, B, trace)
                if deg is not None:
                    eng.resources.record_degraded(int(deg.n_degraded))
                    return deg
            shed_kind = ("worker_down" if "worker_down" in reasons
                         else "deadline")
            eng.resources.record_shed(kind=shed_kind)
            return self._shed_frame(B, trace, kind=shed_kind)
        self._remember(karr, columns, status)
        wall = time.perf_counter() - t0
        with self._lock:
            m = self.metrics
            m.requests += B
            m.batches += 1
            m.serve_s += wall
            m.observe_latency(wall)
        # freshness stamp across touched shards: MIN watermark (the
        # slowest shard bounds the batch) / MAX feature age
        wm = age = None
        for _, it in parts:
            if it.watermark is not None:
                wm = it.watermark if wm is None \
                    else min(wm, it.watermark)
            if it.feature_age is not None:
                age = it.feature_age if age is None \
                    else max(age, it.feature_age)
        vv = self.version_vector()
        eng.flight.record(
            "serve", trace=trace, deployment=self.tag, rows=B,
            version_vector=list(vv), watermark=wm, feature_age=age,
            serve_ms=wall * 1e3)
        return FeatureFrame(
            columns, status=status, deployment=self.name,
            version=self.version, trace_id=trace,
            table_version=max(vv, default=-1),
            latency={"serve_s": wall},
            version_vector=vv, watermark=wm, feature_age=age)

    def _rerouted(self, parts, owners: np.ndarray, karr: np.ndarray,
                  ts_arr: np.ndarray, row_arr: Optional[np.ndarray], ctx
                  ) -> List[Tuple[np.ndarray, object]]:
        """``parts`` with every sub-batch that a ``remove_shard`` turned
        away sent again to its keys' current owners. A scatter that read
        the route table before the shard left the ring can submit to its
        queue after ``retire_queue``; the queue sheds it at once
        (``worker_down``), and without this the batch would come back
        degraded or shed although every key has a live owner. A shard
        that died, not removed, is not retried here: its rows take the
        degradation ladder."""
        eng = self.engine
        out = []
        todo = list(parts)
        for _ in range(len(eng.shards) + 1):
            late = []
            for idx, it in todo:
                if (it.shed and it.shed_reason == "worker_down"
                        and int(owners[idx[0]]) in eng._retired):
                    late.append(idx)
                else:
                    out.append((idx, it))
            if not late:
                return out
            idx = np.concatenate(late)
            owners = np.empty(len(karr), owners.dtype)
            owners[idx] = eng.owners_of(karr[idx])
            todo = [(idx[j], it) for j, it in eng.router.scatter(
                self.handles, karr[idx], ts_arr[idx],
                row_arr[idx] if row_arr is not None else None, ctx=ctx,
                owners=owners[idx])]
        return out + todo

    # ------------------------------------------------------ stale tier
    @staticmethod
    def _ckey(key):
        return key.item() if isinstance(key, np.generic) else key

    def _out_names(self) -> Tuple[str, ...]:
        """A served frame's columns: the features, then the PREDICT
        output when the query has one."""
        names = tuple(self.phys.feature_names)
        pred = self.query.predict if self.query is not None else None
        return names + ((pred.output,) if pred is not None else ())

    def _remember(self, karr, columns, status) -> None:
        """Refresh the stale tier from a fully-computed batch: every
        STATUS_OK row of every output column (the PREDICT output
        included), keyed by request key, LRU-evicted."""
        if self._stale_cap <= 0:
            return
        cols = [np.asarray(columns[n], np.float32)
                for n in self._out_names()]
        st = np.asarray(status)
        with self._lock:
            self._widths = {n: c.shape[1:]
                            for n, c in zip(self._out_names(), cols)}
            cache = self._stale
            for i in np.flatnonzero(st == STATUS_OK):
                k = self._ckey(karr[int(i)])
                cache[k] = tuple(c[int(i)] for c in cols)
                cache.move_to_end(k)
            while len(cache) > self._stale_cap:
                cache.popitem(last=False)

    def _zero_columns(self, B: int) -> Dict[str, np.ndarray]:
        """Zero-filled output columns for ``B`` rows, each as wide as
        the last fresh batch served (one value per row before any)."""
        return {n: np.zeros((B,) + tuple(self._widths.get(n, ())),
                            np.float32)
                for n in self._out_names()}

    def _degraded_frame(self, parts, B: int, trace
                        ) -> Optional[FeatureFrame]:
        """Assemble a mixed frame: completed sub-batches keep their
        fresh rows/statuses; worker_down sub-batches answer from the
        stale tier with STATUS_DEGRADED, every output column (the
        PREDICT output included) as last served. Returns ``None`` —
        meaning fall back to a whole-batch shed — if ANY down-shard key
        has no cached row (a partially-degradable batch would otherwise
        need per-row shed statuses, which the shed contract forbids)."""
        names = self._out_names()
        status = np.zeros(B, np.int8)
        n_deg = 0
        with self._lock:
            columns = self._zero_columns(B)
            for idx, it in parts:
                if not it.shed:
                    for kname, v in it.columns.items():
                        if kname in columns:
                            columns[kname][idx] = np.asarray(v, np.float32)
                    status[idx] = it.status
                    continue
                for j, key in zip(idx, it.keys):
                    row = self._stale.get(self._ckey(key))
                    if row is None:
                        return None
                    for n, v in zip(names, row):
                        columns[n][int(j)] = v
                    status[int(j)] = STATUS_DEGRADED
                    n_deg += 1
            self.metrics.degraded_requests += n_deg
            self.metrics.degraded_batches += 1
        vv = self.version_vector()
        return FeatureFrame(
            columns, status=status, deployment=self.name,
            version=self.version, trace_id=trace,
            table_version=max(vv, default=-1), version_vector=vv)

    def _shed_frame(self, B: int, trace,
                    kind: str = "shed") -> FeatureFrame:
        with self._lock:
            self.metrics.shed_requests += B
            self.metrics.shed_batches += 1
            columns = self._zero_columns(B)
        self.engine.flight.record("shed", trace=trace,
                                  deployment=self.tag, rows=B,
                                  shed_kind=kind)
        return FeatureFrame(
            columns, status=np.full(B, STATUS_SHED, np.int8),
            deployment=self.name, version=self.version, trace_id=trace,
            version_vector=self.version_vector())

    def rollback(self) -> "ShardedDeploymentHandle":
        return self.engine.rollback(self.name)


class ShardedPipeline:
    """Streaming facade: one IngestPipeline per shard, each with its own
    watermarks/frontiers — routing by the engine's ring, so an event's
    reorder repair happens on the shard that stores it. Ownership is
    read UNDER the engine's route lock: an event must not land in a
    source shard's buffer after that shard's key range was extracted by
    an in-flight migration step."""

    def __init__(self, engine: "ShardedEngine", table: str,
                 pipes: Sequence, replicated: bool):
        self.engine = engine
        self.table = table
        self.pipes: List = list(pipes)   # grows under add_shard
        self.replicated = replicated

    def _active(self) -> List[Tuple[int, object]]:
        retired = self.engine._retired
        return [(s, p) for s, p in enumerate(self.pipes)
                if s not in retired]

    def _gate(self, s: int) -> None:
        """Refuse ingest into a shard whose worker is respawning/replaying
        its WAL. A fresh write landing in the rebuilt buffer BEFORE replay
        finishes would make ``migrate_in``'s prefix-skip drop the older
        replayed events — recovery would no longer be bit-identical. The
        producer sees :class:`ShardDownError` and retries after recovery."""
        client = getattr(self.pipes[s], "client", None)
        if client is not None and not client.ready:
            raise ShardDownError(
                f"shard {s} is recovering (WAL replay in progress)")

    def push(self, key, ts: float, row: np.ndarray) -> bool:
        eng = self.engine
        if self.replicated:
            ok = True
            for _s, p in self._active():
                ok = p.push(key, ts, row) and ok
            return ok
        with eng._route_lock:
            s = eng._routing.owner(key)
            self._gate(s)
            return self.pipes[s].push(key, ts, row)

    def push_batch(self, keys: Sequence, ts: Sequence[float],
                   rows: np.ndarray, *, all_or_nothing: bool = False
                   ) -> int:
        keys = np.asarray(keys)
        ts = np.asarray(ts, np.float32)
        rows = np.asarray(rows, np.float32)
        eng = self.engine
        if self.replicated:
            return min(p.push_batch(keys, ts, rows,
                                    all_or_nothing=all_or_nothing)
                       for _s, p in self._active())
        with eng._route_lock:
            sid = eng._routing.owners_of(keys)
            n = 0
            for s in np.unique(sid):
                self._gate(int(s))
                idx = np.flatnonzero(sid == s)
                n += self.pipes[s].push_batch(
                    keys[idx], ts[idx], rows[idx],
                    all_or_nothing=all_or_nothing)
            return n

    def flush(self, *, flush_all: bool = True) -> None:
        for _s, p in self._active():
            p.flush(flush_all=flush_all)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        return all(p.wait_idle(timeout) for _s, p in self._active())

    def warm(self) -> int:
        return sum(p.warm() for _s, p in self._active())

    def version_vector(self) -> Tuple[int, ...]:
        return tuple(p.table.version for _s, p in self._active())

    def metrics(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for _s, p in self._active():
            for k, v in p.metrics().items():
                out[k] = out.get(k, 0) + v
        out["n_shards"] = len(self._active())
        return out

    def close(self, *, drain: bool = True) -> None:
        for _s, p in self._active():
            p.close(drain=drain)


class ShardedEngine:
    """N hash-partitioned shard engines behind the Engine API."""

    def __init__(self, cfg: ShardConfig = ShardConfig(), *,
                 backend: Optional[str] = None,
                 flags: OptFlags = OptFlags(), device="cuda",
                 **engine_kw):
        if cfg.compile_cache_dir is not None:
            raise ValueError(
                "compile_cache_dir has no counterpart in the port: its "
                "workers compile nothing but the kernel library, which is "
                "kept by digest in build/kernels/<digest>/")
        self.cfg = cfg
        self.flags = flags
        self._engine_kw = dict(engine_kw)
        S = cfg.n_shards
        kind = (backend or cfg.backend
                or os.environ.get("REPRO_SHARD_BACKEND") or "inprocess")
        if kind not in ("inprocess", "process"):
            raise ValueError(f"unknown shard backend {kind!r}; expected "
                             f"'inprocess' or 'process'")
        self.backend_kind = kind
        self.device = torch.device(device)
        self.devices: Tuple[torch.device, ...] = tuple(
            self._device_of(s) for s in range(S))
        if kind == "process":
            from repro_torch.shard.proc.backend import ProcShardBackend
            plan = cfg.fault_plan if cfg.fault_plan is not None \
                else FaultPlan.from_env()
            self.backend = ProcShardBackend(
                S, flags=flags, engine_kw=engine_kw, device=self.device,
                pin_devices=cfg.pin_devices,
                standby_workers=cfg.standby_workers, fault_plan=plan)
            self.backend.reseed_hook = self._reseed_replicas
            self.backend.respawn_hook = self._replay_shard
            self.backend.prespawn_hook = self._archive_wal
            self.backend.replay_hook = self._replay_wal
            self.shards: List = list(self.backend.clients)
            default_lanes = S
        else:
            self.backend = None
            self.shards = [Engine(flags, device=d, **engine_kw)
                           for d in self.devices]
            default_lanes = len(set(self.devices))
        n_lanes = cfg.n_lanes if cfg.n_lanes is not None else default_lanes
        self.router = ShardRouter(S, dispatch_rows=cfg.dispatch_rows,
                                  coalesce_delay_s=cfg.coalesce_delay_s,
                                  n_lanes=n_lanes)
        self.resources = ResourceManager(cfg.admission)
        # shared observability: ONE tracer for the whole tier — in-process
        # shard engines record into it (their own constructor-made one is
        # replaced), so a trace tree assembles in place across admission,
        # router, lanes and shard serves; process workers keep their own
        # tracer and export spans per serve RPC, which the client adopts
        # (re-based) into this one — and a flight recorder for the tier's
        # serve and shed records, dumped on a worker death. Each shard
        # engine keeps its own profiler, freshness and drift; the methods
        # below merge them (over RPC for workers).
        self.tracer = Tracer(sample_rate=float(
            os.environ.get("REPRO_TRACE_SAMPLE", "0") or 0))
        self.flight = FlightRecorder()
        for sub in self.shards:
            sub.tracer = self.tracer
        self.router.tracer = self.tracer
        # ring routing state: readers (scatter, query_offline) read the
        # route table lock-free — a reader racing a range flip sees either
        # the old owner (which retains a stale copy: correct) or the new
        # owner (which already finished copying: correct). WRITERS must
        # hold _route_lock across owner-compute + staging so no event
        # lands in a source buffer after its range was extracted.
        self._route_lock = threading.RLock()
        if cfg.partitioner == "modulo":
            self._ring: Optional[HashRing] = None
            self._routing = ModuloRouting(S)
        elif cfg.partitioner == "ring":
            self._ring = HashRing(range(S), vnodes=cfg.vnodes)
            self._routing = RouteTable(self._ring)
        else:
            raise ValueError(f"unknown partitioner {cfg.partitioner!r}")
        self._retired: Set[int] = set()
        self.specs: Dict[str, _TableSpec] = {}
        self.streams: Dict[str, ShardedPipeline] = {}
        self._stream_cfgs: Dict[str, object] = {}
        self._models: Dict[str, Tuple[Callable, object]] = {}
        self.deployments: Dict[str, ShardedDeploymentHandle] = {}
        self._versions: Dict[str, Dict[int, ShardedDeploymentHandle]] = {}
        self._history: Dict[str, List[ShardedDeploymentHandle]] = {}
        self._deploy_lock = threading.RLock()
        # serializes reshard operations; taken OUTSIDE _deploy_lock so a
        # migration can wait out a worker respawn (whose hooks need the
        # deploy lock) without deadlocking
        self._reshard_lock = threading.Lock()
        # WAL recovery counters (latency_decomposition / telemetry)
        self.recovery_stats: Dict[str, float] = {
            "wal_replays": 0, "wal_replayed_events": 0,
            "wal_replay_lag_s": 0.0}
        self._closed = False

    def _device_of(self, s: int) -> torch.device:
        n = (torch.cuda.device_count() if self.device.type == "cuda"
             and torch.cuda.is_available() else 1)
        return shard_device(self.device, s, self.cfg.pin_devices, n)

    # ------------------------------------------------------------ identity
    @property
    def n_shards(self) -> int:
        """ACTIVE shard count (grows/shrinks with add/remove_shard)."""
        return len(self.shards) - len(self._retired)

    def _active_ids(self) -> List[int]:
        return [s for s in range(len(self.shards))
                if s not in self._retired]

    def _primary(self):
        return self.shards[self._active_ids()[0]]

    @property
    def cache(self):
        """A live shard's plan cache (FeatureServer warm-gating)."""
        return self._primary().cache

    def shard_of(self, key) -> int:
        """Current owning shard of ``key`` under the ring (or modulo)."""
        return self._routing.owner(key)

    def owners_of(self, keys: np.ndarray) -> np.ndarray:
        return self._routing.owners_of(np.asarray(keys))

    @property
    def worker_restarts(self) -> int:
        """Total worker respawns (process backend; 0 in-process)."""
        if self.backend is None:
            return 0
        return sum(c.restarts for c in self.backend.clients)

    @property
    def recovering(self) -> bool:
        """True while a non-retired worker is alive but not serving yet
        (its catalog or WAL replay is in flight); False in-process."""
        return self.backend is not None and any(
            not c.ready and not c.retired for c in self.backend.clients)

    def transport_stats(self) -> Dict[str, int]:
        """Transport counters (retries, corrupt frames, RPC timeouts)
        summed over the workers; empty in-process."""
        agg: Dict[str, int] = {}
        for c in (self.backend.clients if self.backend is not None
                  else ()):
            for k, v in c.transport_stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def recovery_snapshot(self) -> Dict[str, float]:
        """The recovery counters: WAL replays, and under the process
        backend the supervisor's respawn counters and
        ``worker_restarts``."""
        out = dict(self.recovery_stats)
        if self.backend is not None:
            out.update(self.backend.recovery_stats)
            out["worker_restarts"] = self.worker_restarts
        return out

    # ------------------------------------------------------------------ DDL
    def create_table(self, schema: TableSchema, *, max_keys: int = 1024,
                     capacity: int = 1024, bucket_size: int = 64,
                     join_keys: Sequence[str] = (),
                     replicate: bool = False,
                     per_shard_max_keys: Optional[int] = None) -> None:
        """Create the table on every shard.

        Partitioned (default): each shard holds the keys that hash to it;
        ``max_keys`` is the TOTAL key budget and each shard provisions
        ``max_keys/S`` plus 30% hash-skew headroom (override with
        ``per_shard_max_keys``). Replicated: every shard holds a full
        copy — required for LAST JOIN right tables, whose probes must
        resolve on the probing shard.
        """
        S = self.n_shards
        if replicate or per_shard_max_keys is None:
            per_shard = max_keys if replicate else max(
                16, int(1.3 * max_keys / S) + 8)
        else:
            per_shard = per_shard_max_keys
        create_kw = dict(max_keys=per_shard, capacity=capacity,
                         bucket_size=bucket_size,
                         join_keys=tuple(join_keys))
        for s in self._active_ids():
            self.shards[s].create_table(schema, **create_kw)
        self.specs[schema.name] = _TableSpec(schema=schema,
                                             replicated=replicate,
                                             create_kw=create_kw)
        if self.backend is not None:
            self.backend.log_ddl("create_table", schema=schema,
                                 **create_kw)

    def tables_of(self, name: str) -> Tuple:
        """The per-shard Table objects for ``name`` (shard order;
        in-process backend only — a subprocess's tables are not
        reachable as objects, which is rather the point)."""
        if self.backend is not None:
            raise NotImplementedError(
                "tables_of() reaches into shard-engine objects; the "
                "process backend keeps those in worker subprocesses — "
                "use query_offline / telemetry snapshots instead")
        return tuple(self.shards[s].tables[name]
                     for s in self._active_ids())

    def insert(self, table: str, keys: Sequence, ts: Sequence[float],
               rows: np.ndarray) -> None:
        """Bulk insert, routed to owning shards (replicated tables fan
        out to all — one serialized payload broadcast under the process
        backend). For stream-attached partitioned tables the multi-shard
        write is TRANSACTIONAL: every involved shard prepares its slice,
        then all commit — or any reject aborts them all with nothing
        staged (matching ``Engine.insert``'s atomic contract, but across
        shards).

        Every shard insert is copy-on-write (``donate=False``; a worker
        always inserts so): the shard engines are live, their lanes serve
        off table snapshots while this writes, so each insert of up to
        ``capacity`` events clones the shard's table."""
        spec = self._spec(table)
        keys = np.asarray(keys)
        ts = np.asarray(ts, np.float32)
        rows = np.asarray(rows, np.float32)
        if spec.replicated:
            if self.backend is not None:
                self.backend.broadcast("insert", only=self._active_ids(),
                                       table=table, keys=keys.tolist(),
                                       ts=ts.tolist(), rows=rows)
                return
            for s in self._active_ids():
                self.shards[s].insert(table, keys.tolist(), ts.tolist(),
                                      rows, donate=False)
            return
        facade = self.streams.get(table)
        if facade is not None:
            self._insert_txn(table, facade, keys, ts, rows)
            return
        with self._route_lock:
            sid = self._routing.owners_of(keys)
            parts = [(int(s), np.flatnonzero(sid == s))
                     for s in np.unique(sid)]
            if self.backend is not None and len(parts) > 1:
                # one insert RPC per worker, all in flight at once: each
                # worker clones and scatters in its own process
                with ThreadPoolExecutor(max_workers=len(parts)) as ex:
                    futs = [ex.submit(self.shards[s].insert, table,
                                      keys[idx].tolist(), ts[idx].tolist(),
                                      rows[idx]) for s, idx in parts]
                    for f in futs:
                        f.result()
                return
            for s, idx in parts:
                self.shards[s].insert(table, keys[idx].tolist(),
                                      ts[idx].tolist(), rows[idx],
                                      donate=False)

    def _insert_txn(self, table: str, facade: ShardedPipeline,
                    keys: np.ndarray, ts: np.ndarray, rows: np.ndarray
                    ) -> None:
        """Cross-shard 2-phase ingest over the per-shard stream buffers.
        ``prepare`` validates each slice against its shard's released
        frontier and parks it; the buffers then HOLD their watermarks at
        the prepared timestamps, so phase 2 ``commit`` cannot fail. Any
        reject (or a dead worker mid-prepare) aborts every parked
        slice."""
        with self._route_lock:
            sid = self._routing.owners_of(keys)
            txns: List[Tuple[int, int]] = []
            try:
                for s in np.unique(sid):
                    facade._gate(int(s))
                    idx = np.flatnonzero(sid == s)
                    txn = facade.pipes[s].prepare(
                        keys[idx].tolist(), ts[idx].tolist(), rows[idx])
                    if txn is None:
                        raise ValueError(
                            f"insert on table {table!r} rejected "
                            f"atomically: the batch contains event(s) "
                            f"beyond a shard's released frontier "
                            f"(unrepairably late) or with non-finite "
                            f"timestamps; nothing was staged on any "
                            f"shard")
                    txns.append((int(s), txn))
            except BaseException:
                for s, txn in txns:
                    try:
                        facade.pipes[s].abort_txn(txn)
                    except (ShardDownError, TimeoutError):
                        pass       # abort is advisory on a dead shard
                raise
            for s, txn in txns:
                facade.pipes[s].commit_txn(txn)
        # barrier (outside the route lock — flushing does device work):
        # everything committed becomes queryable, surfacing flush errors
        # exactly like Engine.insert's single-shard barrier
        for s, _txn in txns:
            pipe = facade.pipes[s]
            if self.backend is not None:    # the worker checks for itself
                pipe.flush(flush_all=True, check=True)
                continue
            errs_before = pipe.stats["errors"]
            pipe.flush(flush_all=True)
            if (pipe.stats["errors"] > errs_before
                    and pipe.buffer.n_staged > 0):
                raise pipe.last_error

    def _spec(self, table: str) -> _TableSpec:
        spec = self.specs.get(table)
        if spec is None:
            raise KeyError(f"unknown table {table!r}; create_table first; "
                           f"known: {sorted(self.specs)}")
        return spec

    # ------------------------------------------------------------ streaming
    def attach_stream(self, table: str, cfg=None, **cfg_kw
                      ) -> ShardedPipeline:
        """One ingest pipeline per shard (per-shard watermarks); events
        route to the owning shard's pipeline."""
        from repro_torch.streaming.pipeline import PipelineConfig
        spec = self._spec(table)
        if table in self.streams:
            raise ValueError(f"table {table!r} already has a stream")
        if cfg is None and cfg_kw:
            cfg = PipelineConfig(**cfg_kw)
        elif cfg is not None and cfg_kw:
            raise ValueError("pass cfg or keywords, not both")
        if (self.cfg.wal_dir is not None and not spec.replicated
                and getattr(cfg, "wal", None) is None):
            # durability: every partitioned stream shard gets its own WAL
            # under <wal_dir>/shard-{shard}/<table>; the template keeps
            # the `{shard}` placeholder and each shard resolves its own
            # id (an added shard resolves to its new slot; a worker
            # client resolves its own, so the DDL replay after a respawn
            # lands in the new incarnation's directory)
            cfg = dataclasses.replace(
                cfg if cfg is not None else PipelineConfig(),
                wal=WalConfig(dir=os.path.join(
                    self.cfg.wal_dir, "shard-{shard}", table)))
        pipes = [self.shards[s].attach_stream(table,
                                              wal_resolve_shard(cfg, s))
                 for s in self._active_ids()]
        facade = ShardedPipeline(self, table, pipes, spec.replicated)
        self.streams[table] = facade
        self._stream_cfgs[table] = cfg
        if self.backend is not None:
            self.backend.log_ddl("attach_stream", table=table, cfg=cfg)
        return facade

    def create_stream(self, schema: TableSchema, *, max_keys: int = 1024,
                      capacity: int = 1024, bucket_size: int = 64,
                      replicate: bool = False, **cfg_kw):
        self.create_table(schema, max_keys=max_keys, capacity=capacity,
                          bucket_size=bucket_size, replicate=replicate)
        facade = self.attach_stream(schema.name, **cfg_kw)
        tables = (None if self.backend is not None
                  else self.tables_of(schema.name))
        return tables, facade

    def register_model(self, name: str, fn: Callable,
                       params: object = None) -> None:
        """``params`` (tensors) go to every in-process shard as given; a
        shard on another device than the parameters is the caller's to
        feed. Under the process backend ``fn`` crosses a pickle boundary
        by reference — a module-level function the workers can import,
        not a closure — and ``params`` tensors cross as numpy, each
        worker putting them on its own device."""
        for s in self._active_ids():
            self.shards[s].register_model(name, fn, params)
        self._models[name] = (fn, params)
        if self.backend is not None:
            self.backend.log_ddl("register_model", name=name, fn=fn,
                                 params=params)

    def set_cost_model(self, model: CostModel) -> CostModel:
        """Install calibrated optimizer constants on EVERY shard (all
        shards must compile the same plan — a per-shard cost model would
        break the one-plan-per-version invariant ``deploy`` relies on).
        Takes effect on the next ``deploy``; returns the previous model."""
        with self._deploy_lock:
            prev = self._primary().cost_model
            for s in self._active_ids():
                self.shards[s].set_cost_model(model)
            if self.backend is not None:
                self.backend.log_ddl("set_cost_model", model=model)
            return prev

    @property
    def cost_model(self) -> CostModel:
        return self._primary().cost_model

    # --------------------------------------------------------------- deploy
    def deploy(self, name: str,
               query: Union[str, Query, dsl.QueryBuilder], *,
               warm_buckets: Optional[Sequence[int]] = None,
               canary: float = 0.0) -> ShardedDeploymentHandle:
        """Build one version per shard, then publish the whole set
        atomically under one handle. Joined right tables must be
        replicated (probes resolve through the probing shard's local
        replica)."""
        if canary and not (0.0 < canary <= 1.0):
            raise ValueError(
                f"canary fraction must be in (0, 1], got {canary}")
        if isinstance(query, str):
            query = dsl.parse_sql(query)
        elif isinstance(query, dsl.QueryBuilder):
            query = query.build()
        with self._deploy_lock:
            prev = self.deployments.get(name)
            if canary > 0.0 and prev is None:
                raise ValueError(
                    f"canary deploy of {name!r} requires an existing live "
                    f"deployment; deploy without canary= first")
            # build EVERY shard's version before any publish: a failed
            # shard build must leave the live set untouched AND not leak
            # the versions already built on earlier shards
            handles: List[Optional[DeploymentHandle]] = \
                [None] * len(self.shards)
            built: List[Tuple[int, DeploymentHandle]] = []
            try:
                for s in self._active_ids():
                    h = self.shards[s].build_version(
                        name, query, warm_buckets=warm_buckets)
                    handles[s] = h
                    built.append((s, h))
            except BaseException:
                self._discard_built(built)
                raise
            first = next(h for h in handles if h is not None)
            for j in first.plan.joins:
                if not self._spec(j.table).replicated:
                    self._discard_built(built)
                    raise ValueError(
                        f"LAST JOIN right table {j.table!r} is hash-"
                        f"partitioned; a probing shard could not resolve "
                        f"keys owned by other shards — create it with "
                        f"replicate=True (broadcast dimension table)")
            version = first.version
            sh = ShardedDeploymentHandle(self, name, version, handles)
            sh.query = query
            sh.warm_buckets = (tuple(warm_buckets) if warm_buckets
                               else None)
            self._versions.setdefault(name, {})[version] = sh
            if canary > 0.0:
                displaced = prev._canary[0] if prev._canary else None
                sh.state = DeploymentHandle.CANARY
                prev._canary = (sh, float(canary))
                if displaced is not None:
                    self._discard(displaced)
            else:
                self._swap(name, sh, prev)
            return sh

    def _discard_built(self, built: List[Tuple[int, DeploymentHandle]]
                       ) -> None:
        for s, h in built:
            try:
                self.shards[s].discard_version(h)
            except (ShardDownError, TimeoutError):
                pass       # a shard dying mid-rollback is already down

    def _swap(self, name: str,
              new: ShardedDeploymentHandle,
              prev: Optional[ShardedDeploymentHandle]) -> None:
        for s in self._active_ids():
            if new.handles[s] is not None:
                self.shards[s].publish_version(new.handles[s])
        new._canary = None
        new.state = DeploymentHandle.LIVE
        self.deployments[name] = new       # the atomic publish
        if prev is not None:
            if prev._canary is not None and prev._canary[0] is not new:
                self._discard(prev._canary[0])
            prev._canary = None
            prev.state = DeploymentHandle.RETIRED
            hist = self._history.setdefault(name, [])
            hist.append(prev)
            # mirror the inner engines' retention bound: beyond it the
            # inner handles released their executors anyway, so the
            # sharded wrapper is unpinnable too
            while len(hist) > self._primary().max_retained_versions:
                dropped = hist.pop(0)
                self._versions.get(name, {}).pop(dropped.version, None)

    def _discard(self, cand: ShardedDeploymentHandle) -> None:
        cand.state = DeploymentHandle.RETIRED
        self._discard_built([(s, cand.handles[s])
                             for s in self._active_ids()
                             if cand.handles[s] is not None])
        self._versions.get(cand.name, {}).pop(cand.version, None)

    def handle(self, name: str, version: Optional[int] = None
               ) -> ShardedDeploymentHandle:
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

    def promote(self, name: str) -> ShardedDeploymentHandle:
        with self._deploy_lock:
            live = self.handle(name)
            if live._canary is None:
                raise ValueError(
                    f"deployment {name!r} has no active canary")
            cand, _ = live._canary
            live._canary = None
            self._swap(name, cand, live)
            return cand

    def rollback(self, name: str) -> ShardedDeploymentHandle:
        with self._deploy_lock:
            live = self.deployments.get(name)
            if live is not None and live._canary is not None:
                self._discard(live._canary[0])
                live._canary = None
                return live
            hist = self._history.get(name)
            if not hist:
                raise ValueError(
                    f"no prior version of {name!r} to roll back to")
            prev = hist.pop()
            self._swap(name, prev, live)
            return prev

    # -------------------------------------------------------------- elastic
    def add_shard(self) -> int:
        """Grow the shard set by one under live traffic: bring up a shard
        engine on its device (a fresh worker subprocess, or an adopted
        standby, under the process backend), replay the catalog (tables,
        streams, models, cost model), seed replicated tables, build +
        publish every retained deployment version, add a router queue —
        and only THEN flip ring ownership, interval by interval,
        migrating each key range before its flip. Requests keep flowing
        the whole time (routing always answers with a shard that holds
        the data). Returns the new shard id."""
        if self._ring is None:
            raise RuntimeError(
                "partitioner='modulo' cannot reshard; use the default "
                "consistent-hash ring")
        with self._deploy_lock:
            s = len(self.shards)
            # 1) runtime + catalog
            dev = self._device_of(s)
            if self.backend is not None:
                eng = self.backend.add_client()   # replays the DDL itself
                eng.tracer = self.tracer
                new_pipes = eng._streams
            else:
                eng = Engine(self.flags, device=dev, **self._engine_kw)
                eng.tracer = self.tracer
                for spec in self.specs.values():
                    eng.create_table(spec.schema, **spec.create_kw)
                for name, (fn, params) in self._models.items():
                    eng.register_model(name, fn, params)
                eng.set_cost_model(self.cost_model)
                for tname, scfg in self._stream_cfgs.items():
                    eng.attach_stream(tname, wal_resolve_shard(scfg, s))
                new_pipes = eng.streams
            self.shards.append(eng)
            self.devices = self.devices + (dev,)
            # 2) streaming facades gain the new shard's pipe
            for tname, facade in self.streams.items():
                facade.pipes.append(new_pipes[tname])
            # 3) replicated dimension tables: full copy from a donor
            self._seed_replicas(s)
            # 4) every retained deployment version exists on the new
            #    shard BEFORE any traffic can route there
            for name, versions in self._versions.items():
                live = self.deployments.get(name)
                for v in sorted(versions):
                    sh = versions[v]
                    h = eng.build_version(name, sh.query,
                                          warm_buckets=sh.warm_buckets)
                    sh.handles = sh.handles + (h,)
                    if live is sh:
                        eng.publish_version(h)
            # 5) routing: new queue now; the range migration itself runs
            #    OUTSIDE the deploy lock — a worker respawn mid-migration
            #    needs that lock for its catalog/deployment/WAL replay
            #    hooks, and _reshard waits out exactly such respawns
            self.router.add_queue()
        with self._reshard_lock:
            self._reshard(self._ring.with_shard(s))
        return s

    def remove_shard(self, s: int) -> int:
        """Shrink the shard set: migrate every key range owned by ``s``
        to the surviving shards (interval by interval, under live
        traffic), then retire and close the shard engine (its worker,
        under the process backend). The slot id is never reused. Returns
        the number of events migrated."""
        if self._ring is None:
            raise RuntimeError(
                "partitioner='modulo' cannot reshard; use the default "
                "consistent-hash ring")
        with self._deploy_lock:
            if s in self._retired or not 0 <= s < len(self.shards):
                raise ValueError(f"shard {s} is not active")
            if self.n_shards <= 1:
                raise ValueError("cannot remove the last active shard")
        # migrate outside the deploy lock (see add_shard): a respawn of
        # some OTHER worker mid-migration must be able to run its replay
        # hooks while _reshard retries the interrupted batch
        with self._reshard_lock:
            moved = self._reshard(self._ring.without_shard(s))
        with self._deploy_lock:
            self._retired.add(s)
            # no NEW traffic routes to s now (ring + _retired), but a
            # scatter that read the pre-reshard route table can still
            # target it: retire the queue (late submits shed), then wait
            # out everything already queued/executing before the engine
            # closes
            self.router.retire_queue(s)
            self.router.drain_shard(s)
            if self.backend is not None:
                self.shards[s].retired = True   # supervisor: no respawn
            self.shards[s].close()
            # every retained version drops the slot's handle, and each
            # stream facade its closed pipeline, so the shard's tables can
            # be freed (its version entries stay)
            for sh in self._retained_handles():
                sh._release_slot(s)
            for facade in self.streams.values():
                if s < len(facade.pipes):
                    facade.pipes[s] = None
            return moved

    def _retained_handles(self) -> List[ShardedDeploymentHandle]:
        """Every sharded handle the engine still holds: live, canary,
        retained versions and history, each once."""
        seen: Dict[int, ShardedDeploymentHandle] = {}
        for sh in list(self.deployments.values()) + [
                h for vs in self._versions.values() for h in vs.values()
        ] + [h for hs in self._history.values() for h in hs]:
            seen[id(sh)] = sh
            if sh._canary is not None:
                seen[id(sh._canary[0])] = sh._canary[0]
        return list(seen.values())

    def _seed_replicas(self, s: int) -> None:
        """Copy every replicated table's full contents onto shard ``s``
        from the first healthy donor (a new shard / respawned worker)."""
        donor = next((d for d in self._active_ids() if d != s), None)
        if donor is None:
            return
        for tname, spec in self.specs.items():
            if not spec.replicated:
                continue
            facade = self.streams.get(tname)
            if facade is not None and donor < len(facade.pipes):
                facade.pipes[donor].flush(flush_all=True)
            lk, ex, _mi = self._mig_ops(donor)
            keys = lk(tname)
            if not keys:
                continue
            ks, tsv, rws = ex(tname, keys)
            if len(ks):
                _lk, _ex, mi = self._mig_ops(s)
                mi(tname, ks, tsv, rws)

    def _mig_ops(self, s: int):
        """(list_keys, extract_events, migrate_in) for shard ``s`` —
        local calls in-process, worker RPCs under the process backend."""
        eng = self.shards[s]
        if self.backend is not None:
            return eng.list_keys, eng.extract_events, eng.migrate_in
        return ((lambda t: _migrate.list_keys(eng, t)),
                (lambda t, ks, **kw: _migrate.extract_events(eng, t, ks,
                                                             **kw)),
                (lambda t, ks, tsv, rws, totals=None: _migrate.migrate_in(
                    eng, t, ks, tsv, rws, totals)))

    def _reshard(self, new_ring: HashRing, *,
                 batch_arcs: Optional[int] = None) -> int:
        """Migrate routing from the current ring to ``new_ring``: serve
        from a merged route table, copy each differing key range
        (source flush -> enumerate keys in range -> extract -> insert
        into target, skipping any already-present prefix) and flip its
        owner — one batch of ranges at a time under the route lock, so
        ingest interleaves with migration at batch granularity. The
        source keeps its (now stale) copy: readers are never routed
        there for the moved keys, ``query_offline`` filters by current
        ownership, and the skip logic makes a later move-back safe."""
        step = batch_arcs or self.cfg.migrate_batch_arcs
        with self._route_lock:
            rt = RouteTable.merged(self._ring, new_ring)
            self._routing = rt
        plan = rt.plan_against(new_ring)
        tgt = {a: new_ring.owner_of_hash(int(rt.points[a]))
               for a in plan}
        partitioned = [t for t, sp in self.specs.items()
                       if not sp.replicated]
        moved = 0
        for i in range(0, len(plan), step):
            batch = plan[i:i + step]
            # one batch is retried as a unit when a worker dies (or an
            # RPC times out) mid-migration: migrate_in's prefix-skip
            # makes a re-run idempotent, arcs already flipped regroup as
            # src == dst no-ops, and the respawned worker's WAL replay
            # (which needs the route lock we release between attempts)
            # restores the source data the retry re-extracts
            deadline = time.monotonic() + _RESHARD_RETRY_S
            while True:
                try:
                    moved += self._migrate_batch(rt, batch, tgt,
                                                 partitioned)
                    break
                except (ShardDownError, TimeoutError):
                    if time.monotonic() >= deadline:
                        raise
                    # route lock released: the supervisor's respawn +
                    # replay hooks can run; wait for every worker to
                    # come back before re-running the batch
                    self._await_ready()
        self._ring = new_ring
        with self._route_lock:
            self._routing = RouteTable(new_ring)
        return moved

    def _migrate_batch(self, rt: RouteTable, batch: Sequence[int],
                       tgt: Dict[int, int], partitioned: Sequence[str]
                       ) -> int:
        """Copy one batch of arcs to their new owners and flip them,
        under the route lock; returns the events moved."""
        moved = 0
        with self._route_lock:
            groups: Dict[Tuple[int, int], List[int]] = {}
            for a in batch:
                groups.setdefault((rt.arc_owner(a), tgt[a]),
                                  []).append(a)
            for (src, dst), arcs in groups.items():
                if src == dst:
                    rt.set_owner(arcs, dst)
                    continue
                arcset = np.asarray(arcs)
                for tname in partitioned:
                    facade = self.streams.get(tname)
                    if facade is not None:
                        # staged events must be IN the table before
                        # extract reads its snapshot
                        facade.pipes[src].flush(flush_all=True)
                    lk, ex, _mi = self._mig_ops(src)
                    all_keys = lk(tname)
                    if not all_keys:
                        continue
                    in_arc = rt.arc_of_hashes(
                        key_hashes(np.asarray(all_keys)))
                    sel = [all_keys[int(j)] for j in np.flatnonzero(
                        np.isin(in_arc, arcset))]
                    if not sel:
                        continue
                    # with each key's total: a key new on the target
                    # keeps its ring positions there
                    ks, tsv, rws, tot = ex(tname, sel, with_totals=True)
                    if len(ks):
                        _lk, _ex, mi = self._mig_ops(dst)
                        moved += mi(tname, ks, tsv, rws, tot)
                rt.set_owner(arcs, dst)
        return moved

    # ----------------------------------------------- worker respawn hooks
    def _reseed_replicas(self, s: int, client) -> None:
        """(process backend) After a worker respawn + catalog replay,
        re-seed its replicated dimension tables from a healthy donor —
        joins on the respawned shard must not silently miss every
        dimension row. Partitioned table data re-enters through the
        stream or the WAL replay."""
        del client
        with self._deploy_lock:
            self._seed_replicas(s)

    def _replay_shard(self, s: int, client) -> None:
        """(process backend) Rebuild every retained deployment version
        on a respawned worker, in version order, aliasing the parent's
        stable version ids to the fresh worker's numbering; publish the
        live one. Runs under the deploy lock so a concurrent deploy
        cannot interleave with the rebuild."""
        with self._deploy_lock:
            for name, versions in self._versions.items():
                live = self.deployments.get(name)
                for v in sorted(versions):
                    sh = versions[v]
                    ph = sh.handles[s] if s < len(sh.handles) else None
                    if ph is None:
                        continue
                    summary = client.proc.call(
                        "build_version", name=name, query=sh.query,
                        warm_buckets=sh.warm_buckets)
                    client._alias[(name, ph.version)] = \
                        summary["version"]
                    ph.table.version = summary["table_version"]
                    ph.phys.feature_names = \
                        list(summary["feature_names"])
                    ph.phys.groups = tuple(summary["groups"])
                    if live is not None and live.handles[s] is ph:
                        ph.table.version = client.proc.call(
                            "publish_version", name=name,
                            version=summary["version"])

    def _await_ready(self, timeout: float = 30.0) -> bool:
        """Block until every non-retired process worker is serving again
        (in-process backend: trivially true). MUST be called without
        ``_route_lock`` held — the supervisor's WAL replay needs it."""
        deadline = time.monotonic() + timeout
        while self.recovering:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)
        return True

    # ------------------------------------------------- WAL recovery hooks
    def _archive_wal(self, s: int) -> None:
        """(process backend, pre-spawn) Move the dead shard's WAL tree
        aside so the respawned incarnation starts a FRESH log — replay
        re-ingests through the pipeline and re-logs into the new one.
        Archives stack (``.recover-0``, ``.recover-1`` ...) if a worker
        dies again before the previous replay finished; prefix-skip
        makes replaying both idempotent."""
        # postmortem evidence first: the ring holds the batches that led
        # into the crash (rate-limited, so a crash loop can't disk-fill)
        self.flight.record("worker_down", shard=s)
        self.flight.dump(f"worker-down-shard-{s}")
        if self.cfg.wal_dir is None:
            return
        src = os.path.join(self.cfg.wal_dir, f"shard-{s}")
        if not os.path.isdir(src):
            return
        k = 0
        while os.path.exists(f"{src}.recover-{k}"):
            k += 1
        os.rename(src, f"{src}.recover-{k}")

    def _replay_wal(self, s: int, client) -> None:
        """(process backend, post-respawn) Replay the archived WAL of
        shard ``s`` through the LIVE route table: events are re-scattered
        to their current owners (usually ``s`` itself, but a reshard may
        have moved keys while the worker was down) via ``migrate_in``,
        whose prefix-skip keeps duplicates out. Runs after the catalog +
        deployment replay, while the client is still ``ready=False`` so
        no fresh ingest can race ahead of the replayed history."""
        del client
        if self.cfg.wal_dir is None:
            return
        t0 = time.monotonic()
        dirs = sorted(d for d in os.listdir(self.cfg.wal_dir)
                      if d.startswith(f"shard-{s}.recover-")) \
            if os.path.isdir(self.cfg.wal_dir) else []
        total = 0
        for d in dirs:
            rdir = os.path.join(self.cfg.wal_dir, d)
            for tname in sorted(os.listdir(rdir)):
                spec = self.specs.get(tname)
                if (spec is None or spec.replicated
                        or tname not in self.streams):
                    continue
                events: List[Tuple[object, float, np.ndarray]] = []
                for keys, tsv, rows in wal_read_dir(
                        os.path.join(rdir, tname)):
                    for j in range(len(keys)):
                        events.append((keys[j], float(tsv[j]), rows[j]))
                if not events:
                    continue
                # global (ts, append-seq) order: stable sort reproduces
                # exactly the order the buffer accepted them in
                events.sort(key=lambda e: e[1])
                ks = np.asarray([e[0] for e in events])
                tsv = np.asarray([e[1] for e in events], np.float32)
                rws = np.asarray([e[2] for e in events], np.float32)
                with self._route_lock:
                    owners = self._routing.owners_of(ks)
                for o in np.unique(owners):
                    idx = np.flatnonzero(owners == o)
                    _lk, _ex, mi = self._mig_ops(int(o))
                    for c in range(0, len(idx), 2048):
                        sl = idx[c:c + 2048]
                        total += mi(tname, ks[sl], tsv[sl], rws[sl])
            shutil.rmtree(rdir)          # replayed in full: drop archive
        self.recovery_stats["wal_replays"] += 1
        self.recovery_stats["wal_replayed_events"] += total
        self.recovery_stats["wal_replay_lag_s"] = \
            time.monotonic() - t0

    # --------------------------------------------------------------- online
    def request(self, name: str, keys: Sequence, ts: Sequence[float],
                rows: Optional[np.ndarray] = None,
                ctx: Optional[RequestContext] = None) -> FeatureFrame:
        pin = ctx.version_pin if ctx is not None else None
        return self.handle(name, pin).request(keys, ts, rows, ctx=ctx)

    # -------------------------------------------------------------- offline
    def query_offline(self, name: str, *, batch_size: int = 1024,
                      point_in_time: bool = True) -> Dict[str, np.ndarray]:
        """Per-shard offline materialisation under pinned snapshots,
        concatenated. ``__key`` holds the ACTUAL key values (not dense
        indices — those are shard-local), plus a ``__shard`` column and
        the ``__version_vector`` the run was pinned to. Rows whose key is
        no longer owned by the shard that produced them (stale copies
        left by a range migration) are filtered out, so the output
        matches the unsharded engine before/during/after a reshard."""
        dep = self.handle(name)
        base_spec = self.specs.get(dep.table.schema.name)
        replicated = base_spec is not None and base_spec.replicated
        outs: List[Dict[str, np.ndarray]] = []
        vvec = []
        shard_ids_ = ([self._active_ids()[0]] if replicated
                      else self._active_ids())
        for s in shard_ids_:
            res = self.shards[s].query_offline(
                name, batch_size=batch_size, point_in_time=point_in_time)
            h = dep.handles[s]
            vvec.append(h.table.version if h is not None else -1)
            if "__key" not in res or len(res["__key"]) == 0:
                # hash skew (or n_shards > distinct keys) can leave a
                # shard with no retained events; skip it rather than
                # concatenating dtype-less empties into the key column
                continue
            if self.backend is None:
                # dense indices are shard-local: map them to the real
                # keys here (a worker already did, where its key_to_idx
                # lives)
                inv = {i: k for k, i in h.table.key_to_idx.items()}
                res["__key"] = np.asarray([inv[int(i)]
                                           for i in res["__key"]])
            if not replicated:
                own = self._routing.owners_of(res["__key"]) == s
                if not own.all():
                    res = {k: v[own] for k, v in res.items()}
                if len(res["__key"]) == 0:
                    continue
            res["__shard"] = np.full(len(res["__key"]), s, np.int32)
            outs.append(res)
        if not outs:
            merged = {n: np.zeros((0,), np.float32)
                      for n in dep.phys.feature_names}
            merged["__key"] = np.zeros((0,), np.int64)
            merged["__ts"] = np.zeros((0,), np.float32)
            merged["__shard"] = np.zeros((0,), np.int32)
        else:
            merged = {k: np.concatenate([o[k] for o in outs])
                      for k in outs[0]}
        merged["__version_vector"] = np.asarray(vvec, np.int64)
        return merged

    # ---------------------------------------------------------------- intro
    def explain(self, name: str) -> str:
        dep = self.handle(name)
        rs = self.router.stats()
        part = ("modulo" if self._ring is None else
                f"consistent-hash ring ({self._ring.vnodes} vnodes/"
                f"shard)")
        lines = [
            f"sharded deployment {name!r} v{dep.version} [{dep.state}] "
            f"across {self.n_shards} shard(s) "
            f"[{self.backend_kind} backend]",
            f"  router: {part}, "
            f"dispatch_rows={self.cfg.dispatch_rows}, "
            f"lanes={self.router.n_lanes}, "
            f"rows/dispatch={rs['rows_per_dispatch']:.1f}",
            f"  admission: max_inflight="
            f"{self.cfg.admission.max_inflight}, max_queue_depth="
            f"{self.cfg.admission.max_queue_depth} "
            f"({self.resources.metrics()})",
            "  devices: " + ", ".join(
                str(self.devices[s]) if self.backend is None
                else f"worker-subprocess {self.shards[s].proc.device} "
                     f"(pid {self.shards[s].proc.pid})"
                for s in self._active_ids()),
            f"  version vector: {dep.version_vector()}",
        ]
        lines.append(f"  per-shard plan (shard {self._active_ids()[0]} "
                     f"of {self.n_shards}; all shards compile the same "
                     f"plan):")
        lines += ["  " + l for l in
                  self._primary().explain(name).splitlines()]
        return "\n".join(lines)

    def explain_analyze(self, target: str) -> str:
        """Measured-runtime EXPLAIN, merged across shards. ``target`` is
        a deployment name or an ``EXPLAIN ANALYZE SELECT ...`` statement
        (matched against deployed queries, like the single engine)."""
        from repro_torch.obs.profile import OperatorProfiler
        name = target
        sql = dsl.strip_explain_analyze(target)
        if sql is not None:
            q = dsl.parse_sql(sql)
            name = next((nm for nm, dep in self.deployments.items()
                         if dep.query == q), None)
            if name is None:
                raise KeyError(
                    f"EXPLAIN ANALYZE: no live deployment serves this "
                    f"query (deploy it first); deployed: "
                    f"{sorted(self.deployments)}")
        dep = self.handle(name)
        snaps = [self.shards[s].profile_snapshot(name)
                 for s in self._active_ids()]
        return OperatorProfiler.render(
            name, dep.version, OperatorProfiler.merge(snaps),
            n_shards=len(snaps))

    def drain_profile_observations(self, name: str) -> List[Dict]:
        """Measured-per-operator calibrator feed (control plane): drain
        every in-process shard profiler's interval accumulator. Process
        workers keep their profiles worker-side (the plane falls back to
        its EM attribution there)."""
        obs: List[Dict] = []
        if self.backend is None:
            for s in self._active_ids():
                obs.extend(
                    self.shards[s].profiler.drain_observations(name))
        return obs

    # ----------------------------------------------------------- freshness
    def freshness_snapshot(self) -> Dict[str, Dict[str, object]]:
        """Cross-shard freshness: the shards' snapshots (one RPC per
        worker under the process backend) merged exactly — sketches add
        bucket-wise, counters sum, watermarks take the MIN (the slowest
        shard bounds global freshness)."""
        return FreshnessTracker.merge(
            [self.shards[s].freshness_snapshot()
             for s in self._active_ids()])

    def freshness_export(self) -> Dict[str, object]:
        """Flat ``freshness`` metrics group (merged across shards)."""
        return FreshnessTracker.export(self.freshness_snapshot())

    def _drift_monitor(self) -> DriftMonitor:
        return DriftMonitor.merge([self.shards[s].drift_snapshot()
                                   for s in self._active_ids()])

    def drift_report(self) -> Dict[str, Dict[str, float]]:
        """Per-column live-vs-reference PSI, merged across shards."""
        return self._drift_monitor().report()

    def drift_export(self) -> Dict[str, float]:
        return self._drift_monitor().export()

    def pin_drift_reference(self) -> List[str]:
        """Pin every shard's current live distribution as its drift
        reference (each shard pins locally; the merged report then
        compares merged-live vs merged-reference)."""
        cols: Set[str] = set()
        for s in self._active_ids():
            cols.update(self.shards[s].pin_drift_reference())
        return sorted(cols)

    def latency_decomposition(self) -> Dict[str, float]:
        # counters sum across shards; rates are recomputed from the
        # summed counters and percentiles take the worst shard — summing
        # a ratio or a p99 across shards would be nonsense
        agg: Dict[str, float] = {}
        join_matches = 0.0
        join_p99: List[float] = []
        hit: List[float] = []
        for s in self._active_ids():
            eng = self.shards[s]
            d = eng.latency_decomposition()
            for k, v in d.items():
                if k in ("cache_hit_rate", "join_match_rate",
                         "join_age_p99"):
                    continue
                agg[k] = agg.get(k, 0.0) + v
            if d.get("join_probes"):
                join_matches += d["join_match_rate"] * d["join_probes"]
                p99 = d.get("join_age_p99", float("nan"))
                if not np.isnan(p99):
                    join_p99.append(p99)
            hit.append(eng.cache.stats.hit_rate)
        if agg.get("join_probes"):
            agg["join_match_rate"] = join_matches / agg["join_probes"]
            agg["join_age_p99"] = (max(join_p99) if join_p99
                                   else float("nan"))
        agg["cache_hit_rate"] = float(np.mean(hit)) if hit else 0.0
        agg["n_shards"] = self.n_shards
        rec = self.recovery_snapshot()
        agg["worker_restarts"] = rec.pop("worker_restarts", 0)
        agg.update({f"router_{k}": v
                    for k, v in self.router.stats().items()})
        agg.update({f"admission_{k}": v
                    for k, v in self.resources.metrics().items()})
        agg.update({f"recovery_{k}": v for k, v in rec.items()})
        agg.update({f"transport_{k}": v
                    for k, v in self.transport_stats().items()})
        return agg

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # drain first: in-flight gathers complete before any lane stops
        self.router.shutdown(drain=True)
        self.streams.clear()   # shard engines own + close the pipelines
        if self.backend is not None:
            self.backend.close()
            return
        for s in self._active_ids():
            self.shards[s].close()

    def __enter__(self) -> "ShardedEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
