"""Parent-side process backend: worker supervision + Engine-shaped proxies.

``ProcShardBackend`` owns N :class:`_WorkerProc` subprocesses (one per
shard, spawned with :func:`worker_env`) and wraps each in a
:class:`ProcEngineClient` that duck-types the slice of the ``Engine`` API
the sharded runtime uses — so ``ShardedEngine`` and the ``ShardRouter``
lanes run UNCHANGED against subprocess shards: a lane calls
``handle.request(keys, ts, rows)`` exactly as before; here that is one
``serve`` RPC over the worker's channel instead of a local call. Each
worker owns a full port ``Engine`` on its device, so its serves launch
the feature kernels in that process.

Liveness: a monitor thread polls worker processes. Death fails every
pending RPC with :class:`ShardDownError` (lanes translate it into a
whole-batch ``STATUS_SHED`` — no hung futures, no raw exceptions on the
serving path), then the worker is respawned, its catalog (DDL, streams,
models, cost model) replayed, replicated dimension tables re-seeded
from a healthy shard, and the engine's ``_replay_shard`` hook rebuilds
and republishes every retained deployment version. Partitioned table
data is NOT recovered — it re-enters through the stream (or the WAL
replay hook) like any other restart (DESIGN.md §11).

Version alias map: a respawned worker restarts version numbering at 1,
while the parent's handles keep their original version ids; per-client
``(name, parent_version) -> worker_version`` aliases keep every parent
handle addressable across respawns without rewriting the router/engine
bookkeeping.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.shard.proc.faults import FaultInjector, FaultPlan
from repro_torch.shard.proc.transport import Channel, FrameCorrupt, \
    encode_args, to_host
from repro_torch.shard.router import ShardDownError

__all__ = ["ProcShardBackend", "ProcEngineClient", "ProcDeploymentHandle",
           "ProcPipelineClient", "worker_env"]

_SPAWN_TIMEOUT_S = 120.0
_RPC_TIMEOUT_S = 120.0
# retry/backoff for unanswered RPC attempts: the frame (same req_id —
# worker-side dedup keeps execution exactly-once) is re-sent after
# base·2^attempt seconds, capped; the OVERALL call deadline still rules
_RETRY_BASE_S = 0.25
_RETRY_CAP_S = 5.0
_TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def _card_index(shard_id: int, device: torch.device,
                pin_devices: bool) -> Optional[int]:
    """Which visible card shard ``shard_id``'s worker is pinned to:
    ``shard_id % D`` for a CUDA device, ``pin_devices`` and ``D > 1``
    visible cards; None when the worker sees what the parent sees
    (one card, the CPU, pinning off, or a shard-agnostic standby)."""
    if device.type != "cuda" or not pin_devices or shard_id < 0:
        return None
    n = torch.cuda.device_count()
    return shard_id % n if n > 1 else None


def worker_env(shard_id: int, device="cpu", *,
               pin_devices: bool = True) -> Dict[str, str]:
    """The environment of shard ``shard_id``'s worker (``-1``: a
    standby). With more than one card visible and ``pin_devices``, the
    worker sees only its shard's card (``CUDA_VISIBLE_DEVICES``, mapped
    through the parent's own list when it has one), so its ``cuda`` is
    that card; with one card it is left unset and every worker shares
    ``cuda:0``. ``OMP_NUM_THREADS=1`` unless the caller set it (N workers
    must not each take every core for the CPU ops), the tcmalloc preload
    when available, ``src`` first on ``PYTHONPATH``. No JAX or XLA
    setting reaches a worker: it runs the port only."""
    dev = torch.device(device)
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("JAX_")}
    card = _card_index(shard_id, dev, pin_devices)
    if card is not None:
        visible = [c.strip() for c in
                   env.get("CUDA_VISIBLE_DEVICES", "").split(",")
                   if c.strip()]
        env["CUDA_VISIBLE_DEVICES"] = (visible[card] if card < len(visible)
                                       else str(card))
    env.setdefault("OMP_NUM_THREADS", "1")
    if "LD_PRELOAD" not in env:
        for p in _TCMALLOC_PATHS:
            if os.path.exists(p):
                env["LD_PRELOAD"] = p
                break
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH", "")) if p)
    env["REPRO_SHARD_WORKER_ID"] = str(shard_id)
    env["REPRO_SHARD_DEVICE"] = dev.type
    # the worker must not itself default to the process backend
    env.pop("REPRO_SHARD_BACKEND", None)
    return env


class _WorkerProc:
    """One worker subprocess + its channel + pending-RPC bookkeeping.

    May *adopt* a pre-warmed standby process instead of cold-spawning
    (``standby``), carries a shared ``stats`` dict so transport counters
    survive respawns, and arms a parent-side fault injector (with a
    SIGKILL trigger on this worker) when a ``fault_plan`` is given."""

    def __init__(self, shard_id: int, flags, engine_kw: dict, *,
                 device: torch.device, pin_devices: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 standby=None, stats: Optional[Dict[str, int]] = None):
        self.shard_id = shard_id
        self.alive = False
        self.adopted = False
        self._lock = threading.Lock()
        self._pending: Dict[int, "threading.Event"] = {}
        self._results: Dict[int, Tuple[bool, object]] = {}
        self._req_seq = 0
        self.stats = stats if stats is not None else {}
        card = _card_index(shard_id, device, pin_devices)
        entry = standby.take() if standby is not None else None
        if entry is not None:
            # warm adoption: the standby already paid its imports (and
            # context) and is parked on recv — our hello turns it into
            # this shard. It sees every card, so name the shard's own.
            self.proc, parent_sock, self.ch = entry
            self.adopted = True
            wdev = f"cuda:{card}" if card is not None else str(device)
        else:
            parent_sock, child_sock = socket.socketpair()
            env = worker_env(shard_id, device, pin_devices=pin_devices)
            env["REPRO_SHARD_WORKER_FD"] = str(child_sock.fileno())
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.shard.proc.worker"],
                env=env, pass_fds=[child_sock.fileno()])
            child_sock.close()
            self.ch = Channel(parent_sock)
            # pinned: the worker's only visible card is its cuda:0
            wdev = "cuda" if card is not None else str(device)
        # handshake: engine construction args out, ready frame back
        parent_sock.settimeout(_SPAWN_TIMEOUT_S)
        try:
            self.ch.send(("hello", {"shard_id": shard_id, "flags": flags,
                                    "device": wdev, "engine_kw": engine_kw,
                                    "fault_plan": fault_plan}))
            tag, info = self.ch.recv()
        except (EOFError, OSError) as e:
            self.ch.close()
            self._reap()
            raise RuntimeError(
                f"shard {shard_id} worker (pid {self.proc.pid}) did not "
                f"come up: exit code {self.proc.poll()} (its traceback is "
                f"on stderr)") from e
        if tag != "ready":
            self.ch.close()
            self._reap()
            raise RuntimeError(f"worker {shard_id} bad handshake: {tag!r}")
        parent_sock.settimeout(None)
        self.pid = info["pid"]
        self.device = info["device"]
        self.alive = True
        # chaos: only after the handshake — bootstrap frames are sacred.
        # The kill trigger lives HERE (not in the worker): SIGKILL on
        # the Nth outbound frame models a worker dying mid-RPC.
        if fault_plan is not None and fault_plan.active:
            pid = self.pid
            self.ch.fault_injector = FaultInjector(
                fault_plan, role=f"client-{shard_id}",
                kill_cb=lambda: os.kill(pid, signal.SIGKILL))
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"shard{shard_id}-reader")
        self._reader.start()

    # ---------------------------------------------------------------- rpc
    def _read_loop(self) -> None:
        try:
            while True:
                try:
                    req_id, ok, payload = self.ch.recv()
                except FrameCorrupt:
                    # frame consumed, stream aligned: the retry layer
                    # re-sends the request, so just count and read on
                    self.stats["frame_corrupt"] = \
                        self.stats.get("frame_corrupt", 0) + 1
                    continue
                with self._lock:
                    ev = self._pending.pop(req_id, None)
                    if ev is not None:
                        self._results[req_id] = (ok, payload)
                        ev.set()
        except (EOFError, OSError):
            self.mark_down()

    def mark_down(self) -> None:
        """Worker is gone: fail every pending RPC immediately."""
        with self._lock:
            self.alive = False
            pending = list(self._pending.items())
            self._pending.clear()
            for req_id, ev in pending:
                self._results[req_id] = (False, ShardDownError(
                    f"shard {self.shard_id} worker (pid {self.pid}) died"))
                ev.set()

    def submit_blob(self, method: str, blob: bytes) -> int:
        with self._lock:
            if not self.alive:
                raise ShardDownError(
                    f"shard {self.shard_id} worker is down")
            self._req_seq += 1
            req_id = self._req_seq
            self._pending[req_id] = threading.Event()
        try:
            self.ch.send((req_id, method, blob))
        except OSError:
            self.mark_down()
        return req_id

    def call(self, method: str, _timeout: float = _RPC_TIMEOUT_S,
             **args):
        """RPC with bounded-exponential-backoff retry. An unanswered
        attempt re-sends the SAME req_id/frame (drop/corrupt faults eat
        frames; the worker's dedup keeps a merely-slow original from
        double-executing), until the overall ``_timeout`` deadline.
        ``ShardDownError`` is never retried — the supervisor owns
        respawn, and the lane sheds/degrades meanwhile."""
        return self.call_blob(method, encode_args(args), _timeout)

    def call_blob(self, method: str, blob: bytes,
                  _timeout: float = _RPC_TIMEOUT_S):
        """:meth:`call` with the arguments already pickled (a broadcast
        pickles them once for every worker)."""
        deadline = time.monotonic() + _timeout
        with self._lock:
            if not self.alive:
                raise ShardDownError(
                    f"shard {self.shard_id} worker is down")
            self._req_seq += 1
            req_id = self._req_seq
            ev = self._pending[req_id] = threading.Event()
        attempt = 0
        while True:
            try:
                self.ch.send((req_id, method, blob))
            except OSError:
                self.mark_down()     # sets ev with ShardDownError below
            attempt_s = min(_RETRY_BASE_S * (2.0 ** attempt),
                            _RETRY_CAP_S)
            remaining = deadline - time.monotonic()
            if ev.wait(min(attempt_s, max(remaining, 0.001))):
                with self._lock:
                    ok, payload = self._results.pop(req_id)
                if not ok:
                    raise payload
                return payload
            if time.monotonic() >= deadline:
                with self._lock:
                    self._pending.pop(req_id, None)
                    self._results.pop(req_id, None)
                self.stats["rpc_timeouts"] = \
                    self.stats.get("rpc_timeouts", 0) + 1
                raise TimeoutError(
                    f"shard {self.shard_id} RPC {method!r} timed out "
                    f"after {_timeout}s ({attempt + 1} attempts)")
            attempt += 1
            self.stats["retries"] = self.stats.get("retries", 0) + 1

    # --------------------------------------------------------- lifecycle
    def dead(self) -> bool:
        return self.proc.poll() is not None

    def _reap(self, timeout: float = 5.0) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5.0)

    def close(self, timeout: float = 5.0) -> None:
        if self.alive:
            try:
                self.submit_blob("shutdown", encode_args({}))
            except (ShardDownError, OSError):
                pass
        self.ch.close()           # EOF unblocks the worker's serve loop
        self._reap(timeout)
        self.mark_down()


class _ProxyMetrics:
    """Parent-side per-shard-handle counters (tests and introspection
    read ``handle.metrics.requests``; the authoritative worker-side
    HandleMetrics stays available via the ``handle_metrics`` RPC)."""

    def __init__(self):
        self.requests = 0
        self.batches = 0
        self.serve_s = 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"requests": self.requests, "batches": self.batches,
                "serve_s": self.serve_s}


class _TableMirror:
    """Schema, shape and last-seen version of one worker-side table.
    ``version`` refreshes on every publish/flush/serve response, so
    version vectors are cheap reads, not RPCs. ``capacity``,
    ``bucket_size`` and ``preagg`` (True where the table keeps the
    pre-aggregate tier, else None) are what the control plane's cost
    attribution reads of a table."""

    def __init__(self, schema, version: int = 0):
        self.schema = schema
        self.version = version
        self.capacity: Optional[int] = None
        self.bucket_size: Optional[int] = None
        self.preagg: Optional[bool] = None

    def __repr__(self) -> str:
        return (f"_TableMirror({self.schema.name!r} "
                f"v{self.version})")


class ProcDeploymentHandle:
    """Per-shard deployment proxy satisfying the lane/handle contract:
    ``request(keys, ts, rows)``, ``.table.schema``, ``.plan.joins``,
    ``.phys.feature_names``, ``.metrics``, ``.warm``, ``.live``."""

    # lanes may pass ``timeout_s`` (derived from the RequestContext
    # deadline) so a serve RPC cannot outlive its request's budget
    supports_rpc_deadline = True

    def __init__(self, client: "ProcEngineClient", name: str,
                 version: int, summary: dict):
        from repro_torch.core.engine import DeploymentHandle
        self.client = client
        self.name = name
        self.version = version           # parent version id (stable)
        self.table = client._table_mirror(summary["table"],
                                          summary["schema"])
        self.table.version = summary["table_version"]
        self.table.capacity = summary["capacity"]
        self.table.bucket_size = summary["bucket_size"]
        self.table.preagg = True if summary["preagg"] else None
        self.plan = SimpleNamespace(joins=tuple(summary["joins"]))
        # the plan's window groups ride along (its executors cannot):
        # the control plane's cost attribution reads them
        self.phys = SimpleNamespace(
            feature_names=list(summary["feature_names"]),
            groups=tuple(summary["groups"]))
        self.state = DeploymentHandle.WARMING
        self.metrics = _ProxyMetrics()

    @property
    def live(self) -> bool:
        from repro_torch.core.engine import DeploymentHandle
        return self.state == DeploymentHandle.LIVE

    def _wv(self) -> int:
        return self.client._alias.get((self.name, self.version),
                                      self.version)

    def request(self, keys, ts, rows=None, *,
                timeout_s: Optional[float] = None, ctx=None, n_live=None):
        from repro_torch.core.results import FeatureFrame
        if not self.client.ready:
            raise ShardDownError(
                f"shard {self.client.shard_id} is respawning")
        tracer = getattr(self.client, "tracer", None)
        trace = None
        if (ctx is not None and ctx.trace_id is not None
                and tracer is not None and tracer.sampled(ctx.trace_id)):
            trace = {"trace_id": ctx.trace_id, "parent": ctx.parent_span}
        t0 = time.perf_counter()
        columns, status, tver, spans, wm, age = self.client.proc.call(
            "serve",
            _timeout=_RPC_TIMEOUT_S if timeout_s is None else timeout_s,
            name=self.name, version=self._wv(),
            keys=np.asarray(keys), ts=np.asarray(ts, np.float32),
            rows=None if rows is None else np.asarray(rows, np.float32),
            trace=trace, n_live=n_live)
        t1 = time.perf_counter()
        if spans and tracer is not None:
            self._adopt_spans(tracer, spans, t0, t1)
        self.table.version = max(self.table.version, tver)
        self.metrics.requests += len(keys)
        self.metrics.batches += 1
        self.metrics.serve_s += t1 - t0
        return FeatureFrame(columns, status=status, deployment=self.name,
                            version=self.version, table_version=tver,
                            watermark=wm, feature_age=age)

    @staticmethod
    def _adopt_spans(tracer, spans, rpc_start: float,
                     rpc_end: float) -> None:
        """Re-base worker-clock spans onto this process's clock: the
        worker span window is centered inside the RPC window (transport
        overhead split evenly before/after — the classic symmetric-
        offset estimate), then adopted idempotently (retried/duplicated
        RPCs re-deliver the same span ids; ``Tracer.adopt`` dedups)."""
        w0 = min(s["start"] for s in spans)
        w1 = max(s["end"] for s in spans)
        slack = max((rpc_end - rpc_start) - (w1 - w0), 0.0) / 2.0
        tracer.adopt(spans, rebase=rpc_start + slack - w0)

    def warm(self, buckets: Sequence[int]) -> int:
        return self.client.proc.call("warm", name=self.name,
                                     version=self._wv(),
                                     buckets=tuple(buckets))

    def join_staleness(self) -> Dict[str, Dict[str, float]]:
        return self.client.proc.call("join_staleness", name=self.name,
                                     version=self._wv())

    def __repr__(self) -> str:
        return (f"ProcDeploymentHandle({self.name!r} v{self.version} "
                f"[{self.state}] shard {self.client.shard_id})")


class ProcPipelineClient:
    """IngestPipeline proxy for one shard's stream (RPC per call; the
    worker-side flusher thread does the actual table mutation)."""

    def __init__(self, client: "ProcEngineClient", table: str):
        self.client = client
        self.table_name = table

    @property
    def table(self) -> _TableMirror:
        return self.client._tables[self.table_name]

    def push(self, key, ts: float, row) -> bool:
        return self.client.proc.call("pipe_push", table=self.table_name,
                                     key=key, ts=float(ts),
                                     row=np.asarray(row, np.float32))

    def push_batch(self, keys, ts, rows, *, all_or_nothing: bool = False
                   ) -> int:
        return self.client.proc.call(
            "pipe_push_batch", table=self.table_name,
            keys=np.asarray(keys), ts=np.asarray(ts, np.float32),
            rows=np.asarray(rows, np.float32),
            all_or_nothing=all_or_nothing)

    def prepare(self, keys, ts, rows) -> Optional[int]:
        return self.client.proc.call(
            "pipe_prepare", table=self.table_name,
            keys=np.asarray(keys), ts=np.asarray(ts, np.float32),
            rows=np.asarray(rows, np.float32))

    def commit_txn(self, txn: int) -> int:
        return self.client.proc.call("pipe_commit",
                                     table=self.table_name, txn=txn)

    def abort_txn(self, txn: int) -> None:
        self.client.proc.call("pipe_abort", table=self.table_name,
                              txn=txn)

    def flush(self, *, flush_all: bool = True, check: bool = False
              ) -> None:
        ver = self.client.proc.call("pipe_flush", table=self.table_name,
                                    flush_all=flush_all, check=check)
        self.table.version = max(self.table.version, ver)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        return self.client.proc.call("pipe_wait_idle",
                                     table=self.table_name,
                                     timeout=timeout)

    def warm(self) -> int:
        return self.client.proc.call("pipe_warm", table=self.table_name)

    def metrics(self) -> Dict[str, float]:
        return self.client.proc.call("pipe_metrics",
                                     table=self.table_name)

    def close(self, *, drain: bool = True) -> None:
        # the worker owns its pipelines and closes them with its engine;
        # a parent-side close is just a best-effort final drain
        if drain and self.client.proc.alive:
            try:
                self.flush(flush_all=True)
            except (ShardDownError, TimeoutError):
                pass


class _StatsProxy:
    """``engine.stats`` stand-in — the control plane reads worker-side
    counter snapshots over the transport."""

    def __init__(self, client: "ProcEngineClient", method: str):
        self._client = client
        self._method = method

    def snapshot(self) -> Dict[str, float]:
        return self._client.proc.call(self._method)


class _CacheStatsProxy(_StatsProxy):
    @property
    def hit_rate(self) -> float:
        return self._client.proc.call("cache_hit_rate")


class _CacheProxy:
    def __init__(self, client: "ProcEngineClient", enabled: bool):
        self.stats = _CacheStatsProxy(client, "cache_stats")
        self.enabled = enabled


class ProcEngineClient:
    """Engine-shaped facade over one worker subprocess. Implements the
    subset of the Engine surface ``ShardedEngine`` + telemetry touch;
    anything else raises ``AttributeError`` naturally (in-process-only
    introspection like ``.tables`` is deliberately absent — reaching
    into another process's objects is the bug this backend removes)."""

    def __init__(self, backend: "ProcShardBackend", shard_id: int):
        from repro_torch.core.optimizer import CostModel
        self.backend = backend
        self.shard_id = shard_id
        # client-level so counters survive worker respawns (each
        # _WorkerProc writes into this same dict)
        self.transport_stats: Dict[str, int] = {
            "retries": 0, "frame_corrupt": 0, "rpc_timeouts": 0}
        self.proc = backend.spawn(shard_id, self.transport_stats)
        self._tables: Dict[str, _TableMirror] = {}
        self._streams: Dict[str, ProcPipelineClient] = {}
        self._alias: Dict[Tuple[str, int], int] = {}
        self._live: Dict[str, ProcDeploymentHandle] = {}
        self.stats = _StatsProxy(self, "engine_stats")
        self.cache = _CacheProxy(
            self, enabled=backend.engine_kw.get("max_cache_entries",
                                                128) > 0)
        self.max_retained_versions = backend.engine_kw.get(
            "max_retained_versions", 2)
        self.cost_model = backend.engine_kw.get("cost_model") \
            or CostModel()
        self.restarts = 0
        # set by ShardedEngine.remove_shard: an intentionally-closed
        # worker must not be respawned by the supervisor
        self.retired = False
        # False while a respawn is replaying the catalog/deployments on
        # a fresh worker: the process is alive but cannot serve yet, so
        # the serving path sheds (worker_down) instead of surfacing the
        # worker's raw missing-handle errors
        self.ready = True

    # ----------------------------------------------------------- mirrors
    def _table_mirror(self, name: str, schema) -> _TableMirror:
        m = self._tables.get(name)
        if m is None:
            m = self._tables[name] = _TableMirror(schema)
        return m

    # --------------------------------------------------------------- DDL
    def create_table(self, schema, *, max_keys: int = 1024,
                     capacity: int = 1024, bucket_size: int = 64,
                     join_keys: Sequence[str] = ()) -> None:
        self.proc.call("create_table", schema=schema, max_keys=max_keys,
                       capacity=capacity, bucket_size=bucket_size,
                       join_keys=tuple(join_keys))
        self._table_mirror(schema.name, schema)

    def insert(self, table: str, keys, ts, rows, *,
               donate: bool = True) -> None:
        # donate is accepted for call-site parity with Engine.insert but
        # not forwarded: the worker always inserts copy-on-write, since
        # its RPC pool may serve off a snapshot meanwhile
        self.proc.call("insert", table=table, keys=keys, ts=ts,
                       rows=np.asarray(rows, np.float32))

    def attach_stream(self, table: str, cfg=None, **cfg_kw
                      ) -> ProcPipelineClient:
        from repro_torch.streaming.pipeline import PipelineConfig
        from repro_torch.streaming.wal import resolve_shard
        if cfg is None and cfg_kw:
            cfg = PipelineConfig(**cfg_kw)
        # WAL dirs are per shard: substitute a ``{shard}`` placeholder
        # HERE — this path also runs during catalog replay onto a
        # respawned worker and on elastic add_client, so the new log
        # lands in this shard's own directory
        cfg = resolve_shard(cfg, self.shard_id)
        self.proc.call("attach_stream", table=table, cfg=cfg)
        pipe = ProcPipelineClient(self, table)
        self._streams[table] = pipe
        return pipe

    def register_model(self, name: str, fn, params=None) -> None:
        """``fn`` crosses by reference (a module-level function the
        worker can import); ``params`` tensors cross as numpy and the
        worker puts them on its own device."""
        self.proc.call("register_model", name=name, fn=fn,
                       params=to_host(params, mark=True))

    def set_cost_model(self, model):
        prev = self.cost_model
        self.proc.call("set_cost_model", model=model)
        self.cost_model = model
        return prev

    # ------------------------------------------------------------ deploy
    def build_version(self, name: str, query, *,
                      warm_buckets=None) -> ProcDeploymentHandle:
        summary = self.proc.call("build_version", name=name, query=query,
                                 warm_buckets=warm_buckets)
        return ProcDeploymentHandle(self, name, summary["version"],
                                    summary)

    def publish_version(self, handle: ProcDeploymentHandle) -> None:
        from repro_torch.core.engine import DeploymentHandle
        tver = self.proc.call("publish_version", name=handle.name,
                              version=handle._wv())
        handle.table.version = max(handle.table.version, tver)
        old = self._live.get(handle.name)
        if old is not None and old is not handle:
            old.state = DeploymentHandle.RETIRED
        handle.state = DeploymentHandle.LIVE
        self._live[handle.name] = handle

    def discard_version(self, handle: ProcDeploymentHandle) -> None:
        from repro_torch.core.engine import DeploymentHandle
        self.proc.call("discard_version", name=handle.name,
                       version=handle._wv())
        handle.state = DeploymentHandle.RETIRED
        self._alias.pop((handle.name, handle.version), None)

    # ----------------------------------------------------------- offline
    def query_offline(self, name: str, *, batch_size: int = 1024,
                      point_in_time: bool = True) -> Dict[str, np.ndarray]:
        """Worker-side materialisation; ``__key`` already holds REAL key
        values (mapped where ``key_to_idx`` lives, inside the worker)."""
        return self.proc.call("query_offline", name=name,
                              batch_size=batch_size,
                              point_in_time=point_in_time)

    # --------------------------------------------------------- migration
    def list_keys(self, table: str) -> List:
        return self.proc.call("list_keys", table=table)

    def extract_events(self, table: str, keys: Sequence, *,
                       with_totals: bool = False):
        return self.proc.call("extract_events", table=table,
                              keys=list(keys), with_totals=with_totals)

    def migrate_in(self, table: str, keys: Sequence, ts, rows,
                   totals=None) -> int:
        return self.proc.call("migrate_in", table=table, keys=list(keys),
                              ts=np.asarray(ts, np.float32),
                              rows=np.asarray(rows, np.float32),
                              totals=totals)

    # ------------------------------------------------------------- intro
    def latency_decomposition(self) -> Dict[str, float]:
        return self.proc.call("latency_decomposition")

    def explain(self, name: str) -> str:
        return self.proc.call("explain", name=name)

    def explain_analyze(self, target: str) -> str:
        return self.proc.call("explain_analyze", target=target)

    def profile_snapshot(self, name: str) -> Optional[Dict]:
        """Worker-side OperatorProfiler totals (picklable dict) — merged
        parent-side across shards for sharded EXPLAIN ANALYZE."""
        return self.proc.call("profile_snapshot", name=name)

    def freshness_snapshot(self) -> Dict:
        """Worker-side FreshnessTracker snapshot (sketch dicts + live
        watermarks) — merged exactly parent-side across shards."""
        return self.proc.call("freshness_snapshot")

    def drift_snapshot(self) -> Dict:
        return self.proc.call("drift_snapshot")

    def pin_drift_reference(self) -> List[str]:
        return self.proc.call("pin_drift")

    def table_version(self, table: str) -> int:
        v = self.proc.call("table_version", table=table)
        m = self._tables.get(table)
        if m is not None:
            m.version = max(m.version, v)
        return v

    def launch_counts(self, *, reset: bool = False) -> Dict[str, int]:
        """The worker's feature-kernel launch counters (``reset`` zeroes
        them after reading)."""
        return self.proc.call("launch_counts", reset=reset)

    def ping(self) -> Dict[str, object]:
        """Worker identity and counters: pid, device, the kernel
        libraries it built (0: it loaded a built one), frames dropped as
        corrupt and duplicate requests it dropped."""
        return self.proc.call("ping")

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.proc.close()


class ProcShardBackend:
    """Spawns, supervises, and (on death) respawns the worker fleet.

    On the card the parent builds the kernel library before any worker
    starts, so the workers (and every respawn) only load it."""

    MONITOR_INTERVAL_S = 0.2

    def __init__(self, n_shards: int, *, flags, engine_kw: dict,
                 device="cuda", pin_devices: bool = True,
                 standby_workers: int = 0,
                 fault_plan: Optional[FaultPlan] = None):
        from repro_torch.featurestore.table import resolve_device
        self.flags = flags
        self.engine_kw = dict(engine_kw)
        self.device = resolve_device(device)
        self.pin_devices = pin_devices
        self.fault_plan = fault_plan
        self.clients: List[ProcEngineClient] = []
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.library()
        # (method, kwargs) log replayed onto respawned workers, in order
        self._ddl_log: List[Tuple[str, dict]] = []
        # set by ShardedEngine: called with (shard_id, client) after the
        # catalog replay, to rebuild + republish deployment versions
        self.respawn_hook: Optional[Callable[[int, "ProcEngineClient"],
                                             None]] = None
        # set by ShardedEngine: shard_id -> replicated table names, for
        # replica re-seeding from a healthy shard
        self.reseed_hook: Optional[Callable[[int, "ProcEngineClient"],
                                            None]] = None
        # WAL hooks (ShardedEngine): prespawn archives the dead shard's
        # log dir BEFORE the replacement opens a fresh one; replay —
        # after the catalog + deployments are back — re-scatters the
        # archived events through the live RouteTable
        self.prespawn_hook: Optional[Callable[[int], None]] = None
        self.replay_hook: Optional[Callable[[int, "ProcEngineClient"],
                                            None]] = None
        # last-recovery timing, read by telemetry and the smoke
        self.recovery_stats: Dict[str, float] = {}
        self._closing = False
        # pool first: standbys warm in the background while the initial
        # fleet cold-spawns (nothing is warm yet for the first spawns)
        self.standby = None
        if standby_workers > 0:
            from repro_torch.shard.proc.standby import StandbyPool
            self.standby = StandbyPool(standby_workers,
                                       device=self.device.type)
        # the initial fleet comes up in parallel: each spawn is mostly
        # the worker's own imports and context, which overlap
        with ThreadPoolExecutor(max_workers=max(n_shards, 1)) as ex:
            futs = [ex.submit(ProcEngineClient, self, s)
                    for s in range(n_shards)]
            errors = []
            for f in futs:
                try:
                    self.clients.append(f.result())
                except Exception as e:       # closed below, then raised
                    errors.append(e)
        if errors:
            self.close()
            raise errors[0]
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="shard-proc-monitor")
        self._monitor.start()

    def spawn(self, shard_id: int, stats: Dict[str, int], *,
              respawn: bool = False) -> _WorkerProc:
        """A worker for ``shard_id`` (adopting a standby when one is
        warm). A respawned worker must not inherit a live kill trigger —
        that would be a crash loop, not a chaos experiment."""
        plan = self.fault_plan
        if respawn and plan is not None:
            plan = plan.disarmed()
        return _WorkerProc(shard_id, self.flags, self.engine_kw,
                           device=self.device, pin_devices=self.pin_devices,
                           fault_plan=plan, standby=self.standby,
                           stats=stats)

    @property
    def pids(self) -> List[int]:
        """Every process this backend started and has not reaped: the
        shard workers (live or dead) and the standbys."""
        out = [c.proc.proc.pid for c in self.clients]
        if self.standby is not None:
            out += self.standby.pids
        return out

    # ------------------------------------------------------------ catalog
    def log_ddl(self, method: str, **kwargs) -> None:
        self._ddl_log.append((method, kwargs))

    def add_client(self) -> ProcEngineClient:
        """Spawn one more worker (elastic add_shard) and bring it up to
        the current catalog."""
        client = ProcEngineClient(self, len(self.clients))
        self._replay_catalog(client)
        self.clients.append(client)
        return client

    def _replay_catalog(self, client: ProcEngineClient) -> None:
        for method, kwargs in self._ddl_log:
            getattr(client, method)(**kwargs)

    # ---------------------------------------------------------- broadcast
    def broadcast(self, method: str, only: Optional[Sequence[int]] = None,
                  **args) -> List:
        """One serialized payload fanned to every (or ``only``) worker —
        the replicated-dimension-table ingest path: the args blob is
        pickled ONCE, each worker gets the same bytes, all in flight at
        once, each with the retry/backoff of :meth:`_WorkerProc.call`."""
        blob = encode_args(args)
        targets = [self.clients[i] for i in only] if only is not None \
            else list(self.clients)
        with ThreadPoolExecutor(max_workers=max(len(targets), 1)) as ex:
            futs = [ex.submit(c.proc.call_blob, method, blob)
                    for c in targets]
            return [f.result() for f in futs]

    # ---------------------------------------------------------- liveness
    def _monitor_loop(self) -> None:
        while not self._closing:
            time.sleep(self.MONITOR_INTERVAL_S)
            for client in list(self.clients):
                if self._closing or client.retired:
                    continue
                proc = client.proc
                if not proc.dead():
                    continue
                proc.mark_down()       # idempotent; poll may beat EOF
                try:
                    self._respawn(client)
                except Exception as e:     # keep supervising
                    if not self._closing:
                        sys.stderr.write(
                            f"# shard {client.shard_id} respawn failed: "
                            f"{e!r}\n")

    def _respawn(self, client: ProcEngineClient) -> None:
        t0 = time.perf_counter()
        client.ready = False
        client.proc.mark_down()
        try:
            client.proc.close(timeout=1.0)
        except (OSError, subprocess.TimeoutExpired):
            pass
        if self.prespawn_hook is not None:
            # archive the dead shard's WAL dir before the replacement
            # worker opens a fresh log at the same path
            try:
                self.prespawn_hook(client.shard_id)
            except Exception as e:     # the respawn goes on regardless
                sys.stderr.write(f"# shard {client.shard_id} WAL "
                                 f"archive failed: {e!r}\n")
        if self._closing:
            return
        client.proc = self.spawn(client.shard_id, client.transport_stats,
                                 respawn=True)
        if self._closing:             # close() raced the spawn
            client.proc.close(timeout=1.0)
            return
        t_spawn = time.perf_counter()
        client.restarts += 1
        client._alias.clear()
        client._live.clear()
        # mirrors refresh by max(); the fresh worker restarts version
        # numbering near 0, so stale high values must be dropped first
        for m in client._tables.values():
            m.version = 0
        try:
            self._replay_catalog(client)
            if self.reseed_hook is not None:
                self.reseed_hook(client.shard_id, client)
            if self.respawn_hook is not None:
                self.respawn_hook(client.shard_id, client)
            if self.replay_hook is not None:
                self.replay_hook(client.shard_id, client)
        except BaseException:
            # a failed replay leaves the client not-ready; kill the
            # worker so the monitor's next pass retries the respawn
            client.proc.close(timeout=1.0)
            raise
        client.ready = True
        now = time.perf_counter()
        self.recovery_stats = {
            "last_mttr_s": now - t0,
            "last_spawn_s": t_spawn - t0,
            "last_replay_s": now - t_spawn,
            "last_adopted": float(client.proc.adopted),
            "recoveries": self.recovery_stats.get("recoveries", 0) + 1}

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop the monitor (no respawn after this), then every worker
        and standby; no process of the backend outlives this call."""
        self._closing = True
        monitor = getattr(self, "_monitor", None)
        if monitor is not None:        # a respawn in flight finishes
            monitor.join(timeout=300.0)
        for client in self.clients:
            client.close()
        if self.standby is not None:
            self.standby.close()
