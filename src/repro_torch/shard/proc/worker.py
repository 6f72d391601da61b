"""Shard worker subprocess: one full port Engine behind an RPC loop.

Spawned by :class:`repro_torch.shard.proc.backend.ProcShardBackend` with
the channel fd in ``REPRO_SHARD_WORKER_FD`` and the env of
:func:`~repro_torch.shard.proc.backend.worker_env` (the shard's card in
``CUDA_VISIBLE_DEVICES`` when the host has several, ``OMP_NUM_THREADS=1``):
one interpreter, one GIL and one CUDA context per shard, which is the
point of the process backend.

The first frame the parent sends is ``hello``, carrying the device
(``"cuda"`` or ``"cpu"``) and the engine constructor arguments;
``Engine(flags, device=...)`` raises where CUDA is absent, so a worker
asked for the card never comes up on the CPU by itself. After that every
frame is ``(req_id, method, args_blob)`` dispatched on a small thread
pool (serving dispatches must not queue behind a multi-second
``build_version``; the threads share the worker's default stream, and
the engine's thread safety is that of its pooled mode). Responses are
``(req_id, True, result)`` or ``(req_id, False, exception)``.

Results cross as host values only: every tensor in a frame, an offline
result, extracted events or a snapshot becomes numpy first. A CUDA
tensor inside a pickle would open a context on ``cuda:<index>`` in the
process that reads it — and in a worker whose ``CUDA_VISIBLE_DEVICES``
remaps the index, fail.
"""
from __future__ import annotations

import collections
import os
import socket
import sys
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.shard.proc.transport import Channel, FrameCorrupt, \
    decode_args, to_device, to_host

# completed responses kept for duplicate-request resend (retry/backoff
# makes delivery at-least-once; this cache keeps execution exactly-once)
_DONE_CACHE = 256
# the wrappers whose launch counters the worker reports (its engine runs
# the feature kernels)
_FEATURE_KERNELS = ("window_agg", "fused_window", "preagg_window",
                    "last_join")


def _kernel_modules():
    import importlib
    return {k: importlib.import_module(f"repro_torch.kernels.{k}")
            for k in _FEATURE_KERNELS}


class WorkerServer:
    """RPC dispatch around one Engine (one shard's whole runtime)."""

    def __init__(self, ch: Channel, shard_id: int, flags, device,
                 engine_kw):
        from repro_torch.core.engine import Engine
        self.ch = ch
        self.shard_id = shard_id
        self.engine = Engine(flags, device=device, **engine_kw)
        # the CLIENT makes the sampling decision (it only attaches a
        # trace dict to a serve RPC for sampled traces); worker-side the
        # tracer accepts whatever arrives, so both samplers never have
        # to agree on a rate across the process boundary
        self.engine.tracer.set_sample_rate(1.0)
        # (name, version) -> DeploymentHandle; the parent addresses serve
        # and control RPCs by this pair, never by object reference
        self.handles = {}
        self.pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"shard{shard_id}-rpc")
        self._stopping = False
        # at-least-once delivery (client retries resend the SAME req_id)
        # must stay exactly-once execution: duplicates of an in-flight
        # request are dropped (the original will answer), duplicates of
        # a finished one get its cached response re-sent
        self._dedup_lock = threading.Lock()
        self._inflight: set = set()
        self._done: "collections.OrderedDict" = collections.OrderedDict()
        self.frames_corrupt = 0
        self.dups_dropped = 0

    # --------------------------------------------------------------- loop
    def serve_forever(self) -> None:
        while not self._stopping:
            try:
                req_id, method, blob = self.ch.recv()
            except FrameCorrupt:
                # frame consumed, stream still aligned: the client's
                # retry layer re-sends — just keep reading
                self.frames_corrupt += 1
                continue
            except EOFError:
                break            # parent gone: exit quietly
            with self._dedup_lock:
                if req_id in self._inflight:
                    self.dups_dropped += 1
                    continue
                cached = self._done.get(req_id)
                if cached is None:
                    self._inflight.add(req_id)
            if cached is not None:
                self.dups_dropped += 1
                self.pool.submit(self.ch.send, cached)
                continue
            self.pool.submit(self._handle, req_id, method, blob)
        self.pool.shutdown(wait=True)
        self.engine.close()

    def _finish(self, req_id, resp) -> None:
        with self._dedup_lock:
            self._inflight.discard(req_id)
            if resp is not None:
                self._done[req_id] = resp
                while len(self._done) > _DONE_CACHE:
                    self._done.popitem(last=False)

    def _handle(self, req_id, method, blob) -> None:
        resp = None
        try:
            try:
                args = decode_args(blob) if blob else {}
                result = getattr(self, "rpc_" + method)(**args)
                resp = (req_id, True, result)
                self.ch.send(resp)
            except BaseException as e:
                # exceptions cross the boundary as values; strip
                # unpicklable baggage rather than killing the worker
                try:
                    resp = (req_id, False, e)
                    self.ch.send(resp)
                except Exception:
                    resp = (req_id, False, RuntimeError(
                        f"{type(e).__name__}: {e}\n"
                        + traceback.format_exc(limit=8)))
                    self.ch.send(resp)
        finally:
            self._finish(req_id, resp)

    def _pipe(self, table: str):
        pipe = self.engine.streams.get(table)
        if pipe is None:
            raise KeyError(f"table {table!r} has no attached stream on "
                           f"shard {self.shard_id}")
        return pipe

    def _handle_of(self, name: str, version: int):
        h = self.handles.get((name, version))
        if h is None:
            raise KeyError(f"shard {self.shard_id} has no handle "
                           f"{name!r} v{version}")
        return h

    # ---------------------------------------------------------------- DDL
    def rpc_create_table(self, schema=None, max_keys=1024, capacity=1024,
                         bucket_size=64, join_keys=()):
        self.engine.create_table(schema, max_keys=max_keys,
                                 capacity=capacity,
                                 bucket_size=bucket_size,
                                 join_keys=join_keys)

    def _release_cached(self) -> None:
        """Hand the superseded table versions' device blocks back to the
        card. The worker shares the card with its siblings: a copy-on-
        write insert leaves the old version's blocks in this process's
        caching allocator, where another worker's next clone cannot get
        them."""
        if self.engine.device.type == "cuda":
            torch.cuda.empty_cache()

    def rpc_insert(self, table=None, keys=None, ts=None, rows=None):
        # copy-on-write: the RPC pool may be serving off a snapshot of
        # this table while the insert runs
        self.engine.insert(table, keys, ts, rows, donate=False)
        self._release_cached()

    def rpc_register_model(self, name=None, fn=None, params=None):
        self.engine.register_model(name, fn,
                                   to_device(params, self.engine.device))

    def rpc_set_cost_model(self, model=None):
        self.engine.set_cost_model(model)

    # ---------------------------------------------------------- streaming
    def rpc_attach_stream(self, table=None, cfg=None):
        self.engine.attach_stream(table, cfg)

    def rpc_pipe_push(self, table=None, key=None, ts=None, row=None):
        return self._pipe(table).push(key, ts, row)

    def rpc_pipe_push_batch(self, table=None, keys=None, ts=None,
                            rows=None, all_or_nothing=False):
        return self._pipe(table).push_batch(
            keys, ts, rows, all_or_nothing=all_or_nothing)

    def rpc_pipe_prepare(self, table=None, keys=None, ts=None, rows=None):
        return self._pipe(table).prepare(keys, ts, rows)

    def rpc_pipe_commit(self, table=None, txn=None):
        return self._pipe(table).commit_txn(txn)

    def rpc_pipe_abort(self, table=None, txn=None):
        self._pipe(table).abort_txn(txn)

    def rpc_pipe_flush(self, table=None, flush_all=True, check=False):
        pipe = self._pipe(table)
        pipe.flush(flush_all=flush_all)
        if check and pipe.last_error is not None \
                and pipe.buffer.n_staged > 0:
            # mirror Engine.insert's barrier semantics: staged remainder
            # plus an error means the write did not fully land
            raise RuntimeError(
                f"ingest into {table!r} failed on shard "
                f"{self.shard_id}: {pipe.last_error}") from pipe.last_error
        return pipe.table.version

    def rpc_pipe_wait_idle(self, table=None, timeout=30.0):
        return self._pipe(table).wait_idle(timeout)

    def rpc_pipe_warm(self, table=None):
        return self._pipe(table).warm()

    def rpc_pipe_metrics(self, table=None):
        return dict(self._pipe(table).metrics())

    # ------------------------------------------------------------- deploy
    def rpc_build_version(self, name=None, query=None, warm_buckets=None):
        h = self.engine.build_version(name, query,
                                      warm_buckets=warm_buckets)
        self.handles[(name, h.version)] = h
        return {"version": h.version,
                "feature_names": list(h.phys.feature_names),
                "groups": tuple(h.phys.groups),
                "joins": tuple(h.plan.joins),
                "table": h.table.schema.name,
                "schema": h.table.schema,
                "table_version": h.table.version,
                "capacity": h.table.capacity,
                "bucket_size": h.table.bucket_size,
                "preagg": h.table.preagg is not None}

    def rpc_publish_version(self, name=None, version=None):
        h = self._handle_of(name, version)
        self.engine.publish_version(h)
        return h.table.version

    def rpc_discard_version(self, name=None, version=None):
        h = self.handles.pop((name, version), None)
        if h is not None:
            self.engine.discard_version(h)

    def rpc_warm(self, name=None, version=None, buckets=()):
        return self._handle_of(name, version).warm(buckets)

    # -------------------------------------------------------------- serve
    def rpc_serve(self, name=None, version=None, keys=None, ts=None,
                  rows=None, trace=None, n_live=None):
        ctx = None
        if trace is not None:
            from repro_torch.core.results import RequestContext
            ctx = RequestContext(trace_id=trace["trace_id"],
                                 parent_span=trace.get("parent"))
        frame = self._handle_of(name, version).request(keys, ts, rows,
                                                       ctx=ctx,
                                                       n_live=n_live)
        # worker-clock span export rides the response; the client
        # re-bases onto its own clock and adopts (dedup by span id keeps
        # transport retries/dups idempotent)
        spans = (self.engine.tracer.export_trace(trace["trace_id"])
                 if trace is not None else ())
        return (to_host(frame.columns), np.asarray(frame.status),
                int(frame.table_version), spans,
                frame.watermark, frame.feature_age)

    def rpc_handle_metrics(self, name=None, version=None):
        return self._handle_of(name, version).metrics.snapshot()

    def rpc_join_staleness(self, name=None, version=None):
        return self._handle_of(name, version).join_staleness()

    # ------------------------------------------------------------ offline
    def rpc_query_offline(self, name=None, batch_size=1024,
                          point_in_time=True):
        res = self.engine.query_offline(name, batch_size=batch_size,
                                        point_in_time=point_in_time)
        out = {k: np.asarray(v) for k, v in to_host(res).items()}
        if "__key" in out and len(out["__key"]):
            # map shard-local dense indices back to real key values here,
            # where key_to_idx lives — the parent never sees local indices
            live = self.engine.deployments.get(name)
            h = live if live is not None else next(
                (h for (n, _v), h in self.handles.items() if n == name),
                None)
            inv = {i: k for k, i in h.table.key_to_idx.items()}
            out["__key"] = np.asarray([inv[int(i)] for i in out["__key"]])
        return out

    # ---------------------------------------------------------- migration
    def rpc_list_keys(self, table=None):
        from repro_torch.shard.migrate import list_keys
        return list_keys(self.engine, table)

    def rpc_extract_events(self, table=None, keys=None, with_totals=False):
        from repro_torch.shard.migrate import extract_events
        out = extract_events(self.engine, table, keys,
                             with_totals=with_totals)
        return (out[0], to_host(out[1]), to_host(out[2])) + out[3:]

    def rpc_migrate_in(self, table=None, keys=None, ts=None, rows=None,
                       totals=None):
        from repro_torch.shard.migrate import migrate_in
        n = migrate_in(self.engine, table, keys, ts, rows, totals)
        self._release_cached()
        return n

    # -------------------------------------------------------------- intro
    def rpc_engine_stats(self):
        return self.engine.stats.snapshot()

    def rpc_cache_stats(self):
        return self.engine.cache.stats.snapshot()

    def rpc_cache_hit_rate(self):
        return float(self.engine.cache.stats.hit_rate)

    def rpc_latency_decomposition(self):
        return self.engine.latency_decomposition()

    def rpc_explain(self, name=None):
        return self.engine.explain(name)

    def rpc_explain_analyze(self, target=None):
        return self.engine.explain_analyze(target)

    def rpc_profile_snapshot(self, name=None):
        return to_host(self.engine.profile_snapshot(name))

    def rpc_freshness_snapshot(self):
        return to_host(self.engine.freshness_snapshot())

    def rpc_drift_snapshot(self):
        return to_host(self.engine.drift_snapshot())

    def rpc_pin_drift(self):
        return self.engine.pin_drift_reference()

    def rpc_table_version(self, table=None):
        return self.engine.tables[table].version

    def rpc_launch_counts(self, reset=False):
        """This process's feature-kernel launch counters (each wrapper
        adds one where it launches its kernel); ``reset`` zeroes them
        after reading."""
        mods = _kernel_modules()
        out = {k: int(m.launches) for k, m in mods.items()}
        if reset:
            for m in mods.values():
                m.launches = 0
        return out

    def rpc_ping(self):
        from repro_torch.kernels import _build
        return {"shard": self.shard_id, "pid": os.getpid(),
                "device": str(self.engine.device),
                "kernel_builds": _build.builds,
                "frames_corrupt": self.frames_corrupt,
                "dups_dropped": self.dups_dropped}

    def rpc_shutdown(self):
        self._stopping = True


def prewarm(device: str) -> None:
    """What a parked standby pays before it is adopted: the engine's
    imports and, for the card, the CUDA context and the kernel library
    (loaded from ``build/kernels/<digest>/``; the parent built it before
    spawning), so an adopted standby pays neither."""
    from repro_torch.core.engine import Engine  # noqa: F401  (import cost)
    from repro_torch.shard import migrate  # noqa: F401
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        torch.cuda.init()
        torch.zeros(1, device=dev)          # the context itself
        torch.cuda.synchronize(dev)
        _build.library()


def main() -> int:
    fd = int(os.environ["REPRO_SHARD_WORKER_FD"])
    sock = socket.socket(fileno=fd)
    ch = Channel(sock)
    if os.environ.get("REPRO_SHARD_PREWARM") == "1":
        # standby pool (proc/standby.py): pay the imports, the context and
        # the library load NOW, while parked, then tell the parent we're
        # warm. The hello — carrying the actual shard identity — may
        # arrive much later, at adoption time.
        prewarm(os.environ.get("REPRO_SHARD_DEVICE", "cpu"))
        try:
            ch.send(("warm", {"pid": os.getpid()}))
        except OSError:
            return 0   # the pool closed while this standby was warming
    # hello carries the engine construction args (sent before any RPC)
    try:
        tag, hello = ch.recv()
    except EOFError:
        return 0       # never adopted: the standby pool closed quietly
    if tag != "hello":
        raise RuntimeError(f"expected a hello frame, got {tag!r}")
    server = WorkerServer(ch, shard_id=hello["shard_id"],
                          flags=hello["flags"], device=hello["device"],
                          engine_kw=hello.get("engine_kw", {}))
    ch.send(("ready", {"pid": os.getpid(),
                       "device": str(server.engine.device)}))
    # chaos: install the fault injector only AFTER the handshake, so
    # bootstrap frames are never faulted; the worker side runs the plan
    # disarmed (frame faults only) — the kill trigger belongs to the
    # parent, which can SIGKILL this process mid-RPC
    plan = hello.get("fault_plan")
    if plan is not None and plan.disarmed().active:
        from repro_torch.shard.proc.faults import FaultInjector
        ch.fault_injector = FaultInjector(
            plan.disarmed(), role=f"worker-{hello['shard_id']}")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
