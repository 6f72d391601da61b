"""Port chaos tier (``repro_torch.shard.proc``: faults, transport, WAL
recovery, warm standbys) against the JAX package's (``repro.shard.proc``)
and the port's in-process sharded engine.

The nine cases of ``tests/test_chaos.py``: the fault plan's parsing, the
seeded injector (replayable, kill once), the CRC channel (corruption
caught with the stream aligned, duplicates delivered twice), seeded
drop/dup/corrupt traffic served all-OK through retries, ``kill_after``
killing both workers mid-RPC, the SIGKILL under live ingest and serving
recovered from the WAL with a warm standby, and the degraded ladder —
here on process workers. Two cross-package cases: the port's injector
makes JAX's frame decisions for the same plan and role, and a JAX
``Channel`` and a port ``Channel`` exchange frames both ways over one
socketpair, byte for byte. And the process-backend cases of the JAX
observability suite: a trace across a worker respawn, the registry's
``transport`` and ``recovery`` groups, and the worker-down flight dump
(with the control plane's recovery tick); and EXPLAIN ANALYZE,
freshness and drift merged from the workers' snapshots over RPC.

Tolerances: the process port against the port's in-process engine (or a
never-killed in-process twin fed the same events) bit for bit; fault
decisions, frames, parsed plans and group sets exactly equal to JAX's.

Every wait is bounded (a worker's exit, the respawn count, the engine's
``_await_ready``, a thread's ``join(timeout=)``, a poll with a
deadline); no case sleeps and then asserts on timing.
"""
import json
import os
import re
import shutil
import signal
import socket
import tempfile
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from repro.shard.proc import faults as jfaults
from repro.shard.proc import transport as jtransport
from repro_torch.control.plane import ControlPlane
from repro_torch.core.results import (STATUS_DEGRADED, STATUS_OK,
                                      STATUS_SHED, STATUS_UNKNOWN_KEY,
                                      RequestContext)
from repro_torch.featurestore.table import TableSchema
from repro_torch.obs.export import registry_from_engine
from repro_torch.obs.trace import new_trace_id
from repro_torch.shard import ShardConfig, ShardedEngine
from repro_torch.shard.proc.faults import FaultInjector, FaultPlan
from repro_torch.shard.proc.transport import (Channel, FrameCorrupt,
                                              encode_args)

torch.set_num_threads(1)

SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 10 PRECEDING AND CURRENT ROW)"""
SCHEMA = TableSchema("events", key_col="user", ts_col="ts",
                     value_cols=("amount", "mkey"))
DIM = TableSchema("dim", key_col="mkey", ts_col="dts",
                  value_cols=("risk", "tier"))


def _events(n=300, n_keys=8, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    ts = np.sort(rng.uniform(0, 1000.0, n)).astype(np.float32)
    rows = np.stack(
        [rng.normal(size=n),
         rng.integers(0, 4, n).astype(np.float64)], -1).astype(np.float32)
    return keys, ts, rows


def _proc(**cfg_kw):
    return ShardedEngine(ShardConfig(**cfg_kw), backend="process",
                         device="cpu")


def _inproc(**cfg_kw):
    return ShardedEngine(ShardConfig(**cfg_kw), device="cpu")


def _equal(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got.status),
                                  np.asarray(want.status), err_msg=what)
    assert sorted(got.columns) == sorted(want.columns), what
    for c in want.columns:
        np.testing.assert_array_equal(np.asarray(got[c]),
                                      np.asarray(want[c]),
                                      err_msg=f"{what} {c}")


def _until(fn, ok, timeout=90.0, poll=0.05):
    """Call ``fn`` until ``ok(result)`` or the deadline; the last result."""
    deadline = time.monotonic() + timeout
    out = fn()
    while not ok(out) and time.monotonic() < deadline:
        time.sleep(poll)
        out = fn()
    return out


def _kill(se, s):
    """SIGKILL shard ``s``'s worker and wait (bounded) until it is gone."""
    proc = se.shards[s].proc.proc
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=30)


def _recovered(se, restarts, timeout=90.0):
    """Wait (bounded) until ``restarts`` respawns happened in all and
    every worker serves again."""
    _until(lambda: se.worker_restarts, lambda n: n >= restarts, timeout)
    return se.worker_restarts >= restarts and se._await_ready(timeout)


def _all_ok(fr):
    return (np.asarray(fr.status) == STATUS_OK).all()


def _loaded(se, stream=False):
    keys, ts, rows = _events()
    se.create_table(SCHEMA, max_keys=64, capacity=64, bucket_size=8)
    if stream:
        pipe = se.attach_stream("events", flush_interval_s=0.05)
        pipe.push_batch(keys, ts, rows)
        pipe.flush()
    else:
        se.insert("events", keys.tolist(), ts.tolist(), rows)
    se.deploy("q", SQL)
    return se


# ------------------------------------------------------------- fault plan
def test_fault_plan_parse_and_env(monkeypatch):
    spec = "seed=7,drop=0.05,dup=0.1,kill_after=40"
    p = FaultPlan.parse(spec)
    assert (p.seed, p.drop, p.duplicate, p.kill_after) == (7, .05, .1, 40)
    assert p.active and p.disarmed().kill_after == 0
    assert not FaultPlan().active
    assert p == FaultPlan(**vars(jfaults.FaultPlan.parse(spec)))
    with pytest.raises(ValueError, match="unknown FaultPlan field"):
        FaultPlan.parse("seed=1,typo=0.5")
    monkeypatch.setenv("REPRO_FAULT_PLAN", "seed=3,corrupt=0.2")
    assert FaultPlan.from_env().corrupt == 0.2
    monkeypatch.setenv("REPRO_FAULT_PLAN", "")
    assert FaultPlan.from_env() is None


def test_fault_injector_seeded_replayable():
    plan = FaultPlan(seed=11, drop=0.3, duplicate=0.3, corrupt=0.2)
    outs = []
    for _ in range(2):  # same plan+role => identical fault sequence
        inj = FaultInjector(plan, role="client-0")
        outs.append([len(inj.frames(b"payload-%d" % i))
                     for i in range(200)])
    assert outs[0] == outs[1]
    assert 0 in outs[0] and 2 in outs[0]   # drops and dups both occurred
    inj2 = FaultInjector(plan, role="worker-0")
    assert [len(inj2.frames(b"payload-%d" % i))
            for i in range(200)] != outs[0]


def test_fault_injector_kill_fires_once():
    fired = []
    inj = FaultInjector(FaultPlan(kill_after=3), role="x",
                        kill_cb=lambda: fired.append(1))
    for i in range(6):
        f = b"f%d" % i
        assert inj.frames(f) == ([] if i == 2 else [(f, zlib.crc32(f))])
    assert fired == [1]                    # not re-fired on frames 4..6
    assert inj.stats["killed"] == 1


@pytest.mark.parametrize("role", ["client-0", "worker-1", ""])
def test_fault_injector_matches_jax_frame_for_frame(role):
    """Same plan, same role: the port's injector draws JAX's decisions —
    every wire frame (mutated bytes included), every kill, every
    counter."""
    kw = dict(seed=1337, drop=0.1, delay=0.1, delay_s=0.0, duplicate=0.2,
              corrupt=0.15, kill_after=57)
    kills = {"port": 0, "jax": 0}

    def bump(k):
        def cb():
            kills[k] += 1
        return cb

    mine = FaultInjector(FaultPlan(**kw), role=role, kill_cb=bump("port"))
    ref = jfaults.FaultInjector(jfaults.FaultPlan(**kw), role=role,
                                kill_cb=bump("jax"))
    rng = np.random.default_rng(4)
    for i in range(400):
        payload = rng.bytes(int(rng.integers(1, 200)))
        assert mine.frames(payload) == ref.frames(payload), i
    assert mine.stats == ref.stats and kills == {"port": 1, "jax": 1}
    assert mine.stats["corrupted"] and mine.stats["duplicated"]


# ------------------------------------------------------------- transport
def test_channel_crc_detects_corruption_and_stays_aligned():
    a, b = socket.socketpair()
    ca, cb = Channel(a), Channel(b)
    ca.fault_injector = FaultInjector(FaultPlan(seed=5, corrupt=1.0),
                                      role="t")
    ca.send((1, "m", b"x"))
    with pytest.raises(FrameCorrupt):
        cb.recv()
    ca.fault_injector = None               # the stream is still aligned
    ca.send((2, "ok", b"y"))
    assert cb.recv() == (2, "ok", b"y")
    ca.close()
    cb.close()


def test_channel_duplicate_frames_arrive_twice():
    a, b = socket.socketpair()
    ca, cb = Channel(a), Channel(b)
    ca.fault_injector = FaultInjector(FaultPlan(seed=1, duplicate=1.0),
                                      role="t")
    ca.send((7, "m", b"z"))
    assert cb.recv() == (7, "m", b"z")
    assert cb.recv() == (7, "m", b"z")     # the dedup layer's problem
    ca.close()
    cb.close()


def _raw(sock, n):
    buf = b""
    while len(buf) < n:
        buf += sock.recv(n - len(buf))
    return buf


def test_channel_interoperates_with_jax_byte_for_byte():
    """A JAX Channel and a port Channel on the two ends of one
    socketpair: requests and responses both ways, the same bytes on the
    wire for the same frame, and a corrupt frame from either side raises
    on the other and leaves the stream aligned."""
    frames = [(1, "serve", encode_args({"keys": np.arange(5),
                                        "ts": np.ones(5, np.float32)})),
              (1, True, ({"s": np.linspace(0, 1, 5, dtype=np.float32)},
                         np.zeros(5, np.int8), 3, (), None, None)),
              (2, False, KeyError("no handle"))]
    # byte for byte: what each package puts on the wire
    for fr in frames:
        wires = []
        for chan in (Channel, jtransport.Channel):
            a, b = socket.socketpair()
            chan(a).send(fr)
            hdr = _raw(b, 12)
            n = int.from_bytes(hdr[:8], "big")
            wires.append(hdr + _raw(b, n))
            a.close()
            b.close()
        assert wires[0] == wires[1]
    a, b = socket.socketpair()
    jc, tc = jtransport.Channel(a), Channel(b)
    jc.send(frames[0])
    got = tc.recv()
    assert got[:2] == (1, "serve")
    np.testing.assert_array_equal(jtransport.decode_args(got[2])["keys"],
                                  np.arange(5))
    tc.send(frames[1])
    back = jc.recv()
    np.testing.assert_array_equal(back[2][0]["s"], frames[1][2][0]["s"])
    for sender, reader, inj, err in (
            (tc, jc, FaultInjector(FaultPlan(seed=5, corrupt=1.0), role="t"),
             jtransport.FrameCorrupt),
            (jc, tc, jfaults.FaultInjector(
                jfaults.FaultPlan(seed=5, corrupt=1.0), role="t"),
             FrameCorrupt)):
        sender.fault_injector = inj
        sender.send((3, "bad", b"z" * 64))
        with pytest.raises(err):
            reader.recv()
        sender.fault_injector = None
        sender.send((4, "ok", b"y"))
        assert reader.recv() == (4, "ok", b"y")
    jc.close()
    tc.close()


# -------------------------------------------------- chaos traffic (proc)
def test_chaos_traffic_all_ok_through_retries():
    """Seeded drop/dup/corrupt faults on every channel: at-least-once
    delivery + worker dedup + CRC re-reads yield bit-exact all-OK
    service — the chaos is invisible above the transport — and the
    registry's transport group counts it; replicated (broadcast) inserts
    retry the same way."""
    plan = FaultPlan(seed=7, drop=0.03, duplicate=0.05, corrupt=0.03)
    se = _loaded(_proc(n_shards=2, fault_plan=plan))
    ref = _loaded(_inproc(n_shards=2))
    try:
        rk, rt = list(range(8)), [2000.0] * 8
        for _ in range(12):
            fr = se.request("q", rk, rt)
            assert _all_ok(fr)
        _equal(fr, ref.request("q", rk, rt), "through the faults")
        # a broadcast (replicated ingest: one payload, every worker) rides
        # the same retries: a dropped copy is re-sent, not waited out
        # (30 inserts: ~120 frames at these rates, so some copy is all
        # but surely dropped or corrupted; waiting one out takes 120 s)
        se.create_table(DIM, max_keys=8, capacity=128, bucket_size=8,
                        replicate=True)
        t0 = time.perf_counter()
        for i in range(30):
            se.insert("dim", list(range(4)), [float(i)] * 4,
                      np.full((4, 2), i, np.float32))
        assert time.perf_counter() - t0 < 60.0
        for c in se.shards:
            ks, _ts, rws = c.extract_events("dim", list(range(4)))
            assert len(ks) == 120 and sorted(set(ks)) == [0, 1, 2, 3]
            np.testing.assert_array_equal(np.sort(rws[:, 0]),
                                          np.repeat(np.arange(30), 4))
        # the plan bit (~190 frames each way by now), and the registry's
        # own reads cross the faulty transport too
        dec = se.latency_decomposition()
        assert (dec["transport_retries"] > 0
                or dec["transport_frame_corrupt"] > 0)
        snap = registry_from_engine(se).collect()
        assert snap["transport"]["retries"] >= dec["transport_retries"]
        assert snap["transport"]["frame_corrupt"] >= \
            dec["transport_frame_corrupt"]
        assert se.worker_restarts == 0
    finally:
        se.close()
        ref.close()


def test_chaos_kill_after_mid_rpc_sheds_then_recovers():
    """kill_after SIGKILLs a worker ON an outbound frame — the caller is
    left holding an in-flight RPC. It sheds or degrades (never hangs,
    never raises); the supervisor respawns with a DISARMED plan, and
    service resumes. Each client role draws its own stream, so BOTH
    workers die at their own 40th frame."""
    keys, ts, rows = _events()
    se = _proc(n_shards=2, fault_plan=FaultPlan(seed=3, kill_after=40),
               standby_workers=1)
    try:
        _loaded(se, stream=True)
        rk, rt = list(range(8)), [2000.0] * 8

        def serve():
            fr = se.request("q", rk, rt)     # must never raise or hang
            return se.worker_restarts, set(np.asarray(fr.status).tolist())

        n, st = _until(serve, lambda r: r[0] >= 2
                       and not r[1] & {STATUS_SHED, STATUS_DEGRADED},
                       timeout=150.0)
        assert n >= 2, "both kills fired"
        assert _recovered(se, 2)
        pipe = se.streams["events"]

        def reingest():
            try:
                pipe.push_batch(keys, ts + 3000.0, rows)
                pipe.flush()
            except (RuntimeError, TimeoutError):   # retryable: a respawn
                return False
            return _all_ok(se.request("q", rk, [9000.0] * 8))

        assert _until(reingest, bool, timeout=60.0)
    finally:
        se.close()


def test_chaos_sigkill_under_live_traffic_bit_identical():
    """SIGKILL one shard under continuous ingest + serve: every request
    returns within its deadline and never raises, the DEGRADED/SHED
    window ends, no key stays UNKNOWN, the standby is adopted, the WAL
    replays, and the output is bit-identical to a never-killed twin fed
    the same events."""
    extra_ts = np.linspace(1500.0, 1600.0, 40).astype(np.float32)
    extra_keys = np.arange(40) % 8
    extra_rows = np.ones((40, 2), np.float32)
    wal_dir = tempfile.mkdtemp(prefix="chaos-wal-")
    twin = _inproc(n_shards=2)
    se = _proc(n_shards=2, wal_dir=wal_dir, standby_workers=1)
    stop = threading.Event()
    t = None
    try:
        for eng in (se, twin):
            _loaded(eng, stream=True)
        rk, rt = list(range(8)), [2500.0] * 8
        assert _all_ok(se.request("q", rk, rt))
        assert _until(lambda: se.backend.standby.n_warm, bool, 60.0)
        hung, errors, served = [], [], threading.Event()

        def serve_loop():
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    se.request("q", rk, rt,
                               ctx=RequestContext.with_timeout(5.0))
                except Exception as e:       # noqa: BLE001 — asserted
                    errors.append(repr(e))
                if time.perf_counter() - t0 > 30.0:
                    hung.append(time.perf_counter() - t0)
                served.set()

        t = threading.Thread(target=serve_loop, daemon=True)
        t.start()
        assert served.wait(30.0)
        _kill(se, 1)

        # live ingest during the outage goes through the 2PC path, which
        # makes a producer retry safe: a failed attempt aborts the slice
        # prepared on the live shard, so nothing lands twice
        def insert():
            try:
                se.insert("events", extra_keys.tolist(), extra_ts.tolist(),
                          extra_rows)
                se.streams["events"].flush()
            except (RuntimeError, TimeoutError):   # ShardDownError too
                return False
            return True

        assert _until(insert, bool, timeout=60.0, poll=0.1), \
            "ingest never recovered after the kill"
        fr = _until(lambda: se.request("q", rk, [3000.0] * 8), _all_ok)
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert _all_ok(fr), np.asarray(fr.status).tolist()
        assert not hung, f"requests hung: {hung}"
        assert not errors, f"requests raised: {errors[:3]}"
        assert se.worker_restarts == 1
        twin.insert("events", extra_keys.tolist(), extra_ts.tolist(),
                    extra_rows)
        twin.streams["events"].flush()
        _equal(se.request("q", rk, [3000.0] * 8),
               twin.request("q", rk, [3000.0] * 8), "after the kill")
        dec = se.latency_decomposition()
        assert dec["recovery_wal_replays"] >= 1
        assert dec["recovery_wal_replayed_events"] > 0
        assert dec["recovery_last_adopted"] == 1.0   # the standby
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=30)
        se.close()
        twin.close()
        shutil.rmtree(wal_dir, ignore_errors=True)


def test_degraded_ladder_stale_tier_on_process_workers():
    """The OK -> DEGRADED -> SHED ladder over process workers, the same
    frames as the in-process port: with shard 1's queue retired, its keys
    answer DEGRADED from the stale tier (bit-exact last-served values)
    beside fresh OK rows; an uncached key in its range sheds the whole
    batch."""
    out = []
    for se in (_loaded(_proc(n_shards=2, degraded_cache_keys=64)),
               _loaded(_inproc(n_shards=2, degraded_cache_keys=64))):
        try:
            rk, rt = list(range(8)), [2000.0] * 8
            fr = se.request("q", rk, rt)
            assert _all_ok(fr)
            down = {k for k in rk if se.shard_of(k) == 1}
            assert down and len(down) < 8
            se.router.retire_queue(1)
            fr2 = se.request("q", rk, rt)
            st = np.asarray(fr2.status)
            assert (st[[k in down for k in rk]] == STATUS_DEGRADED).all()
            assert (st[[k not in down for k in rk]] == STATUS_OK).all()
            for c in fr.columns:
                np.testing.assert_array_equal(fr[c], fr2[c], err_msg=c)
            assert fr2.n_degraded == len(down)
            cold = next(k for k in range(8, 200)
                        if se.shard_of(k) == 1)
            fr3 = se.request("q", rk + [cold], rt + [2000.0])
            assert (np.asarray(fr3.status) == STATUS_SHED).all()
            out.append((fr2, se.resources.metrics(),
                        se.handle("q").metrics.snapshot()["degraded_"
                                                          "requests"]))
        finally:
            se.close()
    _equal(out[0][0], out[1][0], "degraded frame")
    assert out[0][1:] == out[1][1:]


# ---------------------------------- the JAX obs suite's process-backend cases
def test_proc_trace_survives_worker_respawn():
    """Trace ids survive the sharded gather and a worker respawn: the
    workers' spans, re-based onto this clock, are adopted into the
    parent's tracer and nest inside the lane's window; the respawned
    worker's tracer re-arms."""
    se = _loaded(_proc(n_shards=2))
    se.tracer.set_sample_rate(1.0)
    try:
        rk, rt = list(range(8)), [2000.0] * 8
        tid = new_trace_id()
        fr = se.request("q", rk, rt, ctx=RequestContext(trace_id=tid))
        assert _all_ok(fr) and fr.trace_id == tid
        spans = se.tracer.trace(tid)
        assert "engine.serve" in {s.name for s in spans}
        assert se.tracer.counters["spans_adopted"] > 0
        lanes = [s for s in spans if s.name == "lane.execute"]
        for s in spans:
            if s.name == "engine.serve":
                lane = next(l for l in lanes if l.span_id == s.parent_id)
                assert lane.start <= s.start <= s.end <= lane.end
        _kill(se, 1)
        assert _recovered(se, 1)
        assert se.worker_restarts == 1
        _until(lambda: se.request("q", rk, rt),
               lambda f: set(np.asarray(f.status).tolist())
               <= {STATUS_OK, STATUS_UNKNOWN_KEY})
        tid2 = new_trace_id()
        fr2 = se.request("q", rk, rt, ctx=RequestContext(trace_id=tid2))
        assert fr2.trace_id == tid2
        spans = se.tracer.trace(tid2)
        assert sum(s.name == "engine.serve" for s in spans) == 2
        ids = [s.span_id for s in spans]
        assert len(ids) == len(set(ids))
    finally:
        se.close()


def test_proc_registry_includes_transport_and_recovery():
    """The process engine's registry: the in-process sharded groups plus
    ``transport``, with the respawn count in ``recovery``."""
    se = _loaded(_proc(n_shards=2))
    ref = _loaded(_inproc(n_shards=2))
    try:
        for eng in (se, ref):
            eng.request("q", list(range(4)), [2000.0] * 4)
        reg = registry_from_engine(se)
        groups = set(reg.groups())
        assert groups == set(registry_from_engine(ref).groups()) \
            | {"transport"}
        snap = reg.collect()
        assert snap["engine"]["n_requests"] >= 4
        assert snap["transport"] == {"retries": 0, "frame_corrupt": 0,
                                     "rpc_timeouts": 0}
        assert snap["recovery"] == {"wal_replays": 0,
                                    "wal_replayed_events": 0,
                                    "wal_replay_lag_s": 0.0,
                                    "worker_restarts": 0}
    finally:
        se.close()
        ref.close()


def test_sharded_worker_down_dumps_flight(tmp_path):
    """A worker death is a flight-dump trigger: the parent records the
    worker_down marker and persists the ring. A ControlPlane tick after
    the respawn reports ``recovering`` (and fits nothing); the next one
    is steady again; the collector's series count the restart."""
    se = _loaded(_proc(n_shards=2))
    try:
        se.flight.out_dir = str(tmp_path)
        se.request("q", list(range(8)), [2000.0] * 8)
        plane = ControlPlane(se, "q", replan=False)
        assert plane.tick()["recovering"] is False
        _kill(se, 1)
        assert _recovered(se, 1)
        assert se.flight.dumps
        recs = [json.loads(ln)
                for ln in open(se.flight.dumps[0], encoding="utf-8")]
        assert any(r["kind"] == "worker_down" and r["shard"] == 1
                   for r in recs)
        assert any(r["kind"] == "serve" for r in recs)
        rep = plane.tick()
        assert rep["recovering"] is True
        assert rep["replan"] == {"action": "recovering"}
        assert plane.tick()["recovering"] is False
        series = plane.collector.series
        assert sum(series["engine.worker_restarts"].values()) == 1
    finally:
        se.close()


def _without_clock(snap):
    """A freshness snapshot without its wall-clock stamps."""
    return {t: {k: v for k, v in ent.items()
                if k not in ("published_at", "i2v_sketch")}
            for t, ent in snap.items()}


def _mask(text):
    """``explain_analyze`` with its measured seconds masked."""
    text = re.sub(r"(serve|exec|host|plan) \d+\.\d+", r"\1 #", text)
    text = re.sub(r"\d+\.\d+ (us/req|ms/batch)", r"# \1", text)
    return re.sub(r" +", " ", text)


def test_proc_snapshots_over_rpc_merge_like_in_process():
    """EXPLAIN ANALYZE, freshness and drift of a process engine: each
    worker's profile, freshness and drift snapshot crosses as an RPC and
    the merge equals the in-process port's over the same requests."""
    se, ref = _loaded(_proc(n_shards=2)), _loaded(_inproc(n_shards=2))
    try:
        for eng in (se, ref):
            for i in range(3):
                eng.request("q", list(range(8)), [2000.0 + i] * 8)
            assert eng.pin_drift_reference() == ["c", "s"]
            for i in range(3):
                eng.request("q", list(range(8)), [3000.0 + i] * 8)
        assert _without_clock(se.freshness_snapshot()) == \
            _without_clock(ref.freshness_snapshot())
        assert se.drift_report() == ref.drift_report()
        assert se.drift_export() == ref.drift_export()
        txt = se.explain_analyze("q")
        assert "(merged across 2 shards)" in txt
        assert _mask(txt) == _mask(ref.explain_analyze("q"))
    finally:
        se.close()
        ref.close()
