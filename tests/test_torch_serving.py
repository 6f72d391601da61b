"""Port serving front end: the dynamic batcher's semantics, and
``FeatureServer`` over the port's engine (frames, the write path, a hot
swap under load with a version pin), held against the JAX package's
batcher and engine on the same inputs.

Every threaded test synchronizes with events, barriers, ``flush`` and
bounded waits (``Request.wait(timeout)``, ``join(timeout)``), each
followed by an assertion; none sleeps and then asserts.

Tolerances: exact for status, versions, batch composition and counters;
features from a single-row request equal the same row of a batched
``engine.request`` to ``rtol 2e-4`` (sums; exact for counts), and the JAX
engine's to the same tolerance.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.engine import Engine as JEngine
from repro.core.optimizer import OptFlags as JFlags
from repro.featurestore.table import TableSchema as JSchema
from repro.serving.batcher import BatcherConfig as JBatcherConfig
from repro.serving.batcher import DynamicBatcher as JBatcher
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags
from repro_torch.core.results import (DeadlineExceeded, FeatureFrame,
                                      RequestContext)
from repro_torch.featurestore.table import TableSchema
from repro_torch.serving import (BatcherConfig, DynamicBatcher,
                                 FeatureServer, ServerConfig)
from repro_torch.serving.batcher import BatcherClosed

torch.set_num_threads(1)


def echo_serve(keys, ts, payloads):
    return {"k": np.asarray(keys, np.float32),
            "t": np.asarray(ts, np.float32)}


# ---------------------------------------------------------------- batcher
def _gated(cls_b, cls_cfg, n=16, max_batch=8):
    """``n`` requests queued behind a blocked first batch, then released:
    the batches the batcher forms are a function of the queue alone."""
    batches = []
    gate, entered = threading.Event(), threading.Event()

    def serve(keys, ts, payloads):
        if not entered.is_set():
            entered.set()
            assert gate.wait(30.0)
        batches.append(list(keys))
        return echo_serve(keys, ts, payloads)

    b = cls_b(serve, cls_cfg(max_batch=max_batch, max_delay_s=0.001))
    first = b.submit(-1, -1.0)
    assert entered.wait(30.0)
    reqs = [b.submit(i, float(i)) for i in range(n)]
    gate.set()
    outs = [r.wait(30.0) for r in [first] + reqs]
    b.close()
    return batches, outs, dict(b.stats)


def test_batcher_batches_like_jax():
    got = _gated(DynamicBatcher, BatcherConfig)
    want = _gated(JBatcher, JBatcherConfig)
    assert got[0] == want[0] == [[-1], list(range(8)), list(range(8, 16))]
    for g, w in zip(got[1], want[1]):
        assert g == w
    assert got[2] == want[2]
    assert got[2]["max_batch_seen"] == 8 and got[2]["requests"] == 17


def test_batcher_concurrent_clients():
    b = DynamicBatcher(echo_serve, BatcherConfig(max_batch=8,
                                                 max_delay_s=0.02))
    out = {}
    barrier = threading.Barrier(16)

    def client(i):
        barrier.wait(30.0)
        out[i] = b(i, float(i), timeout=30.0)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    b.close()
    assert all(out[i]["k"] == i and out[i]["t"] == i for i in range(16))
    assert b.stats["requests"] == 16 and b.stats["max_batch_seen"] <= 8
    assert b.mean_batch == 16 / b.stats["batches"]


def test_batcher_deadline_flush_and_errors():
    b = DynamicBatcher(echo_serve, BatcherConfig(max_batch=64,
                                                 max_delay_s=0.001))
    assert b(1, 1.0, timeout=30.0)["k"] == 1.0     # flushed by deadline
    b.close()

    def boom(keys, ts, payloads):
        raise ValueError("boom")

    b = DynamicBatcher(boom, BatcherConfig(max_delay_s=0.001))
    with pytest.raises(ValueError, match="boom"):
        b(1, 1.0, timeout=30.0)
    b.close()


def test_batcher_admission_control_and_mixed_payloads():
    gate = threading.Event()

    def slow(keys, ts, payloads):
        assert gate.wait(30.0)
        return {"p": (payloads[:, 0] if payloads is not None
                      else np.zeros(len(keys), np.float32))}

    b = DynamicBatcher(slow, BatcherConfig(max_batch=4, max_delay_s=0.001,
                                           max_queue=4))
    reqs, rejected = [], 0
    for i in range(12):
        try:
            reqs.append(b.submit(i, float(i),
                                 np.asarray([7.0], np.float32)
                                 if i % 2 == 0 else None))
        except RuntimeError:
            rejected += 1
    gate.set()
    for i, r in enumerate(reqs):
        assert float(r.wait(30.0)["p"]) in (0.0, 7.0)
    b.close()
    assert rejected > 0 and b.stats["rejected"] == rejected
    assert len(reqs) + rejected == 12


def test_batcher_close_fails_queued_and_inflight_requests():
    release, entered = threading.Event(), threading.Event()

    def blocked(keys, ts, payloads):
        entered.set()
        release.wait(30.0)
        return echo_serve(keys, ts, payloads)

    b = DynamicBatcher(blocked, BatcherConfig(max_batch=1,
                                              max_delay_s=0.001))
    r1 = b.submit(1, 1.0)
    assert entered.wait(30.0)
    r2 = b.submit(2, 2.0)
    b.close()
    for r in (r2, r1):
        with pytest.raises(BatcherClosed):
            r.wait(30.0)
    with pytest.raises(BatcherClosed):
        b.submit(3, 3.0)
    release.set()


def test_batcher_groups_by_version_pin():
    batches = []
    gate, entered = threading.Event(), threading.Event()

    def serve(keys, ts, payloads, ctx=None):
        if not entered.is_set():
            entered.set()
            assert gate.wait(30.0)
        batches.append((None if ctx is None else ctx.version_pin,
                        list(keys)))
        return {"k": np.asarray(keys, np.float32)}

    b = DynamicBatcher(serve, BatcherConfig(max_batch=16, max_delay_s=0.001))
    first = b.submit(0, 0.0)
    assert entered.wait(30.0)
    reqs = [b.submit(pin, float(i), ctx=RequestContext(version_pin=pin))
            for i, pin in enumerate([1, 2] * 8)]
    gate.set()
    for r in [first] + reqs:
        r.wait(30.0)
    b.close()
    assert batches[1:] == [(1, [1] * 8), (2, [2] * 8)]


def test_batcher_expires_deadlined_requests():
    gate, entered = threading.Event(), threading.Event()

    def slow(keys, ts, payloads):
        entered.set()
        assert gate.wait(30.0)
        return echo_serve(keys, ts, payloads)

    b = DynamicBatcher(slow, BatcherConfig(max_batch=2, max_delay_s=0.001))
    r1 = b.submit(1, 1.0)
    assert entered.wait(30.0)                      # r1 holds the dispatcher
    ctx = RequestContext.with_timeout(0.01)
    r2 = b.submit(2, 2.0, ctx=ctx)
    while not ctx.expired:                         # passes while queued
        time.sleep(0.001)
    gate.set()
    assert r1.wait(30.0)["k"] == 1.0
    with pytest.raises(DeadlineExceeded):
        r2.wait(30.0)
    assert b.stats["expired"] == 1
    with pytest.raises(DeadlineExceeded):
        b.submit(3, 3.0, ctx=RequestContext(deadline=0.0))
    b.close()


# ---------------------------------------------------------- FeatureServer
SQL_A = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 20 PRECEDING AND CURRENT ROW)"""
SQL_B = SQL_A.replace("20 PRECEDING", "5 PRECEDING")
RNG = np.random.default_rng(0)
EV_KEYS = RNG.integers(0, 8, 200)
EV_TS = np.sort(RNG.uniform(0, 1000, 200)).astype(np.float32)
EV_ROWS = RNG.normal(size=(200, 1)).astype(np.float32)
T_NEXT = float(EV_TS.max()) + 1.0


def _small_engine(kind="port", stream=False):
    if kind == "jax":
        eng, S = JEngine(JFlags()), JSchema
    else:
        eng, S = Engine(OptFlags(), device="cpu"), TableSchema
    schema = S("events", key_col="user", ts_col="ts", value_cols=("amount",))
    if stream:
        eng.create_stream(schema, max_keys=16, capacity=64, bucket_size=8,
                          lateness=0.0, flush_interval_s=0.001)
    else:
        eng.create_table(schema, max_keys=16, capacity=64, bucket_size=8)
    eng.insert("events", EV_KEYS.tolist(), EV_TS.tolist(), EV_ROWS)
    return eng


def test_feature_server_frames_equal_engine_request():
    eng, jeng = _small_engine(), _small_engine("jax")
    for e in (eng, jeng):
        e.deploy("q", SQL_A)
    keys = list(range(10))                         # 8, 9 unknown
    ts = [T_NEXT + i for i in range(10)]
    want = eng.request("q", keys, ts)
    jwant = jeng.request("q", keys, ts)
    cfg = ServerConfig(BatcherConfig(max_batch=4, max_delay_s=0.002),
                       warm_buckets=(1, 2, 4))
    got = {}
    barrier = threading.Barrier(len(keys))
    with FeatureServer(eng, "q", cfg) as srv:
        assert srv.handle is eng.handle("q") and srv.pipeline is None

        def client(i):
            barrier.wait(30.0)
            got[i] = srv.request(keys[i], ts[i], timeout=30.0)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(keys))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert srv.batcher.stats["requests"] == len(keys)
        with pytest.raises(RuntimeError, match="no stream attached"):
            srv.ingest(0, T_NEXT, np.zeros(1, np.float32))
    for i in range(len(keys)):
        fr = got[i]
        assert isinstance(fr, FeatureFrame) and fr.trace_id
        assert fr.version == 1 and fr.status[0] == want.status[i]
        assert fr.status[0] == jwant.status[i]
        for c in ("s", "c"):
            np.testing.assert_allclose(fr[c], want[c][i], rtol=2e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(fr[c], jwant[c][i], rtol=2e-4,
                                       atol=1e-5)
    assert sum(not got[i].all_ok for i in got) == 2
    srv.close()                                    # idempotent
    eng.close()
    jeng.close()


def test_feature_server_ingest_then_request():
    eng = _small_engine(stream=True)
    eng.deploy("q", SQL_A)
    srv = FeatureServer(eng, "q")
    pipe = srv.pipeline
    assert pipe is eng.streams["events"]
    key = int(np.argmin(np.bincount(EV_KEYS)))     # fewest events
    before = srv.request(key, T_NEXT + 5.0, timeout=30.0)
    assert 0 < float(before["c"]) < 20
    assert srv.ingest(key, T_NEXT, np.asarray([5.0], np.float32))
    assert not srv.ingest(key, 0.0, np.asarray([5.0], np.float32))   # late
    pipe.flush()
    after = srv.request(key, T_NEXT + 5.0, timeout=30.0)
    assert after.table_version > before.table_version
    assert float(after["c"]) == float(before["c"]) + 1
    assert float(after["s"]) != float(before["s"])
    srv.close()
    eng.close()


def test_feature_server_swap_under_load_and_version_pin():
    eng = _small_engine()
    eng.deploy("q", SQL_A)
    cfg = ServerConfig(BatcherConfig(max_batch=8, max_delay_s=0.002),
                       warm_buckets=(1, 2, 4, 8))
    with FeatureServer(eng, "q", cfg) as srv:
        base = srv.request(int(EV_KEYS[0]), T_NEXT, timeout=30.0)
        assert base.version == 1
        stop, got_v2 = threading.Event(), threading.Event()
        n_before = threading.Barrier(4)
        frames, errs = [], []

        def client(seed):
            i = seed
            n_before.wait(30.0)
            while not stop.is_set():
                i += 1
                try:
                    f = srv.request(int(EV_KEYS[i % 8]), T_NEXT + i,
                                    timeout=30.0)
                except Exception as e:            # pragma: no cover
                    errs.append(e)
                    return
                frames.append(f)
                if f.version == 2:
                    got_v2.set()

        threads = [threading.Thread(target=client, args=(s,))
                   for s in (0, 1000, 2000)]
        for t in threads:
            t.start()
        n_before.wait(30.0)                        # clients are running
        eng.deploy("q", SQL_B)                     # hot swap under load
        assert got_v2.wait(30.0)
        stop.set()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        assert {f.version for f in frames} <= {1, 2}
        for f in frames:                           # one version per frame
            assert set(f.keys()) == {"s", "c"} and f.all_ok
            assert float(f["c"]) <= (20 if f.version == 1 else 5)
        pinned = srv.request(int(EV_KEYS[0]), T_NEXT + 500, timeout=30.0,
                             ctx=RequestContext(version_pin=1,
                                                trace_id="t-123"))
        assert pinned.version == 1 and pinned.trace_id == "t-123"
        assert eng.handle("q").version == 2
    eng.close()
