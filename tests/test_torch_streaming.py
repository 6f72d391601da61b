"""Port streaming ingest against the JAX package: the reorder buffer, the
background flusher's copy-on-write publish, TTL retention with the
pre-aggregate rebuild, the write-ahead log, and the engine's write path.

The same seeded event trace (disordered within the reorder window) goes
through the JAX pipeline and the port's; the resulting tables, keyed by
the original keys (the flusher's batching may assign dense indices in a
different order), must hold the same events, and the deployed query the
same features online and offline. The retention and pre-aggregate
functions run on the same state in both packages. Threaded tests wait on
``flush``, ``wait_idle``, events and joins, each bounded and followed by
an assertion.

Tolerances: exact for the ring (ts, totals, values), the buffer's output
and counters, compaction, counts, min/max and LAST; ``rtol 2e-4`` for the
pre-aggregate sums and sums of squares (summation order) and for summed
features.
"""
import os
import struct
import threading

import numpy as np
import pytest
import torch

from repro.core.engine import Engine as JEngine
from repro.core.optimizer import OptFlags as JFlags
from repro.featurestore import preagg as jpreagg
from repro.featurestore.table import Table as JTable
from repro.featurestore.table import TableSchema as JSchema
from repro.streaming import StreamBuffer as JBuffer
from repro.streaming import StreamSource as JSource
from repro.streaming import compact_expired as jcompact
from repro.streaming.pipeline import PipelineConfig as JPipelineConfig
from repro.streaming.wal import WalConfig as JWalConfig
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags
from repro_torch.data.synthetic import EventStreamConfig
from repro_torch.featurestore import preagg
from repro_torch.featurestore.table import (PreAggState, Table, TableSchema,
                                            TableState)
from repro_torch.streaming import (IngestPipeline, PipelineConfig,
                                   RetentionPolicy, StreamBuffer,
                                   StreamSource, compact_expired,
                                   online_offline_consistency)
from repro_torch.streaming.retention import apply_retention
from repro_torch.streaming.wal import (WalConfig, WriteAheadLog, read_dir,
                                       read_segment)

torch.set_num_threads(1)

SQL = """
SELECT SUM(amount) OVER w AS s,
       COUNT(amount) OVER w AS c,
       MAX(amount) OVER w AS mx,
       LAST(lat) OVER w AS last_lat
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 20 PRECEDING AND CURRENT ROW)
"""
COLS = ("amount", "lat", "lon")
PREAGG_FIELDS = ("sum", "sumsq", "min", "max", "count")


def schema3(S=TableSchema):
    return S("events", key_col="user", ts_col="ts", value_cols=COLS)


def source(n=400, n_keys=8, seed=0, cls=StreamSource):
    return cls.from_config(EventStreamConfig(
        n_events=n, n_keys=n_keys, n_features=3, seed=seed))


def _engine(kind, **flags):
    if kind == "jax":
        return JEngine(JFlags(**flags)), JSchema
    return Engine(OptFlags(**flags), device="cpu"), TableSchema


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _by_key(table):
    """The table's events and pre-aggregates per original key."""
    st, pa = table.snapshot().state, table.snapshot().preagg
    arrays = {"values": _np(st.values), "ts": _np(st.ts),
              "total": _np(st.total)}
    if pa is not None:
        arrays.update({f: _np(getattr(pa, f)) for f in PREAGG_FIELDS})
    return {k: {f: a[i] for f, a in arrays.items()}
            for k, i in table.key_to_idx.items()}


def _assert_tables_equal(got, want):
    g, w = _by_key(got), _by_key(want)
    assert sorted(g) == sorted(w)
    for k in w:
        for f in ("ts", "total", "values", "min", "max", "count"):
            np.testing.assert_array_equal(g[k][f], w[k][f], err_msg=(k, f))
        for f in ("sum", "sumsq"):
            np.testing.assert_allclose(g[k][f], w[k][f], rtol=2e-4,
                                       atol=1e-4, err_msg=(k, f))


# ---------------------------------------------------------------- buffer
def _drive(b):
    """One push/ready script; returns everything it observed."""
    seen = []
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 50, 60)).astype(np.float32)
    arrival = np.argsort(t + rng.uniform(0, 3, 60), kind="stable")
    for n, i in enumerate(arrival):
        key = "ab"[int(i) % 2]
        seen.append(b.push(key, float(t[i]), np.asarray([t[i]], np.float32)))
        if n % 7 == 6:
            k, ts, rows = b.ready()
            seen.append((list(k), ts.tolist(), rows.tolist()))
    seen.append(b.push("a", 0.5, np.zeros(1, np.float32)))    # late
    k, ts, rows = b.ready(flush_all=True)
    seen.append((list(k), ts.tolist(), rows.tolist()))
    return seen, b.stats.snapshot()


def test_buffer_repair_drops_and_watermarks_match_jax():
    got = _drive(StreamBuffer(lateness=2.0))
    want = _drive(JBuffer(lateness=2.0))
    assert got == want
    assert got[1]["reordered"] > 0 and got[1]["dropped_late"] >= 1


def test_buffer_repairs_within_watermark():
    b = StreamBuffer(lateness=5.0)
    for t in [3.0, 1.0, 2.0, 0.5, 4.0]:
        assert b.push("a", t, np.asarray([t], np.float32))
    k, ts, _ = b.ready()
    assert len(k) == 0                             # inside the window
    b.push("a", 9.5, np.asarray([9.5], np.float32))
    k, ts, _ = b.ready()
    assert list(ts) == [0.5, 1.0, 2.0, 3.0, 4.0]
    assert b.stats.reordered > 0 and b.stats.dropped_late == 0
    assert not b.push("a", 0.1, np.zeros(1, np.float32))   # < frontier
    assert b.stats.dropped_late == 1
    assert b.watermark("a") == pytest.approx(4.5)


def test_buffer_bounded_state_and_non_finite():
    b = StreamBuffer(lateness=1e9, max_staged=8)
    for i in range(16):
        b.push("a", float(i), np.zeros(1, np.float32))
    k, ts, _ = b.ready()
    assert len(k) >= 8 and list(ts) == sorted(ts)
    with pytest.raises(ValueError, match="non-finite"):
        StreamBuffer(lateness=1.0).push("a", float("nan"),
                                        np.zeros(1, np.float32))


# --------------------------------------------- streamed load == JAX stream
@pytest.fixture(scope="module")
def streamed():
    """The same disordered trace through each package's pipeline."""
    out = {}
    for kind in ("jax", "port"):
        eng, S = _engine(kind)
        _, pipe = eng.create_stream(schema3(S), max_keys=16, capacity=64,
                                    bucket_size=8, lateness=2.0,
                                    flush_interval_s=0.001)
        cls = JSource if kind == "jax" else StreamSource
        src = source(400, cls=cls).with_disorder(jitter=1.5, seed=3)
        src.replay(pipe, batch_size=32)
        pipe.flush()
        assert pipe.last_error is None
        eng.deploy("f", SQL)
        out[kind] = (eng, pipe)
    yield out
    for eng, _ in out.values():
        eng.close()


def test_disordered_stream_gives_jax_table_state(streamed):
    (je, jp), (te, tp) = streamed["jax"], streamed["port"]
    tm, jm = tp.metrics(), jp.metrics()
    assert tm["reordered"] > 0 and tm["dropped_late"] == 0
    for f in ("reordered", "dropped_late", "events_flushed"):
        assert tm[f] == jm[f], f
    assert tm["events_flushed"] == 400
    assert int(te.tables["events"].state.total.sum()) == 400
    # capacity 64 over 400 Zipf events: the hot keys wrap their rings
    assert int(te.tables["events"].state.total.max()) > 64
    _assert_tables_equal(te.tables["events"], je.tables["events"])


def test_disordered_stream_gives_jax_features(streamed):
    (je, _), (te, _) = streamed["jax"], streamed["port"]
    t_max = float(te.tables["events"].watermark)
    keys = list(range(10))                         # two unknown keys
    ts = [t_max + 1.0 + i for i in range(10)]
    got, want = te.request("f", keys, ts), je.request("f", keys, ts)
    np.testing.assert_array_equal(got.status, want.status)
    assert got.n_unknown == 2
    for c in want:
        np.testing.assert_allclose(got[c], want[c], rtol=2e-4, atol=1e-4)
    got, want = te.query_offline("f"), je.query_offline("f")
    order = {}
    for tag, res, eng in (("port", got, te), ("jax", want, je)):
        rev = {i: k for k, i in eng.tables["events"].key_to_idx.items()}
        orig = np.asarray([rev[int(i)] for i in res["__key"]])
        order[tag] = np.lexsort((res["__ts"], orig))
    for c in ("s", "c", "mx", "last_lat", "__ts"):
        np.testing.assert_allclose(got[c][order["port"]],
                                   want[c][order["jax"]], rtol=2e-4,
                                   atol=1e-4, err_msg=c)


def test_stream_replay_online_offline_consistency():
    eng = Engine(OptFlags(assume_latest=False), device="cpu")
    _, pipe = eng.create_stream(schema3(), max_keys=16, capacity=128,
                                bucket_size=16, lateness=2.0)
    source(300).with_disorder(jitter=1.0, seed=5).replay(pipe,
                                                         batch_size=64)
    pipe.flush()
    eng.deploy("f", SQL)
    ok, errs = online_offline_consistency(eng, "f")
    assert ok, errs
    assert set(errs) == {"s", "c", "mx", "last_lat"}
    eng.close()


# ----------------------------------------------------- flusher and publish
def test_pipeline_background_flush_without_explicit_flush():
    t = Table(schema3(), max_keys=8, capacity=64, bucket_size=8,
              device="cpu")
    pipe = IngestPipeline(t, PipelineConfig(lateness=0.0,
                                            flush_interval_s=0.001))
    for i in range(20):
        pipe.push("u", float(i), np.asarray([i, 0, 0], np.float32))
    # lateness 0: every event is releasable; the flusher drains them
    assert pipe.wait_idle(timeout=30.0)
    assert int(t.state.total.sum()) == 20
    assert pipe.metrics()["flushes"] >= 1 and pipe.last_error is None
    assert pipe.warm() == 0                        # nothing to compile
    pipe.close()
    pipe.close()                                   # idempotent
    assert int(t.state.total.sum()) == 20


def test_snapshot_isolation_under_concurrent_flush():
    """A reader's captured snapshot stays internally consistent while
    flushes publish new versions concurrently (copy-on-write: a flush
    never writes into a published tensor)."""
    t = Table(schema3(), max_keys=8, capacity=256, bucket_size=16,
              device="cpu")
    pipe = IngestPipeline(t, PipelineConfig(lateness=0.0,
                                            flush_interval_s=0.0))
    src = source(1500, n_keys=8, seed=9)
    errors, versions, final = [], set(), {}
    stop, started, caught_up = (threading.Event(), threading.Event(),
                                threading.Event())

    def reader():
        while not stop.is_set():
            snap = t.snapshot()
            tot = snap.state.total.clone()
            ts = snap.state.ts.clone()
            vals = snap.state.values.clone()
            versions.add(snap.version)
            started.set()
            if "v" in final and snap.version >= final["v"]:
                caught_up.set()
            n_live = (ts > -1e38).sum(1)
            if not torch.equal(n_live, torch.clamp(tot, max=256).long()):
                errors.append(("live slots", snap.version))
            # nothing was written into the snapshot after it was taken
            if not (torch.equal(snap.state.total, tot)
                    and torch.equal(snap.state.ts, ts)
                    and torch.equal(snap.state.values, vals)):
                errors.append(("mutated", snap.version))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    assert started.wait(30.0)
    src.replay(pipe, batch_size=64)
    pipe.flush()
    final["v"] = t.version
    assert caught_up.wait(30.0)                    # read the last version
    stop.set()
    th.join(timeout=30.0)
    assert not th.is_alive()
    assert pipe.last_error is None
    assert not errors, errors[:5]
    assert t.version > 1 and len(versions) > 1
    pipe.close()


def test_versions_monotone_and_copying_insert_keeps_snapshots():
    t = Table(schema3(), max_keys=4, capacity=64, bucket_size=8,
              device="cpu")
    v0 = t.version
    t.insert(["a"], [1.0], np.zeros((1, 3), np.float32), donate=False)
    snap = t.snapshot()
    assert snap.version == v0 + 1
    t.insert(["a"], [2.0], np.ones((1, 3), np.float32), donate=False)
    assert t.version == snap.version + 1
    assert int(snap.state.total[0]) == 1           # the old version holds
    assert t.warm_ingest(max_batch=64) == 0


# ------------------------------------------------------------ engine API
def test_engine_insert_routes_through_attached_stream_atomically():
    eng = Engine(OptFlags(), device="cpu")
    t, pipe = eng.create_stream(schema3(), max_keys=8, capacity=64,
                                bucket_size=8, lateness=0.5)
    src = source(60, n_keys=4)
    order = np.argsort(src.ts, kind="stable")
    eng.insert("events", src.keys[order].tolist(), src.ts[order].tolist(),
               src.rows[order])
    assert int(t.state.total.sum()) == 60
    assert pipe.metrics()["events_flushed"] == 60
    t_last = float(src.ts.max())
    staged = pipe.buffer.n_staged
    with pytest.raises(ValueError, match="rejected atomically"):
        eng.insert("events", [0, 0], [t_last + 1.0, -1.0],
                   np.ones((2, 3), np.float32))
    assert pipe.buffer.n_staged == staged          # nothing staged
    eng.insert("events", [0, 0], [t_last + 1.0, t_last + 2.0],
               np.ones((2, 3), np.float32))
    assert int(t.state.total.sum()) == 62          # no double ingest
    eng.close()


def test_attach_to_nonempty_table_seeds_frontier_and_validation():
    eng = Engine(OptFlags(), device="cpu")
    t = eng.create_table(schema3(), max_keys=8, capacity=64, bucket_size=8)
    t.insert(["a"], [10.0], np.ones((1, 3), np.float32))
    pipe = eng.attach_stream("events", lateness=0.0, flush_interval_s=0.001)
    assert not pipe.push("a", 5.0, np.ones(3, np.float32))   # stale
    assert pipe.push("a", 11.0, np.ones(3, np.float32))
    pipe.flush()
    m = pipe.metrics()
    assert m["dropped_late"] == 1 and m["errors"] == 0
    assert int(t.state.total.sum()) == 2 and pipe.last_error is None
    with pytest.raises(ValueError, match="already has a stream"):
        eng.attach_stream("events")
    with pytest.raises(KeyError):
        eng.attach_stream("nope")
    eng.create_table(TableSchema("other", "user", "ts", COLS))
    with pytest.raises(ValueError, match="cfg or keywords"):
        eng.attach_stream("other", PipelineConfig(), lateness=1.0)
    eng.close()
    assert not eng.streams and pipe._stop           # close stops them


def test_handle_serves_across_republish_during_swap():
    eng = Engine(OptFlags(), device="cpu")
    _, pipe = eng.create_stream(schema3(), max_keys=8, capacity=64,
                                bucket_size=8, lateness=0.0,
                                flush_interval_s=0.001)
    src = source(120, n_keys=4)
    half = len(src.keys) // 2
    with pipe:
        pipe.push_batch(src.keys[:half].tolist(), src.ts[:half],
                        src.rows[:half])
        pipe.flush()
        v_before = pipe.version
        h1 = eng.deploy("q", SQL)
        rk, rt = [int(src.keys[0])], [float(src.ts.max()) + 1.0]
        f1 = h1.request(rk, rt)
        assert f1.version == 1 and f1.table_version >= v_before
        pipe.push_batch(src.keys[half:].tolist(), src.ts[half:],
                        src.rows[half:])
        h2 = eng.deploy("q", SQL.replace("20 PRECEDING", "5 PRECEDING"))
        pipe.flush()
        assert pipe.version > v_before
        f2 = h2.request(rk, rt)
        assert f2.version == 2 and f2.table_version == pipe.version
        f1b = h1.request(rk, rt)                   # retired, still serves
        assert f1b.version == 1 and f1b.table_version == f2.table_version
        assert float(f1b["c"][0]) >= float(f1["c"][0])
    eng.close()


# ------------------------------------------------- retention and preagg
def _wrapped_state(n_keys=6, capacity=32, bucket=8, seed=0):
    """A JAX table with wrapped, unwrapped and empty rings, and the same
    state as port tensors."""
    rng = np.random.default_rng(seed)
    jt = JTable(schema3(JSchema), max_keys=n_keys, capacity=capacity,
                bucket_size=bucket)
    counts = [100, 45, 32, 7, 0, 64][:n_keys]
    keys, ts = [], []
    for k, n in enumerate(counts):
        keys += [k] * n
        ts += sorted(rng.uniform(0, 100, n).tolist())
    order = np.argsort(np.asarray(ts), kind="stable")
    keys = [keys[i] for i in order]
    ts = np.asarray(ts, np.float32)[order]
    rows = rng.normal(0, 3, (len(keys), 3)).astype(np.float32)
    for s in range(0, len(keys), capacity):
        jt.insert(keys[s:s + capacity], ts[s:s + capacity],
                  rows[s:s + capacity])
    js = jt.state
    state = TableState(torch.from_numpy(np.array(js.values)),
                       torch.from_numpy(np.array(js.ts)),
                       torch.from_numpy(np.array(js.total)))
    pa = PreAggState(*(torch.from_numpy(np.array(getattr(jt.preagg, f)))
                       for f in PREAGG_FIELDS))
    return jt, state, pa


def _assert_preagg_equal(got, want):
    for f in ("min", "max", "count"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=2e-4,
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("cutoff", [-1.0, 40.0, 80.1, 99.5, 1e9])
def test_compact_expired_exact_against_jax(cutoff):
    jt, state, _ = _wrapped_state()
    js, jpa, jdrop = jcompact(jt.state, cutoff=cutoff, bucket_size=8)
    got, gpa, gdrop = compact_expired(state, cutoff=cutoff, bucket_size=8)
    assert gdrop == jdrop
    for f in ("values", "ts", "total"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(js, f)), err_msg=f)
    _assert_preagg_equal(gpa, jpa)
    # chunks of two keys give the same result
    got2, gpa2, gdrop2 = compact_expired(state, cutoff=cutoff, bucket_size=8,
                                         chunk_elems=2 * 32 * 3)
    assert gdrop2 == gdrop
    for f in ("values", "ts", "total"):
        assert torch.equal(getattr(got2, f), getattr(got, f)), f
    for f in PREAGG_FIELDS:
        assert torch.equal(getattr(gpa2, f), getattr(gpa, f)), f
    assert int(state.total[0]) == 100              # source untouched
    ok, err = preagg.verify_preagg(got, gpa, bucket_size=8)
    assert ok, err


def test_rebuild_and_verify_preagg_match_jax():
    jt, state, pa = _wrapped_state(seed=2)
    want = jpreagg.rebuild_preagg(jt.state, bucket_size=8)
    got = preagg.rebuild_preagg(state, bucket_size=8)
    _assert_preagg_equal(got, want)
    for chunk in (32 * 3, 5 * 32 * 3):             # 1 and 5 keys a chunk
        small = preagg.rebuild_preagg(state, bucket_size=8,
                                      chunk_elems=chunk)
        for f in PREAGG_FIELDS:
            assert torch.equal(getattr(small, f), getattr(got, f)), f
    # the incremental tier of the ingest against the rebuild
    j_ok, j_err = jpreagg.verify_preagg(jt.state, jt.preagg, bucket_size=8)
    t_ok, t_err = preagg.verify_preagg(state, pa, bucket_size=8,
                                       chunk_elems=2 * 4 * 3)
    assert t_ok and j_ok
    assert t_err == pytest.approx(j_err, abs=1e-4)
    # one corrupted, fully live bucket: both find it
    bad = PreAggState(*(getattr(pa, f).clone() for f in PREAGG_FIELDS))
    # 45 events in a ring of 32: slot 0 holds positions 32..39, all live
    k45 = int((state.total == 45).nonzero()[0, 0])
    bad.sum[k45, 0, 2] += 0.5
    jbad = jt.preagg.__class__(**{f: np.asarray(getattr(bad, f).numpy())
                                  for f in PREAGG_FIELDS})
    j_ok, j_err = jpreagg.verify_preagg(jt.state, jbad, bucket_size=8)
    t_ok, t_err = preagg.verify_preagg(state, bad, bucket_size=8)
    assert not t_ok and not j_ok
    assert t_err == pytest.approx(j_err, abs=1e-4) and t_err >= 0.5 - 1e-4
    assert preagg.preagg_memory_overhead(state, pa) == pytest.approx(
        jpreagg.preagg_memory_overhead(jt.state, jt.preagg))
    assert preagg.preagg_memory_overhead(state, None) == 0.0


def test_apply_retention_publishes_and_pipeline_hook():
    t = Table(schema3(), max_keys=4, capacity=64, bucket_size=8,
              device="cpu")
    t.insert(["u"] * 40, np.arange(40, dtype=np.float32),
             np.ones((40, 3), np.float32))
    v = t.version
    assert apply_retention(t, RetentionPolicy(ttl=0.0), now=39.0) == 0
    assert apply_retention(t, RetentionPolicy(ttl=10.0), now=39.0) == 29
    assert t.version == v + 1 and int(t.state.total[0]) == 11
    assert apply_retention(t, RetentionPolicy(ttl=10.0), now=39.0) == 0

    t2 = Table(schema3(), max_keys=4, capacity=64, bucket_size=8,
               device="cpu")
    pipe = IngestPipeline(t2, PipelineConfig(
        lateness=0.0, flush_interval_s=0.0,
        retention=RetentionPolicy(ttl=10.0, every_n_flushes=1)))
    for i in range(40):
        pipe.push("u", float(i), np.asarray([i, 0, 0], np.float32))
    pipe.flush()
    m = pipe.metrics()
    assert pipe.last_error is None and m["ttl_dropped"] > 0
    live = t2.state.ts[0][t2.state.ts[0] > -1e38]
    assert float(live.min()) >= 39.0 - 10.0
    ok, err = preagg.verify_preagg(t2.state, t2.preagg, bucket_size=8)
    assert ok, err
    pipe.close()


# ------------------------------------------------------------------- WAL
WAL_SCHEMA = ("events", "user", "ts", ("amount", "aux"))


def _batch(n, t0=0.0, seed=0):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(0, 4, n)]
    ts = (t0 + np.sort(rng.uniform(0, 10.0, n))).astype(np.float32)
    return keys, ts, rng.normal(size=(n, 2)).astype(np.float32)


def test_wal_roundtrip_rotation_and_resume(tmp_path):
    d = str(tmp_path / "wal")
    wal = WriteAheadLog(WalConfig(dir=d, segment_bytes=256, sync=False))
    batches = [_batch(4, t0=i * 100.0, seed=i) for i in range(6)]
    for k, t, r in batches:
        wal.append(k, t, r)
    wal.append([], np.zeros(0, np.float32), np.zeros((0, 2), np.float32))
    assert wal.metrics()["rotations"] >= 1 and wal.n_segments >= 2
    assert wal.metrics()["records"] == 6 and wal.metrics()["events"] == 24
    recs = list(wal.replay())
    assert len(recs) == 6
    for (k, t, r), (rk, rt, rr) in zip(batches, recs):
        assert k == rk
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(r, rr)
    wal.close()
    wal2 = WriteAheadLog(WalConfig(dir=d, sync=False))     # resumes
    wal2.append(*_batch(3, t0=900.0, seed=9))
    assert len(list(wal2.replay())) == 7
    wal2.close()


def test_wal_truncate_and_torn_tail(tmp_path):
    d = str(tmp_path / "wal")
    wal = WriteAheadLog(WalConfig(dir=d, segment_bytes=200, sync=False))
    for i in range(6):
        wal.append(*_batch(4, t0=i * 100.0, seed=i))
    n_before = wal.n_segments
    removed = wal.truncate(300.0)
    assert removed >= 1 and wal.n_segments == n_before - removed
    assert list(wal.replay())                      # the active one stays
    wal.close()

    d2 = str(tmp_path / "wal2")
    wal = WriteAheadLog(WalConfig(dir=d2, sync=False))
    k1, t1, r1 = _batch(6, seed=1)
    k2, t2, r2 = _batch(6, t0=50.0, seed=2)
    wal.append(k1, t1, r1)
    wal.append(k2, t2, r2)
    wal.close()
    seg = os.path.join(d2, sorted(os.listdir(d2))[0])
    with open(seg, "ab") as f:                     # half-written record
        f.write(struct.pack(">II", 9999, 0) + b"half a record")
    assert [r[0] for r in read_segment(seg)] == [k1, k2]
    data = bytearray(open(seg, "rb").read())
    rec1_len = 8 + struct.unpack(">II", bytes(data[:8]))[0]
    data[rec1_len + 12] ^= 0xFF                    # corrupt record 2
    with open(seg, "wb") as f:
        f.write(bytes(data))
    recs = read_segment(seg)
    assert len(recs) == 1 and recs[0][0] == k1


def test_jax_written_wal_replays_into_the_port(tmp_path):
    """A log the JAX pipeline wrote (disordered pushes, one dropped late
    event) replays through the port's pipeline into JAX's table state,
    and the port's own log reads back the same records."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    src = source(200, n_keys=4, seed=7, cls=JSource).with_disorder(
        jitter=1.0, seed=1)
    je = JEngine(JFlags())
    je.create_table(JSchema(*WAL_SCHEMA[:3], ("amount", "aux")),
                    max_keys=8, capacity=64, bucket_size=8)
    jpipe = je.attach_stream("events", JPipelineConfig(
        lateness=1.5, wal=JWalConfig(dir=jdir, sync=False)))
    jpipe.push_batch(src.keys.tolist(), src.ts, src.rows[:, :2])
    jpipe.flush(flush_all=True)
    assert not jpipe.push(int(src.keys[0]), float(src.ts.min()),
                          np.ones(2, np.float32))          # late: unlogged

    te = Engine(OptFlags(), device="cpu")
    te.create_table(TableSchema(*WAL_SCHEMA), max_keys=8, capacity=64,
                    bucket_size=8)
    tpipe = te.attach_stream("events", PipelineConfig(
        lateness=1.5, wal=WalConfig(dir=tdir, sync=False)))
    n = 0
    for keys, ts, rows in read_dir(jdir):
        n += tpipe.push_batch(keys, ts, rows)
    tpipe.flush(flush_all=True)
    assert n == 200 and tpipe.last_error is None
    _assert_tables_equal(te.tables["events"], je.tables["events"])
    assert [(k, t.tolist()) for k, t, _ in read_dir(tdir)] == [
        (k, t.tolist()) for k, t, _ in read_dir(jdir)]
    je.close()
    te.close()
