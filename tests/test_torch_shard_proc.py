"""Port process-backed shard runtime (``repro_torch.shard.proc``) against
the port's in-process sharded engine and the JAX package's
(``repro.shard``), on the same numpy inputs.

The six scenarios of ``tests/test_shard_proc.py`` run with the port's
workers on ``device="cpu"``: parity with the lifecycle and offline, the
broadcast dimension join, the cross-shard 2PC insert, a SIGKILLed worker
shed -> respawn -> recover, elastic ``add_shard`` into a new subprocess,
and a SIGKILL of the new worker in the middle of that migration. Two
more: a registered PREDICT model whose parameters cross as numpy, and
``worker_env``'s ``CUDA_VISIBLE_DEVICES`` / ``OMP_NUM_THREADS`` rules;
with them, the card as the default device (no worker without CUDA) and
the kernel library built once across processes.

Tolerances: the process port against the port's in-process engine bit
for bit (frames, statuses, ``query_offline``); against the JAX
in-process sharded engine exact for counts, statuses and joined
columns, ``rtol 2e-4`` (atol 1e-5) for sums and averages.

Every wait is bounded: on a worker's exit (``Popen.wait(timeout=)``), on
the engine's ``_await_ready``, on a thread's ``join(timeout=)``, or a
poll of the served status with a deadline; no case sleeps and then
asserts on timing.
"""
import os
import signal
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core import dsl as jdsl
from repro.core.engine import Engine as JEngine
from repro.core.optimizer import OptFlags as JFlags
from repro.featurestore.table import TableSchema as JSchema
from repro.shard import ShardConfig as JShardConfig
from repro.shard import ShardedEngine as JShardedEngine
from repro_torch.core import dsl
from repro_torch.core.results import (STATUS_DEGRADED, STATUS_OK,
                                      STATUS_SHED, STATUS_UNKNOWN_KEY)
from repro_torch.featurestore.table import TableSchema
from repro_torch.shard import ShardConfig, ShardedEngine
from repro_torch.shard.proc import backend as proc_backend

torch.set_num_threads(1)

JAX = types.SimpleNamespace(Schema=JSchema, dsl=jdsl)
PORT = types.SimpleNamespace(Schema=TableSchema, dsl=dsl)

SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c,
AVG(amount) OVER w AS a
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 10 PRECEDING AND CURRENT ROW)"""
EXACT = ("c", "risk")


def _schema(pk):
    return pk.Schema("events", key_col="user", ts_col="ts",
                     value_cols=("amount", "mkey"))


def _dim(pk):
    return pk.Schema("dim", key_col="mkey", ts_col="dts",
                     value_cols=("risk", "tier"))


def _events(n=400, n_keys=16, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    ts = np.sort(rng.uniform(0, 1000.0, n)).astype(np.float32)
    rows = np.stack(
        [rng.normal(size=n),
         rng.integers(0, 4, n).astype(np.float64)], -1).astype(np.float32)
    return keys, ts, rows


def _join_query(pk):
    d = pk.dsl
    return (d.QueryBuilder("events")
            .window("w", partition_by="user", order_by="ts", rows=10)
            .select(s=d.sum_(d.col("amount")).over("w"),
                    risk=d.tbl("dim").risk)
            .last_join("dim", on="mkey", order_by="dts"))


def _proc(**cfg_kw):
    return ShardedEngine(ShardConfig(**cfg_kw), backend="process",
                         device="cpu")


def _inproc(**cfg_kw):
    return ShardedEngine(ShardConfig(**cfg_kw), device="cpu")


def _equal(got, want, what=""):
    """Bit for bit, column by column, and the statuses."""
    assert sorted(got.columns) == sorted(want.columns), what
    np.testing.assert_array_equal(got.status, want.status, err_msg=what)
    for n in want.columns:
        np.testing.assert_array_equal(np.asarray(got[n]),
                                      np.asarray(want[n]),
                                      err_msg=f"{what} {n}")


def _close_to_jax(got, want, what=""):
    """The port against JAX: exact for counts, statuses and joins,
    rtol 2e-4 for sums and averages."""
    assert sorted(got.columns) == sorted(want.columns), what
    np.testing.assert_array_equal(got.status, np.asarray(want.status),
                                  err_msg=what)
    for n in want.columns:
        g = np.asarray(got[n], np.float64)
        w = np.asarray(want[n], np.float64)
        if n in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5,
                                       err_msg=f"{what} {n}")


def _sorted_offline(res, names):
    order = np.lexsort((res["__ts"], res["__key"]))
    return {c: np.asarray(res[c])[order]
            for c in list(names) + ["__key", "__ts"]}


def _kill(se, s):
    """SIGKILL shard ``s``'s worker and wait (bounded) until it is gone."""
    proc = se.shards[s].proc.proc
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=30)


def _until(fn, ok, timeout=90.0, poll=0.05):
    """Call ``fn`` until ``ok(result)`` or the deadline; the last result."""
    deadline = time.monotonic() + timeout
    out = fn()
    while not ok(out) and time.monotonic() < deadline:
        time.sleep(poll)
        out = fn()
    return out


def _recovered(se, restarts, timeout=90.0):
    """Wait (bounded) until the supervisor has respawned ``restarts``
    workers in all and every worker serves again."""
    _until(lambda: se.worker_restarts, lambda n: n >= restarts, timeout)
    return se.worker_restarts >= restarts and se._await_ready(timeout)


def _statuses(fr):
    return set(np.asarray(fr.status).tolist())


# ---------------------------------------------------------------------------
# the six scenarios of tests/test_shard_proc.py
# ---------------------------------------------------------------------------

def test_proc_parity_lifecycle_and_offline():
    """One subprocess per shard, the same API, bit-identical to the
    in-process port online and offline, close to JAX; redeploy and
    rollback run their control RPCs on every worker; telemetry crosses
    the transport."""
    keys, ts, rows = _events()
    se, ref = _proc(n_shards=2), _inproc(n_shards=2)
    jse = JShardedEngine(JShardConfig(n_shards=2))
    try:
        for eng, pk in ((se, PORT), (ref, PORT), (jse, JAX)):
            eng.create_table(_schema(pk), max_keys=64, capacity=64,
                             bucket_size=8)
            eng.insert("events", keys.tolist(), ts.tolist(), rows)
            eng.deploy("q", SQL)
        assert se.backend_kind == "process"
        rk, rt = list(range(16)), [2000.0] * 16
        got = se.request("q", rk, rt)
        _equal(got, ref.request("q", rk, rt), "online")
        _close_to_jax(got, jse.request("q", rk, rt), "online vs jax")
        assert len(got.version_vector) == 2
        # offline: the workers map dense indices to real keys themselves
        names = ("s", "c", "a")
        ob = _sorted_offline(se.query_offline("q"), names)
        oa = _sorted_offline(ref.query_offline("q"), names)
        oj = _sorted_offline(jse.query_offline("q"), names)
        for c in oa:
            np.testing.assert_array_equal(ob[c], oa[c], err_msg=c)
        np.testing.assert_array_equal(ob["__key"], oj["__key"])
        np.testing.assert_array_equal(ob["c"], oj["c"])
        np.testing.assert_allclose(ob["s"], oj["s"], rtol=2e-4, atol=1e-5)
        # redeploy + rollback: serialized control RPCs on every worker
        for eng in (se, ref):
            eng.deploy("q", SQL.replace("10 PRECEDING", "5 PRECEDING"))
        assert se.handle("q").version == 2
        _equal(se.request("q", rk, rt), ref.request("q", rk, rt), "v2")
        se.rollback("q")
        _equal(se.request("q", rk, rt), got, "rolled back")
        # control-plane reads cross the transport
        dec = se.latency_decomposition()
        assert dec["n_shards"] == 2 and dec["worker_restarts"] == 0
        assert dec["n_requests"] >= 48
        assert all(isinstance(sub.stats.snapshot(), dict)
                   for sub in se.shards)
        assert "process backend" in se.explain("q")
        assert "worker-subprocess cpu" in se.explain("q")
        with pytest.raises(NotImplementedError, match="worker"):
            se.tables_of("events")
    finally:
        se.close()
        ref.close()
    assert all(c.proc.proc.poll() is not None for c in se.backend.clients)


def test_proc_broadcast_dimension_join():
    """Replicated dimension ingest is ONE serialized payload fanned to
    every worker; LAST JOIN probes resolve on the probing shard."""
    keys, ts, rows = _events()
    drow = np.stack([np.arange(4) * 0.1, np.arange(4) * 1.0],
                    -1).astype(np.float32)
    se, ref = _proc(n_shards=2), _inproc(n_shards=2)
    jse = JShardedEngine(JShardConfig(n_shards=2))
    try:
        for eng, pk in ((se, PORT), (ref, PORT), (jse, JAX)):
            eng.create_table(_schema(pk), max_keys=64, capacity=64,
                             bucket_size=8)
            eng.create_table(_dim(pk), max_keys=16, capacity=16,
                             bucket_size=8, replicate=True)
            eng.insert("dim", list(range(4)), [1.0] * 4, drow)
            eng.insert("events", keys.tolist(), ts.tolist(), rows)
            eng.deploy("jq", _join_query(pk))
        rk, rt = list(range(8)), [2000.0] * 8
        fr = se.request("jq", rk, rt, rows=rows[:8])
        assert (fr.status == STATUS_OK).all()
        np.testing.assert_array_equal(fr.columns["risk"],
                                      rows[:8, 1] * np.float32(0.1))
        _equal(fr, ref.request("jq", rk, rt, rows=rows[:8]), "join")
        _close_to_jax(fr, jse.request("jq", rk, rt, rows=rows[:8]),
                      "join vs jax")
        st = se.handle("jq").join_staleness()["dim"]
        assert st["match_rate"] == 1.0
        assert st == ref.handle("jq").join_staleness()["dim"]
    finally:
        se.close()
        ref.close()


def _txn(eng, pk):
    """The 2PC scenario on one engine: what each step returned."""
    pipe = eng.attach_stream("events", lateness=1.0)
    ka = next(k for k in range(100) if eng.shard_of(k) == 0)
    kb = next(k for k in range(100) if eng.shard_of(k) == 1)
    eng.insert("events", [ka], [100.0], np.ones((1, 2), np.float32))
    pipe.flush()
    eng.deploy("q", SQL)
    with pytest.raises(ValueError, match="rejected atomically"):
        eng.insert("events", [ka, kb], [10.0, 200.0],
                   np.ones((2, 2), np.float32))
    pipe.flush()
    out = [np.asarray(eng.request("q", [kb], [500.0]).status).tolist()]
    eng.insert("events", [ka, kb], [300.0, 300.0],
               np.ones((2, 2), np.float32))
    pipe.flush()
    fr = eng.request("q", [ka, kb], [500.0, 500.0])
    out += [np.asarray(fr.status).tolist(), np.asarray(fr["c"]).tolist(),
            np.asarray(fr["s"]).tolist()]
    return out


def test_proc_transactional_insert_all_or_nothing():
    """A cross-shard insert into a stream-attached table: one shard's
    unrepairably-late slice rejects the WHOLE batch (the other shard's
    prepared slice is aborted, not applied); a valid batch commits on
    every involved shard."""
    se, ref = _proc(n_shards=2), _inproc(n_shards=2)
    jse = JShardedEngine(JShardConfig(n_shards=2))
    try:
        for eng, pk in ((se, PORT), (ref, PORT), (jse, JAX)):
            eng.create_table(_schema(pk), max_keys=64, capacity=64,
                             bucket_size=8)
        got = _txn(se, PORT)
        assert got[0] == [STATUS_UNKNOWN_KEY]          # nothing staged
        assert got[1] == [STATUS_OK, STATUS_OK] and got[2] == [2.0, 1.0]
        assert got == _txn(ref, PORT) == _txn(jse, JAX)
    finally:
        se.close()
        ref.close()


def test_proc_killed_worker_shed_respawn_recover():
    """SIGKILL one worker mid-service: its keys degrade (stale tier) or
    the batch sheds whole — worker_down, never a hang or a raw
    exception — the supervisor respawns it, replays the catalog and
    deployments, and serving resumes; the lost partitioned data comes
    back through the stream, bit-identical to the in-process port."""
    keys, ts, rows = _events(n=200, n_keys=8)
    se, ref = _proc(n_shards=2), _inproc(n_shards=2)
    try:
        for eng in (se, ref):
            eng.create_table(_schema(PORT), max_keys=64, capacity=64,
                             bucket_size=8)
            pipe = eng.attach_stream("events", flush_interval_s=0.05)
            pipe.push_batch(keys, ts, rows)
            pipe.flush()
            eng.deploy("q", SQL)
        rk, rt = list(range(8)), [2000.0] * 8
        assert (se.request("q", rk, rt).status == STATUS_OK).all()
        _kill(se, 1)
        t0 = time.perf_counter()
        st = _statuses(se.request("q", rk, rt))
        assert time.perf_counter() - t0 < 30.0     # answered, not hung
        assert st <= {STATUS_OK, STATUS_DEGRADED} or st == {STATUS_SHED}
        assert _recovered(se, 1)
        fr = _until(lambda: se.request("q", rk, rt),
                    lambda f: _statuses(f) <= {STATUS_OK,
                                               STATUS_UNKNOWN_KEY})
        assert _statuses(fr) <= {STATUS_OK, STATUS_UNKNOWN_KEY}
        assert se.worker_restarts == 1
        m = se.resources.metrics()
        assert m["served_degraded"] >= 1 or m["shed_worker_down"] >= 1
        # re-ingest: the respawned shard's keys come back
        for eng in (se, ref):
            eng.streams["events"].push_batch(keys, ts + 3000.0, rows)
            eng.streams["events"].flush()
        fr = se.request("q", rk, [9000.0] * 8)
        assert (fr.status == STATUS_OK).all()
        ones = [k for k in rk if se.shard_of(k) == 0]
        _equal(se.request("q", ones, [9000.0] * len(ones)),
               ref.request("q", ones, [9000.0] * len(ones)),
               "the shard that lived")
    finally:
        se.close()
        ref.close()


def test_proc_elastic_add_shard():
    """add_shard spawns a NEW subprocess, replays the catalog into it,
    seeds replicas, rebuilds deployments and migrates key ranges:
    outputs identical before and after, equal to the in-process port
    grown the same way."""
    keys, ts, rows = _events()
    drow = np.stack([np.arange(4) * 0.1, np.arange(4) * 1.0],
                    -1).astype(np.float32)
    se, ref = _proc(n_shards=2), _inproc(n_shards=2)
    try:
        for eng in (se, ref):
            eng.create_table(_schema(PORT), max_keys=64, capacity=64,
                             bucket_size=8)
            eng.create_table(_dim(PORT), max_keys=16, capacity=16,
                             bucket_size=8, replicate=True)
            eng.insert("dim", list(range(4)), [1.0] * 4, drow)
            eng.insert("events", keys.tolist(), ts.tolist(), rows)
            eng.deploy("jq", _join_query(PORT))
        rk, rt = list(range(16)), [2000.0] * 16
        before = se.request("jq", rk, rt, rows=rows[:16])
        assert (before.status == STATUS_OK).all()
        assert se.add_shard() == ref.add_shard() == 2
        assert se.n_shards == 3
        after = se.request("jq", rk, rt, rows=rows[:16])
        _equal(after, before, "after add_shard")
        _equal(after, ref.request("jq", rk, rt, rows=rows[:16]),
               "grown in process")
        assert se._routing.shard_counts().get(2, 0) > 0
        res = se.query_offline("jq")
        assert len(res["__version_vector"]) == 3
        want = ref.query_offline("jq")
        for c in ("s", "risk", "__key", "__ts"):
            np.testing.assert_array_equal(
                _sorted_offline(res, ("s", "risk"))[c],
                _sorted_offline(want, ("s", "risk"))[c], err_msg=c)
    finally:
        se.close()
        ref.close()


def test_proc_sigkill_during_add_shard_migration_bit_identical():
    """SIGKILL the NEW worker while add_shard's arc-batch migration is
    feeding it: the interrupted batch retries (the source keeps its
    stale copy, ``migrate_in`` prefix-skips what already landed,
    ``_reshard`` waits out the respawn, the WAL replays), so add_shard
    completes and the 3-shard output is bit-identical to an in-process
    port grown the same way without a failure, and close to JAX's."""
    keys, ts, rows = _events(n=300, n_keys=16)
    wal_dir = tempfile.mkdtemp(prefix="mig-wal-")
    se = _proc(n_shards=2, wal_dir=wal_dir, standby_workers=1,
               migrate_batch_arcs=2)
    ref = _inproc(n_shards=2)
    jse = JShardedEngine(JShardConfig(n_shards=2))
    th = None
    try:
        for eng, pk in ((se, PORT), (ref, PORT), (jse, JAX)):
            eng.create_table(_schema(pk), max_keys=64, capacity=64,
                             bucket_size=8)
            pipe = eng.attach_stream("events", flush_interval_s=0.05)
            pipe.push_batch(keys, ts, rows)
            pipe.flush()
            eng.deploy("q", SQL)
        rk, rt = list(range(16)), [2000.0] * 16
        assert (se.request("q", rk, rt).status == STATUS_OK).all()
        grown, errors = [], []

        def grow():
            try:
                grown.append(se.add_shard())
            except BaseException as e:           # asserted below
                errors.append(e)

        th = threading.Thread(target=grow)
        th.start()
        # once >= 1 arc flipped to the new shard we are inside the
        # arc-batch copy loop (~32 batches of 2 arcs over 64 vnodes)
        flipped = _until(lambda: se._routing.shard_counts().get(2, 0),
                         lambda n: n > 0 or not th.is_alive(), 120.0,
                         poll=0.002)
        assert flipped > 0, "migration never started"
        _kill(se, 2)
        th.join(timeout=180)
        assert not th.is_alive(), "add_shard hung after mid-copy kill"
        assert not errors, errors
        assert grown == [2] and se.n_shards == 3
        assert _recovered(se, 1)
        fr = _until(lambda: se.request("q", rk, rt),
                    lambda f: (f.status == STATUS_OK).all())
        assert (fr.status == STATUS_OK).all()
        ref.add_shard()
        jse.add_shard()
        _equal(fr, ref.request("q", rk, rt), "after the kill")
        _close_to_jax(fr, jse.request("q", rk, rt), "vs jax")
        assert se._routing.shard_counts().get(2, 0) > 0
    finally:
        if th is not None:
            th.join(timeout=180)
        se.close()
        ref.close()
        import shutil
        shutil.rmtree(wal_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# PREDICT under the process backend; the worker's environment
# ---------------------------------------------------------------------------

SCORER = '''
def scorer(p, feats):
    """Column by column, so a row's score does not depend on its batch;
    the same code runs on torch tensors and on JAX arrays."""
    mu, sd, w, b = p
    z = (feats - mu) / sd * w
    acc = b + z[:, 0]
    for j in range(1, z.shape[1]):
        acc = acc + z[:, j]
    return acc
'''
PREDICT_SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c,
PREDICT(m, s, c) AS score
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 10 PRECEDING AND CURRENT ROW)"""


def test_proc_registered_model_params_cross_as_numpy(tmp_path,
                                                     monkeypatch):
    """A module-level scorer crosses by reference and its tensor
    parameters as numpy; each worker rebuilds them as tensors on its own
    device. Scores bit-identical to the in-process port, close to JAX."""
    import importlib
    (tmp_path / "proc_scorer.py").write_text(SCORER)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    fn = importlib.import_module("proc_scorer").scorer
    rng = np.random.default_rng(3)
    params = (np.asarray([0.5, 3.0], np.float32),
              np.asarray([2.0, 4.0], np.float32),
              rng.normal(size=2).astype(np.float32),
              np.float32(0.25))
    tparams = tuple(torch.tensor(np.asarray(p)) for p in params)
    keys, ts, rows = _events()
    se, ref = _proc(n_shards=2), _inproc(n_shards=2)
    jeng = JEngine(JFlags())
    try:
        for eng, pk, p in ((se, PORT, tparams), (ref, PORT, tparams),
                           (jeng, JAX, params)):
            eng.create_table(_schema(pk), max_keys=64, capacity=64,
                             bucket_size=8)
            eng.insert("events", keys.tolist(), ts.tolist(), rows)
            eng.register_model("m", fn, p)
            eng.deploy("p", PREDICT_SQL)
        rk, rt = list(range(16)), [2000.0] * 16
        got = se.request("p", rk, rt)
        assert (got.status == STATUS_OK).all()
        _equal(got, ref.request("p", rk, rt), "predict")
        want = jeng.request("p", rk, rt)
        np.testing.assert_array_equal(got["c"], np.asarray(want["c"]))
        np.testing.assert_allclose(got["score"], np.asarray(want["score"]),
                                   rtol=2e-4, atol=1e-5)
        # a respawned worker gets the model from the catalog replay
        _kill(se, 0)
        assert _recovered(se, 1)
        assert se.worker_restarts == 1
        fr = _until(lambda: se.request("p", rk, rt),
                    lambda f: STATUS_SHED not in _statuses(f)
                    and STATUS_DEGRADED not in _statuses(f))
        assert np.isfinite(fr["score"]).all()
    finally:
        se.close()
        ref.close()
        sys.modules.pop("proc_scorer", None)


def test_proc_degraded_and_shed_frames_carry_the_predict_output(
        tmp_path, monkeypatch):
    """Under the process backend too, a degraded frame answers a down
    shard's keys with every column they were last served with, the
    PREDICT output included, and a shed frame has it zero-filled (JAX's
    frames lack ``score``: ``tests/test_torch_shard.py`` states the
    difference). Shard 1's queue is retired, so its sub-batches shed
    worker_down without a kill."""
    import importlib
    (tmp_path / "proc_scorer.py").write_text(SCORER)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    fn = importlib.import_module("proc_scorer").scorer
    rng = np.random.default_rng(3)
    params = tuple(torch.tensor(np.asarray(p)) for p in (
        np.asarray([0.5, 3.0], np.float32),
        np.asarray([2.0, 4.0], np.float32),
        rng.normal(size=2).astype(np.float32), np.float32(0.25)))
    keys, ts, rows = _events()
    se = _proc(n_shards=2, degraded_cache_keys=64)
    try:
        se.create_table(_schema(PORT), max_keys=64, capacity=64,
                        bucket_size=8)
        se.insert("events", keys.tolist(), ts.tolist(), rows)
        se.register_model("m", fn, params)
        se.deploy("p", PREDICT_SQL)
        rk, rt = list(range(8)), [2000.0] * 8
        fresh = se.request("p", rk, rt)
        assert (fresh.status == STATUS_OK).all()
        down = np.asarray([se.shard_of(k) == 1 for k in rk])
        assert down.any() and not down.all()
        se.router.retire_queue(1)
        deg = se.request("p", rk, rt)
        assert (deg.status[down] == STATUS_DEGRADED).all()
        assert (deg.status[~down] == STATUS_OK).all()
        assert sorted(deg.columns) == ["c", "s", "score"]
        for n in deg.columns:
            np.testing.assert_array_equal(np.asarray(deg[n]),
                                          np.asarray(fresh[n]), err_msg=n)
        cold = next(k for k in range(8, 200)
                    if se.shard_of(k) == 1 and k not in rk)
        shed = se.request("p", rk + [cold], rt + [2000.0])
        assert (shed.status == STATUS_SHED).all()
        assert sorted(shed.columns) == ["c", "s", "score"]
        assert not np.asarray(shed["score"]).any()
    finally:
        se.close()
        sys.modules.pop("proc_scorer", None)


WRAP_SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c,
AVG(mkey) OVER w AS a, MAX(amount) OVER w AS mx, MIN(mkey) OVER w AS mn
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             RANGE BETWEEN 600 PRECEDING AND CURRENT ROW)"""


def test_proc_reshard_of_keys_that_wrapped_their_rings():
    """Capacity 16, bucket 4, Zipf keys far past 16 events, a window on
    the pre-aggregate tier; 2 -> 3 -> 2 worker processes, then one more
    event per key. The workers carry each migrated key's total with its
    rows and seat it at its source's ring positions, so the frames equal
    the port's unsharded engine bit for bit throughout."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    rng = np.random.default_rng(3)
    n, n_keys = 1500, 12
    p = 1.0 / np.arange(1, n_keys + 1)
    keys = rng.choice(n_keys, n, p=p / p.sum())
    ts = np.sort(rng.uniform(0, 1000.0, n)).astype(np.float32)
    rows = np.stack([rng.normal(size=n), rng.uniform(0, 8, n)],
                    -1).astype(np.float32)
    ref = Engine(OptFlags(), device="cpu")
    se = _proc(n_shards=2)
    try:
        for eng in (ref, se):
            eng.create_table(_schema(PORT), max_keys=16, capacity=16,
                             bucket_size=4)
            eng.insert("events", keys.tolist(), ts.tolist(), rows)
            eng.deploy("q", WRAP_SQL)
        rk, rt = list(range(n_keys)), [1000.5] * n_keys
        owners0 = [se.shard_of(k) for k in rk]
        _equal(se.request("q", rk, rt), ref.request("q", rk, rt),
               "before")
        se.add_shard()
        se.remove_shard(0)
        moved = [k for k, o in zip(rk, owners0) if se.shard_of(k) != o]
        tot = ref.tables["events"].state.total
        assert any(int(tot[ref.tables["events"].key_to_idx[k]]) > 16
                   for k in moved)
        _equal(se.request("q", rk, rt), ref.request("q", rk, rt),
               "after reshard")
        extra = np.random.default_rng(5).normal(
            size=(n_keys, 2)).astype(np.float32)
        for eng in (ref, se):
            eng.insert("events", rk, [1000.25] * n_keys, extra)
        _equal(se.request("q", rk, rt), ref.request("q", rk, rt),
               "after reshard and one more event")
    finally:
        se.close()
        ref.close()


def test_process_engine_defaults_to_cuda_and_spawns_nothing_without_it(
        monkeypatch):
    """``ShardedEngine(backend="process")`` asks for the card by default
    and raises before any worker starts where CUDA is absent: no worker
    comes up on the CPU by itself."""
    import subprocess
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedEngine(ShardConfig(n_shards=2, standby_workers=1),
                      backend="process")
    assert spawned == []


def test_worker_env_pins_one_card_per_shard(monkeypatch):
    """With several cards, shard s's worker sees only card s % D (through
    the parent's own CUDA_VISIBLE_DEVICES list when it has one); with one
    card, the CPU, pinning off or a standby, nothing is pinned.
    OMP_NUM_THREADS is 1 unless the caller set it; no JAX or XLA setting
    and no REPRO_SHARD_BACKEND reaches a worker."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_"
                                    "count=4")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("REPRO_SHARD_BACKEND", "process")
    env = proc_backend.worker_env

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [env(s, "cuda")["CUDA_VISIBLE_DEVICES"] for s in range(6)] == \
        ["0", "1", "2", "3", "0", "1"]
    e = env(5, "cuda")
    assert e["OMP_NUM_THREADS"] == "1"
    assert e["REPRO_SHARD_WORKER_ID"] == "5"
    assert e["REPRO_SHARD_DEVICE"] == "cuda"
    assert "XLA_FLAGS" not in e and "JAX_PLATFORMS" not in e
    assert "REPRO_SHARD_BACKEND" not in e
    import repro_torch
    assert e["PYTHONPATH"].split(os.pathsep)[0] == \
        os.path.dirname(os.path.dirname(os.path.abspath(
            repro_torch.__file__)))
    for unpinned in (env(1, "cuda", pin_devices=False), env(-1, "cuda"),
                     env(1, "cpu")):
        assert "CUDA_VISIBLE_DEVICES" not in unpinned
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert [env(s, "cuda")["CUDA_VISIBLE_DEVICES"] for s in range(5)] == \
        ["4", "5", "6", "7", "4"]
    assert env(-1, "cuda")["CUDA_VISIBLE_DEVICES"] == "4,5,6,7"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert "CUDA_VISIBLE_DEVICES" not in env(3, "cuda")
    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    assert env(0, "cuda")["OMP_NUM_THREADS"] == "8"


BUILD_SCRIPT = '''
import sys, time, types
from pathlib import Path
from repro_torch.kernels import _build
root, log, go = Path(sys.argv[1]), sys.argv[2], Path(sys.argv[3])


def fake_build(out):
    with open(log, "a") as f:
        f.write("build\\n")
    time.sleep(0.5)              # a slow nvcc: the other process waits
    out.write_bytes(b"")


class FakeLib:
    def __init__(self, path):
        self.rt_error_string = types.SimpleNamespace()


_build.BUILD_ROOT, _build._build, _build.ctypes.CDLL = root, fake_build, \\
    FakeLib
deadline = time.monotonic() + 60.0
while not go.exists() and time.monotonic() < deadline:
    time.sleep(0.002)            # both processes start their build together
_build.library()
print(_build.builds)
'''


def test_kernel_library_builds_once_across_processes(tmp_path):
    """Two processes (shard workers) whose first launches race each other
    build the library once: the first takes the digest directory's
    flock and builds, the second waits and loads what it built (the
    build is stubbed: no nvcc on this machine)."""
    import subprocess
    script = tmp_path / "first_launch.py"
    script.write_text(BUILD_SCRIPT)
    log, go = tmp_path / "builds.log", tmp_path / "go"
    env = proc_backend.worker_env(0, "cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "kernels"), str(log),
         str(go)], env=env, stdout=subprocess.PIPE, text=True)
        for _ in range(2)]
    go.write_text("")
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert sorted(int(o.strip()) for o in outs) == [0, 1]
    assert log.read_text() == "build\n"
    built = list((tmp_path / "kernels").glob("*/librepro_torch_kernels.so"))
    assert len(built) == 1


def test_standby_pool_defaults_to_the_card():
    """``StandbyPool``'s workers prewarm for the card unless the caller
    names the CPU, as every entry point of the port does; a pool of no
    workers spawns no process."""
    from repro_torch.shard.proc.standby import StandbyPool
    pool = StandbyPool(0)
    try:
        assert pool.device == "cuda"
        assert pool.stats["spawned"] == 0
    finally:
        pool.close()
    assert StandbyPool(0, device="cpu").device == "cpu"
