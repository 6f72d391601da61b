"""Port sharded serving runtime (``repro_torch.shard``) against the JAX
package's (``repro.shard``) on the same numpy inputs.

Each in-process scenario of ``tests/test_shard.py`` (routing stability,
empty shards offline, sharded == unsharded on a disordered streamed load,
LAST JOIN against a replicated table and the refusal of a partitioned
one, whole-batch shedding at admission and at dequeue, in-flight
backpressure, hot swap / canary / promote / rollback with the version
vector, FeatureServer end to end, elastic reshard under live traffic,
modulo cannot reshard, cross-shard insert all-or-nothing, router
shutdown drains), the degraded ladder of ``tests/test_chaos.py`` and the
2PC prepare TTL of ``tests/test_wal.py`` runs on both packages, and the
results are compared. So do the ring's hashes and owners, the migration
primitives, a reshard whose keys wrap their rings, the placement
function, ``DeploymentHandle.request(n_live=)`` and
``ServerConfig.hedge_after_s``. The process backend's scenarios are in
``tests/test_torch_shard_proc.py`` and ``tests/test_torch_chaos.py``;
here only the three ways to select it.

Tolerances: exact for routing, owners, status, versions, version
vectors, counters, counts, min/max, first/last and joined columns, and
for the port against its own unsharded engine; ``rtol 2e-4`` (atol
1e-5) for sums and averages against JAX. After a reshard, a key whose
ring had wrapped keeps its ring positions on its new shard in the port,
which then equals its unsharded engine bit for bit; JAX re-inserts it at
other positions, so its pre-aggregate buckets group other events, and
its sums there are held to ``rtol 2e-4``.

Threaded tests wait on events and bounded joins; none sleeps and then
asserts on timing alone.
"""
import gc
import os
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch

from repro.core import dsl as jdsl
from repro.core.engine import Engine as JEngine
from repro.core.optimizer import OptFlags as JFlags
from repro.core.results import RequestContext as JCtx
from repro.featurestore.table import TableSchema as JSchema
from repro.serving.batcher import BatcherConfig as JBatcherConfig
from repro.serving.server import FeatureServer as JFeatureServer
from repro.serving.server import ServerConfig as JServerConfig
from repro.shard import (AdmissionConfig as JAdmission,
                         ShardConfig as JShardConfig,
                         ShardedEngine as JShardedEngine)
from repro.shard import migrate as jmigrate
from repro.shard import ring as jring
from repro.shard import router as jrouter
from repro_torch.core import dsl
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags
from repro_torch.core.results import (STATUS_DEGRADED, STATUS_OK,
                                      STATUS_SHED, FeatureFrame,
                                      RequestContext)
from repro_torch.featurestore.table import Table, TableSchema
from repro_torch.serving import BatcherConfig, FeatureServer, ServerConfig
from repro_torch.shard import (AdmissionConfig, ShardConfig, ShardedEngine,
                               migrate, ring, router, shard_device)
from repro_torch.shard.router import ShardRouter, SubBatch

torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    name="jax", Engine=JEngine, Flags=JFlags, Schema=JSchema, Ctx=JCtx,
    Sharded=JShardedEngine, Cfg=JShardConfig, Admission=JAdmission,
    dsl=jdsl, Server=JFeatureServer, ServerCfg=JServerConfig,
    BatcherCfg=JBatcherConfig, migrate=jmigrate, kw={})
PORT = types.SimpleNamespace(
    name="port", Engine=Engine, Flags=OptFlags, Schema=TableSchema,
    Ctx=RequestContext, Sharded=ShardedEngine, Cfg=ShardConfig,
    Admission=AdmissionConfig, dsl=dsl, Server=FeatureServer,
    ServerCfg=ServerConfig, BatcherCfg=BatcherConfig, migrate=migrate,
    kw={"device": "cpu"})
PKGS = (JAX, PORT)

SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c,
AVG(amount) OVER w AS a
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 10 PRECEDING AND CURRENT ROW)"""
EXACT = ("c", "risk", "mx", "mn", "lst")


def _schema(pk):
    return pk.Schema("events", key_col="user", ts_col="ts",
                     value_cols=("amount", "mkey"))


def _events(n=600, n_keys=24, n_dim_keys=8, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    ts = np.sort(rng.uniform(0, 1000.0, n)).astype(np.float32)
    rows = np.stack(
        [rng.normal(size=n),
         rng.integers(0, n_dim_keys, n).astype(np.float64)],
        -1).astype(np.float32)
    return keys, ts, rows


def _disorder(keys, ts, rows, lateness, seed=1):
    """Shuffle events within a bounded disorder window (repairable)."""
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0, 0.45 * lateness, len(ts))
    order = np.argsort(ts + jitter.astype(np.float32), kind="stable")
    return keys[order], ts[order], rows[order]


def _sharded(pk, cfg=None, **cfg_kw):
    return pk.Sharded(cfg if cfg is not None else pk.Cfg(**cfg_kw),
                      **pk.kw)


def _loaded(pk, n_shards=2, **cfg_kw):
    keys, ts, rows = _events()
    se = _sharded(pk, n_shards=n_shards, **cfg_kw)
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    se.insert("events", keys.tolist(), ts.tolist(), rows)
    se.deploy("q", SQL)
    return se


def _cols(fr):
    return {n: np.asarray(fr[n]) for n in fr}


def _assert_close(got, want, what=""):
    """Port against JAX: exact for counts and selects, rtol 2e-4 for
    sums and averages."""
    assert sorted(got) == sorted(want), what
    for n in want:
        g = np.asarray(got[n], np.float64)
        w = np.asarray(want[n], np.float64)
        assert g.shape == w.shape, (what, n)
        if n in EXACT or n.startswith("__"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5,
                                       err_msg=f"{what} {n}")


def _assert_equal(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for n in want:
        np.testing.assert_array_equal(np.asarray(got[n]),
                                      np.asarray(want[n]),
                                      err_msg=f"{what} {n}")


# ---------------------------------------------------------------------------
# the ring and the router's hashes
# ---------------------------------------------------------------------------

KEY_SETS = {
    "int": np.arange(-50, 400, dtype=np.int64),
    "str": np.asarray([f"user-{i}" for i in range(300)], dtype=object),
    "np_str": np.asarray([f"user-{i}" for i in range(300)]),
    "mixed": np.asarray([f"u{i}" for i in range(40)] + [1.5, 2.25, -3.75],
                        dtype=object),
}


@pytest.mark.parametrize("kind", sorted(KEY_SETS))
def test_hashes_ring_and_route_table_equal_jax(kind):
    keys = KEY_SETS[kind]
    assert np.array_equal(ring.key_hashes(keys), jring.key_hashes(keys))
    assert [ring.key_hash(k) for k in keys] == \
        [jring.key_hash(k) for k in keys]
    # numpy scalars hash as their Python value on both paths
    assert [ring.key_hash(k) for k in keys.tolist()] == \
        [ring.key_hash(k) for k in keys]
    for n in (1, 2, 4, 7):
        assert np.array_equal(router.shard_ids(keys, n),
                              jrouter.shard_ids(keys, n))
        assert [router.shard_of(k, n) for k in keys] == \
            list(router.shard_ids(keys, n))
    r, jr = ring.HashRing(range(4), vnodes=16), jring.HashRing(range(4),
                                                               vnodes=16)
    assert np.array_equal(r.points, jr.points)
    assert np.array_equal(r.owners_of(keys), jr.owners_of(keys))
    for new, jnew in ((r.with_shard(4), jr.with_shard(4)),
                      (r.without_shard(1), jr.without_shard(1))):
        assert new.shard_set == jnew.shard_set
        assert np.array_equal(new.owners_of(keys), jnew.owners_of(keys))
        rt = ring.RouteTable.merged(r, new)
        jrt = jring.RouteTable.merged(jr, jnew)
        assert np.array_equal(rt.points, jrt.points)
        assert np.array_equal(rt.owners_of(keys), jrt.owners_of(keys))
        assert np.array_equal(rt.owners_of(keys), r.owners_of(keys))
        plan = rt.plan_against(new)
        assert plan == jrt.plan_against(jnew) and plan
        # flipping every planned arc routes exactly like the new ring
        for a in plan:
            rt.set_owner([a], new.owner_of_hash(int(rt.points[a])))
        assert np.array_equal(rt.owners_of(keys), new.owners_of(keys))
        assert [rt.owner(k) for k in keys[:20]] == \
            list(new.owners_of(keys[:20]))
    mod, jmod = ring.ModuloRouting(3), jring.ModuloRouting(3)
    assert np.array_equal(mod.owners_of(keys), jmod.owners_of(keys))


# ---------------------------------------------------------------------------
# routing invariants
# ---------------------------------------------------------------------------

def _owner_map(pk):
    keys, ts, rows = _events()
    se = _sharded(pk, n_shards=4)
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    se.insert("events", keys.tolist(), ts.tolist(), rows)
    se.deploy("q", SQL)

    def serving_shard(key):
        before = [h.metrics.requests for h in se.handle("q").handles]
        se.request("q", [key], [2000.0])
        after = [h.metrics.requests for h in se.handle("q").handles]
        hits = [i for i, (b, a) in enumerate(zip(before, after)) if a > b]
        assert len(hits) == 1
        return hits[0]

    owner = {k: serving_shard(k) for k in range(8)}
    assert owner == {k: se.shard_of(k) for k in range(8)}
    # more publishes (ingest) and a redeploy move no key
    se.insert("events", keys[:50].tolist(), (ts[:50] + 5000.0).tolist(),
              rows[:50])
    se.deploy("q", SQL.replace("10 PRECEDING", "5 PRECEDING"))
    assert {k: serving_shard(k) for k in range(8)} == owner
    se.close()
    return owner


def test_routing_stable_across_publishes_and_redeploys():
    assert _owner_map(PORT) == _owner_map(JAX)


def _offline_with_empty_shards(pk):
    se = _sharded(pk, n_shards=4)
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    keys = np.asarray([0, 4] * 40)
    ts = np.sort(np.random.default_rng(0).uniform(0, 100, 80))
    rows = np.random.default_rng(1).normal(size=(80, 2)).astype(np.float32)
    se.insert("events", keys.tolist(), ts.tolist(), rows)
    se.deploy("q", SQL)
    res = se.query_offline("q")
    assert len(res["__key"]) == 80
    assert set(res["__shard"].tolist()) == {se.shard_of(0), se.shard_of(4)}
    se.close()
    return res


def test_query_offline_with_empty_shards():
    got, want = (_offline_with_empty_shards(pk) for pk in (PORT, JAX))
    assert len(got["__version_vector"]) == 4
    _assert_close(got, want, "offline")


# ---------------------------------------------------------------------------
# sharded vs unsharded on a disordered streamed load
# ---------------------------------------------------------------------------

def _pair(pk, n_shards=3, lateness=30.0, with_join=False):
    keys, ts, rows = _events()
    dkeys, dts, drows = _disorder(keys, ts, rows, lateness)
    ref = pk.Engine(pk.Flags(), **pk.kw)
    se = _sharded(pk, n_shards=n_shards)
    for eng in (ref, se):
        eng.create_table(_schema(pk), max_keys=64, capacity=64,
                         bucket_size=8)
    if with_join:
        dim = pk.Schema("dim", key_col="mkey", ts_col="dts",
                        value_cols=("risk", "tier"))
        ref.create_table(dim, max_keys=16, capacity=16, bucket_size=8)
        se.create_table(dim, max_keys=16, capacity=16, bucket_size=8,
                        replicate=True)
        for t0 in (100.0, 600.0):
            drow = np.stack([np.arange(8) + t0, np.arange(8) * 0.5],
                            -1).astype(np.float32)
            for eng in (ref, se):
                eng.insert("dim", list(range(8)), [t0] * 8, drow)
    rpipe = ref.attach_stream("events", lateness=lateness,
                              flush_interval_s=0.001)
    spipe = se.attach_stream("events", lateness=lateness,
                             flush_interval_s=0.001)
    for i in range(len(dkeys)):
        rpipe.push(int(dkeys[i]), float(dts[i]), drows[i])
        spipe.push(int(dkeys[i]), float(dts[i]), drows[i])
    rpipe.flush()
    spipe.flush()
    return ref, se, (keys, ts, rows)


def _streamed(pk):
    ref, se, _ = _pair(pk)
    ref.deploy("q", SQL)
    se.deploy("q", SQL)
    rng = np.random.default_rng(7)
    out = []
    for b in range(3):
        rk = rng.integers(0, 24, 16).tolist()
        rt = np.full(16, 2000.0 + b, np.float32).tolist()
        a, s = ref.request("q", rk, rt), se.request("q", rk, rt)
        assert len(s.version_vector) == 3
        np.testing.assert_array_equal(a.status, s.status)
        _assert_equal(_cols(s), _cols(a), f"{pk.name} sharded")
        out.append((_cols(s), s.status, s.version_vector))
    ref.close()
    se.close()
    return out


def test_sharded_equals_unsharded_on_a_streamed_load():
    got, want = _streamed(PORT), _streamed(JAX)
    for (g, gs, gv), (w, ws, wv) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        _assert_close(g, w, "port vs jax")


def _join_query(pk):
    return (pk.dsl.QueryBuilder("events")
            .window("w", partition_by="user", order_by="ts", rows=10)
            .select(s=pk.dsl.sum_(pk.dsl.col("amount")).over("w"),
                    risk=pk.dsl.tbl("dim").risk)
            .last_join("dim", on="mkey", order_by="dts"))


def _joined(pk):
    ref, se, (keys, ts, rows) = _pair(pk, with_join=True)
    ref.deploy("jq", _join_query(pk))
    se.deploy("jq", _join_query(pk))
    rng = np.random.default_rng(9)
    idx = rng.integers(0, len(keys), 16)
    rk, rr = keys[idx].tolist(), rows[idx]
    rt = np.full(16, 2000.0, np.float32).tolist()
    a, s = ref.request("jq", rk, rt, rows=rr), se.request("jq", rk, rt,
                                                          rows=rr)
    _assert_equal(_cols(s), _cols(a), f"{pk.name} joined")
    st = se.handle("jq").join_staleness()["dim"]
    assert 0.0 < st["match_rate"] <= 1.0
    dec = se.latency_decomposition()
    assert 0.0 < dec["join_match_rate"] <= 1.0 and dec["join_probes"] >= 16
    oa, ob = ref.query_offline("jq"), se.query_offline("jq")
    inv = {i: k for k, i in ref.tables["events"].key_to_idx.items()}
    ka = np.asarray([inv[int(i)] for i in oa["__key"]])
    ia = np.lexsort((oa["__ts"], ka))
    ib = np.lexsort((ob["__ts"], ob["__key"]))
    assert np.array_equal(ka[ia], ob["__key"][ib])
    for n in ("s", "risk"):
        assert np.array_equal(oa[n][ia], ob[n][ib]), n
    assert len(ob["__version_vector"]) == 3
    sorted_ob = {n: ob[n][ib] for n in ("s", "risk", "__key", "__ts")}
    ref.close()
    se.close()
    return _cols(s), st, sorted_ob


def test_sharded_last_join_and_offline_parity():
    (g, gst, goff), (w, wst, woff) = _joined(PORT), _joined(JAX)
    _assert_close(g, w, "online")
    _assert_close(goff, woff, "offline")
    for f in ("probes", "matches", "match_rate", "age_samples"):
        assert gst[f] == wst[f], f


@pytest.mark.parametrize("pk", PKGS, ids=lambda p: p.name)
def test_join_on_partitioned_right_table_rejected(pk):
    se = _sharded(pk, n_shards=2)
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    se.create_table(pk.Schema("dim", key_col="mkey", ts_col="dts",
                              value_cols=("risk",)),
                    max_keys=16, capacity=16, bucket_size=8)
    q = (pk.dsl.QueryBuilder("events")
         .window("w", partition_by="user", order_by="ts", rows=5)
         .select(s=pk.dsl.sum_(pk.dsl.col("amount")).over("w"),
                 risk=pk.dsl.tbl("dim").risk)
         .last_join("dim", on="mkey", order_by="dts"))
    with pytest.raises(ValueError, match="replicate=True"):
        se.deploy("jq", q)
    assert "jq" not in se.deployments
    se.close()


# ---------------------------------------------------------------------------
# shedding and admission
# ---------------------------------------------------------------------------

def _shed_at_admission(pk):
    se = _loaded(pk)
    ctx = pk.Ctx(deadline=time.monotonic() - 1.0)
    out = se.request("q", list(range(8)), [2000.0] * 8, ctx=ctx)
    assert (out.status == STATUS_SHED).all() and out.n_shed == 8
    assert set(out.keys()) == set(se.handle("q").phys.feature_names)
    assert all(np.asarray(out[n]).shape == (8,) for n in out)
    ok = se.request("q", list(range(8)), [2001.0] * 8)
    assert (ok.status == STATUS_OK).all()
    m = se.handle("q").metrics
    res = (out.status, out.version_vector, _cols(ok), m.shed_batches,
           m.shed_requests, se.resources.metrics())
    se.close()
    return res


def test_whole_batch_shed_at_admission():
    got, want = _shed_at_admission(PORT), _shed_at_admission(JAX)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    _assert_close(got[2], want[2])
    assert got[3:] == want[3:]


@pytest.mark.parametrize("pk", PKGS, ids=lambda p: p.name)
def test_router_sheds_expired_subbatch_at_dequeue(pk):
    mod = router if pk is PORT else jrouter
    rt = mod.ShardRouter(1, dispatch_rows=8)

    class _Handle:
        class table:
            class schema:
                value_cols = ("amount",)

        def request(self, *a, **kw):               # pragma: no cover
            raise AssertionError("a shed sub-batch is never computed")

    item = mod.SubBatch(_Handle(), np.arange(4), np.zeros(4, np.float32),
                        None, ctx=pk.Ctx(deadline=time.monotonic() - 1))
    rt.submit(0, item)
    assert item.done.wait(5.0)
    assert item.shed and item.shed_reason == "deadline"
    assert item.error is None
    cols, status, _, any_shed = rt.gather([(np.arange(4), item)], 4)
    assert any_shed and cols is None
    assert rt.stats()["shed_sub_batches"] == 1
    rt.close()


def _backpressure(pk):
    se = _loaded(pk, admission=pk.Admission(max_inflight=1,
                                            admit_timeout_s=0.05))
    se.request("q", [1, 2], [2000.0] * 2)
    adm = se.resources.admit("q")
    assert not adm.shed
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="admission control"):
        se.request("q", [1, 2], [2001.0] * 2)
    assert time.monotonic() - t0 >= 0.04
    adm.release()
    assert se.request("q", [1, 2], [2002.0] * 2).all_ok
    ctx = pk.Ctx.with_timeout(0.02)
    adm2 = se.resources.admit("q")
    shed = se.request("q", [1, 2], [2003.0] * 2, ctx=ctx)
    adm2.release()
    assert (shed.status == STATUS_SHED).all()
    stats = se.resources.metrics()
    se.close()
    return stats


def test_admission_inflight_backpressure():
    got, want = _backpressure(PORT), _backpressure(JAX)
    assert got == want
    assert got["rejected_inflight"] == 1 and got["shed_deadline"] == 1


# ---------------------------------------------------------------------------
# deployment lifecycle across shards
# ---------------------------------------------------------------------------

def _lifecycle(pk):
    se = _loaded(pk)
    rk, rt = list(range(8)), [2000.0] * 8
    steps = []

    def step(label, fr):
        live = se.handle("q")
        steps.append((label, fr.version, live.version,
                      live._canary[0].version if live._canary else None,
                      tuple(fr.version_vector), fr.status.tolist()))
        return _cols(fr)

    base = step("v1", se.request("q", rk, rt))
    se.deploy("q", SQL.replace("10 PRECEDING", "5 PRECEDING"), canary=1.0)
    cand_cols = step("canary", se.request("q", rk, rt))
    cand = se.handle("q", version=2)
    assert cand.metrics.canary_batches == 1
    se.promote("q")
    assert all(h.live for h in se.handle("q").handles)
    step("promote", se.request("q", rk, rt))
    se.rollback("q")
    after = step("rollback", se.request("q", rk, rt))
    assert np.array_equal(after["s"], base["s"])
    step("pinned", se.request("q", rk, rt, ctx=pk.Ctx(version_pin=2)))
    se.close()
    return steps, base, cand_cols, cand.metrics.canary_max_abs_diff


def test_hot_swap_canary_promote_rollback():
    got, want = _lifecycle(PORT), _lifecycle(JAX)
    assert got[0] == want[0]
    assert [s[1] for s in got[0]] == [1, 2, 2, 1, 2]
    _assert_close(got[1], want[1], "v1")
    _assert_close(got[2], want[2], "canary")
    assert got[3] == pytest.approx(want[3], rel=2e-4, abs=1e-5)


def _server_round(pk):
    keys, ts, rows = _events()
    se = _sharded(pk, n_shards=2)
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    se.attach_stream("events", lateness=5.0, flush_interval_s=0.001)
    se.insert("events", keys.tolist(), ts.tolist(), rows)
    se.deploy("q", SQL)
    srv = pk.Server(se, "q", pk.ServerCfg(pk.BatcherCfg(max_batch=8,
                                                        max_delay_s=0.005)))
    outs = {}

    def client(i):
        outs[i] = srv.request(i % 16, 2000.0 + i)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert len(outs) == 16 and not any(t.is_alive() for t in threads)
    # the write path routes through the sharded pipeline facade
    assert srv.ingest(3, 3000.0, np.asarray([1.0, 0.0], np.float32))
    se.streams["events"].flush()
    after = se.request("q", [3], [3001.0])
    srv.close()
    se.close()
    return ({i: _cols(o) for i, o in outs.items()},
            {i: o.status.tolist() for i, o in outs.items()}, _cols(after))


def test_feature_server_over_the_sharded_engine():
    got, want = _server_round(PORT), _server_round(JAX)
    assert got[1] == want[1]
    for i in want[0]:
        _assert_close(got[0][i], want[0][i], f"request {i}")
    _assert_close(got[2], want[2], "after ingest")


# ---------------------------------------------------------------------------
# elastic resharding and transactional ingest
# ---------------------------------------------------------------------------

def _reshard_under_traffic(pk, traffic=True):
    """Grow by a shard, then remove shard 0, with a thread requesting the
    same 24 keys all along when ``traffic``. Every batch the thread gets
    back is all shed or all correct; it checks at least one whole batch
    before the reshard begins and one sent after it ends (events with
    deadlines, so a loaded host only slows the test down)."""
    keys, ts, rows = _events()
    ref = pk.Engine(pk.Flags(), **pk.kw)
    ref.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    ref.insert("events", keys.tolist(), ts.tolist(), rows)
    ref.deploy("q", SQL)
    rk, rt = list(range(24)), [2000.0] * 24
    want = _cols(ref.request("q", rk, rt))
    se = _loaded(pk)
    stop, errors, checked = threading.Event(), [], [0]
    before, resharded, after = (threading.Event(), threading.Event(),
                                threading.Event())

    def hammer():
        while not stop.is_set():
            sent_after = resharded.is_set()
            try:
                got = se.request("q", rk, rt)
            except Exception as e:          # noqa: BLE001
                errors.append(e)
                return
            if (got.status == STATUS_SHED).all():
                continue
            if not (got.status == STATUS_OK).all() or any(
                    not np.array_equal(want[n], np.asarray(got[n]))
                    for n in want):
                errors.append(AssertionError(
                    f"a mixed or wrong batch: status {got.status.tolist()}"))
                return
            checked[0] += 1
            (after if sent_after else before).set()

    t = threading.Thread(target=hammer, daemon=True)
    if traffic:
        t.start()
    try:
        assert not traffic or before.wait(60.0) or errors, \
            "no batch checked before the reshard"
        s_new = se.add_shard()
        counts = se._routing.shard_counts()
        assert se.n_shards == 3 and counts.get(s_new, 0) > 0
        moved = se.remove_shard(0)
        assert se.n_shards == 2 and moved > 0
        resharded.set()
        assert not traffic or after.wait(60.0) or errors, \
            "no batch checked after the reshard"
    finally:
        stop.set()
        if traffic:
            t.join(60.0)
    assert not t.is_alive()
    assert not errors, errors[:1]
    assert checked[0] >= 2 or not traffic
    got = se.request("q", rk, rt)
    assert (got.status == STATUS_OK).all()
    _assert_equal(_cols(got), want, f"{pk.name} after reshard")
    oa, ob = ref.query_offline("q"), se.query_offline("q")
    inv = {i: k for k, i in ref.tables["events"].key_to_idx.items()}
    ka = np.asarray([inv[int(i)] for i in oa["__key"]])
    ia, ib = np.lexsort((oa["__ts"], ka)), np.lexsort((ob["__ts"],
                                                      ob["__key"]))
    assert np.array_equal(ka[ia], ob["__key"][ib])
    for n in ("s", "c", "a"):
        assert np.array_equal(oa[n][ia], ob[n][ib]), n
    assert 0 not in set(ob["__shard"].tolist())
    res = (counts, moved, _cols(got), got.version_vector,
           {n: ob[n][ib] for n in ("s", "c", "a", "__key", "__ts")})
    ref.close()
    se.close()
    return res


def test_elastic_reshard_under_live_traffic():
    """The port reshards under a requesting thread (``_reshard_under_
    traffic``); the JAX package, run as the reference without one (its
    router still turns away a request that raced ``remove_shard``, see
    the next test), gives the same arcs, migrated events and answers:
    nothing is ingested while the shards move, so they do not depend on
    the traffic."""
    got = _reshard_under_traffic(PORT)
    want = _reshard_under_traffic(JAX, traffic=False)
    assert got[0] == want[0]          # the same arcs per shard
    assert got[1] == want[1]          # the same events migrated
    _assert_close(got[2], want[2], "online")
    _assert_close(got[4], want[4], "offline")


def _routed_before_remove(pk):
    """A request whose owners were read before ``remove_shard(0)`` and
    whose sub-batches are submitted after it: the statuses it gets back
    and its columns, the reference's answer, and the owners lookups."""
    se = _loaded(pk)
    rk, rt = list(range(24)), [2000.0] * 24
    want = _cols(se.request("q", rk, rt))     # fills the stale tier too
    stale = se.owners_of(np.asarray(rk))
    assert (stale == 0).any()
    se.remove_shard(0)
    real, calls = se.owners_of, []

    def stale_once(keys):
        calls.append(len(keys))
        return stale if len(calls) == 1 else real(keys)

    se.owners_of = stale_once
    try:
        got = se.request("q", rk, rt)
    finally:
        se.owners_of = real
    se.close()
    return got.status.tolist(), _cols(got), want, calls, stale


def test_a_request_routed_before_remove_shard_reaches_the_new_owner():
    """The race the live-traffic test met under load, made deterministic:
    a scatter reads the route table, ``remove_shard(0)`` runs to its end
    (migrates, retires shard 0's queue), then the scatter submits. The
    port sends the sub-batch shed at shard 0's retired queue again to
    its keys' new owners, so every row is computed and equals the answer
    before the reshard; the JAX package answers those rows from the stale
    tier (``STATUS_DEGRADED``), a mixed batch."""
    status, cols, want, calls, stale = _routed_before_remove(PORT)
    assert status == [STATUS_OK] * 24
    _assert_equal(cols, want, "rerouted")
    assert calls == [24, int((stale == 0).sum())]   # shard 0's rows again
    jstatus, _, _, jcalls, jstale = _routed_before_remove(JAX)
    assert jcalls == [24]
    assert [s == STATUS_DEGRADED for s in jstatus] == (jstale == 0).tolist()


@pytest.mark.parametrize("pk", PKGS, ids=lambda p: p.name)
def test_modulo_partitioner_cannot_reshard(pk):
    se = _sharded(pk, n_shards=2, partitioner="modulo")
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    mod = router if pk is PORT else jrouter
    assert [se.shard_of(k) for k in range(32)] == \
        [mod.shard_of(k, 2) for k in range(32)]
    with pytest.raises(RuntimeError, match="cannot reshard"):
        se.add_shard()
    with pytest.raises(RuntimeError, match="cannot reshard"):
        se.remove_shard(0)
    se.close()


def _all_or_nothing(pk):
    se = _sharded(pk, n_shards=2)
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    pipe = se.attach_stream("events", lateness=1.0)
    ka = next(k for k in range(100) if se.shard_of(k) == 0)
    kb = next(k for k in range(100) if se.shard_of(k) == 1)
    se.insert("events", [ka], [100.0], np.ones((1, 2), np.float32))
    pipe.flush()
    se.deploy("q", SQL)
    with pytest.raises(ValueError, match="rejected atomically"):
        se.insert("events", [ka, kb], [10.0, 200.0],
                  np.ones((2, 2), np.float32))
    pipe.flush()
    first = se.request("q", [kb], [500.0]).status.tolist()
    assert first != [STATUS_OK]                  # nothing staged for kb
    se.insert("events", [ka, kb], [300.0, 300.0],
              np.ones((2, 2), np.float32))
    pipe.flush()
    fr = se.request("q", [ka, kb], [500.0, 500.0])
    assert fr.status.tolist() == [STATUS_OK, STATUS_OK]
    assert fr.columns["c"].tolist() == [2.0, 1.0]
    se.close()
    return ka, kb, first, _cols(fr)


def test_cross_shard_insert_all_or_nothing():
    got, want = _all_or_nothing(PORT), _all_or_nothing(JAX)
    assert got[:3] == want[:3]
    _assert_close(got[3], want[3])


@pytest.mark.parametrize("pk", PKGS, ids=lambda p: p.name)
def test_router_shutdown_drains_inflight_gathers(pk):
    se = _loaded(pk, n_shards=3, coalesce_delay_s=0.02)
    se.request("q", [0], [2000.0])                 # warm every executor
    results, refused = [], []
    submitted = threading.Barrier(13)

    def client(i):
        submitted.wait(30.0)
        try:
            results.append(se.request("q", [i % 16], [2000.0]))
        except RuntimeError as e:       # submitted after accepting flipped
            refused.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(12)]
    for th in threads:
        th.start()
    submitted.wait(30.0)
    # the coalesce delay keeps the first sub-batches QUEUED while the
    # engine closes: the drain must complete them
    se.close()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive(), "request hung across shutdown"
    assert len(results) + len(refused) == 12
    for fr in results:
        assert (fr.status == STATUS_OK).all()
    for e in refused:
        assert "closed" in str(e)
    with pytest.raises(RuntimeError, match="closed"):
        se.router.scatter(se.handle("q").handles, np.asarray([1]),
                          np.asarray([2000.0], np.float32), None)


def _degraded_ladder(pk):
    se = _loaded(pk, degraded_cache_keys=64)
    rk, rt = list(range(8)), [2000.0] * 8
    fr = se.request("q", rk, rt)
    assert (np.asarray(fr.status) == STATUS_OK).all()
    down = {s for s in range(8) if se.shard_of(s) == 1}
    assert down and len(down) < 8
    se.router.retire_queue(1)           # its sub-batches shed worker_down
    fr2 = se.request("q", rk, rt)
    st = np.asarray(fr2.status)
    assert (st[[k in down for k in rk]] == STATUS_DEGRADED).all()
    assert (st[[k not in down for k in rk]] == STATUS_OK).all()
    for c in fr.columns:                # the stale rows, bit for bit
        assert np.array_equal(np.asarray(fr[c]), np.asarray(fr2[c])), c
    assert fr2.n_degraded == len(down)
    m = se.handle("q").metrics.snapshot()
    cold = next(k for k in range(8, 200)
                if se.shard_of(k) == 1 and k not in rk)
    fr3 = se.request("q", rk + [cold], rt + [2000.0])
    assert (np.asarray(fr3.status) == STATUS_SHED).all()
    res = (st.tolist(), _cols(fr2), m["degraded_requests"],
           m["degraded_batches"], se.resources.metrics())
    se.close()
    return res


def test_degraded_ladder_stale_tier():
    got, want = _degraded_ladder(PORT), _degraded_ladder(JAX)
    assert got[0] == want[0]
    _assert_close(got[1], want[1])
    assert got[2:] == want[2:]


PREDICT_SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c,
PREDICT(m, s, c) AS score
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 10 PRECEDING AND CURRENT ROW)"""


def _scorer(p, feats):
    """Column by column, so a row's score does not depend on its batch;
    the same code runs on torch tensors and on JAX arrays."""
    mu, sd, w, b = p
    z = (feats - mu) / sd * w
    acc = b + z[:, 0]
    for j in range(1, z.shape[1]):
        acc = acc + z[:, j]
    return acc


def _scorer_params(pk):
    rng = np.random.default_rng(3)
    params = (np.asarray([0.5, 3.0], np.float32),
              np.asarray([2.0, 4.0], np.float32),
              rng.normal(size=2).astype(np.float32), np.float32(0.25))
    if pk is PORT:
        return tuple(torch.tensor(np.asarray(p)) for p in params)
    return params


def _predict_ladder(pk):
    """A fresh PREDICT frame, then shard 1's queue retired: a degraded
    frame (its keys from the stale tier), then a shed one (a key of
    shard 1 the tier never saw)."""
    keys, ts, rows = _events()
    se = _sharded(pk, n_shards=2, degraded_cache_keys=64)
    se.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    se.insert("events", keys.tolist(), ts.tolist(), rows)
    se.register_model("m", _scorer, _scorer_params(pk))
    se.deploy("p", PREDICT_SQL)
    rk, rt = list(range(8)), [2000.0] * 8
    fresh = se.request("p", rk, rt)
    assert (np.asarray(fresh.status) == STATUS_OK).all()
    down = [k in {s for s in rk if se.shard_of(s) == 1} for k in rk]
    assert any(down) and not all(down)
    se.router.retire_queue(1)
    deg = se.request("p", rk, rt)
    cold = next(k for k in range(8, 200)
                if se.shard_of(k) == 1 and k not in rk)
    shed = se.request("p", rk + [cold], rt + [2000.0])
    se.close()
    return fresh, deg, shed, np.asarray(down)


def test_degraded_and_shed_frames_carry_the_predict_output():
    """A degraded frame answers a down shard's keys with every column
    they were last served with, the PREDICT output included, and a shed
    frame has that column zero-filled. JAX's stale tier and shed frame
    carry the features only, so its degraded and shed frames have no
    ``score``: here the port differs from JAX on purpose."""
    (pf, pd, ps, down), (jf, jd, js, jdown) = (
        _predict_ladder(PORT), _predict_ladder(JAX))
    assert down.tolist() == jdown.tolist()
    _assert_close(_cols(pf), _cols(jf), "fresh")
    st = np.asarray(pd.status)
    assert (st[down] == STATUS_DEGRADED).all()
    assert (st[~down] == STATUS_OK).all()
    assert np.asarray(jd.status).tolist() == st.tolist()
    assert sorted(pd.columns) == ["c", "s", "score"]
    for n in pd.columns:            # the stale rows, bit for bit
        np.testing.assert_array_equal(np.asarray(pd[n]),
                                      np.asarray(pf[n]), err_msg=n)
    assert "score" in jf.columns and "score" not in jd.columns
    assert (np.asarray(ps.status) == STATUS_SHED).all()
    assert sorted(ps.columns) == ["c", "s", "score"]
    assert not np.asarray(ps["score"]).any()
    assert "score" not in js.columns
    _assert_close({n: np.asarray(pd[n]) for n in jd.columns},
                  _cols(jd), "degraded features")


def _retire_and_release(pk):
    """Three shards; ``h`` is the first version of ``q``, retained after
    a redeploy; shard 0 is removed."""
    se = _loaded(pk, n_shards=3)
    se.attach_stream("events", flush_interval_s=0.01)
    h = se.handle("q")
    se.deploy("q", SQL.replace("10 PRECEDING", "5 PRECEDING"))
    tab = weakref.ref(se.shards[0].tables["events"])
    se.remove_shard(0)
    gc.collect()
    rk, rt = list(range(16)), [2000.0] * 16
    out = (h.version_vector(), se.handle("q").version_vector(),
           _cols(se.request("q", rk, rt)), h, tab)
    se.close()
    return out


def test_remove_shard_releases_the_retired_slot_tables():
    """After ``remove_shard(0)`` no retained handle holds shard 0's
    handle, nor the stream facade its pipeline, so its table is freed
    (JAX keeps it), while every version vector still has shard 0's entry,
    equal to JAX's."""
    pold, pnew, pfr, ph, ptab = _retire_and_release(PORT)
    jold, jnew, jfr, jh, jtab = _retire_and_release(JAX)
    assert pold == jold and pnew == jnew
    assert len(pold) == 3
    _assert_close(pfr, jfr, "after remove_shard")
    assert ph.handles[0] is None and ptab() is None
    assert jh.handles[0] is not None and jtab() is not None


def _prepare_ttl(pk):
    se = _sharded(pk, n_shards=2)
    se.create_table(_schema(pk), max_keys=16, capacity=64, bucket_size=8)
    facade = se.attach_stream("events", prepare_ttl_s=0.05)
    se.insert("events", [0, 1], [10.0, 10.0], np.ones((2, 2), np.float32))
    se.deploy("q", SQL)
    pipe0 = facade.pipes[se.shard_of(0)]
    txn = pipe0.prepare([0], [20.0], np.ones((1, 2), np.float32))
    assert txn is not None
    time.sleep(0.08)                    # past the TTL: presumed dead
    with pytest.raises(ValueError, match="auto-aborted"):
        pipe0.commit_txn(txn)
    se.insert("events", [0], [30.0], np.ones((1, 2), np.float32))
    fr = se.request("q", [0], [100.0])
    se.close()
    return fr.columns["c"].tolist(), fr.status.tolist()


def test_prepare_ttl_via_sharded_insert():
    got = _prepare_ttl(PORT)
    assert got == _prepare_ttl(JAX)
    assert got[0] == [2.0]               # ts 10 + ts 30, not ts 20


# ---------------------------------------------------------------------------
# migration primitives, and a reshard whose keys wrap their rings
# ---------------------------------------------------------------------------

def _wrapped_events(n=1500, n_keys=12, seed=3):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_keys + 1)
    keys = rng.choice(n_keys, n, p=p / p.sum())
    ts = np.sort(rng.uniform(0, 1000.0, n)).astype(np.float32)
    rows = np.stack([rng.normal(size=n), rng.uniform(0, 8, n)],
                    -1).astype(np.float32)
    return keys, ts, rows


def test_extract_events_gathers_jax_rows_without_a_table_copy():
    keys, ts, rows = _wrapped_events()
    engines = {}
    for pk in PKGS:
        e = pk.Engine(pk.Flags(), **pk.kw)
        e.create_table(_schema(pk), max_keys=16, capacity=16, bucket_size=4)
        e.insert("events", keys.tolist(), ts.tolist(), rows)
        engines[pk.name] = e
    tab = engines["port"].tables["events"]
    assert int(tab.state.total.max()) > 3 * tab.capacity
    # a key subset in a scrambled order, with an absent key
    sel = [7, 0, 99, 3, 11, 1]
    gk, gts, grows = migrate.extract_events(engines["port"], "events", sel)
    wk, wts, wrows = jmigrate.extract_events(engines["jax"], "events", sel)
    assert gk == wk
    np.testing.assert_array_equal(gts, wts)
    np.testing.assert_array_equal(grows, wrows)
    # the same rows as a host enumeration of each key's ring
    st = tab.snapshot().state
    C = tab.capacity
    host = []
    for k in sel:
        i = tab.key_to_idx.get(k)
        if i is None:
            continue
        tot = int(st.total[i])
        for p in range(max(tot - C, 0), tot):
            host.append((float(st.ts[i, p % C]), k,
                         st.values[i, p % C].numpy()))
    order = sorted(range(len(host)), key=lambda j: host[j][0])
    assert gk == [host[j][1] for j in order]
    np.testing.assert_array_equal(
        grows, np.stack([host[j][2] for j in order]))
    assert migrate.list_keys(engines["port"], "events") == \
        jmigrate.list_keys(engines["jax"], "events")
    # migrate_in skips the prefix a target already holds
    for name, mod in (("port", migrate), ("jax", jmigrate)):
        pk = PORT if name == "port" else JAX
        tgt = pk.Engine(pk.Flags(), **pk.kw)
        tgt.create_table(_schema(pk), max_keys=16, capacity=16,
                         bucket_size=4)
        half = len(gk) // 2
        assert mod.migrate_in(tgt, "events", gk[:half], gts[:half],
                              grows[:half]) == half
        assert mod.migrate_in(tgt, "events", gk, gts, grows) == \
            len(gk) - half
        assert mod.migrate_in(tgt, "events", gk, gts, grows) == 0
        tgt.close()
    for e in engines.values():
        e.close()


WRAP_SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c,
AVG(mkey) OVER w AS a, MAX(amount) OVER w AS mx, MIN(mkey) OVER w AS mn
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             RANGE BETWEEN 600 PRECEDING AND CURRENT ROW)"""


def _wrapped_reshard(pk):
    """Capacity 16, bucket 4, keys far past 16 events, a RANGE window
    the optimizer routes to the pre-aggregate tier; 2 -> 3 -> 2 shards,
    then one more event per key (which completes the newest bucket of a
    key whose oldest one had lost its head). Returns the unsharded frame
    and the sharded frames before and after, the same after the extra
    events, the keys that moved, whether they had wrapped, and per key
    whether its ring and tier on its shard equal the unsharded engine's
    (None for JAX, whose state is not compared)."""
    keys, ts, rows = _wrapped_events()
    ref = pk.Engine(pk.Flags(), **pk.kw)
    se = _sharded(pk, n_shards=2)
    for e in (ref, se):
        e.create_table(_schema(pk), max_keys=16, capacity=16, bucket_size=4)
        e.insert("events", keys.tolist(), ts.tolist(), rows)
        e.deploy("q", WRAP_SQL)
    assert "preagg" in se.explain("q")
    rk = list(range(12))
    rt = [1000.5] * 12
    want = _cols(ref.request("q", rk, rt))
    before = _cols(se.request("q", rk, rt))
    owners0 = [se.shard_of(k) for k in rk]
    se.add_shard()
    se.remove_shard(0)
    moved = [k for k, o in zip(rk, owners0) if se.shard_of(k) != o]
    after = _cols(se.request("q", rk, rt))
    tot = ref.tables["events"].state.total
    wrapped = {k: int(np.asarray(tot)[ref.tables["events"].key_to_idx[k]])
               > 16 for k in rk}
    same_state = None
    if pk is PORT:
        rtab = ref.tables["events"]
        same_state = {}
        for k in rk:
            tab = se.shards[se.shard_of(k)].tables["events"]
            i, j = rtab.key_to_idx[k], tab.key_to_idx[k]
            same_state[k] = all(
                torch.equal(a[i], b[j]) for a, b in (
                    (rtab.state.values, tab.state.values),
                    (rtab.state.ts, tab.state.ts),
                    (rtab.state.total, tab.state.total),
                    (rtab.preagg.sum, tab.preagg.sum),
                    (rtab.preagg.sumsq, tab.preagg.sumsq),
                    (rtab.preagg.count, tab.preagg.count)))
    rng = np.random.default_rng(5)
    extra = rng.normal(size=(12, 2)).astype(np.float32)
    for e in (ref, se):
        e.insert("events", rk, [1000.25] * 12, extra)
    want2 = _cols(ref.request("q", rk, rt))
    after2 = _cols(se.request("q", rk, rt))
    ref.close()
    se.close()
    return want, before, after, want2, after2, moved, wrapped, same_state


def test_reshard_of_keys_that_wrapped_their_rings():
    """The port seats a migrated key at its source's ring positions, so
    it equals its unsharded engine bit for bit after the reshard (ring,
    tier and frames). JAX re-inserts at positions ``[0, n)``: its sums
    of moved wrapped keys are held to ``rtol 2e-4``, and the port to JAX
    likewise."""
    port, jax_ = _wrapped_reshard(PORT), _wrapped_reshard(JAX)
    pw, pb, pa, pw2, pa2, pmoved, pwrap, pstate = port
    jw, jb, ja, jw2, ja2, jmoved, jwrap, _ = jax_
    assert pmoved == jmoved and pwrap == jwrap
    assert any(pwrap[k] for k in pmoved)     # a wrapped key did move
    # before the reshard each package's shards equal its unsharded engine
    _assert_equal(pb, pw, "port before")
    _assert_equal(jb, jw, "jax before")
    # after it, the port's shards hold every key's state as the
    # unsharded engine does, and serve the same frames, bit for bit
    assert all(pstate.values()), pstate
    _assert_equal(pa, pw, "port after reshard")
    _assert_equal(pa2, pw2, "port after reshard and one more event")
    # JAX: counts, min and max exact, sums of the moved wrapped keys
    # within rtol 2e-4 (their bucket grouping changed), the rest exact
    for got, want, what in ((ja, jw, "jax"), (ja2, jw2, "jax, one more")):
        _assert_close(got, want, f"{what} after reshard")
        stay = [i for i, k in enumerate(range(12)) if k not in pmoved]
        for n in want:
            np.testing.assert_array_equal(got[n][stay], want[n][stay],
                                          err_msg=f"{what} {n}")
    _assert_close(pa, ja, "port vs jax after")
    _assert_close(pa2, ja2, "port vs jax after one more event")


# ---------------------------------------------------------------------------
# placement, backends, n_live, hedging, batching-independent state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("pin", [True, False])
def test_shard_placement(n_devices, pin):
    for base in ("cuda", "cpu"):
        got = [shard_device(base, s, pin, n_devices) for s in range(6)]
        if pin and base == "cuda" and n_devices > 1:
            assert got == [torch.device("cuda", s % n_devices)
                           for s in range(6)]
        else:
            assert got == [torch.device(base)] * 6


def test_cpu_sharded_engine_places_every_shard_on_the_cpu():
    se = ShardedEngine(ShardConfig(n_shards=3), device="cpu")
    se.create_table(_schema(PORT), max_keys=64, capacity=64, bucket_size=8)
    assert se.devices == (torch.device("cpu"),) * 3
    assert se.router.n_lanes == 1
    assert all(t.device.type == "cpu" for t in se.tables_of("events"))
    se.close()


def test_sharded_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedEngine(ShardConfig(n_shards=2))


@pytest.mark.parametrize("how", ["argument", "config", "env"])
def test_process_backend_from_argument_config_or_env(how, monkeypatch):
    """Each of the three ways to ask for the process backend runs one
    worker subprocess per shard, with a lane of its own; ``close`` stops
    it."""
    if how == "env":
        monkeypatch.setenv("REPRO_SHARD_BACKEND", "process")
        cfg, kw = ShardConfig(n_shards=1), {}
    elif how == "config":
        cfg, kw = ShardConfig(n_shards=1, backend="process"), {}
    else:
        cfg, kw = ShardConfig(n_shards=1), {"backend": "process"}
    se = ShardedEngine(cfg, device="cpu", **kw)
    try:
        assert se.backend_kind == "process"
        info = se.shards[0].ping()
        assert info["pid"] == se.shards[0].proc.pid != os.getpid()
        assert info["device"] == "cpu"
        assert se.router.n_lanes == 1
    finally:
        se.close()
    assert se.backend.clients[0].proc.proc.poll() is not None


def test_unknown_shard_backend_raises():
    with pytest.raises(ValueError, match="unknown shard backend"):
        ShardedEngine(ShardConfig(backend="threads"), device="cpu")


def test_compile_cache_dir_has_no_counterpart():
    """The JAX workers' XLA cache directory: the port compiles nothing
    per worker, so a value is refused before any worker spawns."""
    with pytest.raises(ValueError, match="compile_cache_dir"):
        ShardedEngine(ShardConfig(backend="process",
                                  compile_cache_dir="/nonexistent"),
                      device="cpu")


@pytest.mark.parametrize("n_live", [0, 5, 16])
def test_request_n_live_serves_the_same_rows(n_live):
    keys, ts, rows = _events()
    out = {}
    for pk in PKGS:
        e = pk.Engine(pk.Flags(), **pk.kw)
        e.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
        e.insert("events", keys.tolist(), ts.tolist(), rows)
        h = e.deploy("q", SQL)
        rk = list(range(16))
        rt = [2000.0 + i for i in range(16)]
        plain = h.request(rk, rt)
        live = h.request(rk, rt, n_live=n_live)
        np.testing.assert_array_equal(plain.status, live.status)
        _assert_equal(_cols(live), _cols(plain), pk.name)
        out[pk.name] = (_cols(live), live.feature_age)
        e.close()
    _assert_close(out["port"][0], out["jax"][0])
    if n_live:
        assert out["port"][1] == pytest.approx(out["jax"][1])


def _hedged_round(pk):
    keys, ts, rows = _events()
    e = pk.Engine(pk.Flags(), **pk.kw)
    e.create_table(_schema(pk), max_keys=64, capacity=64, bucket_size=8)
    e.insert("events", keys.tolist(), ts.tolist(), rows)
    e.deploy("q", SQL)
    srv = pk.Server(e, "q", pk.ServerCfg(
        pk.BatcherCfg(max_batch=1, max_delay_s=0.0, num_dispatchers=2),
        hedge_after_s=0.05))
    # the first dispatch stalls until the hedge has been answered
    real = srv.batcher.serve_batch
    calls, lock, release = [0], threading.Lock(), threading.Event()

    def serve(keys_, ts_, payloads, ctx=None):
        with lock:
            calls[0] += 1
            n = calls[0]
        if n == 1:
            assert release.wait(30.0)
        out = real(keys_, ts_, payloads, ctx=ctx)
        release.set()
        return out

    srv.batcher.serve_batch = serve
    t0 = time.monotonic()
    fr = srv.request(5, 2000.0, timeout=30.0)
    elapsed = time.monotonic() - t0
    srv.close()
    e.close()
    return _cols(fr), calls[0], elapsed


def test_feature_server_hedges_a_stalled_request():
    (got, g_calls, g_s), (want, w_calls, _) = (_hedged_round(PORT),
                                               _hedged_round(JAX))
    assert g_calls == w_calls == 2        # the stalled call and its hedge
    assert g_s < 30.0
    _assert_close(got, want)


def test_table_state_is_independent_of_insert_batching():
    """A sharded table receives each key's events in other insert
    batches than an unsharded one: both tiers must come out the same."""
    keys, ts, rows = _wrapped_events(n=3000, n_keys=40)
    sch = TableSchema("e", "k", "ts", ("a", "b"))
    tabs = []
    for split in (1, 3):
        t = Table(sch, max_keys=48, capacity=64, bucket_size=8,
                  device="cpu")
        for s in range(split):
            idx = np.flatnonzero(keys % split == s)
            t.insert(keys[idx].tolist(), ts[idx], rows[idx], donate=False)
        tabs.append(t)
    a, b = tabs
    ia = torch.tensor([a.key_to_idx[k] for k in sorted(a.key_to_idx)])
    ib = torch.tensor([b.key_to_idx[k] for k in sorted(b.key_to_idx)])
    for f in ("values", "ts", "total"):
        assert torch.equal(getattr(a.state, f)[ia],
                           getattr(b.state, f)[ib]), f
    for f in ("sum", "sumsq", "min", "max", "count"):
        assert torch.equal(getattr(a.preagg, f)[ia],
                           getattr(b.preagg, f)[ib]), f


def test_drain_shard_waits_for_its_own_work_only():
    """Two shard queues share one lane. While the lane executes shard
    1's sub-batch, draining shard 0 returns at once; draining shard 1
    waits until that sub-batch is done. (Waiting on the lane's busy flag
    instead, as ``repro.shard.router`` does, would hold a shard's
    removal for as long as any traffic keeps the lane busy.)"""
    rt = ShardRouter(2, dispatch_rows=8, coalesce_delay_s=0.0, n_lanes=1)
    entered, release = threading.Event(), threading.Event()

    class _Handle:
        class table:
            class schema:
                value_cols = ("amount",)

        def request(self, keys, ts, rows, n_live=None):
            entered.set()
            assert release.wait(30.0)
            n = len(keys)
            return FeatureFrame({"x": np.zeros(n, np.float32)},
                                status=np.zeros(n, np.int8))

    item = SubBatch(_Handle(), np.arange(3), np.zeros(3, np.float32), None)
    rt.submit(1, item)
    assert entered.wait(30.0)
    t0 = time.monotonic()
    assert rt.drain_shard(0, timeout=10.0)
    assert time.monotonic() - t0 < 5.0
    assert not rt.drain_shard(1, timeout=0.05)    # its item is executing
    release.set()
    assert item.done.wait(30.0) and item.error is None
    assert rt.drain_shard(1, timeout=10.0)
    rt.shutdown()
