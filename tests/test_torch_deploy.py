"""Port engine, versioned deployments and execution modes, against the JAX
engine on the same events.

Both engines ingest the same seeded stream and run the same sequence of
deploys, redeploys (hot swaps), canaries, promotions and rollbacks; after
every step the live version, every handle's state, the registry's active
version, the plan cache's invalidations and misses and the served
``FeatureFrame`` must agree. One batch shape is served throughout: the JAX
cache keys executables per batch bucket where the port keys one executor
per plan, so the miss counts compare only at one bucket. Pooled
(``parallel_workers=4``) and per-row (``vectorized=False``) execution must
give the batched frames, in the port and in JAX, and ``query_offline``
with ``batch_size=`` and both ``point_in_time`` values must give JAX's.

Tolerances: exact for status, versions, states, counters, counts,
min/max, LAST and joined columns; ``rtol 2e-4`` for sums and averages;
STD gets an absolute ``4e-4 · max|amount|`` (the float32 cancellation of
``sqrt(sumsq/n − mean²)``; JAX also contracts it into an FMA), and so does
a canary's recorded difference between two identical queries, which is
exactly 0 in the port and FMA noise in JAX.
"""
import threading
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.engine import Engine as JEngine
from repro.core.optimizer import OptFlags as JFlags
from repro.core.results import RequestContext as JCtx
from repro.featurestore.table import TableSchema as JSchema
from repro_torch import convert
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags
from repro_torch.core.plan_cache import bucket_batch
from repro_torch.core.results import DeadlineExceeded, RequestContext
from repro_torch.data.synthetic import EventStreamConfig, generate_events
from repro_torch.featurestore.table import TableSchema
from repro_torch.kernels import _build
from test_torch_plan import FRAUD_SCORED, SERVE_FEATURES

torch.set_num_threads(1)

SQL = """
SELECT SUM(amount) OVER w AS s,
       AVG(amount) OVER w AS a,
       STD(amount) OVER w AS sd,
       COUNT(amount) OVER w AS c,
       MAX(lat) OVER w AS mx
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 50 PRECEDING AND CURRENT ROW)
"""
SQL_SHORT = SQL.replace("50 PRECEDING", "5 PRECEDING")
N_EVENTS, N_KEYS, N_MERCHANTS = 600, 24, 6
KEYS, TS, ROWS = generate_events(EventStreamConfig(
    n_events=N_EVENTS, n_keys=N_KEYS, n_features=4, seed=5))
ROWS[:, 3] = np.floor(ROWS[:, 3]) % N_MERCHANTS      # merchant ids
STD_ATOL = 4e-4 * float(np.abs(ROWS[:, 0]).max())
EXACT = ("max", "min", "mx", "cnt", "last", "c")
W = np.asarray([0.02, 0.01, 0.005, 0.001, 1.5, 0.002, 0.03], np.float32)
B = 8


def _engine(kind, flags_kw=None, **kw):
    flags_kw = flags_kw or {}
    if kind == "jax":
        e = JEngine(JFlags(**flags_kw), **kw)
        S = JSchema
    else:
        e = Engine(OptFlags(**flags_kw), device="cpu", **kw)
        S = TableSchema
    e.create_table(S("events", "user", "ts",
                     ("amount", "lat", "lon", "merchant")),
                   max_keys=32, capacity=128, bucket_size=16)
    e.create_table(S("merchants", "merchant", "mts", ("risk", "volume")),
                   max_keys=N_MERCHANTS, capacity=16, bucket_size=4)
    e.insert("events", KEYS.tolist(), TS.tolist(), ROWS)
    rng = np.random.default_rng(7)
    for t0 in (float(TS[0]), float(TS[N_EVENTS // 2])):
        e.insert("merchants", list(range(N_MERCHANTS)), [t0] * N_MERCHANTS,
                 np.stack([rng.uniform(0, 1, N_MERCHANTS),
                           rng.uniform(10, 500, N_MERCHANTS)], -1)
                 .astype(np.float32))
    if kind == "jax":
        e.register_model(
            "fraud", lambda p, f: 1 / (1 + jnp.exp(-(f @ p[0] + p[1]))),
            (jnp.asarray(W), jnp.asarray(-3.0, jnp.float32)))
    else:
        e.register_model("fraud", lambda p, f: torch.sigmoid(f @ p[0] + p[1]),
                         convert.to_tensors((W, np.float32(-3.0)), "cpu"))
    return e


def _requests(seed, n=B):
    """Known and unknown keys at fresh timestamps (the online path)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, N_KEYS + 3, n)
    keys[-1] = N_KEYS + 1                          # one unknown at least
    ts = float(TS.max()) + 1.0 + np.arange(n, dtype=np.float32)
    return keys.tolist(), ts.tolist(), ROWS[rng.integers(0, N_EVENTS, n)]


def _assert_frames_equal(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        g = np.asarray(got[c], np.float64)
        w = np.asarray(want[c], np.float64)
        assert g.shape == w.shape, c
        if c.startswith(("__", "m_")) or c in EXACT or any(
                x in c for x in ("max", "min", "cnt", "last")):
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            atol = {"score": 0.25 * W[2] * STD_ATOL}.get(
                c, STD_ATOL if ("std" in c or c == "sd") else 1e-4)
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=atol,
                                       err_msg=c)


def _state(e, name):
    """Everything the lifecycle exposes, as comparable plain values."""
    live = e.handle(name)
    return {
        "live": live.version,
        "states": {v: h.state for v, h in e._versions[name].items()},
        "registry": e.registry.get(name).version,
        "history": [h.version for h in e._history.get(name, [])],
        "canary": None if live._canary is None else live._canary[0].version,
        "invalidations": e.cache.stats.invalidations,
        "misses": e.cache.stats.misses,
    }


def _lifecycle(e):
    """The same deploy/redeploy/canary/promote/rollback sequence; returns
    per step the lifecycle state and the frames served."""
    steps = []
    req = _requests(1)

    def step(label, n_req=1):
        frames = [e.request("f", *req[:2]) for _ in range(n_req)]
        steps.append((label, _state(e, "f"), frames))

    h1 = e.deploy("f", SQL)
    assert h1.version == 1 and h1.live
    step("deploy")
    h2 = e.deploy("f", SQL_SHORT)                  # hot swap
    assert h2.live and h1.state == "retired"
    step("redeploy")
    assert e.rollback("f") is h1                   # swap only
    step("rollback")
    assert e.rollback("f") is h2                   # toggles back
    step("rollback again")
    c3 = e.deploy("f", SQL, canary=0.5)
    assert c3.state == "canary" and e.handle("f") is h2
    step("canary", n_req=6)
    assert e.promote("f") is c3 and c3.live
    step("promote")
    with pytest.raises(ValueError, match="no active canary"):
        e.promote("f")
    c4 = e.deploy("f", SQL_SHORT, canary=0.25)
    assert e.rollback("f") is c3 and c4.state == "retired"   # abort
    step("canary aborted")
    c5 = e.deploy("f", SQL_SHORT, canary=0.25)
    h6 = e.deploy("f", SQL)                        # displaces the canary
    assert c5.state == "retired" and c5.version not in e._versions["f"]
    assert h6.live
    step("redeploy over a canary")
    c7 = e.deploy("f", SQL, canary=1.0)            # identical query
    step("identical canary", n_req=4)
    with pytest.raises(ValueError, match="requires an existing live"):
        e.deploy("g_fresh", SQL, canary=0.5)
    return steps, c3, c7


@pytest.fixture(scope="module")
def lifecycles():
    out = {}
    for kind in ("jax", "port"):
        e = _engine(kind)
        out[kind] = (_lifecycle(e), e)
    yield out
    for _, e in out.values():
        e.close()


def test_lifecycle_states_match_jax(lifecycles):
    (js, _, _), _ = lifecycles["jax"]
    (ts, _, _), _ = lifecycles["port"]
    assert [s[0] for s in ts] == [s[0] for s in js]
    for (label, tstate, _), (_, jstate, _) in zip(ts, js):
        assert tstate == jstate, label


def test_lifecycle_frames_match_jax(lifecycles):
    (js, _, _), _ = lifecycles["jax"]
    (ts, _, _), _ = lifecycles["port"]
    for (label, _, tf), (_, _, jf) in zip(ts, js):
        # canary routing is counter-based: the same version sequence
        assert [f.version for f in tf] == [f.version for f in jf], label
        for g, w in zip(tf, jf):
            np.testing.assert_array_equal(g.status, w.status)
            assert g.n_unknown > 0
            _assert_frames_equal(g, w)
    canary_versions = [f.version for f in dict(
        (s[0], s[2]) for s in ts)["canary"]]
    assert set(canary_versions) == {2, 3}          # half to the canary


def test_canary_metrics_match_jax(lifecycles):
    (_, jc3, jc7), _ = lifecycles["jax"]
    (_, tc3, tc7), _ = lifecycles["port"]
    assert tc3.metrics.canary_batches == jc3.metrics.canary_batches == 3
    # SQL against SQL_SHORT: the recorded divergence is real
    np.testing.assert_allclose(tc3.metrics.canary_max_abs_diff,
                               jc3.metrics.canary_max_abs_diff,
                               rtol=2e-4, atol=STD_ATOL)
    assert tc3.metrics.canary_max_abs_diff > 1.0
    assert tc7.metrics.canary_batches == jc7.metrics.canary_batches == 4
    # identical queries: 0 in the port, FMA noise in JAX
    assert tc7.metrics.canary_max_abs_diff <= STD_ATOL
    assert jc7.metrics.canary_max_abs_diff <= STD_ATOL


def _pins_and_pruning(e):
    """Version pins, discard_version and max_retained_versions pruning."""
    out = {}
    e.deploy("f", SQL)
    for sql in (SQL_SHORT, SQL, SQL_SHORT):
        e.deploy("f", sql)                         # versions 2, 3, 4
    out["versions"] = sorted(e._versions["f"])
    out["history"] = [h.version for h in e._history["f"]]
    with pytest.raises(KeyError, match="no version 1"):
        e.handle("f", version=1)                   # pruned
    ctx_cls = JCtx if isinstance(e, JEngine) else RequestContext
    keys, ts, _ = _requests(2)
    out["pinned"] = e.request("f", keys, ts, ctx=ctx_cls(version_pin=3))
    out["live"] = e.request("f", keys, ts)
    built = e.build_version("f", SQL)
    assert built.state == "warming" and e.handle("f").version == 4
    out["built"] = built.version
    out["direct"] = built.request(keys, ts)        # serves direct calls
    e.discard_version(built)
    assert built.state == "retired"
    with pytest.raises(KeyError):
        e.handle("f", version=built.version)
    with pytest.raises(ValueError, match="live version"):
        e.discard_version(e.handle("f"))
    rebuilt = e.build_version("f", SQL_SHORT)
    assert e.publish_version(rebuilt) is rebuilt and rebuilt.live
    assert e.publish_version(rebuilt) is rebuilt   # no-op when live
    out["after_publish"] = sorted(e._versions["f"])
    out["invalidations"] = e.cache.stats.invalidations
    return out


def test_pins_discard_and_pruning_match_jax():
    res = {}
    for kind in ("jax", "port"):
        e = _engine(kind, max_retained_versions=1)
        res[kind] = _pins_and_pruning(e)
        e.close()
    j, t = res["jax"], res["port"]
    for k in ("versions", "history", "built", "after_publish",
              "invalidations"):
        assert t[k] == j[k], k
    assert t["versions"] == [3, 4] and t["history"] == [3]
    for k in ("pinned", "live", "direct"):
        assert t[k].version == j[k].version
        _assert_frames_equal(t[k], j[k])
    assert t["pinned"].version == 3 and t["live"].version == 4


def test_warm_rounds_buckets_and_swap_serves_without_a_miss():
    for kind in ("jax", "port"):
        e = _engine(kind, warm_buckets=(3,))
        h = e.deploy("f", SERVE_FEATURES)
        assert h.warm([3, 5, 8, 100]) == 3         # buckets 4, 8, 128
        assert h.buckets_seen == set()             # warm records nothing
        keys, ts, rows = _requests(3, n=5)
        e.request("f", keys, ts, rows=rows)
        assert h.buckets_seen == {bucket_batch(5)}
        h2 = e.deploy("f", SERVE_FEATURES.replace("10 PRECEDING",
                                                  "4 PRECEDING"))
        misses = e.cache.stats.misses
        assert e.request("f", keys, ts, rows=rows).version == 2
        assert e.cache.stats.misses == misses, kind
        assert h2.buckets_seen == {bucket_batch(5)}
        h2.release()
        assert not h2._fns
        e.close()


def test_request_async_matches_sync_and_deadlines():
    e = _engine("port")
    h = e.deploy("f", SQL)
    keys, ts, _ = _requests(4)
    sync = h.request(keys, ts)
    futs = [h.request_async(keys, ts) for _ in range(4)]
    for f in futs:
        out = f.result(timeout=60)
        assert out.version == sync.version
        for c in sync:
            np.testing.assert_array_equal(out[c], sync[c])
    with pytest.raises(DeadlineExceeded):
        h.request(keys, ts, ctx=RequestContext(deadline=0.0))
    e.close()
    e.close()                                      # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        h.request_async(keys, ts)


MODES = {"batched": {}, "pooled": {"parallel_workers": 4},
         "per_row": {"vectorized": False},
         "pooled_per_row": {"parallel_workers": 3, "vectorized": False}}
MODE_DEPLOYMENTS = {"f": SQL, "fraud_scored": FRAUD_SCORED}


@pytest.fixture(scope="module")
def mode_frames():
    """Per package and mode: the frames of two deployments, a joined and
    a plain one, over a batch of known and unknown keys."""
    out = {}
    keys, ts, rows = _requests(6, n=11)
    for kind in ("jax", "port"):
        for mode, kw in MODES.items():
            e = _engine(kind, kw)
            if kind == "port" and kw.get("parallel_workers", 1) > 1:
                assert e._pool is not None
            out[kind, mode] = {}
            for name, sql in MODE_DEPLOYMENTS.items():
                e.deploy(name, sql)
                out[kind, mode][name] = e.request(name, keys, ts, rows=rows)
            e.close()
    return out


@pytest.mark.parametrize("name", sorted(MODE_DEPLOYMENTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_execution_modes_match_batched_and_jax(mode_frames, mode, name):
    got = mode_frames["port", mode][name]
    base = mode_frames["port", "batched"][name]
    want = mode_frames["jax", mode][name]
    np.testing.assert_array_equal(got.status, base.status)
    np.testing.assert_array_equal(got.status, want.status)
    assert got.n_unknown > 0
    # the same engine code over slices of the batch: equal to batched
    _assert_frames_equal(got, base)
    _assert_frames_equal(got, want)


@pytest.mark.parametrize("point_in_time", [True, False])
@pytest.mark.parametrize("batch_size", [100, 1024])
def test_query_offline_options_match_jax(point_in_time, batch_size):
    res = {}
    for kind in ("jax", "port"):
        e = _engine(kind)
        e.deploy("fraud_scored", FRAUD_SCORED)
        e.deploy("f", SQL)
        res[kind] = {n: e.query_offline(n, batch_size=batch_size,
                                        point_in_time=point_in_time)
                     for n in ("fraud_scored", "f")}
        assert not e.handle("f").buckets_seen      # offline records none
        e.close()
    for n in res["port"]:
        got, want = res["port"][n], res["jax"][n]
        assert len(got["__key"]) == len(want["__key"]) > N_EVENTS // 2
        _assert_frames_equal(got, want)


def test_point_in_time_offline_differs_from_assume_latest():
    """The two ``point_in_time`` settings really are different runs: with
    assume_latest, a historical request sees its key's whole history."""
    e = _engine("port")
    e.deploy("f", SQL)
    pit = e.query_offline("f", batch_size=256)
    latest = e.query_offline("f", batch_size=256, point_in_time=False)
    np.testing.assert_array_equal(pit["__key"], latest["__key"])
    assert (latest["c"] >= pit["c"]).all() and (latest["c"] > pit["c"]).any()
    e.close()


def test_engine_modes_construct_and_close():
    for kw in MODES.values():
        e = Engine(OptFlags(**kw), device="cpu")
        assert (e._pool is not None) == (kw.get("parallel_workers", 1) > 1)
        with e:
            pass
        assert e._pool is None and e._closed


# ---------------------------------------------------------------------------
# the kernel layer under several host threads (pool, async, flusher)
# ---------------------------------------------------------------------------

def test_kernel_library_builds_and_loads_once_under_threads(monkeypatch,
                                                            tmp_path):
    """Threads whose first launches race each other build and load the
    library once (the build is stubbed: no nvcc on this machine)."""
    builds, loads, libs = [], [], []

    def fake_build(out):
        builds.append(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"")

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.rt_error_string = types.SimpleNamespace()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    barrier = threading.Barrier(8)

    def first_launch():
        barrier.wait(30.0)
        libs.append(_build.library())

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
    assert len(builds) == 1 and len(loads) == 1


def test_launch_counters_count_every_concurrent_launch():
    module = types.SimpleNamespace(launches=0)
    barrier = threading.Barrier(8)

    def launcher():
        barrier.wait(30.0)
        for _ in range(5000):
            _build.count_launch(module)

    threads = [threading.Thread(target=launcher) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert module.launches == 8 * 5000


def test_engine_stats_count_every_concurrent_batch():
    """Serving threads share one ``EngineStats``: every batch and request
    of 8 threads is counted, and a pooled engine's slices count as its
    workers' batches."""
    e = _engine("port", {"parallel_workers": 4})
    e.deploy("f", SQL)
    s0 = e.stats.snapshot()
    barrier = threading.Barrier(8)
    errors = []

    def serve(seed):
        try:
            barrier.wait(30.0)
            for i in range(10):
                e.request("f", *_requests(seed * 100 + i))
        except Exception as ex:              # raised again below
            errors.append(ex)

    threads = [threading.Thread(target=serve, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not errors and not any(t.is_alive() for t in threads)
    d = {k: v - s0[k] for k, v in e.stats.snapshot().items()}
    assert d["n_requests"] == 8 * 10 * B
    assert d["n_batches"] == 8 * 10 * min(4, B)
    assert d["serve_s"] > 0 and d["exec_s"] > 0
    e.close()
