"""Port control plane (``repro_torch.control``) against the JAX package's
(``repro.control``) on the same numpy inputs.

Every case of ``tests/test_control.py`` runs here on both packages (the
port's engines on ``device="cpu"``) and the results are compared:
telemetry (ring series, stats snapshots and deltas, the latency sketch,
the collector, join staleness), the calibrator and the element profile,
the knob controller and its replay, admission, the batcher's and the
router's live knobs, the replan loop (flip, swap under a serving thread,
health gate, rollback, no-change), and the control plane's tick, loop
and client-observed p99.

Tolerances: exact for ``CostCalibrator.fit``, the knob controller's
decision log for the same observations, the Replanner's and the control
plane's event sequences (times and measured seconds left out), the plan
decisions, counters and statuses; sums and averages of served features
against JAX within ``rtol 2e-4`` (atol 1e-5).

The health gate compares a post-swap p99 with the pre-swap one. Here no
case leaves that decision to the wall clock: before ``check_health`` the
latency sketches are filled with injected values, which pins
``committed`` or ``rolled_back``. Threaded cases still serve through the
swap and assert zero failed requests; they wait on events and bounded
joins, never sleep and then assert on timing.
"""
import importlib
import json
import math
import threading
import time
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SQL = """
SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 50 PRECEDING AND CURRENT ROW)
"""

JOIN_SQL = """
SELECT SUM(amount) OVER w AS s,
       merchants.rating AS rating
FROM events
LAST JOIN merchants ORDER BY mts ON merchant
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 20 PRECEDING AND CURRENT ROW)
"""


def _load(pkg: str) -> types.SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")
    control = imp("control")
    eng_mod = imp("core.engine")
    ns = types.SimpleNamespace(
        pkg=pkg,
        ControlPlane=control.ControlPlane,
        CostCalibrator=control.CostCalibrator,
        KnobConfig=control.KnobConfig,
        KnobController=control.KnobController,
        LoadObservation=control.LoadObservation,
        MetricsCollector=control.MetricsCollector,
        Replanner=control.Replanner, RingSeries=control.RingSeries,
        differs_materially=control.differs_materially,
        plan_element_profile=control.plan_element_profile,
        Engine=eng_mod.Engine, EngineStats=eng_mod.EngineStats,
        HandleMetrics=eng_mod.HandleMetrics,
        CostModel=imp("core.optimizer").CostModel,
        OptFlags=imp("core.optimizer").OptFlags,
        CacheStats=imp("core.plan_cache").CacheStats,
        STATUS_OK=imp("core.results").STATUS_OK,
        RequestContext=imp("core.results").RequestContext,
        TableSchema=imp("featurestore.table").TableSchema,
        AdmissionConfig=imp("shard.resource").AdmissionConfig,
        ResourceManager=imp("shard.resource").ResourceManager,
        BatcherConfig=imp("serving.batcher").BatcherConfig,
        DynamicBatcher=imp("serving.batcher").DynamicBatcher,
        ShardRouter=imp("shard.router").ShardRouter,
    )
    if pkg == "repro_torch":
        E = ns.Engine
        ns.Engine = lambda *a, **k: E(*a, device="cpu", **k)
    return ns


J = _load("repro")
T = _load("repro_torch")
BOTH = (J, T)


def make_engine(ns, flags=None, n_events=400, n_keys=16, seed=0):
    eng = ns.Engine(flags or ns.OptFlags())
    eng.create_table(ns.TableSchema("events", key_col="user", ts_col="ts",
                                    value_cols=("amount", "lat", "lon")),
                     max_keys=64, capacity=256, bucket_size=32)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n_events)
    ts = np.sort(rng.uniform(0, 1000, n_events)).astype(np.float32)
    rows = rng.normal(0, 2, size=(n_events, 3)).astype(np.float32)
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    return eng


def make_join_engine(ns, seed=0):
    eng = ns.Engine(ns.OptFlags())
    eng.create_table(ns.TableSchema("events", key_col="user", ts_col="ts",
                                    value_cols=("amount", "merchant")),
                     max_keys=32, capacity=256, bucket_size=32)
    eng.create_table(ns.TableSchema("merchants", key_col="merchant",
                                    ts_col="mts",
                                    value_cols=("rating", "risk")),
                     max_keys=16, capacity=64, bucket_size=8)
    rng = np.random.default_rng(seed)
    n = 200
    keys = rng.integers(0, 8, n)
    ts = np.sort(rng.uniform(0, 1000, n)).astype(np.float32)
    mids = rng.integers(0, 4, n)
    rows = np.stack([rng.normal(0, 2, n),
                     mids.astype(np.float64)], -1).astype(np.float32)
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    return eng


def serve(eng, name, n_batches=8, B=8, seed=1, rows=False):
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_batches):
        rk = rng.integers(0, 8, B)
        rt = np.sort(rng.uniform(1100, 1500, B)).astype(np.float32)
        rr = None
        if rows:
            rr = np.stack([rng.normal(0, 2, B),
                           rng.integers(0, 4, B).astype(np.float64)],
                          -1).astype(np.float32)
        frames.append(eng.request(name, rk.tolist(), rt.tolist(), rr))
    return frames


def _frames_close(tf, jf):
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        assert np.array_equal(a.status, b.status)
        assert set(a.columns) == set(b.columns)
        for n in b.columns:
            np.testing.assert_allclose(a.columns[n], b.columns[n],
                                       rtol=2e-4, atol=1e-5)


def _untimed(events):
    """An event log without its measured seconds and model reprs."""
    drop = ("baseline_p99_s", "new_p99_s", "model")
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


# ---------------------------------------------------------------- telemetry
def test_ring_series_bounded_fifo():
    out = []
    for ns in BOTH:
        s = ns.RingSeries(maxlen=4)
        for i in range(10):
            s.append(float(i), float(i * 2))
        assert len(s) == 4
        assert s.values() == [12.0, 14.0, 16.0, 18.0]
        assert s.last() == 18.0
        out.append(s.to_json())
    assert out[1] == out[0] == {"t": [6.0, 7.0, 8.0, 9.0],
                                "v": [12.0, 14.0, 16.0, 18.0]}


def test_engine_stats_snapshot_delta():
    out = []
    for ns in BOTH:
        st = ns.EngineStats()
        base = st.snapshot()
        st.n_requests += 10
        st.exec_s += 0.5
        st.kernel_launches += 3
        d = st.delta(base)
        assert d["n_requests"] == 10 and d["kernel_launches"] == 3
        assert d["exec_s"] == pytest.approx(0.5)
        assert d["n_batches"] == 0
        snap2 = st.snapshot()
        st.n_requests += 5
        assert snap2["n_requests"] == 10
        assert st.delta(st.snapshot())["n_requests"] == 0
        out.append((d, snap2))
    assert out[1] == out[0]


def test_cache_stats_snapshot():
    out = []
    for ns in BOTH:
        cs = ns.CacheStats(hits=3, misses=1, compile_seconds=0.25)
        snap = cs.snapshot()
        assert snap["hits"] == 3 and snap["hit_rate"] == pytest.approx(0.75)
        cs.hits += 100
        assert snap["hits"] == 3
        json.dumps(snap)
        out.append(snap)
    assert out[1] == out[0]


def test_handle_metrics_latency_sketch():
    out = []
    for ns in BOTH:
        m = ns.HandleMetrics()
        assert math.isnan(m.latency_percentile(99))
        for i in range(600):
            m.observe_latency(0.001 * (i + 1))
        assert len(m.latency_s) == 600
        p99 = m.latency_percentile(99)
        assert p99 == pytest.approx(0.001 * 595, rel=0.05)
        snap = m.snapshot()
        assert snap["latency_samples"] == 600
        assert snap["latency_p99_s"] >= snap["latency_p50_s"]
        assert snap["latency_sketch"]["kind"] == "qsketch"
        json.dumps(snap)
        out.append((p99, snap))
    assert out[1] == out[0]


def _collector(ns):
    eng = make_engine(ns)
    eng.deploy("f", SQL)
    col = ns.MetricsCollector(eng)
    s0 = col.sample()
    frames = serve(eng, "f", n_batches=5)
    s1 = col.sample()
    assert s1["deployments"]["f"]["delta"]["batches"] == 5
    assert s1["deployments"]["f"]["delta"]["requests"] == 40
    assert s1["engine_delta"]["n_batches"] >= 5
    assert s0["cache"]["hits"] <= s1["cache"]["hits"]
    assert s1["deployments"]["f"]["joins"] == {}
    snap = col.snapshot()
    json.dumps(snap)
    assert snap["n_samples"] == 2
    assert "dep.f.p99_s" in snap["series"]
    out = (s1["deployments"]["f"]["delta"],
           {k: s1["engine_delta"][k] for k in
            ("n_requests", "n_batches", "kernel_launches")},
           sorted(snap["series"]), sorted(s1), frames)
    eng.close()
    return out


def test_collector_samples_and_snapshot_json():
    *tout, tf = _collector(T)
    *jout, jf = _collector(J)
    _frames_close(tf, jf)
    # the delta's serve_s is measured; the counters and the series names
    # are the JAX package's
    tout[0].pop("serve_s")
    jout[0].pop("serve_s")
    assert tout == jout


def _join_collector(ns):
    eng = make_join_engine(ns)
    eng.insert("merchants", [0, 1, 2, 3], [50.0] * 4,
               np.asarray([[m, m * 0.1] for m in range(4)], np.float32))
    eng.deploy("f", JOIN_SQL)
    col = ns.MetricsCollector(eng)
    frames = serve(eng, "f", n_batches=3, rows=True)
    s = col.sample()
    st = s["deployments"]["f"]["joins"]["merchants"]
    assert st["probes"] == 24
    assert 0.0 <= st["match_rate"] <= 1.0
    assert "dep.f.join.merchants.match_rate" in col.series
    json.dumps(s)
    eng.close()
    return st, sorted(col.series), frames


def test_collector_samples_join_staleness():
    tst, tser, tf = _join_collector(T)
    jst, jser, jf = _join_collector(J)
    assert tst == jst
    assert tser == jser
    _frames_close(tf, jf)


# ------------------------------------------------- join staleness reservoir
def _join_empty(ns):
    eng = make_join_engine(ns)
    dep = eng.deploy("f", JOIN_SQL)
    st = dep.join_staleness()["merchants"]
    assert st["probes"] == 0 and st["matches"] == 0
    assert st["match_rate"] == 0.0
    assert math.isnan(st["age_p50"]) and math.isnan(st["age_p99"])
    assert st["age_samples"] == 0
    eng.close()
    return {k: v for k, v in st.items() if k not in ("age_p50", "age_p99")}


def test_join_staleness_empty_reservoir_percentiles():
    assert _join_empty(T) == _join_empty(J)


def _join_zero(ns):
    eng = make_join_engine(ns)
    eng.insert("merchants", [0], [100.0], np.asarray([[1.0, 0.5]],
                                                     np.float32))
    dep = eng.deploy("f", JOIN_SQL)
    rng = np.random.default_rng(2)
    B = 8
    rk = rng.integers(0, 8, B)
    rt = np.full(B, 1200.0, np.float32)
    rr = np.stack([rng.normal(0, 2, B), np.full(B, 9.0)],
                  -1).astype(np.float32)
    eng.request("f", rk.tolist(), rt.tolist(), rr)
    st = dep.join_staleness()["merchants"]
    assert st["probes"] == B and st["matches"] == 0
    assert st["match_rate"] == 0.0
    assert math.isnan(st["age_p99"])
    eng.close()
    return {k: v for k, v in st.items() if k not in ("age_p50", "age_p99")}


def test_join_staleness_zero_probe_rows_after_serving():
    assert _join_zero(T) == _join_zero(J)


def _join_ages(ns):
    eng = make_join_engine(ns, seed=3)
    eng.insert("merchants", [0, 1, 2, 3], [50.0] * 4,
               np.asarray([[m, m * 0.1] for m in range(4)], np.float32))
    dep = eng.deploy("f", JOIN_SQL)
    h = eng.handle("f")
    ages = np.arange(1012, dtype=np.float64)
    res = {"__join_match_merchants": np.ones(len(ages), np.float32),
           "__join_age_merchants": ages}
    h._record_join_stats(res, len(ages))
    sk = h._join_ages["merchants"]
    st = dep.join_staleness()["merchants"]
    eng.close()
    return sk.to_dict(), st


def test_join_age_sketch_determinism_and_bounded_state():
    d1, st1 = _join_ages(T)
    d2, st2 = _join_ages(T)
    assert d1 == d2
    assert st1["age_samples"] == st2["age_samples"] == 1012
    assert st1["age_p99"] == st2["age_p99"]
    assert st1["age_p99"] == pytest.approx(0.99 * 1011, rel=0.05)
    assert len(d1["pos"]) < 1012 // 2
    json.dumps(st1)
    jd, jst = _join_ages(J)
    assert d1 == jd and st1 == jst           # bit for bit against JAX


# --------------------------------------------------------------- calibrator
def test_calibrator_under_sampled_returns_none():
    for ns in BOTH:
        cal = ns.CostCalibrator(min_samples=8)
        for _ in range(7):
            cal.observe("scan", 100.0, 0.001)
        assert cal.fit() is None


def _fit(ns):
    cal = ns.CostCalibrator(min_samples=4)
    for _ in range(6):
        cal.observe("scan", 200.0, 0.0002)
        cal.observe("preagg", 100.0, 0.0005)
        cal.observe("join", 50.0, 0.0001)
    m = cal.fit()
    assert m.scan_el == pytest.approx(1.0)
    assert m.preagg_el == pytest.approx(5.0)
    assert m.join_el == pytest.approx(2.0)
    assert ns.differs_materially(m, ns.CostModel())
    assert not ns.differs_materially(m, m)
    return (m.scan_el, m.preagg_el, m.join_el, tuple(m.table_el))


def test_calibrator_normalizes_to_scan():
    assert _fit(T) == _fit(J)                # exact


def _fit_tables(ns):
    cal = ns.CostCalibrator(min_samples=4)
    for _ in range(6):
        cal.observe("scan", 100.0, 0.0001)
        cal.observe("join", 50.0, 0.0001, table="hot")
        cal.observe("join", 50.0, 0.0004, table="cold")
    m = cal.fit()
    w = dict(m.table_el)
    assert w["cold"] / w["hot"] == pytest.approx(4.0)
    assert (m.table_weight("cold") / m.table_weight("hot")
            == pytest.approx(4.0))
    return (m.scan_el, m.preagg_el, m.join_el, tuple(m.table_el))


def test_calibrator_per_table_join_weights():
    assert _fit_tables(T) == _fit_tables(J)


def _default_model(ns):
    eng = make_engine(ns)
    dep = eng.deploy("f", SQL)
    assert eng.cost_model == ns.CostModel()
    impl = dict(dep.plan.window_impl)
    assert impl["w"] == "preagg"
    eng.close()
    return impl, dep.plan.fingerprint()


def test_cost_model_default_reproduces_seed_costs():
    assert _default_model(T) == _default_model(J)


def _profile(ns):
    eng = make_engine(ns)
    dep = eng.deploy("f", SQL)
    prof = ns.plan_element_profile(dep)
    assert prof.get("preagg", 0) > 0
    assert "join" not in prof
    jeng = make_join_engine(ns)
    jprof = ns.plan_element_profile(jeng.deploy("f", JOIN_SQL))
    eng.close()
    jeng.close()
    return prof, jprof


def test_plan_element_profile_kinds():
    assert _profile(T) == _profile(J)


# ------------------------------------------------------------------- knobs
def _hysteresis(ns):
    c = ns.KnobController(ns.KnobConfig(hysteresis_ticks=2), delay_s=0.004)
    hot = ns.LoadObservation(p99_s=0.5, shed=1)
    calm = ns.LoadObservation(p99_s=0.005)
    assert c.step(hot) == []
    assert c.step(calm) == []
    assert c.step(hot) == []
    decisions = c.step(hot)
    assert len(decisions) == 1
    assert decisions[0].knob == "delay_s"
    assert decisions[0].new == pytest.approx(0.002)
    return c.log


def test_knob_hysteresis_one_bad_tick_is_ignored():
    assert _hysteresis(T) == _hysteresis(J)


def _aimd(ns):
    cfg = ns.KnobConfig(hysteresis_ticks=1, min_delay_s=0.001,
                        max_delay_s=0.003, max_dispatch_rows=300)
    c = ns.KnobController(cfg, delay_s=0.003, dispatch_rows=256,
                          max_inflight=8)
    hot = ns.LoadObservation(p99_s=1.0, shed=3, rejected=1)
    for _ in range(5):
        c.step(hot)
    assert c.knobs["delay_s"] == pytest.approx(0.001)
    assert c.knobs["max_inflight"] > 8
    cool = ns.LoadObservation(p99_s=0.0001)
    for _ in range(10):
        c.step(cool)
    assert c.knobs["delay_s"] == pytest.approx(0.003)
    assert c.knobs["dispatch_rows"] == 300
    return c.log, dict(c.knobs)


def test_knob_aimd_bounds_and_directions():
    assert _aimd(T) == _aimd(J)


def _replay(ns):
    cfg = ns.KnobConfig(hysteresis_ticks=2)
    init = {"delay_s": 0.002, "dispatch_rows": 128, "max_inflight": 8}
    c = ns.KnobController(cfg, seed=42, **init)
    rng = np.random.default_rng(42)
    for _ in range(40):
        c.step(ns.LoadObservation(
            p99_s=float(rng.uniform(0.001, 0.05)),
            queue_depth=int(rng.integers(0, 4)),
            shed=int(rng.integers(0, 2)),
            rejected=int(rng.integers(0, 2)),
            requests=int(rng.integers(1, 100))))
    assert any(e["decisions"] for e in c.log)
    replayed = ns.KnobController.replay(cfg, 42, init, c.log)
    assert replayed.log == c.log
    json.dumps(c.log)
    return c.log


def test_knob_decision_log_replays_identically():
    tlog = _replay(T)
    assert tlog == _replay(J)                 # the same decision log
    # a JAX-written log replays through the port's controller
    cfg = T.KnobConfig(hysteresis_ticks=2)
    init = {"delay_s": 0.002, "dispatch_rows": 128, "max_inflight": 8}
    assert T.KnobController.replay(cfg, 42, init, _replay(J)).log == tlog


# --------------------------------------------------------------- admission
# The port's ResourceManager is the JAX module's copy; each case runs on
# both and compares outcomes and counters. Timeouts are bounded loosely
# (the request gave up at its bound, not at a far later one).
def _admit_deadline(ns):
    mgr = ns.ResourceManager(ns.AdmissionConfig(max_inflight=1,
                                                admit_timeout_s=0.15))
    hold = mgr.admit("d", None)
    ctx = ns.RequestContext.with_timeout(10.0)
    t0 = time.monotonic()
    adm = mgr.admit("d", ctx)
    waited = time.monotonic() - t0
    assert adm.shed
    assert waited < 5.0                       # the cap, not the 10 s
    assert mgr.metrics()["shed_deadline"] == 1
    hold.release()
    return mgr.metrics()


def test_admit_deadlined_request_sheds_instead_of_raising():
    assert _admit_deadline(T) == _admit_deadline(J)


def _admit_at_deadline(ns):
    mgr = ns.ResourceManager(ns.AdmissionConfig(max_inflight=1,
                                                admit_timeout_s=30.0))
    hold = mgr.admit("d", None)
    ctx = ns.RequestContext.with_timeout(0.1)
    t0 = time.monotonic()
    adm = mgr.admit("d", ctx)
    waited = time.monotonic() - t0
    assert adm.shed
    assert 0.05 < waited < 15.0               # the deadline, not the cap
    hold.release()
    return mgr.metrics()


def test_admit_sheds_at_the_request_deadline_not_later():
    assert _admit_at_deadline(T) == _admit_at_deadline(J)


def _admit_raise(ns):
    mgr = ns.ResourceManager(ns.AdmissionConfig(max_inflight=1,
                                                admit_timeout_s=0.05))
    hold = mgr.admit("d", None)
    with pytest.raises(RuntimeError, match="admission control"):
        mgr.admit("d", None)
    assert mgr.metrics()["rejected_inflight"] == 1
    hold.release()
    return mgr.metrics()


def test_admit_deadline_less_still_raises_backpressure():
    assert _admit_raise(T) == _admit_raise(J)


def _admit_budget(ns):
    mgr = ns.ResourceManager(ns.AdmissionConfig(max_inflight=4,
                                                min_service_budget_s=0.2))
    adm = mgr.admit("d", ns.RequestContext.with_timeout(0.05))
    assert adm.shed
    adm2 = mgr.admit("d", ns.RequestContext.with_timeout(5.0))
    assert not adm2.shed
    adm2.release()
    return mgr.metrics()


def test_admit_min_service_budget_sheds_doomed_work():
    assert _admit_budget(T) == _admit_budget(J)


def _admit_wake(ns):
    mgr = ns.ResourceManager(ns.AdmissionConfig(max_inflight=1,
                                                admit_timeout_s=5.0))
    hold_a = mgr.admit("a", None)
    hold_b = mgr.admit("b", None)
    results = {}
    waiting = threading.Barrier(3)

    def waiter(name):
        waiting.wait(5.0)
        adm = mgr.admit(name, ns.RequestContext.with_timeout(3.0))
        results[name] = adm
        adm.release()

    ts = [threading.Thread(target=waiter, args=(n,)) for n in ("a", "b")]
    for t in ts:
        t.start()
    waiting.wait(5.0)
    hold_b.release()
    hold_a.release()
    for t in ts:
        t.join(timeout=5.0)
    assert set(results) == {"a", "b"}
    assert not results["a"].shed and not results["b"].shed
    return mgr.metrics()["shed_deadline"]


def test_admit_release_wakes_waiters_across_deployments():
    assert _admit_wake(T) == _admit_wake(J) == 0


def _admit_reconfigure(ns):
    mgr = ns.ResourceManager(ns.AdmissionConfig(max_inflight=1,
                                                admit_timeout_s=5.0))
    hold = mgr.admit("d", None)
    got = {}
    started = threading.Event()

    def waiter():
        started.set()
        got["adm"] = mgr.admit("d", ns.RequestContext.with_timeout(3.0))

    t = threading.Thread(target=waiter)
    t.start()
    started.wait(5.0)
    mgr.reconfigure(max_inflight=2)
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert not got["adm"].shed
    got["adm"].release()
    hold.release()
    return mgr.cfg.max_inflight, mgr.metrics()


def test_admission_reconfigure_unblocks_live_waiter():
    assert _admit_reconfigure(T) == _admit_reconfigure(J)


# ------------------------------------------------------------ batcher knobs
def _batcher_knobs(ns):
    done = threading.Event()

    def slow_serve(keys, ts, payloads):
        done.wait(0.2)
        return {"x": np.zeros(len(keys), np.float32)}

    b = ns.DynamicBatcher(slow_serve, ns.BatcherConfig(max_batch=64,
                                                       max_delay_s=0.05))
    try:
        prev = b.reconfigure(max_delay_s=0.001)
        assert prev.max_delay_s == pytest.approx(0.05)
        assert b.cfg.max_delay_s == pytest.approx(0.001)
        with pytest.raises(ValueError):
            b.reconfigure(num_dispatchers=4)
        assert b.queue_depth() == 0 and b.oldest_age_s() == 0.0
        r = b.submit(1, 100.0)
        done.set()
        r.wait(5.0)
        return prev, b.cfg, r.result
    finally:
        done.set()
        b.close()


def test_batcher_reconfigure_and_introspection():
    tp, tc, tr = _batcher_knobs(T)
    jp, jc, jr = _batcher_knobs(J)
    assert (tp.max_delay_s, tp.max_batch) == (jp.max_delay_s, jp.max_batch)
    assert (tc.max_delay_s, tc.max_batch) == (jc.max_delay_s, jc.max_batch)
    assert tr == jr


def _router_retune(ns):
    r = ns.ShardRouter(2, dispatch_rows=256, coalesce_delay_s=0.002)
    try:
        assert r.set_dispatch_rows(64) == 256
        assert r.dispatch_rows == 64
        assert all(l.dispatch_rows == 64 and l.max_drain_rows == 256
                   for l in r.lanes)
        assert r.set_coalesce_delay(0.0) == pytest.approx(0.002)
        assert all(l.coalesce_delay_s == 0.0 for l in r.lanes)
        with pytest.raises(ValueError):
            r.set_dispatch_rows(0)
        return ([(l.dispatch_rows, l.max_drain_rows, l.coalesce_delay_s)
                 for l in r.lanes], r.dispatch_rows)
    finally:
        r.close()


def test_router_live_retune():
    assert _router_retune(T) == _router_retune(J)


# -------------------------------------------------------------- closed loop
def _flip_swap_commit(ns):
    """Skewed measurements flip the naive/preagg decision; the Replanner
    rolls the new plan through build -> warm -> publish while a serving
    thread hammers the deployment (zero failed requests, zero non-OK
    statuses), and the health gate commits. The gate's inputs are
    injected: the old version's sketch holds 2 ms batches, the new
    version's 2.5 ms ones (1.25x, under the 1.5x factor)."""
    eng = make_engine(ns)
    eng.deploy("f", SQL)
    assert dict(eng.handle("f").plan.window_impl)["w"] == "preagg"
    serve(eng, "f", n_batches=6)
    old = eng.handle("f")
    old.metrics.latency_s.clear()
    for _ in range(256):
        old.metrics.observe_latency(0.002)

    cal = ns.CostCalibrator(min_samples=4)
    for _ in range(8):
        cal.observe("scan", 100.0, 0.0001)
        cal.observe("preagg", 100.0, 0.0010)
    model = cal.fit(base=eng.cost_model)
    assert model.preagg_el == pytest.approx(10.0)

    stop = threading.Event()
    failures = []
    served = [0]
    swapped = threading.Event()
    after_swap = threading.Event()

    def hammer():
        rng = np.random.default_rng(9)
        n_after = 0
        while not stop.is_set():
            rk = rng.integers(0, 8, 4)
            rt = np.sort(rng.uniform(1100, 1500, 4)).astype(np.float32)
            try:
                fr = eng.request("f", rk.tolist(), rt.tolist())
                if not np.all(np.asarray(fr.status) == ns.STATUS_OK):
                    failures.append(f"bad status {fr.status}")
                served[0] += 1
                if swapped.is_set():
                    n_after += 1
                    if n_after >= 10:
                        after_swap.set()
            except Exception as e:          # noqa: BLE001
                failures.append(repr(e))

    t = threading.Thread(target=hammer)
    t.start()
    try:
        rp = ns.Replanner(eng, "f", min_health_batches=4)
        rep = rp.maybe_replan(model)
        swapped.set()
        assert rep["action"] == "swapped"
        # keep serving across the swap before stopping the hammer
        assert after_swap.wait(60.0)
    finally:
        stop.set()
        t.join(timeout=30.0)
    assert not t.is_alive()
    assert failures == []
    assert served[0] >= 10

    live = eng.handle("f")
    assert dict(live.plan.window_impl)["w"] == "naive"
    assert rp.state == ns.Replanner.MONITORING
    frames = serve(eng, "f", n_batches=6, seed=11)
    live.metrics.latency_s.clear()
    for _ in range(16):
        live.metrics.observe_latency(0.0025)
    health = rp.check_health()
    assert health["action"] == "committed"
    assert rp.state == ns.Replanner.IDLE
    json.dumps(rp.events)
    out = (_untimed(rp.events), dict(live.plan.window_impl),
           live.plan.fingerprint(), frames)
    eng.close()
    return out


def test_closed_loop_flip_swap_zero_failures_and_commit():
    *tout, tf = _flip_swap_commit(T)
    *jout, jf = _flip_swap_commit(J)
    assert tout == jout                       # the same event sequence
    _frames_close(tf, jf)


def _rollback(ns):
    eng = make_engine(ns)
    eng.deploy("f", SQL)
    serve(eng, "f", n_batches=6)
    live = eng.handle("f")
    v1 = live.version
    live.metrics.latency_s.clear()
    for _ in range(32):
        live.metrics.observe_latency(0.002)
    model = ns.CostModel(preagg_el=10.0)
    rp = ns.Replanner(eng, "f", min_health_batches=8, regress_factor=1.5)
    rep = rp.maybe_replan(model)
    assert rep["action"] == "swapped"
    new = eng.handle("f")
    assert new.version != v1
    for _ in range(16):
        new.metrics.observe_latency(0.050)
    health = rp.check_health()
    assert health["action"] == "rolled_back"
    assert eng.handle("f").version == v1
    assert eng.cost_model == ns.CostModel()
    assert rp.state == ns.Replanner.IDLE
    out = (rp.events, dict(eng.handle("f").plan.window_impl))
    eng.close()
    return out


def test_closed_loop_auto_rollback_on_p99_regression():
    """The injected latencies pin the gate: the events, p99 values
    included, are the JAX package's."""
    assert json.dumps(_rollback(T)) == json.dumps(_rollback(J))


def _no_change(ns):
    eng = make_engine(ns)
    eng.deploy("f", SQL)
    v1 = eng.handle("f").version
    model = ns.CostModel(preagg_el=1.2)
    rp = ns.Replanner(eng, "f")
    rep = rp.maybe_replan(model)
    assert rep["action"] == "no_change"
    assert eng.handle("f").version == v1
    assert eng.cost_model == model
    out = (rp.events, eng.handle("f").version,
           sorted(eng._versions["f"]))
    eng.close()
    return out


def test_replan_no_change_keeps_model_without_swap():
    assert _no_change(T) == _no_change(J)


def _untimed_report(r):
    """A tick report without its measured numbers (latency, fitted)."""
    load = dict(r["load"])
    load.pop("p99_s")
    return {"tick": r["tick"], "recovering": r["recovering"],
            "observations_fed": r["observations_fed"],
            "replan": r["replan"]["action"], "health": r["health"],
            "load": load, "knobs": r["knobs"]}


def _tick(ns):
    eng = make_engine(ns)
    eng.deploy("f", SQL)
    plane = ns.ControlPlane(eng, "f", rel_tol=0.2, replan=False)
    # no knob surface is wired (no batcher, router or admission), so no
    # knob decision can depend on the measured p99
    assert plane.knobs.knobs == {}
    serve(eng, "f", n_batches=6)
    r1 = plane.tick()
    serve(eng, "f", n_batches=6, seed=5)
    r2 = plane.tick()
    assert r2["tick"] == 1
    assert r2["observations_fed"] > 0
    assert r2["load"]["requests"] == 48
    snap = plane.snapshot()
    json.dumps(snap)
    assert snap["deployment"] == "f"
    assert snap["telemetry"]["n_samples"] == 2
    out = [_untimed_report(r) for r in (r1, r2)]
    eng.close()
    return out


def test_control_plane_tick_and_snapshot():
    """The same reports as the JAX package's, measured numbers left out.
    (Re-planning is off here: whether the fitted model re-plans depends
    on measured seconds; the replan cases above pin their inputs.)"""
    assert _tick(T) == _tick(J)


def _replan_tick(ns):
    """A tick whose calibrator was fed the flip: the plane hands the
    fitted model to the Replanner, and the next ticks' health checks
    (latencies injected) commit it."""
    eng = make_engine(ns)
    eng.deploy("f", SQL)
    cal = ns.CostCalibrator(min_samples=4)
    for _ in range(8):
        cal.observe("scan", 100.0, 0.0001)
        cal.observe("preagg", 100.0, 0.0010)
    plane = ns.ControlPlane(eng, "f", calibrator=cal,
                            replanner=ns.Replanner(eng, "f",
                                                   min_health_batches=4))
    # nothing served yet: no observations, the fit rests on the feed
    eng.handle("f").metrics.observe_latency(0.002)
    r1 = plane.tick()
    assert r1["replan"]["action"] == "swapped"
    live = eng.handle("f")
    assert dict(live.plan.window_impl)["w"] == "naive"
    for _ in range(4):
        live.metrics.observe_latency(0.002)
    r2 = plane.tick()
    assert r2["health"]["action"] == "committed"
    out = (_untimed(plane.replanner.events),
           [r["replan"]["action"] for r in (r1, r2)],
           r2["health"]["action"])
    eng.close()
    return out


def test_control_plane_tick_replans_on_a_flipped_fit():
    assert _replan_tick(T) == _replan_tick(J)


def _loop(ns):
    eng = make_engine(ns)
    eng.deploy("f", SQL)
    plane = ns.ControlPlane(eng, "f")
    ticked = threading.Event()
    orig = plane.tick

    def tick():
        r = orig()
        ticked.set()
        return r

    plane.tick = tick
    plane.start(interval_s=0.02)
    try:
        serve(eng, "f", n_batches=4)
        assert ticked.wait(30.0)
        with pytest.raises(RuntimeError, match="already started"):
            plane.start()
    finally:
        plane.stop()
    assert plane.reports
    assert plane._thread is None
    eng.close()
    return plane.reports[0]["tick"]


def test_control_plane_background_loop():
    assert _loop(T) == _loop(J) == 0


# ---------------------------------------------------- client latency signal
def _client_latency(ns):
    gate = threading.Event()
    entered = threading.Event()

    def gated_serve(keys, ts, payloads):
        entered.set()
        gate.wait(5.0)
        return {"x": np.zeros(len(keys), np.float32)}

    b = ns.DynamicBatcher(gated_serve, ns.BatcherConfig(max_batch=64,
                                                        max_delay_s=0.0))
    try:
        assert math.isnan(b.client_latency_percentile(99))
        rs = [b.submit(i, 100.0) for i in range(8)]
        assert entered.wait(5.0)
        time.sleep(0.05)                 # queueing time, serve blocked
        gate.set()
        for r in rs:
            r.wait(5.0)
        p99 = b.client_latency_percentile(99)
        # enqueue -> completion covers the blocked serve: at least the
        # 50 ms the gate was held (a lower bound the test itself set),
        # less the sketch's 1 % relative error
        assert math.isfinite(p99) and p99 >= 0.045
        return sorted(b.stats.items())
    finally:
        gate.set()
        b.close()


def test_batcher_client_latency_includes_queueing():
    tst = dict(_client_latency(T))
    jst = dict(_client_latency(J))
    assert tst["requests"] == jst["requests"] == 8


def _client_p99(ns):
    class _Srv:                          # duck-typed FeatureServer
        def __init__(self, batcher):
            self.batcher = batcher

    eng = make_engine(ns)
    eng.deploy("f", SQL)

    def fserve(keys, ts, payloads):
        fr = eng.request("f", list(keys), list(ts))
        return dict(fr.columns)

    b = ns.DynamicBatcher(fserve, ns.BatcherConfig(max_batch=8,
                                                   max_delay_s=0.001))
    plane = ns.ControlPlane(eng, "f", server=_Srv(b))
    try:
        rs = [b.submit(k, 2000.0) for k in range(16)]
        for r in rs:
            r.wait(5.0)
        sample = plane.collector.sample()
        client_p99 = sample["batcher"]["client_p99_s"]
        assert math.isfinite(client_p99)
        assert "batcher.client_p99_s" in plane.collector.series
        obs = plane._load_observation(sample)
        assert obs.p99_s == pytest.approx(client_p99)
        return (sorted(sample["batcher"]), sorted(plane.collector.series),
                obs.requests, obs.queue_depth)
    finally:
        b.close()
        eng.close()


def test_plane_prefers_client_observed_p99():
    assert _client_p99(T) == _client_p99(J)
