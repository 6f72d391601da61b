"""Port observability (``repro_torch.obs`` and the engine's hooks) against
the JAX package's (``repro.obs``) on the same numpy inputs.

Every case of ``tests/test_obs.py`` and ``tests/test_freshness.py`` that
runs in one process is here, run on both packages (the port on
``device="cpu"``) and compared: trace ids, the tracer (sampling, bounded
storage, adoption, trees, the slow-query log), the decomposition
identity, EXPLAIN ANALYZE, the profiler's calibrator feed, single-engine
and sharded trace trees, the metrics registry and its renderers, the
collector, the sketches, freshness stamps and sketches, SLO burn rates,
the SLO -> control plane -> flight recorder path, drift, and the flight
recorder. The process-backend cases (the trace across a worker respawn,
the registry's ``transport`` and ``recovery`` groups, the worker-down
flight dump) are in ``tests/test_torch_chaos.py`` with the rest of the
process runtime's.

Tolerances:
- exact: sketch ``to_dict`` (bit for bit), cardinality estimates, PSI
  values, SLO states and burn rates with explicit ``now``, span names
  and tree shapes, counters, the Prometheus text of the same registry
  contents, ``operator_rows`` and the attributed shares for the same
  ``exec_s``, ``explain_analyze`` with its seconds masked;
- bit for bit: the freshness snapshots (age, ingest-column and key
  sketches) of a port engine and a JAX engine that serve the same
  requests, and the drift sketches of columns that are counts;
- drift columns built from sums: a sum that rounding moved can land in a
  neighbouring sketch bucket, so their sketches are held to equal counts,
  min/max within ``rtol 2e-4`` and percentiles within twice the sketch's
  relative error (the case is stated where it is checked).

No case asserts on a wall-clock latency; the decomposition and the
attribution identities hold by construction (host time is the residual).
"""
import importlib
import json
import math
import os
import re
import time
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SQL = """SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 10 PRECEDING AND CURRENT ROW)"""

N_KEYS = 16
N_TICKS = 40            # event-time grid 0..39; watermark = 39.0


def _load(pkg: str) -> types.SimpleNamespace:
    """The names a case needs, from one package (``repro`` or
    ``repro_torch``). The port's engines run on the CPU."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")
    eng_mod = imp("core.engine")
    shard = imp("shard")
    ns = types.SimpleNamespace(
        pkg=pkg,
        Engine=eng_mod.Engine, EngineStats=eng_mod.EngineStats,
        OptFlags=imp("core.optimizer").OptFlags,
        CostModel=imp("core.optimizer").CostModel,
        STATUS_OK=imp("core.results").STATUS_OK,
        RequestContext=imp("core.results").RequestContext,
        TableSchema=imp("featurestore.table").TableSchema,
        MetricsRegistry=imp("obs.export").MetricsRegistry,
        registry_from_engine=imp("obs.export").registry_from_engine,
        Tracer=imp("obs.trace").Tracer,
        new_trace_id=imp("obs.trace").new_trace_id,
        B32=imp("obs.trace")._B32,
        BatcherConfig=imp("serving.batcher").BatcherConfig,
        FeatureServer=imp("serving.server").FeatureServer,
        ServerConfig=imp("serving.server").ServerConfig,
        ShardConfig=shard.ShardConfig, ShardedEngine=shard.ShardedEngine,
        QuantileSketch=imp("obs.sketch").QuantileSketch,
        RollingSketch=imp("obs.sketch").RollingSketch,
        CardinalityEstimator=imp("obs.sketch").CardinalityEstimator,
        DriftMonitor=imp("obs.sketch").DriftMonitor,
        psi_distance=imp("obs.sketch").psi_distance,
        splitmix64=imp("obs.sketch")._splitmix64,
        FreshnessTracker=imp("obs.freshness").FreshnessTracker,
        SLOSpec=imp("obs.slo").SLOSpec, SLOEngine=imp("obs.slo").SLOEngine,
        OK=imp("obs.slo").OK, ALERTING=imp("obs.slo").ALERTING,
        FlightRecorder=imp("obs.flight").FlightRecorder,
        OperatorProfiler=imp("obs.profile").OperatorProfiler,
        operator_rows=imp("obs.profile").operator_rows,
        attribute_exec=imp("obs.profile").attribute_exec,
        MetricsCollector=imp("control.telemetry").MetricsCollector,
        RingSeries=imp("control.telemetry").RingSeries,
        KnobConfig=imp("control.knobs").KnobConfig,
        KnobController=imp("control.knobs").KnobController,
        ControlPlane=imp("control.plane").ControlPlane,
    )
    if pkg == "repro_torch":
        E, SE = ns.Engine, ns.ShardedEngine
        ns.Engine = lambda *a, **k: E(*a, device="cpu", **k)
        ns.ShardedEngine = lambda *a, **k: SE(*a, device="cpu", **k)
    return ns


J = _load("repro")
T = _load("repro_torch")
BOTH = (J, T)


def _schema(ns):
    return ns.TableSchema("events", key_col="user", ts_col="ts",
                          value_cols=("amount", "mkey"))


def _events(n=300, n_keys=8, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    ts = np.sort(rng.uniform(0, 1000.0, n)).astype(np.float32)
    rows = np.stack(
        [rng.normal(size=n),
         rng.integers(0, 4, n).astype(np.float64)], -1).astype(np.float32)
    return keys, ts, rows


def _engine(ns, sample=1.0):
    keys, ts, rows = _events()
    eng = ns.Engine(ns.OptFlags())
    eng.create_table(_schema(ns), max_keys=64, capacity=64, bucket_size=8)
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    eng.deploy("q", SQL)
    eng.tracer.set_sample_rate(sample)
    return eng


def _sharded(ns, n_shards=2):
    keys, ts, rows = _events()
    se = ns.ShardedEngine(ns.ShardConfig(n_shards=n_shards))
    se.create_table(_schema(ns), max_keys=64, capacity=64, bucket_size=8)
    se.insert("events", keys.tolist(), ts.tolist(), rows)
    se.deploy("q", SQL)
    return se


def _names(tracer, trace_id):
    return {s.name for s in tracer.trace(trace_id)}


def _core(d):
    """Bit-comparable sketch fields (``sum`` excluded: float addition
    order is topology-dependent)."""
    return {k: d[k] for k in ("rel_err", "pos", "neg", "zero", "count",
                              "min", "max")}


def _same(a, b):
    """Equal, with NaN equal to NaN (the exports use NaN for "no
    sample")."""
    return (json.dumps(a, sort_keys=True, default=repr)
            == json.dumps(b, sort_keys=True, default=repr))


def _shape(tree):
    """A trace tree's shape: names and children, no ids or times."""
    if tree is None:
        return None
    return (tree["name"],
            tuple(sorted((_shape(c) for c in tree.get("children", ())),
                         key=repr)))


# =============================================================== trace ids
@pytest.mark.parametrize("ns", BOTH, ids=lambda n: n.pkg)
def test_new_trace_id_ulid_format_unique_and_sortable(ns):
    ids = [ns.new_trace_id() for _ in range(2000)]
    assert len(set(ids)) == len(ids)
    for t in ids[:50]:
        assert len(t) == 26 and all(c in ns.B32 for c in t)
    a = ns.new_trace_id()
    time.sleep(0.003)        # > 1 ms: the 48-bit ms prefix must advance
    b = ns.new_trace_id()
    assert a < b             # lexical order == creation order
    assert T.B32 == J.B32


def _server_autogen(ns):
    eng = _engine(ns, sample=1.0)
    with ns.FeatureServer(eng, "q", ns.ServerConfig(
            batcher=ns.BatcherConfig(max_batch=4,
                                     max_delay_s=0.001))) as srv:
        res = srv.request(1, 2000.0)
        assert res.trace_id is not None and len(res.trace_id) == 26
        assert all(c in ns.B32 for c in res.trace_id)
        names = _names(eng.tracer, res.trace_id)
        assert "server.request" in names
        tid = ns.new_trace_id()
        res2 = srv.request(2, 2000.0, ctx=ns.RequestContext(trace_id=tid))
        assert res2.trace_id == tid
        res3 = srv.request(3, 2000.0, ctx=ns.RequestContext())
        assert res3.trace_id is not None and res3.trace_id != tid
        shape = _shape(eng.tracer.tree(res2.trace_id))
    eng.close()
    return names, shape


def test_server_autogenerates_trace_id_when_absent():
    jn, jshape = _server_autogen(J)
    tn, tshape = _server_autogen(T)
    assert tn == jn
    assert tshape == jshape
    assert tshape[0] == "server.request"


# ================================================================= tracer
def test_tracer_sampling_deterministic_across_instances():
    ids = [J.new_trace_id() for _ in range(256)]
    a, b = T.Tracer(sample_rate=0.5), T.Tracer(sample_rate=0.5)
    ja = J.Tracer(sample_rate=0.5)
    got = [a.sampled(t) for t in ids]
    assert got == [b.sampled(t) for t in ids]
    # the same keep/drop decision as the JAX package's tracer: both tiers
    # of a mixed deployment record the same traces
    assert got == [ja.sampled(t) for t in ids]
    kept = sum(got)
    assert 0 < kept < len(ids)
    z = T.Tracer(sample_rate=0.0)
    assert z.start("x", ids[0]) is None
    assert z.record("x", ids[0], None, 0.0, 1.0) is None
    full = T.Tracer(sample_rate=1.0)
    assert all(full.sampled(t) for t in ids)
    assert not full.sampled(None)


def _bounded(ns):
    tr = ns.Tracer(sample_rate=1.0, max_traces=2, max_spans_per_trace=3)
    tids = [f"trace-{i}" for i in range(3)]
    for tid in tids:
        tr.finish(tr.start("root", tid))
    assert tr.counters["traces_evicted"] == 1
    assert tr.trace(tids[0]) == []
    assert tr.trace(tids[2])
    tid = tids[2]
    root = tr.trace(tid)[0]
    for _ in range(3):
        tr.finish(tr.start("child", tid, parent_id=root.span_id))
    assert len(tr.trace(tid)) == 3
    assert tr.counters["spans_dropped"] >= 1
    return dict(tr.counters), [s.name for s in tr.trace(tid)]


def test_tracer_bounded_storage_lru_and_span_cap():
    assert _bounded(T) == _bounded(J)


def test_tracer_adopt_rebases_and_dedups():
    for worker_ns, client_ns in ((T, T), (J, T), (T, J)):
        worker = worker_ns.Tracer(sample_rate=1.0)
        tid = "trace-adopt"
        s = worker.start("engine.serve", tid, parent_id="p-1")
        s.end = s.start + 0.001
        worker.finish(s, tags={"rows": 4})
        export = worker.export_trace(tid)
        client = client_ns.Tracer(sample_rate=1.0)
        assert client.adopt(export, rebase=100.0) == 1
        got = client.trace(tid)[0]
        assert got.start == pytest.approx(s.start + 100.0)
        assert got.duration_s == pytest.approx(s.duration_s)
        assert got.tags == s.tags and got.parent_id == "p-1"
        before = len(client.trace(tid))
        assert client.adopt(export, rebase=100.0) == 0
        assert client.counters["spans_deduped"] >= 1
        assert len(client.trace(tid)) == before


def _orphans(ns):
    tr = ns.Tracer(sample_rate=1.0)
    tid = "trace-orphans"
    root = tr.start("server.request", tid)
    child = tr.start("engine.serve", tid, parent_id=root.span_id)
    orphan = tr.start("lane.execute", tid, parent_id="never-recorded")
    stray_root = tr.start("admission", tid)
    for s in (child, orphan, stray_root, root):
        tr.finish(s)
    tree = tr.tree(tid)
    assert tree["name"] == "server.request"
    names = {n["name"] for n in ns.Tracer.walk(tree)}
    assert names == {"server.request", "engine.serve", "lane.execute",
                     "admission"}
    return _shape(tree)


def test_tracer_tree_attaches_orphans_under_root():
    assert _orphans(T) == _orphans(J)


def _slow(ns):
    tr = ns.Tracer(sample_rate=1.0, slow_min_samples=5, slow_log_size=4)
    base = 1000.0
    for i in range(20):
        s = tr.start("server.request", f"t{i:03d}")
        s.start, s.end = base + i, base + i + 1e-4   # ~0.1 ms roots
        tr._store(s)
        tr._observe_root(s)
    s = tr.start("server.request", "slow")
    s.start, s.end = base + 50.0, base + 50.5        # one 500 ms outlier
    tr._store(s)
    tr._observe_root(s)
    slow = tr.slow_queries()
    assert slow and slow[-1]["trace_id"] == "slow"
    assert slow[-1]["duration_s"] > 0.4
    assert tr.counters["slow_queries"] >= 1
    assert any(sp["name"] == "server.request" for sp in slow[-1]["spans"])
    return ([(q["trace_id"], q["duration_s"]) for q in slow],
            tr.counters["slow_queries"])


def test_tracer_slow_query_log_captures_p99_outliers():
    """Synthetic span times (no clock): the same roots give the same
    exemplar log in both packages."""
    assert _slow(T) == _slow(J)
    # and through finish(): the engine's path
    tr = T.Tracer(sample_rate=1.0, slow_min_samples=5, slow_log_size=4)
    for i in range(20):
        s = tr.start("server.request", f"f{i}")
        s.start = time.perf_counter() - 1e-4
        tr.finish(s)
    s = tr.start("server.request", "f-slow")
    s.start = time.perf_counter() - 0.5
    tr.finish(s)
    assert tr.slow_queries()[-1]["trace_id"] == "f-slow"


# ================================================ decomposition identity
def test_engine_stats_stage_tripwire():
    for ns in BOTH:
        timing = {f for f in ns.EngineStats._FIELDS if f.endswith("_s")}
        assert timing == set(ns.EngineStats.STAGES) | {"serve_s",
                                                       "parse_s"}
    assert T.EngineStats._FIELDS == J.EngineStats._FIELDS
    assert T.EngineStats.STAGES == J.EngineStats.STAGES


def _decomposition(ns):
    eng = _engine(ns, sample=0.0)
    eng.request("q", [1], [2000.0])
    before = eng.stats.snapshot()
    for i in range(6):
        fr = eng.request("q", list(range(i + 1)), [2000.0] * (i + 1))
        assert (fr.status == ns.STATUS_OK).all()
    d = eng.stats.delta(before)
    assert d["serve_s"] > 0
    # host_s is the serve residual: the stages tile the serve wall
    stage_sum = sum(d[f] for f in ns.EngineStats.STAGES)
    assert stage_sum == pytest.approx(d["serve_s"], rel=0.05, abs=1e-4)
    decomp = eng.latency_decomposition()
    for f in ns.EngineStats.STAGES + ("serve_s",):
        assert f in decomp, f
    out = ({k: d[k] for k in ("n_requests", "n_batches",
                              "kernel_launches")}, sorted(decomp))
    eng.close()
    return out


def test_latency_decomposition_stages_sum_to_serve():
    assert _decomposition(T) == _decomposition(J)


# ======================================================== EXPLAIN ANALYZE
def _mask(text):
    """``explain_analyze`` with its measured seconds masked; element
    counts and the attributed shares stay."""
    text = re.sub(r"(serve|exec|host|plan) \d+\.\d+", r"\1 #", text)
    text = re.sub(r"\d+\.\d+ (us/req|ms/batch)", r"# \1", text)
    return re.sub(r" +", " ", text)


def _explain(ns):
    eng = _engine(ns, sample=0.0)
    before = eng.stats.snapshot()
    for _ in range(4):
        eng.request("q", list(range(8)), [2000.0] * 8)
    d = eng.stats.delta(before)
    prof = eng.profiler.snapshot("q")
    op_total = sum(r["seconds"] for r in prof["ops"].values())
    assert op_total == pytest.approx(prof["exec_s"], rel=1e-6)
    assert prof["exec_s"] == pytest.approx(d["exec_s"], rel=1e-6)
    assert prof["requests"] == d["n_requests"]
    attributed = op_total + prof["host_s"] + prof["plan_s"]
    assert attributed == pytest.approx(prof["serve_s"], rel=0.10)
    txt = eng.explain_analyze("q")
    assert "EXPLAIN ANALYZE deployment 'q'" in txt
    assert "% of exec" in txt and "host/keydir" in txt
    assert "(100.0%)" in txt
    rows = ns.operator_rows(eng.handle("q"))
    shares = ns.attribute_exec(rows, eng.cost_model, 1e-3)
    ops = {op: (r["kind"], r["elements"]) for op, r in prof["ops"].items()}
    eng.close()
    return _mask(txt), rows, shares, ops


def test_explain_analyze_attribution_matches_measured():
    jt, jrows, jsh, jops = _explain(J)
    tt, trows, tsh, tops = _explain(T)
    assert trows == jrows                 # operator_rows: equal
    assert tsh == jsh                     # shares for the same exec_s
    assert tops == jops
    assert tt == jt                       # seconds masked


def _explain_sql(ns):
    eng = _engine(ns, sample=0.0)
    eng.request("q", [1, 2], [2000.0] * 2)
    by_name = eng.explain_analyze("q")
    by_sql = eng.explain_analyze("EXPLAIN ANALYZE " + SQL)
    assert by_sql == by_name
    with pytest.raises(KeyError, match="no live deployment"):
        eng.explain_analyze(
            "EXPLAIN ANALYZE " + SQL.replace("10 PRECEDING",
                                             "7 PRECEDING"))
    eng.close()
    return _mask(by_sql)


def test_explain_analyze_resolves_sql_text():
    assert _explain_sql(T) == _explain_sql(J)


def _profiler_obs(ns):
    eng = _engine(ns, sample=0.0)
    eng.request("q", list(range(4)), [2000.0] * 4)
    obs = eng.drain_profile_observations("q")
    kinds = {o["kind"] for o in obs}
    assert kinds and kinds <= {"scan", "preagg", "join"}
    for o in obs:
        assert o["seconds"] >= 0 and o["elements"] > 0
    assert eng.drain_profile_observations("q") == []
    eng.close()
    return sorted((o["kind"], o["table"], o["elements"]) for o in obs)


def test_profiler_observations_feed_calibrator_kinds():
    assert _profiler_obs(T) == _profiler_obs(J)


# ============================================================ trace trees
def _single_trace(ns):
    eng = _engine(ns, sample=1.0)
    tid = "trace-single"
    fr = eng.request("q", list(range(4)), [2000.0] * 4,
                     ctx=ns.RequestContext(trace_id=tid))
    assert (fr.status == ns.STATUS_OK).all()
    spans = eng.tracer.trace(tid)
    kernels = [s for s in spans if s.name.startswith("kernel.")]
    assert kernels
    serve = next(s for s in spans if s.name == "engine.serve")
    for k in kernels:
        assert k.parent_id == serve.span_id
        assert k.start >= serve.start - 1e-6
        assert k.end <= serve.end + 1e-6
        assert k.tags["attributed"] is True
    # the attributed kernel spans tile the measured exec window exactly
    kernel_total = sum(k.duration_s for k in kernels)
    assert kernel_total == pytest.approx(serve.tags["exec_s"], rel=1e-9,
                                         abs=1e-12)
    out = (sorted(s.name for s in spans),
           sorted((k.name, k.tags["share"]) for k in kernels),
           sorted(serve.tags))
    eng.close()
    return out


def test_single_engine_trace_has_kernel_children():
    assert _single_trace(T) == _single_trace(J)


def _sharded_tree(ns):
    se = _sharded(ns)
    se.tracer.set_sample_rate(1.0)
    try:
        with ns.FeatureServer(se, "q", ns.ServerConfig(
                batcher=ns.BatcherConfig(max_batch=4,
                                         max_delay_s=0.001))) as srv:
            srv.request(0, 2000.0)
            res = srv.request(1, 2000.0)
            assert res.trace_id is not None
        tree = se.tracer.tree(res.trace_id)
        assert tree is not None and tree["name"] == "server.request"
        nodes = se.tracer.walk(tree)
        names = {n["name"] for n in nodes}
        for tier in ("server.request", "batch.queue_wait", "admission",
                     "router.scatter_gather", "lane.execute",
                     "engine.serve"):
            assert tier in names, (tier, sorted(names))
        assert any(n["name"].startswith("kernel.") for n in nodes)
        lanes = [n for n in nodes if n["name"] == "lane.execute"]
        serves = [n for n in nodes if n["name"] == "engine.serve"]
        for sv in serves:
            host = [ln for ln in lanes
                    if ln["start"] - 1e-3 <= sv["start"]
                    and sv["start"] + sv["duration_s"]
                    <= ln["start"] + ln["duration_s"] + 1e-3]
            assert host, "engine.serve not nested in any lane window"
        ids = [n["span_id"] for n in nodes]
        assert len(ids) == len(set(ids))
        txt = se.explain_analyze("q")
        assert "EXPLAIN ANALYZE deployment 'q'" in txt
        assert "(merged across 2 shards)" in txt
        assert "% of exec" in txt
        return _shape(tree), _mask(txt)
    finally:
        se.close()


def test_sharded_trace_tree_end_to_end():
    """One request through a FeatureServer over a 2-shard engine yields
    one tree: server -> batcher -> admission -> router -> lane -> shard
    serve -> kernels; the same tree shape as the JAX package's, and the
    same EXPLAIN ANALYZE merged over the shards."""
    jshape, jtxt = _sharded_tree(J)
    tshape, ttxt = _sharded_tree(T)
    assert tshape == jshape
    assert ttxt == jtxt


# ======================================================= unified export
def _golden(ns):
    reg = ns.MetricsRegistry(prefix="repro")
    reg.register("g", lambda: {
        "a": 3, "b": 2.5, "fraud/requests": 7,
        "nan_gauge": float("nan"), "label": "text", "flag": True})
    return reg.render_prometheus()


def test_registry_prometheus_golden():
    text = _golden(T)
    assert text == _golden(J)
    assert text.strip().split("\n") == [
        "# HELP repro_g_a g a",
        "# TYPE repro_g_a gauge",
        "repro_g_a 3",
        "# HELP repro_g_b g b",
        "# TYPE repro_g_b gauge",
        "repro_g_b 2.5",
        "# HELP repro_g_requests g requests",
        '# TYPE repro_g_requests gauge',
        'repro_g_requests{item="fraud"} 7',
    ]


def test_prometheus_label_escaping():
    out = []
    for ns in BOTH:
        reg = ns.MetricsRegistry(prefix="repro")
        reg.register("g", lambda: {'a\\b"c\nd/x': 1})
        out.append(reg.render_prometheus().strip().split("\n")[-1])
    assert out[1] == out[0] == 'repro_g_x{item="a\\\\b\\"c\\nd"} 1'


def _histogram(ns):
    sk = ns.QuantileSketch()
    vals = [0.001, 0.01, 0.01, 0.1, 1.0, 10.0]
    sk.observe_many(vals)
    reg = ns.MetricsRegistry(prefix="repro")
    reg.register("g", lambda: {"lat/lat_sketch": sk.to_dict()})
    text = reg.render_prometheus()
    lines = text.strip().split("\n")
    assert "# TYPE repro_g_lat_sketch histogram" in lines
    buckets = [ln for ln in lines if "_bucket{" in ln]
    assert buckets[-1] == \
        f'repro_g_lat_sketch_bucket{{item="lat",le="+Inf"}} {len(vals)}'
    cums = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert cums == sorted(cums)
    ubs = [float(ln.split('le="')[1].split('"')[0])
           for ln in buckets[:-1]]
    assert ubs == sorted(ubs)
    assert f'repro_g_lat_sketch_count{{item="lat"}} {len(vals)}' in lines
    sum_line = [ln for ln in lines if "_sum{" in ln][0]
    assert float(sum_line.rsplit(" ", 1)[1]) == \
        pytest.approx(sum(vals), rel=1e-9)
    return text


def test_prometheus_sketch_renders_native_histogram():
    assert _histogram(T) == _histogram(J)


def _jsonl(ns):
    reg = ns.MetricsRegistry()
    reg.register("ok", lambda: {"x": 1, "nan": float("nan")})

    def boom():
        raise RuntimeError("surface torn down")
    reg.register("bad", boom)
    out = reg.collect()
    assert out["ok"]["x"] == 1 and math.isnan(out["ok"]["nan"])
    assert out["bad"] == {}
    line = reg.render_jsonl(now=123.0)
    doc = json.loads(line)
    assert doc["t"] == 123.0 and doc["ok"]["x"] == 1
    assert math.isnan(doc["ok"]["nan"])
    assert doc["bad"] == {}
    text = reg.render_prometheus()
    assert "repro_ok_x 1" in text
    return line, text


def test_registry_jsonl_roundtrip_and_error_isolation():
    assert _jsonl(T) == _jsonl(J)


def _registry_engine(ns):
    eng = _engine(ns, sample=1.0)
    eng.request("q", [1, 2], [2000.0] * 2,
                ctx=ns.RequestContext(trace_id="trace-reg"))
    reg = ns.registry_from_engine(eng)
    groups = reg.groups()
    for g in ("engine", "cache", "deployment", "tracer", "freshness",
              "drift", "flight"):
        assert g in groups, g
    snap = reg.collect()
    assert snap["engine"]["n_requests"] >= 2
    assert snap["deployment"]["q/requests"] >= 2
    assert snap["tracer"]["spans_started"] >= 1
    text = reg.render_prometheus()
    assert "repro_engine_n_requests" in text
    assert 'repro_deployment_requests{item="q"}' in text
    assert "repro_tracer_spans_started" in text
    counters = {g: {k: v for k, v in snap[g].items()
                    if not k.endswith("_s") and "latency" not in k
                    and "published" not in k and "publish_age" not in k
                    and not isinstance(v, dict) and k != "seq"}
                for g in ("engine", "deployment", "tracer", "flight")}
    families = sorted({ln.split("{")[0].split(" ")[0] for ln in
                       text.split("\n") if ln and not ln.startswith("#")})
    eng.close()
    return groups, counters, families


def test_registry_from_engine_groups_and_labels():
    """The same groups, counters and metric families as the JAX
    package's registry over the same engine traffic."""
    assert _registry_engine(T) == _registry_engine(J)


def _registry_sharded(ns):
    se = _sharded(ns)
    try:
        se.request("q", list(range(4)), [2000.0] * 4)
        reg = ns.registry_from_engine(se)
        groups = set(reg.groups())
        assert {"engine", "cache", "deployment", "admission", "router",
                "tracer", "freshness", "drift", "flight"} <= groups
        snap = reg.collect()
        assert snap["engine"].get("n_requests", 0) >= 4
        return groups, snap["engine"]["n_requests"]
    finally:
        se.close()


def test_sharded_registry_includes_router_admission():
    tg, tn = _registry_sharded(T)
    jg, jn = _registry_sharded(J)
    assert tn == jn
    assert "recovery" in tg          # the WAL replay counters, empty here
    assert tg == jg


# ============================================================= telemetry
def _collector_reset(ns):
    eng = _engine(ns, sample=0.0)
    col = ns.MetricsCollector(eng)
    col.sample()
    eng.request("q", list(range(4)), [2000.0] * 4)
    s = col.sample()
    assert s["engine_delta"]["n_requests"] >= 4
    eng.stats = ns.EngineStats()            # a counter reset
    s2 = col.sample()
    for k, v in s2["engine_delta"].items():
        assert v >= 0, (k, v)
    assert s2["engine_delta"]["n_requests"] == 0
    eng.close()
    return s["engine_delta"]["n_requests"], sorted(s2["engine_delta"])


def test_collector_counter_reset_clamps_deltas():
    assert _collector_reset(T) == _collector_reset(J)


def _collector_shares(ns):
    eng = _engine(ns, sample=0.0)
    col = ns.MetricsCollector(eng)
    eng.request("q", [1], [2000.0])
    col.sample()
    assert "repro_engine_n_requests" in col.render_prometheus()
    doc = json.loads(col.render_jsonl(now=5.0))
    assert doc["t"] == 5.0 and doc["engine"]["n_requests"] >= 1
    eng.close()
    return sorted(doc), doc["engine"]["n_requests"]


def test_collector_shares_registry_with_exporters():
    assert _collector_shares(T) == _collector_shares(J)


def test_ring_series_bounded_fifo():
    out = []
    for ns in BOTH:
        rs = ns.RingSeries(maxlen=4)
        assert rs.last() is None and len(rs) == 0 and rs.mean() == 0.0
        for i in range(10):
            rs.append(float(i), float(i))
        assert len(rs) == 4
        assert rs.values() == [6.0, 7.0, 8.0, 9.0]
        assert rs.last() == 9.0
        assert rs.mean(2) == pytest.approx(8.5)
        out.append(rs.to_json())
    assert out[1] == out[0]
    assert out[1]["t"] == [6.0, 7.0, 8.0, 9.0]


# ====================================================== quantile sketch
def _merge_assoc(ns):
    rng = np.random.default_rng(5)
    parts = [rng.lognormal(0, 2.0, 500),
             -rng.lognormal(1.0, 1.0, 300),
             np.concatenate([np.zeros(50), rng.normal(0, 1e-3, 200)])]
    sks = []
    for p in parts:
        sk = ns.QuantileSketch()
        sk.observe_many(p)
        sks.append(sk)
    a, b, c = (sk.to_dict() for sk in sks)

    def merged(*dicts):
        out = ns.QuantileSketch()
        for d in dicts:
            out.merge(dict(d))
        return _core(out.to_dict())

    ab_c = merged(a, b, c)
    assert ab_c == merged(c, b, a)
    bc = ns.QuantileSketch.from_dict(b).merge(dict(c)).to_dict()
    assert ab_c == merged(a, bc)
    whole = ns.QuantileSketch()
    whole.observe_many(np.concatenate(parts))
    assert ab_c == _core(whole.to_dict())
    pct = []
    for q in (1, 25, 50, 75, 99):
        p = ns.QuantileSketch.from_dict(bc).merge(dict(a)).percentile(q)
        assert p == whole.percentile(q)
        pct.append(p)
    return a, b, c, whole.to_dict(), pct


def test_sketch_merge_associative_and_commutative():
    assert _merge_assoc(T) == _merge_assoc(J)     # to_dict bit for bit


def test_sketch_serialization_deterministic_and_roundtrip():
    out = []
    for ns in BOTH:
        rng = np.random.default_rng(9)
        vals = rng.gamma(2.0, 3.0, 1000)
        s1, s2 = ns.QuantileSketch(), ns.QuantileSketch()
        s1.observe_many(vals)
        for chunk in np.split(rng.permutation(vals), 10):
            s2.observe_many(chunk)
        assert s1.to_bytes() != b""
        d1, d2 = s1.to_dict(), s2.to_dict()
        assert _core(d1) == _core(d2)
        rt = ns.QuantileSketch.from_dict(json.loads(json.dumps(d1)))
        assert _core(rt.to_dict()) == _core(d1)
        assert rt.percentile(99) == s1.percentile(99)
        out.append((d1, s1.to_bytes()))
    assert out[1] == out[0]
    # a sketch serialized by one package loads in the other
    jd = out[0][0]
    assert T.QuantileSketch.from_dict(jd).to_dict() == jd


def test_sketch_relative_error_bound_across_six_decades():
    rng = np.random.default_rng(17)
    vals = 10.0 ** rng.uniform(-3, 3, 20000)
    sv = np.sort(vals)
    got = []
    for ns in BOTH:
        sk = ns.QuantileSketch(rel_err=0.01)
        sk.observe_many(vals)
        row = []
        for q in (0.1, 1, 5, 25, 50, 75, 95, 99, 99.9):
            exact = sv[int(q / 100.0 * (len(sv) - 1))]
            p = sk.percentile(q)
            assert abs(p - exact) <= 0.0101 * exact, (q, p, exact)
            row.append(p)
        skn = ns.QuantileSketch(rel_err=0.01)
        skn.observe_many(-vals)
        svn = np.sort(-vals)
        exact = svn[int(0.01 * (len(svn) - 1))]
        assert abs(skn.percentile(1) - exact) <= 0.0101 * abs(exact)
        row.append(skn.percentile(1))
        got.append(row)
    assert got[1] == got[0]


def test_sketch_empty_and_zero_edge_cases():
    for ns in BOTH:
        e = ns.QuantileSketch()
        assert e.count == 0 and math.isnan(e.percentile(50))
        d = e.to_dict()
        assert d["count"] == 0 and d["pos"] == [] and d["neg"] == []
        m = ns.QuantileSketch.merged([e, None, ns.QuantileSketch()])
        assert m.count == 0 and math.isnan(m.percentile(99))
        live = ns.QuantileSketch()
        live.observe_many([1.0, 2.0, 3.0])
        before = _core(live.to_dict())
        live.merge(e.to_dict())
        assert _core(live.to_dict()) == before
        z = ns.QuantileSketch()
        z.observe_many(np.zeros(10))
        assert z.to_dict()["zero"] == 10 and z.percentile(50) == 0.0
        with pytest.raises(ValueError):
            z.merge(ns.QuantileSketch(rel_err=0.05).to_dict())
    assert T.QuantileSketch().to_dict() == J.QuantileSketch().to_dict()


def test_rolling_sketch_time_panes_and_monotonic_len():
    out = []
    for ns in BOTH:
        now = [0.0]
        rs = ns.RollingSketch(window_s=1.0, clock=lambda: now[0])
        for _ in range(100):
            rs.observe(10.0)
        p50 = rs.percentile(50)
        assert p50 == pytest.approx(10.0, rel=0.03)
        now[0] = 1.2
        rs.observe(1.0)
        assert len(rs) == 101 and rs.window_count() == 101
        now[0] = 2.5
        rs.observe(1.0)
        p99 = rs.percentile(99)
        assert p99 == pytest.approx(1.0, rel=0.03)
        assert len(rs) == 102
        d = rs.sketch().to_dict()
        rs.clear()
        assert len(rs) == 0 and math.isnan(rs.percentile(50))
        out.append((p50, p99, d))
    assert out[1] == out[0]


def test_cardinality_estimator_exact_then_approx_and_merge():
    out = []
    for ns in BOTH:
        a = ns.CardinalityEstimator(k=64)
        a.add_many(np.arange(50))
        assert a.estimate() == 50.0
        b = ns.CardinalityEstimator(k=64)
        b.add_many(np.arange(25, 75))
        m = ns.CardinalityEstimator(k=64)
        m.merge(a.to_dict())
        m.merge(b.to_dict())
        assert m.estimate() == pytest.approx(75.0, rel=0.25)
        big = ns.CardinalityEstimator(k=64)
        big.add_many(np.arange(100000))
        assert big.estimate() == pytest.approx(100000, rel=0.30)
        strs = ns.CardinalityEstimator(k=64)
        strs.add_many(np.asarray([f"u{i}" for i in range(300)]))
        out.append((m.estimate(), big.estimate(), big.to_dict(),
                    strs.estimate()))
    assert out[1] == out[0]                  # estimates exact
    x = np.arange(1000, dtype=np.uint64)
    assert np.array_equal(T.splitmix64(x), J.splitmix64(x))


def test_psi_distance_and_drift_monitor_merge_exact():
    """PSI values and the merged monitor's report, exact against JAX."""
    rng = np.random.default_rng(21)
    ref, live = rng.normal(0, 1, 4000), rng.normal(0.4, 1.2, 4000)
    out = []
    for ns in BOTH:
        # the monitor's own relative error, so its merged report scores
        # the same buckets as these two sketches
        r = ns.QuantileSketch(rel_err=0.02)
        l = ns.QuantileSketch(rel_err=0.02)
        r.observe_many(ref)
        l.observe_many(live)
        psi = ns.psi_distance(r.to_dict(), l.to_dict())
        shards = []
        for part in np.split(np.arange(4000), 4):
            dm = ns.DriftMonitor()
            dm.observe_reference({"x": ref[part]})
            dm.observe({"x": live[part], "__meta": live[part]})
            shards.append(dm.snapshot())
        merged = ns.DriftMonitor.merge(shards + [None])
        out.append((psi, merged.report(), merged.export()))
    assert out[1] == out[0]
    assert out[1][1]["x"]["psi"] == pytest.approx(out[1][0], rel=1e-12)


# ===================================================== freshness stamps
def _round_robin_events(seed=0, shuffle=False):
    rng = np.random.default_rng(seed)
    keys, ts = np.meshgrid(np.arange(N_KEYS), np.arange(N_TICKS))
    keys, ts = keys.ravel(), ts.ravel().astype(np.float64)
    rows = np.stack([rng.normal(size=keys.size),
                     rng.integers(0, 4, keys.size)], -1).astype(np.float32)
    if not shuffle:
        return keys, ts, rows
    order = rng.permutation(keys.size)
    return keys[order], ts[order], rows[order]


def _stream_into(eng, keys, ts, rows, lateness=1000.0):
    pipe = eng.attach_stream("events", lateness=lateness,
                             flush_interval_s=0.001)
    pipe.push_batch(keys.tolist(), ts.tolist(), rows)
    pipe.flush()
    return pipe


def _mk(ns, sharded=False):
    eng = (ns.ShardedEngine(ns.ShardConfig(n_shards=3)) if sharded
           else ns.Engine(ns.OptFlags()))
    eng.create_table(_schema(ns), max_keys=64, capacity=64, bucket_size=8)
    return eng


def _stable_snapshot(snap):
    """A freshness snapshot without its wall-clock stamps."""
    return {t: {k: v for k, v in ent.items()
                if k not in ("published_at", "i2v_sketch")}
            for t, ent in snap.items()}


def _watermark_stamp(ns):
    eng = _mk(ns)
    keys, ts, rows = _round_robin_events()
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    assert eng.tables["events"].watermark == float(N_TICKS - 1)
    snap = eng.tables["events"].snapshot()
    assert snap.watermark == float(N_TICKS - 1)
    assert snap.published_at > 0.0
    eng.deploy("q", SQL)
    fr = eng.request("q", [0, 1, 2], [100.0, 200.0, 150.0])
    assert fr.watermark == float(N_TICKS - 1)
    assert fr.feature_age == pytest.approx(200.0 - (N_TICKS - 1))
    assert fr.row(1).feature_age == fr.feature_age
    out = (fr.watermark, fr.feature_age,
           _stable_snapshot(eng.freshness_snapshot()),
           eng.tables["events"].ingest_stats())
    eng.close()
    return out


def test_table_watermark_and_frame_stamp():
    """Stamps, the freshness snapshot and the table's ingest sketches
    bit for bit against JAX."""
    assert _watermark_stamp(T) == _watermark_stamp(J)


def _unserved(ns):
    eng = _mk(ns)
    eng.deploy("q", SQL)
    fr = eng.request("q", [0], [5.0])
    assert fr.watermark is None and fr.feature_age is None
    exp = eng.freshness_export()
    assert math.isnan(ns.FreshnessTracker.worst_age_p99(exp))
    out = sorted(exp)
    eng.close()
    return out


def test_unserved_table_has_no_watermark_stamp():
    assert _unserved(T) == _unserved(J)


def test_ingest_to_visible_latency_recorded():
    """Events pushed, flushed after a wait: the ingest-to-visible sketch
    covers every event and sits at or above the wait (a lower bound the
    wait guarantees; no upper bound is asserted). The ingest-side
    sketches and the key estimate equal JAX's."""
    out = []
    for ns in BOTH:
        eng = _mk(ns)
        keys, ts, rows = _round_robin_events(shuffle=True)
        pipe = eng.attach_stream("events", lateness=1000.0,
                                 flush_interval_s=30.0)
        pipe.push_batch(keys.tolist(), ts.tolist(), rows)
        delay = 0.15
        time.sleep(delay)
        pipe.flush()
        snap = eng.freshness_snapshot()["events"]
        assert snap["ingested"] == keys.size
        i2v = ns.QuantileSketch.from_dict(snap["i2v_sketch"])
        assert i2v.count == keys.size
        assert i2v.percentile(50) >= delay * 0.9
        exp = eng.freshness_export()
        assert exp["events/ingest_visible_p50_s"] >= delay * 0.9
        assert exp["events/keys_est"] == pytest.approx(N_KEYS)
        assert math.isfinite(exp["events/ingest_amount_p50"])
        out.append((snap["ingested"], snap["key_card"], snap["columns"],
                    {k: v for k, v in exp.items() if "ingest_" in k
                     and "visible" not in k}))
        eng.close()
    assert out[1] == out[0]


# ============================= acceptance: e2e freshness, sharded
def _age_and_merge(ns):
    keys, ts, rows = _round_robin_events(shuffle=True)
    ref, se = _mk(ns), _mk(ns, sharded=True)
    try:
        _stream_into(ref, keys, ts, rows)
        _stream_into(se, keys, ts, rows)
        ref.deploy("q", SQL)
        se.deploy("q", SQL)
        wm = float(N_TICKS - 1)
        rng = np.random.default_rng(7)
        for b in range(4):
            rk = rng.integers(0, N_KEYS, 16).tolist()
            rt = (np.full(16, 100.0 + b, np.float32)
                  + rng.integers(0, 5, 16).astype(np.float32)).tolist()
            fa = ref.request("q", rk, rt)
            fs = se.request("q", rk, rt)
            assert (fa.status == ns.STATUS_OK).all()
            assert np.array_equal(fa.status, fs.status)
            assert fa.watermark == fs.watermark == wm
            assert fa.feature_age == fs.feature_age
            assert fa.feature_age == pytest.approx(max(rt) - wm)
        ref_snap = ref.freshness_snapshot()["events"]
        se_snap = se.freshness_snapshot()["events"]
        assert se_snap["watermark"] == ref_snap["watermark"] == wm
        assert se_snap["ingested"] == ref_snap["ingested"] == keys.size
        assert se_snap["serve_rows"] == ref_snap["serve_rows"] == 64
        a, m = ref_snap["age_sketch"], se_snap["age_sketch"]
        assert _core(a) == _core(m)
        assert (ns.QuantileSketch.from_dict(a).percentile(99)
                == ns.QuantileSketch.from_dict(m).percentile(99))
        for col in ("amount", "mkey"):
            assert _core(ref_snap["columns"][col]) == \
                _core(se_snap["columns"][col])
        return (_core(a), _core(m),
                {c: _core(d) for c, d in ref_snap["columns"].items()},
                ref_snap["key_card"], se_snap["key_card"])
    finally:
        ref.close()
        se.close()


def test_feature_age_and_merged_sketch_bit_for_bit():
    """A disordered streamed load into an Engine and a 3-shard
    ShardedEngine of each package: the merged-across-shards age sketch
    equals the single engine's bit for bit, and the port's equal the
    JAX package's."""
    assert _age_and_merge(T) == _age_and_merge(J)


def test_freshness_merge_matches_single_tracker():
    rng = np.random.default_rng(3)
    ages = rng.gamma(2.0, 5.0, 4096)
    out = []
    for ns in BOTH:
        whole, a, b = (ns.FreshnessTracker() for _ in range(3))
        whole.observe_age("t", ages)
        a.observe_age("t", ages[:1500])
        b.observe_age("t", ages[1500:])
        sa, sb = a.snapshot(), b.snapshot()
        sa["t"]["watermark"], sb["t"]["watermark"] = 40.0, 25.0
        merged = ns.FreshnessTracker.merge([sa, None, sb])["t"]
        assert _core(merged["age_sketch"]) == \
            _core(whole.snapshot()["t"]["age_sketch"])
        assert merged["watermark"] == 25.0
        assert merged["serve_rows"] == 4096
        out.append((merged, ns.FreshnessTracker.export(
            {"t": merged}, now=100.0)))
    assert _same(out[1], out[0])


def test_freshness_tracker_folds_at_max_pending():
    """The 256th buffered batch folds on the serving thread; the fold
    order cannot change the result, and the port folds as JAX does."""
    rng = np.random.default_rng(4)
    batches = [rng.gamma(2.0, 5.0, 7) for _ in range(300)]
    out = []
    for ns in BOTH:
        tr = ns.FreshnessTracker()
        for i, b in enumerate(batches):
            tr.observe_age("t", b)
            if i == ns.FreshnessTracker.MAX_PENDING - 2:
                assert len(tr._pending) == ns.FreshnessTracker.MAX_PENDING - 1
            if i == ns.FreshnessTracker.MAX_PENDING - 1:
                assert tr._pending == []      # folded on this call
        dm = ns.DriftMonitor()
        for b in batches:
            dm.observe({"x": b}, n=5)
        out.append((tr.snapshot(), dm.snapshot()))
    assert out[1] == out[0]


# ===================================================== burn-rate SLOs
def _slo_run(ns):
    spec = ns.SLOSpec("lat", "latency_p99_s", bound=0.010, budget=0.1,
                      fast_window_s=10.0, slow_window_s=60.0,
                      burn_threshold=2.0)
    slo = ns.SLOEngine([spec])
    t = 0.0
    trail = []
    for _ in range(60):
        assert slo.evaluate({"latency_p99_s": 0.002}, now=t) == []
        t += 1.0
    slo.evaluate({"latency_p99_s": 0.5}, now=t)
    t += 1.0
    assert slo.state("lat") == ns.OK
    events = []
    for _ in range(12):
        events += slo.evaluate({"latency_p99_s": 0.5}, now=t)
        trail.append(slo.snapshot(now=t))
        t += 1.0
    assert slo.state("lat") == ns.ALERTING
    assert [e["state"] for e in events] == [ns.ALERTING]
    assert events[0]["t"] == 72.0
    for _ in range(11):
        events += slo.evaluate({"latency_p99_s": 0.002}, now=t)
        trail.append(slo.snapshot(now=t))
        t += 1.0
    assert slo.state("lat") == ns.OK
    assert slo.export()["lat/transitions"] == 2.0
    n0 = slo.snapshot(now=t)["lat"]["slow_samples"]
    slo.evaluate({}, now=t)
    slo.evaluate({"latency_p99_s": float("nan")}, now=t)
    assert slo.snapshot(now=t)["lat"]["slow_samples"] == n0
    return events, trail, slo.export()


def test_slo_engine_multi_window_burn_deterministic():
    """Explicit ``now``: the same states, burn rates and transition times
    as the JAX package's."""
    assert _slo_run(T) == _slo_run(J)


def test_slo_spec_validation():
    for ns in BOTH:
        with pytest.raises(ValueError):
            ns.SLOSpec("x", "m", 1.0, action="page")
        with pytest.raises(ValueError):
            ns.SLOSpec("x", "m", 1.0, budget=0.0)
        with pytest.raises(ValueError):
            ns.SLOSpec("x", "m", 1.0, fast_window_s=60, slow_window_s=30)


# ============================ SLO burn -> tick -> flight, pinned latency
def _slo_into_plane(ns, out_dir):
    """The regression is injected into the deployment's latency sketch
    (after each serve the sketch holds the injected value alone), and the
    SLO engine evaluates at an explicit clock the test advances by 0.1 a
    tick: the alert, the knob backoff and the recovery land on the same
    ticks in every run, however fast the machine serves."""
    eng = _mk(ns)
    keys, ts, rows = _round_robin_events()
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    eng.deploy("q", SQL)
    eng.request("q", [0, 1, 2, 3], [100.0] * 4)      # warm
    out_dir.mkdir()
    eng.flight.out_dir = str(out_dir)
    clock = [0.0]

    class ClockedSLO(ns.SLOEngine):
        def evaluate(self, metrics, now=None):
            return super().evaluate(
                metrics, now=clock[0] if now is None else now)

    slo = ClockedSLO([ns.SLOSpec("latency", "latency_p99_s", bound=0.5,
                                 budget=0.25, fast_window_s=0.6,
                                 slow_window_s=0.6, burn_threshold=1.0)])
    plane = ns.ControlPlane(
        eng, "q", replan=False, slo=slo,
        # sky-high plain-p99 target: only the SLO can declare overload
        knobs=ns.KnobController(ns.KnobConfig(target_p99_s=100.0),
                                delay_s=0.004))
    h = eng.handle("q")
    traces = []

    def step(latency):
        clock[0] += 0.1
        tid = f"trace-{len(traces):04d}"
        traces.append(tid)
        eng.request("q", [0, 1, 2, 3], [100.0] * 4,
                    ctx=ns.RequestContext(trace_id=tid))
        h.metrics.latency_s.clear()
        h.metrics.observe_latency(latency)
        return plane.tick()

    states = []
    for _ in range(3):                       # healthy baseline
        assert step(0.001)["slo"]["alerting"] == []
        states.append(slo.state("latency"))
    assert slo.state("latency") == ns.OK
    for _ in range(12):                      # the injected regression
        step(2.0)
        states.append(slo.state("latency"))
        if slo.state("latency") == ns.ALERTING:
            break
    assert slo.state("latency") == ns.ALERTING
    burn = []
    for _ in range(3):
        burn.append(step(2.0))
        states.append(slo.state("latency"))
    assert any(r["load"]["slo_burning"] for r in burn)
    assert plane.knobs.knobs["delay_s"] < 0.004
    moves = [d for r in plane.reports for d in r["knob_decisions"]]
    assert any(d["knob"] == "delay_s" and "overload" in d["reason"]
               for d in moves)
    # the ring hit the disk on the OK -> ALERTING transition with the
    # serve records' trace ids from the burning interval
    assert plane.flight is eng.flight and eng.flight.dumps
    recs = [json.loads(line)
            for line in open(eng.flight.dumps[0], encoding="utf-8")]
    assert recs[0]["kind"] == "dump"
    assert "slo-latency" in os.path.basename(eng.flight.dumps[0])
    kinds = {r["kind"] for r in recs}
    assert "slo_transition" in kinds and "serve" in kinds
    dumped = {r.get("trace") for r in recs if r["kind"] == "serve"}
    assert dumped & set(traces)
    for _ in range(12):                      # recovery
        step(0.001)
        states.append(slo.state("latency"))
        if slo.state("latency") == ns.OK:
            break
    assert slo.state("latency") == ns.OK
    assert not plane.reports[-1]["load"]["slo_burning"]
    eng.close()
    return (states, [(d["knob"], d["old"], d["new"], d["reason"])
                     for d in moves],
            [r["load"]["slo_burning"] for r in plane.reports],
            [(e["t"], e["state"], e["fast_burn"], e["slow_burn"])
             for e in slo.transitions], sorted(dumped, key=str))


def test_slo_burn_alert_into_control_plane_e2e(tmp_path):
    """The SLO flips to ALERTING, the tick folds the alert into the knob
    controller (``slo_burning`` -> overload backoff), the flight ring
    lands on disk with the burning interval's trace ids, and the SLO
    recovers — at the same ticks, with the same burn rates and knob
    moves, as in the JAX package."""
    jout = _slo_into_plane(J, tmp_path / "jax")
    tout = _slo_into_plane(T, tmp_path / "port")
    assert tout == jout


# ================================================================ drift
def _sum_sketches_close(a, b, rel_err):
    """Sketches of a column built from sums: a sum that rounding moved
    can land in a neighbouring bucket. Equal counts, min/max within rtol
    2e-4, percentiles within twice the sketch's relative error."""
    assert a["count"] == b["count"]
    for k in ("min", "max"):
        assert b[k] == pytest.approx(a[k], rel=2e-4, abs=1e-5)
    sa, sb = T.QuantileSketch.from_dict(a), T.QuantileSketch.from_dict(b)
    for q in (1, 25, 50, 75, 99):
        assert sb.percentile(q) == pytest.approx(
            sa.percentile(q), rel=2 * rel_err + 1e-9, abs=1e-5)


def _drift_run(ns):
    eng = _mk(ns)
    keys, ts, rows = _round_robin_events()
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    eng.deploy("q", SQL)
    rng = np.random.default_rng(11)

    def serve(lo, hi, n_batches=6):
        for _ in range(n_batches):
            rk = rng.integers(0, N_KEYS, 16).tolist()
            rt = rng.uniform(lo, hi, 16).astype(np.float32).tolist()
            eng.request("q", rk, rt)

    serve(100.0, 200.0)
    assert eng.pin_drift_reference() == ["c", "s"]
    serve(100.0, 200.0)
    rep = eng.drift_report()
    assert not any(r["drifted"] for r in rep.values()), rep
    assert rep["s"]["psi"] < 0.25
    k2, t2 = np.meshgrid(np.arange(N_KEYS), np.arange(N_TICKS,
                                                      N_TICKS + 20))
    k2, t2 = k2.ravel(), t2.ravel().astype(np.float64)
    r2 = np.stack([rng.normal(50.0, 1.0, k2.size),
                   rng.integers(0, 4, k2.size)], -1).astype(np.float32)
    eng.insert("events", k2.tolist(), t2.tolist(), r2)
    serve(2000.0, 2100.0, n_batches=12)
    rep2 = eng.drift_report()
    assert rep2["s"]["drifted"] and rep2["s"]["psi"] > 0.25
    assert not rep2["c"]["drifted"]
    assert eng.drift_export()["s/drifted"] == 1.0
    out = (rep, rep2, eng.drift.snapshot(),
           _stable_snapshot(eng.freshness_snapshot()))
    eng.close()
    return out


def test_drift_detector_tp_and_fp():
    """Same serving distribution after pinning -> no drift; a shifted
    one -> PSI over the threshold. The count column's sketches and PSI
    and the freshness snapshot are bit for bit JAX's; the sum column
    ``s`` within the sum case above."""
    jrep, jrep2, jsnap, jfresh = _drift_run(J)
    trep, trep2, tsnap, tfresh = _drift_run(T)
    assert tfresh == jfresh
    for side in ("live", "ref"):
        assert tsnap[side]["c"] == jsnap[side]["c"]
        _sum_sketches_close(jsnap[side]["s"], tsnap[side]["s"],
                            jsnap["rel_err"])
    for a, b in ((jrep, trep), (jrep2, trep2)):
        assert b["c"] == a["c"]
        assert b["s"]["drifted"] == a["s"]["drifted"]
        assert b["s"]["live_count"] == a["s"]["live_count"]


def _drift_shards(ns):
    se = _mk(ns, sharded=True)
    keys, ts, rows = _round_robin_events()
    try:
        se.insert("events", keys.tolist(), ts.tolist(), rows)
        se.deploy("q", SQL)
        rng = np.random.default_rng(13)
        batches = [rng.integers(0, N_KEYS, 16).tolist() for _ in range(4)]
        for rk in batches:
            se.request("q", rk, [150.0] * 16)
        assert se.pin_drift_reference() == ["c", "s"]
        for rk in batches:
            se.request("q", rk, [150.0] * 16)
        rep = se.drift_report()
        assert set(rep) == {"c", "s"}
        assert rep["s"]["live_count"] == 64 and rep["s"]["ref_count"] == 64
        assert rep["s"]["psi"] == 0.0
        assert not rep["s"]["drifted"]
        return rep
    finally:
        se.close()


def test_drift_pin_and_merge_across_shards():
    assert _drift_shards(T) == _drift_shards(J)


def _n_live(ns):
    """Edge-padded batches (the lane's repeat-last-row) with ``n_live``:
    the pad rows are served but stay out of the freshness, drift and
    flight observations, so the sketches equal an unpadded run's."""
    keys, ts, rows = _round_robin_events()
    out = []
    for pad in (False, True):
        eng = _mk(ns)
        eng.insert("events", keys.tolist(), ts.tolist(), rows)
        dep = eng.deploy("q", SQL)
        rk = [0, 3, 5, 9, 12]
        rt = [100.0, 101.0, 102.0, 103.0, 104.0]
        if pad:
            k2, t2 = rk + [rk[-1]] * 3, rt + [rt[-1] + 50.0] * 3
            fr = dep.request(k2, t2, n_live=len(rk))
            assert len(fr.status) == 8
        else:
            fr = dep.request(rk, rt)
        rec = [r for r in eng.flight.records() if r["kind"] == "serve"]
        out.append((fr.feature_age, _stable_snapshot(
            eng.freshness_snapshot()), eng.drift.snapshot(),
            rec[-1]["rows"], rec[-1]["feature_age"]))
        eng.close()
    assert out[0] == out[1]
    return out[0]


def test_n_live_trims_freshness_drift_and_flight():
    assert _n_live(T) == _n_live(J)


# ======================================================= flight recorder
def _flight(ns, out_dir):
    fl = ns.FlightRecorder(capacity=8, out_dir=str(out_dir),
                           min_dump_interval_s=60.0)
    fl.set_context(delay_s=0.004)
    fl.set_context(delay_s=0.004)
    for i in range(20):
        fl.record("serve", trace=f"t{i}", rows=4)
    assert len(fl) == 8
    p1 = fl.dump("slo-latency")
    assert p1 and os.path.exists(p1)
    assert fl.dump("again") is None
    assert fl.dump("forced", force=True)
    lines = [json.loads(ln) for ln in open(p1, encoding="utf-8")]
    assert lines[0]["kind"] == "dump"
    assert lines[0]["context"] == {"delay_s": 0.004}
    serves = [ln for ln in lines if ln["kind"] == "serve"]
    assert [s["trace"] for s in serves] == [f"t{i}" for i in range(12, 20)]
    assert fl.stats()["dumps"] == 2.0
    strip = lambda d: {k: v for k, v in d.items() if k != "t"}
    return [strip(ln) for ln in lines], fl.stats()


def test_flight_recorder_ring_dump_and_rate_limit(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert _flight(T, tmp_path / "port") == _flight(J, tmp_path / "jax")


def _sharded_flight(ns):
    se = _mk(ns, sharded=True)
    keys, ts, rows = _round_robin_events()
    try:
        se.insert("events", keys.tolist(), ts.tolist(), rows)
        se.deploy("q", SQL)
        se.request("q", list(range(8)), [100.0] * 8,
                   ctx=ns.RequestContext(trace_id="t-sharded"))
        se.resources.reconfigure(min_service_budget_s=10.0)
        fr = se.request("q", [0, 1], [100.0] * 2,
                        ctx=ns.RequestContext.with_timeout(1.0))
        recs = [{k: v for k, v in r.items()
                 if k not in ("t", "serve_ms", "seq")}
                for r in se.flight.records()]
        shards = [{k: v for k, v in r.items() if k not in ("t", "seq",
                                                           "serve_ms")}
                  for s in se.shards for r in s.flight.records()]
        return recs, sorted(shards, key=repr), fr.status.tolist()
    finally:
        se.close()


def test_sharded_flight_records_serve_and_shed():
    """The sharded tier's serve and shed records (the worker-down dump
    is in ``tests/test_torch_chaos.py``) and the shard engines' own
    serve records, equal to JAX's."""
    assert _sharded_flight(T) == _sharded_flight(J)
