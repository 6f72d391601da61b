"""Port engine: the main path against the JAX engine on the same events.

Both engines ingest the same seeded stream (events LAST JOIN merchants,
merchant profiles re-published mid-stream), deploy the same SQL and must
return equal ``FeatureFrame``s online (``request``) and point-in-time
offline (``query_offline``) — from the port's own ingest and from the JAX
state carried across by ``repro_torch.convert``.

Tolerances: exact for status and for counts, min/max, LAST and joined
columns (order-free reductions and selects); ``rtol 2e-4`` for sums and
averages (summation order). STD is ``sqrt(sumsq/n − mean²)``: where the
true variance is ~0 the float32 cancellation leaves up to ~2·eps·mean² of
variance (XLA also contracts it into an FMA), so STD gets an absolute
``4e-4 · max|amount|`` and PREDICT's score the same error times its weight.

Also the port's own rules: no JAX import anywhere in the port or the chip
smoke, and no CPU run unless the CPU is asked for.
"""
import ast
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.engine import Engine as JEngine
from repro.core.optimizer import OptFlags as JFlags
from repro.featurestore.table import TableSchema as JSchema
from repro_torch import convert
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags
from repro_torch.data.synthetic import EventStreamConfig, generate_events
from repro_torch.featurestore.table import TableSchema
from test_torch_plan import DEPLOYMENTS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_EVENTS, N_KEYS, N_MERCHANTS = 2500, 48, 12
EVENTS = ("events", "user", "ts", ("amount", "lat", "lon", "merchant"))
MERCHANTS = ("merchants", "merchant", "mts", ("risk", "volume"))
KEYS, TS, ROWS = generate_events(EventStreamConfig(
    n_events=N_EVENTS, n_keys=N_KEYS, n_features=4, seed=3))
# PREDICT(fraud, ...) feature order, as in the SQL
FEATURES = ("amt_avg_10", "amt_max_100", "amt_std_10", "amt_sum_10",
            "m_risk", "m_volume", "txn_cnt_100")
W = np.asarray([0.02, 0.01, 0.005, 0.001, 1.5, 0.002, 0.03], np.float32)
B0 = -3.0
STD_ATOL = 4e-4 * float(np.abs(ROWS[:, 0]).max())
EXACT = ("max", "min", "cnt", "last")   # plus the joined m_* columns


def _merchant_epochs():
    rng = np.random.default_rng(7)
    t_mid = float(TS[N_EVENTS // 2])
    return [(t0, np.stack([rng.uniform(0, 1, N_MERCHANTS),
                           rng.uniform(10, 500, N_MERCHANTS)], -1)
             .astype(np.float32)) for t0 in (float(TS[0]), t_mid)]


def _engine(E, F, S, **kw):
    e = E(F(), **kw)
    e.create_table(S(*EVENTS), max_keys=N_KEYS, capacity=128,
                   bucket_size=16)
    e.create_table(S(*MERCHANTS), max_keys=N_MERCHANTS, capacity=16,
                   bucket_size=4)
    return e


def _fill(e):
    e.insert("events", KEYS.tolist(), TS.tolist(), ROWS)
    for t0, rows in _merchant_epochs():
        e.insert("merchants", list(range(N_MERCHANTS)), [t0] * N_MERCHANTS,
                 rows)


def _deploy_all(e, model, params):
    e.register_model("fraud", model, params)
    for name, (sql, _, _) in DEPLOYMENTS.items():
        e.deploy(name, sql)
    return e


def _torch_model(p, f):
    return torch.sigmoid(f @ p[0] + p[1])


@pytest.fixture(scope="module")
def engines():
    """JAX reference, the port from its own ingest, the port from the
    JAX state carried across."""
    j = _engine(JEngine, JFlags, JSchema)
    _fill(j)
    _deploy_all(j, lambda p, f: 1 / (1 + jnp.exp(-(f @ p[0] + p[1]))),
                (jnp.asarray(W), jnp.asarray(B0, jnp.float32)))
    params = convert.to_tensors((W, np.float32(B0)), "cpu")
    own = _engine(Engine, OptFlags, TableSchema, device="cpu")
    _fill(own)
    _deploy_all(own, _torch_model, params)
    carried = _engine(Engine, OptFlags, TableSchema, device="cpu")
    for name, jt in j.tables.items():
        pa = jt.preagg
        convert.load_table(
            carried.tables[name], values=np.asarray(jt.state.values),
            ts=np.asarray(jt.state.ts), total=np.asarray(jt.state.total),
            key_to_idx=jt.key_to_idx,
            preagg={f: np.asarray(getattr(pa, f))
                    for f in ("sum", "sumsq", "min", "max", "count")})
    _deploy_all(carried, _torch_model, params)
    return {"jax": j, "own": own, "carried": carried}


def _assert_columns_equal(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        g = np.asarray(got[c], np.float64)
        w = np.asarray(want[c], np.float64)
        assert g.shape == w.shape, c
        if c.startswith(("__", "m_")) or any(x in c for x in EXACT):
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            atol = {"score": 0.25 * W[2] * STD_ATOL}.get(
                c, STD_ATOL if "std" in c else 1e-4)
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=atol,
                                       err_msg=c)


def _requests(seed, B=64):
    """Known keys, unknown keys and fresh timestamps (online path)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, N_KEYS + 6, B)
    ts = np.full(B, float(TS.max()) + 1.0, np.float32) + np.arange(B)
    rows = ROWS[rng.integers(0, N_EVENTS, B)]
    return keys, ts, rows


@pytest.mark.parametrize("source", ["own", "carried"])
@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_online_frames_equal(engines, name, source):
    keys, ts, rows = _requests(seed=len(name))
    want = engines["jax"].request(name, keys.tolist(), ts.tolist(),
                                  rows=rows)
    got = engines[source].request(name, keys.tolist(), ts.tolist(),
                                  rows=rows)
    np.testing.assert_array_equal(got.status, want.status)
    assert got.n_unknown > 0 and not got.all_ok
    _assert_columns_equal(got, want)
    unknown = got.status != 0
    for c in got:
        assert np.all(np.asarray(got[c])[unknown] == 0.0), c


@pytest.mark.parametrize("source", ["own", "carried"])
@pytest.mark.parametrize("name", ["fraud_scored", "serve_features",
                                  "range_where"])
def test_offline_frames_equal(engines, name, source):
    want = engines["jax"].query_offline(name)
    got = engines[source].query_offline(name)
    assert len(got["__key"]) == len(want["__key"]) > N_EVENTS // 2
    _assert_columns_equal(got, want)


def test_port_request_metadata_and_stats(engines):
    e = engines["own"]
    keys, ts, rows = _requests(seed=99)
    before = e.latency_decomposition()
    fr = e.request("fraud_scored", keys.tolist(), ts.tolist(), rows=rows)
    after = e.latency_decomposition()
    assert fr.deployment == "fraud_scored" and fr.version == 1
    assert fr.table_version == e.tables["events"].version
    assert after["n_requests"] == before["n_requests"] + len(keys)
    assert after["kernel_launches"] == before["kernel_launches"] + 3
    assert after["join_probes"] >= len(keys)
    assert 0.0 < after["join_match_rate"] <= 1.0
    assert after["exec_s"] > before["exec_s"]
    assert fr.latency["serve_s"] > 0.0
    text = e.explain("fraud_scored")
    assert "impl=preagg" in text and "LAST JOIN on=merchant" in text


def test_joined_request_needs_rows(engines):
    with pytest.raises(ValueError, match="rows="):
        engines["own"].request("fraud_scored", [1, 2], [1e6, 1e6])


def test_empty_batch(engines):
    fr = engines["own"].request("serve_features", [], [])
    assert fr.status.shape == (0,) and all(
        np.asarray(v).shape == (0,) for v in fr.values())


# ---------------------------------------------------------------------------
# a deployment wider than one kernel launch: 17 raw-scan windows over 65
# value columns (the CUDA wrappers split it into 16-spec x 64-column
# launches; the plan still counts one fused launch)
# ---------------------------------------------------------------------------

N_WIDE_COLS, N_WIDE_WINDOWS, N_WIDE_KEYS = 65, 17, 24
WIDE_KEYS, WIDE_TS, WIDE_ROWS = generate_events(EventStreamConfig(
    n_events=1200, n_keys=N_WIDE_KEYS, n_features=N_WIDE_COLS, rate_hz=2.0,
    seed=8))
_WIDE_AGGS = (("sum", "SUM"), ("max", "MAX"), ("min", "MIN"),
              ("avg", "AVG"), ("cnt", "COUNT"), ("first", "FIRST"))
WIDE_SQL = (
    "SELECT\n  " + ",\n  ".join(
        [f"{_WIDE_AGGS[j % 6][1]}(c{j}) OVER w{j % N_WIDE_WINDOWS} "
         f"AS {_WIDE_AGGS[j % 6][0]}_{j}" for j in range(N_WIDE_COLS)]
        # a LAST keeps every window off the pre-aggregate tier
        + [f"LAST(c{i}) OVER w{i} AS last_{i}"
           for i in range(N_WIDE_WINDOWS)])
    + "\nFROM wide\nWINDOW " + ",\n  ".join(
        f"w{i} AS (PARTITION BY user ORDER BY ts "
        + (f"ROWS BETWEEN {1 + 6 * i}" if i % 2 == 0
           else f"RANGE BETWEEN {15 * (i + 1)}")
        + " PRECEDING AND CURRENT ROW)" for i in range(N_WIDE_WINDOWS)))


@pytest.fixture(scope="module")
def wide_engines():
    engines = {}
    kinds = {"jax": (JEngine, JFlags, JSchema, {}),
             "port": (Engine, OptFlags, TableSchema, {"device": "cpu"})}
    for tag, (E, F, S, kw) in kinds.items():
        e = E(F(), **kw)
        e.create_table(S("wide", "user", "ts", tuple(
            f"c{j}" for j in range(N_WIDE_COLS))), max_keys=N_WIDE_KEYS,
            capacity=64, bucket_size=8)
        e.insert("wide", WIDE_KEYS.tolist(), WIDE_TS.tolist(), WIDE_ROWS)
        h = e.deploy("wide17", WIDE_SQL)
        assert h.phys.n_kernel_launches == 1      # one fused launch
        assert len(h.phys.groups) == N_WIDE_WINDOWS
        assert {g.impl for g in h.phys.groups} == {"fused"}
        assert len({c for g in h.phys.groups
                    for c in g.plain_cols}) == N_WIDE_COLS
        engines[tag] = e
    return engines


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_wide_deployment_frames_equal(wide_engines, mode):
    if mode == "online":
        rng = np.random.default_rng(21)
        B = 48
        keys = rng.integers(0, N_WIDE_KEYS + 4, B)
        ts = np.full(B, float(WIDE_TS.max()) + 1.0, np.float32) + np.arange(B)
        rows = WIDE_ROWS[rng.integers(0, len(WIDE_ROWS), B)]
        want, got = (wide_engines[k].request("wide17", keys.tolist(),
                                             ts.tolist(), rows=rows)
                     for k in ("jax", "port"))
        np.testing.assert_array_equal(got.status, want.status)
        assert got.n_unknown > 0
    else:
        want, got = (wide_engines[k].query_offline("wide17")
                     for k in ("jax", "port"))
        assert len(got["__key"]) == len(want["__key"]) > 600
    assert len(want) >= N_WIDE_COLS + N_WIDE_WINDOWS
    _assert_columns_equal(got, want)


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------

def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_cuda_engine_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(OptFlags())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(OptFlags(), device="cuda:0")
