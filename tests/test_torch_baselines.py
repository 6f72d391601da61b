"""Port baseline execution models (``repro_torch.core.baselines``) against
the JAX package's (``repro.core.baselines``) on the same numpy inputs.

Each of the five profiles runs on both packages, on the data of
``tests/test_engine.py::test_baseline_profiles_agree_on_results`` and on a
deployment that reaches every aggregate and a RANGE window; the port's
mirror of that JAX test holds every profile to ``openmldb``. Also: the
columnar full scan gives the same bits for any key slab, and the row
interpreter copies only the batch's keys' rows to the host.

Tolerances: the row interpreter exact (both interpret in Python floats
over the same f32 rows); counts, MIN, MAX, FIRST and LAST exact;
``rtol 2e-4`` (atol 1e-5) for sums, averages and ratios of them; STD and
VAR ``rtol 2e-4`` with ``atol 1e-4``: JAX's fused ``x·x − mean²`` rounds
differently from the port's (the STD/VAR case stated in
``tests/test_torch_engine.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.featurestore.table import TableSchema as JSchema
from repro_torch.core import baselines
from repro_torch.featurestore.table import TableSchema

torch.set_num_threads(1)

PROFILES = tuple(baselines.PROFILES)

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

FULL_SQL = """
SELECT SUM(amount) OVER w AS s, VAR(amount) OVER w AS v,
       MIN(lat) OVER w2 AS mn, MAX(lon) OVER w2 AS mx2,
       AVG(lat) OVER w2 AS a2, COUNT(lat) OVER w2 AS c2,
       FIRST(amount) OVER w2 AS fst, LAST(lon) OVER w AS lst,
       SUM(amount * lat) OVER w2 AS sp,
       SUM(amount) OVER w / COUNT(amount) OVER w AS ratio
FROM events
WINDOW w AS (PARTITION BY user ORDER BY ts
             ROWS BETWEEN 20 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY user ORDER BY ts
              RANGE BETWEEN 300 PRECEDING AND CURRENT ROW)
"""

EXACT = ("c", "c2", "mx", "mn", "mx2", "fst", "lst")
STDVAR = ("sd", "v")


def _data():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 16, 500)
    ts = np.sort(rng.uniform(0, 1000, 500)).astype(np.float32)
    rows = rng.normal(0, 2, (500, 3)).astype(np.float32)
    return keys, ts, rows


def _runner(mod, schema_cls, profile, sql, **kw):
    eng = mod.make_engine(profile, **kw)
    schema = schema_cls("events", key_col="user", ts_col="ts",
                        value_cols=("amount", "lat", "lon"))
    eng.create_table(schema, max_keys=64, capacity=256, bucket_size=32)
    keys, ts, rows = _data()
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    eng.deploy("f", sql)
    return eng, mod.BaselineRunner(eng, "f", profile)


def _serve(mod, schema_cls, profile, sql, req_keys, req_ts, **kw):
    eng, r = _runner(mod, schema_cls, profile, sql, **kw)
    out = r.serve_batch(list(req_keys), list(req_ts))
    res = {k: np.asarray(out[k]) for k in out}
    eng.close()
    return res


def _port(profile, sql, req_keys, req_ts, **kw):
    return _serve(baselines, TableSchema, profile, sql, req_keys, req_ts,
                  device="cpu", **kw)


def _jax(profile, sql, req_keys, req_ts):
    return _serve(jbase, JSchema, profile, sql, req_keys, req_ts)


def _requests(n=40, seed=1):
    keys, ts, _ = _data()
    rng = np.random.default_rng(seed)
    rk = rng.choice(np.unique(keys), n).tolist()
    return rk, [float(ts.max()) + 0.5] * n


def _compare(got, want, exact_all, what):
    assert sorted(got) == sorted(want), what
    for n in want:
        g = np.asarray(got[n], np.float64)
        w = np.asarray(want[n], np.float64)
        assert g.shape == w.shape, (what, n)
        if exact_all or n in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {n}")
        elif n in STDVAR:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-4,
                                       err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5,
                                       err_msg=f"{what} {n}")


def test_profiles_and_paper_table_equal_jax():
    assert baselines.PROFILES.keys() == jbase.PROFILES.keys()
    for name, p in baselines.PROFILES.items():
        jp = jbase.PROFILES[name]
        assert p["kind"] == jp["kind"] and p.get("micro") == jp.get("micro")
        if "flags" in jp:
            for f in ("query_opt", "preagg", "plan_cache", "vectorized",
                      "assume_latest"):
                assert getattr(p["flags"], f) == getattr(jp["flags"], f)
    assert baselines.PAPER_TABLE1 == jbase.PAPER_TABLE1


@pytest.mark.parametrize("sql", [SQL, FULL_SQL], ids=["test_sql", "full"])
@pytest.mark.parametrize("profile", PROFILES)
def test_profile_equals_jax(profile, sql):
    if sql is SQL:
        keys, ts, _ = _data()
        rk, rt = keys[:10].tolist(), (ts[:10] + 2000).tolist()
    else:
        rk, rt = _requests()
    got = _port(profile, sql, rk, rt)
    want = _jax(profile, sql, rk, rt)
    _compare(got, want, profile == "row_interpreter", profile)


def test_baseline_profiles_agree_on_results():
    """The port's mirror of the JAX test: every emulated engine computes
    the same features as ``openmldb`` (they differ only in execution
    model), within that test's 1e-3."""
    keys, ts, _ = _data()
    rk, rt = keys[:10].tolist(), (ts[:10] + 2000).tolist()
    results = {p: _port(p, SQL, rk, rt) for p in PROFILES}
    base = results["openmldb"]
    for profile, out in results.items():
        for name in base:
            np.testing.assert_allclose(
                out[name], base[name], rtol=1e-3, atol=1e-3,
                err_msg=f"{profile}:{name}")


@pytest.mark.parametrize("slab", [1, 3, 7])
def test_columnar_fullscan_key_slabs_change_no_bit(slab, monkeypatch):
    """A budget for ``slab`` keys a slab (of the table's 64) gives the
    same bits as one slab of every key."""
    rk, rt = _requests(n=21)          # one full chunk and a padded one
    whole = _port("columnar_fullscan", FULL_SQL, rk, rt)
    per_key = 16 * 256 * baselines._SLOT_BYTES     # chunk x capacity
    monkeypatch.setattr(baselines, "_SLAB_BUDGET", slab * per_key)
    eng, r = _runner(baselines, TableSchema, "columnar_fullscan", FULL_SQL,
                     device="cpu")
    assert r.slab_keys == slab
    out = r.serve_batch(rk, rt)
    slabbed = {k: np.asarray(out[k]) for k in out}
    eng.close()
    assert sorted(whole) == sorted(slabbed)
    for n in whole:
        np.testing.assert_array_equal(slabbed[n], whole[n], err_msg=n)


def test_columnar_fullscan_default_slab_bounds_the_working_set():
    eng, r = _runner(baselines, TableSchema, "columnar_fullscan", SQL,
                     device="cpu")
    C = eng.tables["events"].capacity
    assert r.slab_keys * 16 * C * 32 <= 1 << 30
    eng.close()


def test_row_interpreter_copies_only_the_batch_keys_rows():
    eng, r = _runner(baselines, TableSchema, "row_interpreter", SQL,
                     device="cpu")
    tab = eng.tables["events"]
    rk = [3, 5, 3, 9, 5]
    kpos, values, tsb, total = r._host_rows(rk)
    assert values.shape == (3, tab.capacity, 3)
    assert tsb.shape == (3, tab.capacity) and total.shape == (3,)
    st = tab.snapshot().state
    for i, k in enumerate(rk):
        j = tab.key_to_idx[k]
        np.testing.assert_array_equal(values[kpos[i]], st.values[j].numpy())
        np.testing.assert_array_equal(tsb[kpos[i]], st.ts[j].numpy())
        assert total[kpos[i]] == int(st.total[j])
    eng.close()


def test_make_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        baselines.make_engine("openmldb")
