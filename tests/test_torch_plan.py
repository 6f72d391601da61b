"""Port plan layer: the same SQL gives the same optimized plan, rewrite log,
per-window implementation and kernel-launch count in both packages, and
``eval_scalar`` computes what the JAX version computes.

The three deployments of the main path launch all four feature kernels
between them (events: 4 columns, capacity 1024, bucket 64):

* ``fraud_scored``        — preagg ×2 + LAST JOIN merchants;
* ``serve_features``      — w1 naive (LAST), w2 preagg;
* ``serve_features_last`` — w1 and w2 in one fused launch.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import expr as JE
from repro.core.engine import Engine as JEngine
from repro.core.optimizer import OptFlags as JFlags
from repro.featurestore.table import TableSchema as JSchema
from repro_torch.core import expr as TE
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags
from repro_torch.featurestore.table import TableSchema

torch.set_num_threads(1)

WINDOWS = """
WINDOW w1 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 10 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""
FRAUD_SCORED = """
SELECT
  SUM(amount)   OVER w1 AS amt_sum_10,
  AVG(amount)   OVER w1 AS amt_avg_10,
  STD(amount)   OVER w1 AS amt_std_10,
  COUNT(amount) OVER w2 AS txn_cnt_100,
  MAX(amount)   OVER w2 AS amt_max_100,
  merchants.risk   AS m_risk,
  merchants.volume AS m_volume,
  PREDICT(fraud, amt_avg_10, amt_max_100, amt_std_10, amt_sum_10, m_risk,
          m_volume, txn_cnt_100) AS score
FROM events
LAST JOIN merchants ORDER BY mts ON merchant
""" + WINDOWS
SERVE_FEATURES = """
SELECT
  SUM(amount)  OVER w1 AS amt_sum_10,
  AVG(amount)  OVER w1 AS amt_avg_10,
  MAX(amount)  OVER w1 AS amt_max_10,
  COUNT(amount) OVER w1 AS txn_cnt_10,
  STD(amount)  OVER w1 AS amt_std_10,
  AVG(lat)     OVER w2 AS lat_avg_100,
  AVG(lon)     OVER w2 AS lon_avg_100,
  MIN(amount)  OVER w2 AS amt_min_100,
  MAX(amount)  OVER w2 AS amt_max_100,
  LAST(amount) OVER w1 AS amt_last
FROM events
""" + WINDOWS
SERVE_FEATURES_LAST = SERVE_FEATURES.replace(
    "LAST(amount) OVER w1 AS amt_last",
    "LAST(amount) OVER w1 AS amt_last,\n  LAST(lat) OVER w2 AS lat_last_100")
RANGE_WHERE = """
SELECT SUM(amount) OVER w AS s, COUNT(amount) OVER w AS c,
       FIRST(lat) OVER w AS f, SUM(amount * lat) OVER w AS cross_sum
FROM events WHERE amount > 20
WINDOW w AS (PARTITION BY user ORDER BY ts
             RANGE BETWEEN 500 PRECEDING AND CURRENT ROW)
"""
DEPLOYMENTS = {
    "fraud_scored": (FRAUD_SCORED, {"w1": "preagg", "w2": "preagg"}, 3),
    "serve_features": (SERVE_FEATURES, {"w1": "naive", "w2": "preagg"}, 2),
    "serve_features_last": (SERVE_FEATURES_LAST,
                            {"w1": "fused", "w2": "fused"}, 1),
    "range_where": (RANGE_WHERE, {"w": "naive"}, 1),
}


def _engine(E, F, S, flags_kw, **kw):
    e = E(F(**flags_kw), **kw)
    e.create_table(S("events", key_col="user", ts_col="ts",
                     value_cols=("amount", "lat", "lon", "merchant")),
                   max_keys=64, capacity=1024, bucket_size=64)
    e.create_table(S("merchants", key_col="merchant", ts_col="mts",
                     value_cols=("risk", "volume")),
                   max_keys=12, capacity=64, bucket_size=8)
    e.register_model("fraud", lambda p, f: f.sum(-1), None)
    return e


@pytest.mark.parametrize("flags_kw", [
    {}, {"assume_latest": False}, {"fuse_windows": False},
    {"preagg": False}, {"query_opt": False}])
@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_same_plan_in_both_packages(name, flags_kw):
    sql = DEPLOYMENTS[name][0]
    j = _engine(JEngine, JFlags, JSchema, flags_kw)
    t = _engine(Engine, OptFlags, TableSchema, flags_kw, device="cpu")
    jh, th = j.deploy(name, sql), t.deploy(name, sql)
    # the two packages' plan classes differ; their renderings must not
    assert repr(th.plan) == repr(jh.plan)
    assert th.plan.fingerprint() == jh.plan.fingerprint()
    assert th.opt_log == jh.opt_log
    assert th.phys.n_kernel_launches == jh.phys.n_kernel_launches
    assert ([(g.name, g.impl, g.plain_cols, g.fields) for g in th.phys.groups]
            == [(g.name, g.impl, g.plain_cols, g.fields)
                for g in jh.phys.groups])
    assert th.phys.feature_names == jh.phys.feature_names


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_main_path_window_impls_and_launches(name):
    """The implementation per window and the launches of one batch that
    the main path is specified with (default flags)."""
    sql, impls, launches = DEPLOYMENTS[name]
    t = _engine(Engine, OptFlags, TableSchema, {}, device="cpu")
    h = t.deploy(name, sql)
    assert dict(h.plan.window_impl) == impls
    assert h.phys.n_kernel_launches == launches
    assert f"kernel launches/batch: {launches}" in t.explain(name)


def test_redeploy_is_refused():
    t = _engine(Engine, OptFlags, TableSchema, {}, device="cpu")
    t.deploy("f", SERVE_FEATURES)
    with pytest.raises(ValueError, match="not ported"):
        t.deploy("f", SERVE_FEATURES)


_ARGS = {"x": np.asarray([-2.5, -0.5, 0.0, 0.25, 3.0], np.float32),
         "y": np.asarray([1.0, 0.0, 2.0, -1.0, 0.5], np.float32),
         "z": np.asarray([0.0, 3.0, 1.0, 4.0, 2.0], np.float32)}
_FUNC_CALLS = {
    "log": ("z",), "log1p": ("z",), "abs": ("x",), "sqrt": ("z",),
    "exp": ("x",), "neg": ("x",), "not": ("y",), "min2": ("x", "y"),
    "max2": ("x", "y"), "sigmoid": ("x",), "relu": ("x",),
    "floor": ("x",), "ceil": ("x",), "clip": ("x", "y", "z"),
    "if": ("y", "x", "z"), "safe_div": ("x", "z"),
    "safe_var": ("z", "x", "y"), "safe_std": ("z", "x", "y"),
}


@pytest.mark.parametrize("fname", sorted(JE.scalar_func_names()))
def test_eval_scalar_functions_match(fname):
    e = JE.Func(fname, tuple(JE.Col(a) for a in _FUNC_CALLS[fname]))
    te = TE.Func(fname, tuple(TE.Col(a) for a in _FUNC_CALLS[fname]))
    want = np.asarray(JE.eval_scalar(
        e, {k: jnp.asarray(v) for k, v in _ARGS.items()}))
    got = TE.eval_scalar(
        te, {k: torch.from_numpy(v.copy()) for k, v in _ARGS.items()})
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               want.astype(np.float64), rtol=1e-6,
                               atol=1e-6, equal_nan=True)


def test_eval_scalar_binops_literals_and_casts():
    ops = ("+", "-", "*", "/", "//", "%", ">", ">=", "<", "<=", "==", "!=",
           "and", "or")
    for op in ops:
        je = JE.Cast("f32", JE.BinOp(op, JE.Col("x"), JE.Lit(0.5)))
        te = TE.Cast("f32", TE.BinOp(op, TE.Col("x"), TE.Lit(0.5)))
        want = np.asarray(JE.eval_scalar(je, {"x": jnp.asarray(_ARGS["x"])}))
        got = TE.eval_scalar(te, {"x": torch.from_numpy(_ARGS["x"].copy())})
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=op)
