"""Port kernels: the plain PyTorch versions (``repro_torch.kernels.ref``)
against the JAX references (``repro.kernels.ref``) on the shape sweeps of
``tests/test_kernels.py``, and against the Pallas kernels (interpret mode)
at one small shape each; dispatch and the CUDA wrappers' input checks.

The same numpy inputs go to both packages. Tolerances: exact for count,
min, max, first, last, the LAST JOIN row, ``matched`` and the selected ts
(selects and order-free reductions); ``rtol 2e-4`` for sum and sumsq, whose
summation order differs between the two frameworks.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_table_with_events
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels.fused_window import fused_window_cuda
from repro_torch.kernels.last_join import last_join_cuda
from repro_torch.kernels.preagg_window import preagg_window_cuda
from repro_torch.kernels.window_agg import window_agg_cuda

torch.set_num_threads(1)

EXACT = ("count", "min", "max", "first", "last")


def _t(a):
    """A JAX or numpy array as a CPU tensor (numpy in between)."""
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _events_state(**kw):
    """numpy state of a JAX table filled by ``make_table_with_events``
    (cached: sweeps share tables, and each new shape costs a compile)."""
    t, _ = make_table_with_events(**kw)
    return _state(t)


def _state(table):
    st, pa = table.state, table.preagg
    out = {"values": np.asarray(st.values), "ts": np.asarray(st.ts),
           "total": np.asarray(st.total)}
    if pa is not None:
        out.update(pa_sum=np.asarray(pa.sum), pa_sumsq=np.asarray(pa.sumsq),
                   pa_min=np.asarray(pa.min), pa_max=np.asarray(pa.max),
                   pa_count=np.asarray(pa.count))
    return out


def _assert_fields(got, want, rtol=2e-4):
    assert set(got) == set(want)
    for f in want:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if f in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol,
                                       err_msg=f)


def _requests(n_keys, B, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_keys, B).astype(np.int32),
            np.sort(rng.uniform(lo, hi, B)).astype(np.float32))


# ---------------------------------------------------------------------------
# window_agg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_keys,capacity,n_cols", [
    (4, 64, 1), (8, 128, 3), (3, 256, 2)])
@pytest.mark.parametrize("rows_prec,range_prec", [
    (10, None), (None, 50.0), (31, None)])
@pytest.mark.parametrize("assume_latest", [False, True])
def test_window_agg_ref_matches_jax(n_keys, capacity, n_cols, rows_prec,
                                    range_prec, assume_latest):
    s = _events_state(n_keys=n_keys, n_events=capacity * 2, n_cols=n_cols,
                      capacity=capacity, bucket_size=16, seed=42)
    rk, rt = _requests(n_keys, 16, 100, 1200, 1)
    kw = dict(rows_preceding=rows_prec, range_preceding=range_prec,
              assume_latest=assume_latest)
    want = jref.window_agg_ref(jnp.asarray(s["values"]), s["ts"],
                               s["total"], jnp.asarray(rk), jnp.asarray(rt),
                               **kw)
    got = tref.window_agg_ref(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                              _t(rk), _t(rt), **kw)
    _assert_fields(got, want)


@pytest.mark.parametrize("cols", [(2,), (2, 0), (1, 2, 0)])
def test_window_agg_cols_read_the_named_columns(cols):
    """``cols`` narrows the read: equal to the JAX reference on the
    columns sliced out beforehand, with the mask and a field subset."""
    s = _events_state(n_keys=5, n_events=300, n_cols=3, capacity=128,
                      seed=3)
    rk, rt = _requests(5, 12, 100, 1200, 2)
    mask = s["values"][:, :, 1] > 0
    fields = ("sum", "count", "min", "last")
    want = jref.window_agg_ref(jnp.asarray(s["values"][:, :, list(cols)]),
                               s["ts"], s["total"], jnp.asarray(rk),
                               jnp.asarray(rt), rows_preceding=40,
                               evt_mask=jnp.asarray(mask), fields=fields)
    got = tref.window_agg_ref(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                              _t(rk), _t(rt), cols=cols, rows_preceding=40,
                              evt_mask=_t(mask), fields=fields)
    _assert_fields(got, want)


def test_window_agg_ref_matches_pallas_interpret():
    from repro.kernels.window_agg import window_agg_pallas
    s = _events_state(n_keys=4, n_events=160, n_cols=2, capacity=64,
                      seed=42)
    rk, rt = _requests(4, 8, 100, 1200, 1)
    want = window_agg_pallas(jnp.asarray(s["values"]), jnp.asarray(s["ts"]),
                             jnp.asarray(s["total"]), jnp.asarray(rk),
                             jnp.asarray(rt), range_preceding=50.0,
                             interpret=True)
    got = ops.window_agg(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                         _t(rk), _t(rt), range_preceding=50.0)
    _assert_fields(got, want)


# ---------------------------------------------------------------------------
# fused_window
# ---------------------------------------------------------------------------

FUSED_SPEC_ROWS = (10, None, 31, None)
FUSED_SPEC_RANGES = (None, 50.0, None, 400.0)
FUSED_SPEC_FIELDS = (
    ("sum", "count", "max"),
    ("sum", "sumsq", "count"),
    ("sum", "sumsq", "count", "min", "max", "first", "last"),
    ("min", "first", "last", "count"),
)


def _fused_inputs(with_mask, seed=13):
    s = _events_state(n_keys=5, n_events=300, n_cols=3, capacity=128,
                      bucket_size=16, seed=seed)
    rk, rt = _requests(5, 12, 100, 1300, 3)
    mask = (s["values"][:, :, 0] > 0) if with_mask else None
    return s, rk, rt, mask


@pytest.mark.parametrize("assume_latest", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_window_ref_matches_jax(assume_latest, with_mask):
    s, rk, rt, mask = _fused_inputs(with_mask)
    kw = dict(spec_rows=FUSED_SPEC_ROWS, spec_ranges=FUSED_SPEC_RANGES,
              spec_fields=FUSED_SPEC_FIELDS, assume_latest=assume_latest)
    want = jref.fused_window_ref(
        jnp.asarray(s["values"]), s["ts"], s["total"], jnp.asarray(rk),
        jnp.asarray(rt), evt_mask=None if mask is None else jnp.asarray(mask),
        **kw)
    got = tref.fused_window_ref(
        _t(s["values"]), _t(s["ts"]), _t(s["total"]), _t(rk), _t(rt),
        evt_mask=None if mask is None else _t(mask), **kw)
    _assert_fields(got, want)


def test_fused_window_ref_matches_pallas_interpret():
    from repro.kernels.fused_window import fused_window_pallas
    s, rk, rt, mask = _fused_inputs(with_mask=True)
    kw = dict(spec_rows=FUSED_SPEC_ROWS, spec_ranges=FUSED_SPEC_RANGES,
              spec_fields=FUSED_SPEC_FIELDS)
    want = fused_window_pallas(
        jnp.asarray(s["values"]), jnp.asarray(s["ts"]),
        jnp.asarray(s["total"]), jnp.asarray(rk), jnp.asarray(rt),
        evt_mask=jnp.asarray(mask), interpret=True, **kw)
    got = ops.fused_window(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                           _t(rk), _t(rt), evt_mask=_t(mask), **kw)
    _assert_fields(got, want)


def test_fused_window_empty_windows_and_field_zeroing():
    """Requests before any event: count 0, min at the +3.0e38 sentinel for
    the spec that asked for it, exactly zero for the spec that did not."""
    s, rk, _, _ = _fused_inputs(with_mask=False)
    rt = np.full(12, -100.0, np.float32)
    out = tref.fused_window_ref(
        _t(s["values"]), _t(s["ts"]), _t(s["total"]), _t(rk), _t(rt),
        spec_rows=(5, None), spec_ranges=(None, 30.0),
        spec_fields=(("sum", "count", "min"), ("count",)))
    assert torch.all(out["count"] == 0.0)
    assert torch.all(out["min"][:, 0] == tref.POS_INF)
    assert torch.all(out["min"][:, 1] == 0.0)
    assert torch.all(out["sum"][:, 1] == 0.0)


@pytest.mark.parametrize("rows,ranges,fields,match", [
    ((5, 7), (None, 30.0), (("sum",), ("sum",)), "exactly one"),
    ((5,), (None, 30.0), (("sum",),), "lengths"),
    ((5,), (None,), (("median",),), "unknown fields"),
])
def test_fused_window_spec_validation(rows, ranges, fields, match):
    s, rk, rt, _ = _fused_inputs(with_mask=False)
    with pytest.raises(ValueError, match=match):
        tref.fused_window_ref(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                              _t(rk), _t(rt), spec_rows=rows,
                              spec_ranges=ranges, spec_fields=fields)


# ---------------------------------------------------------------------------
# preagg_window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,bucket", [(64, 8), (128, 16), (256, 64)])
@pytest.mark.parametrize("rows_prec,range_prec", [
    (20, None), (None, 100.0), (120, None)])
def test_preagg_window_ref_matches_jax(capacity, bucket, rows_prec,
                                       range_prec):
    s = _events_state(n_keys=6, n_events=capacity * 3, capacity=capacity,
                      bucket_size=bucket, seed=7)
    rk, rt = _requests(6, 8, 200, 1500, 3)
    kw = dict(bucket_size=bucket, rows_preceding=rows_prec,
              range_preceding=range_prec)
    names = ("values", "ts", "total", "pa_sum", "pa_sumsq", "pa_min",
             "pa_max", "pa_count")
    want = jref.preagg_window_ref(*(jnp.asarray(s[n]) for n in names),
                                  jnp.asarray(rk), jnp.asarray(rt), **kw)
    got = tref.preagg_window_ref(*(_t(s[n]) for n in names), _t(rk), _t(rt),
                                 **kw)
    _assert_fields(got, want)


def test_preagg_window_cols_and_pallas_interpret():
    """``cols`` reads the same columns of the ring and of every tier; the
    answer equals the Pallas kernel on the columns sliced out."""
    from repro.kernels.preagg_window import preagg_window_pallas
    s = _events_state(n_keys=6, n_events=384, n_cols=3, capacity=128,
                      bucket_size=16, seed=7)
    rk, rt = _requests(6, 8, 200, 1500, 3)
    cols = [2, 0]
    sl = {n: (s[n][:, :, cols] if s[n].ndim == 3 else s[n])
          for n in ("values", "pa_sum", "pa_sumsq", "pa_min", "pa_max")}
    want = preagg_window_pallas(
        jnp.asarray(sl["values"]), jnp.asarray(s["ts"]),
        jnp.asarray(s["total"]), *(jnp.asarray(sl[n]) for n in
                                   ("pa_sum", "pa_sumsq", "pa_min",
                                    "pa_max")),
        jnp.asarray(s["pa_count"]), jnp.asarray(rk), jnp.asarray(rt),
        bucket_size=16, rows_preceding=50, interpret=True)
    got = ops.preagg_window(
        *(_t(s[n]) for n in ("values", "ts", "total", "pa_sum", "pa_sumsq",
                             "pa_min", "pa_max", "pa_count")),
        _t(rk), _t(rt), bucket_size=16, cols=tuple(cols), rows_preceding=50)
    _assert_fields(got, want)


def test_preagg_equals_naive_window():
    """Paper Eq. 2 in the port: the pre-aggregated path equals the scan."""
    s = {k: _t(v) for k, v in _events_state(
        n_keys=5, n_events=300, capacity=128, bucket_size=16,
        seed=11).items()}
    rk, rt = _requests(5, 12, 0, 1200, 5)
    naive = tref.window_agg_ref(s["values"], s["ts"], s["total"], _t(rk),
                                _t(rt), rows_preceding=40)
    fast = tref.preagg_window_ref(
        s["values"], s["ts"], s["total"], s["pa_sum"], s["pa_sumsq"],
        s["pa_min"], s["pa_max"], s["pa_count"], _t(rk), _t(rt),
        bucket_size=16, rows_preceding=40)
    for f in ("sum", "count", "min", "max"):
        np.testing.assert_allclose(fast[f].numpy(), naive[f].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


# ---------------------------------------------------------------------------
# last_join
# ---------------------------------------------------------------------------

def _join_state(seed=7, capacity=64):
    """Right table with keys 0..5 populated (6, 7 empty), tied timestamps
    and enough events to wrap the ring (the JAX suite's fixture)."""
    from repro.featurestore.table import Table, TableSchema
    rng = np.random.default_rng(seed)
    t = Table(TableSchema("right", key_col="k", ts_col="ts",
                          value_cols=("a", "b", "c")),
              max_keys=8, capacity=capacity, bucket_size=8)
    keys = rng.integers(0, 6, 500)
    ts = rng.uniform(1.0, 1000, 500)
    ts[50:60] = ts[50]
    ts = np.sort(ts).astype(np.float32)
    rows = rng.normal(0, 2, (500, 3)).astype(np.float32)
    keys = np.concatenate([np.arange(6), keys])
    ts = np.concatenate([np.zeros(6, np.float32), ts])
    rows = np.concatenate([np.zeros((6, 3), np.float32), rows])
    t.insert(keys.tolist(), ts.tolist(), rows)
    rk = np.asarray(list(rng.integers(0, 6, 12)) + [6, 0, 1, 2], np.int32)
    rt = np.asarray(list(np.sort(rng.uniform(100, 900, 12)))
                    + [500.0, -5.0, 1e6, float(ts[55])], np.float32)
    return _state(t), rk, rt


@pytest.mark.parametrize("assume_latest", [False, True])
@pytest.mark.parametrize("col_idx", [(0,), (2, 0)])
def test_last_join_ref_matches_jax(assume_latest, col_idx):
    s, rk, rt = _join_state()
    kw = dict(col_idx=col_idx, assume_latest=assume_latest, with_ts=True)
    want = jref.last_join_ref(jnp.asarray(s["values"]), s["ts"], s["total"],
                              jnp.asarray(rk), jnp.asarray(rt), **kw)
    got = tref.last_join_ref(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                             _t(rk), _t(rt), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_last_join_ref_matches_pallas_interpret():
    from repro.kernels.last_join import last_join_pallas
    s, rk, rt = _join_state()
    want = last_join_pallas(jnp.asarray(s["values"]), jnp.asarray(s["ts"]),
                            jnp.asarray(s["total"]), jnp.asarray(rk),
                            jnp.asarray(rt), col_idx=(1, 2), with_ts=True,
                            interpret=True)
    got = ops.last_join(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                        _t(rk), _t(rt), col_idx=(1, 2), with_ts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_last_join_requires_columns():
    s, rk, rt = _join_state()
    with pytest.raises(ValueError, match="at least one value column"):
        tref.last_join_ref(_t(s["values"]), _t(s["ts"]), _t(s["total"]),
                           _t(rk), _t(rt), col_idx=())


# ---------------------------------------------------------------------------
# dispatch and the CUDA wrappers' checks (no card needed)
# ---------------------------------------------------------------------------

def _small_ring():
    s, rk, rt = _join_state()
    return {k: _t(v) for k, v in s.items()}, _t(rk), _t(rt)


@pytest.mark.parametrize("wrapper", ["window_agg", "fused_window",
                                     "preagg_window", "last_join"])
def test_cuda_wrapper_rejects_cpu_tensors(wrapper):
    """A CUDA wrapper never computes on the CPU: it refuses the tensors
    before it builds or launches anything."""
    s, rk, rt = _small_ring()
    ring = (s["values"], s["ts"], s["total"])
    calls = {
        "window_agg": lambda: window_agg_cuda(*ring, rk, rt,
                                              rows_preceding=4),
        "fused_window": lambda: fused_window_cuda(
            *ring, rk, rt, spec_rows=(4,), spec_ranges=(None,),
            spec_fields=(("sum",),)),
        "preagg_window": lambda: preagg_window_cuda(
            *ring, s["pa_sum"], s["pa_sumsq"], s["pa_min"], s["pa_max"],
            s["pa_count"], rk, rt, bucket_size=8, rows_preceding=4),
        "last_join": lambda: last_join_cuda(*ring, rk, rt, col_idx=(0,)),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()


def test_dispatch_refuses_other_devices():
    s, rk, rt = _small_ring()
    meta = s["values"].to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.window_agg(meta, s["ts"], s["total"], rk, rt, rows_preceding=4)


def test_dispatch_takes_plain_version_for_cpu_tensors():
    s, rk, rt = _small_ring()
    got = ops.last_join(s["values"], s["ts"], s["total"], rk, rt,
                        col_idx=(0, 2))
    want = tref.last_join_ref(s["values"], s["ts"], s["total"], rk, rt,
                              col_idx=(0, 2))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
