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
import contextlib
import ctypes
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_table_with_events
from repro.kernels import ref as jref
from repro_torch.kernels import (_build, fused_window, last_join, ops,
                                 preagg_window, ref as tref, window_agg)
from repro_torch.kernels.fused_window import fused_window_cuda, spec_table
from repro_torch.kernels.last_join import last_join_cuda
from repro_torch.kernels.preagg_window import (SHAPES, preagg_window_cuda,
                                               window_split)
from repro_torch.kernels.ref import FUSED_FIELDS
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


def test_fused_spec_table_packs_once_per_static_table():
    """The materialised fields in FUSED_FIELDS order and their bits,
    whether a spec is a RANGE frame, and per spec its (rows, bits, span)
    triple (rows -1 for RANGE, span 0.0 for ROWS); the same object for
    the same tuples."""
    rows, ranges = (10, None, 0), (None, 50.0, None)
    fields = (("sum", "last"), ("count", "min"), ("max",))
    got = spec_table(rows, ranges, fields)
    assert spec_table(rows, ranges, fields) is got
    names, present, any_range, specs = got
    assert names == ("sum", "count", "min", "max", "last")
    assert present == _build.field_bits(names) and any_range
    assert specs == tuple(zip((10, -1, 0),
                              (_build.field_bits(f) for f in fields),
                              (0.0, 50.0, 0.0)))
    assert not spec_table((1,), (None,), (("sum",),))[2]


@pytest.mark.parametrize("rows,ranges,fields,match", [
    ((-1,), (None,), (("sum",),), ">= 0"),
    ((1,), (None,), (("median",),), "unknown fields"),
    ((1, 2), (None,), (("sum",), ("sum",)), "lengths must match"),
])
def test_fused_spec_table_rejects_bad_tables(rows, ranges, fields, match):
    with pytest.raises(ValueError, match=match):
        spec_table(rows, ranges, fields)
    s, rk, rt = _small_ring()
    with pytest.raises(ValueError, match=match):       # before any launch
        fused_window_cuda(s["values"], s["ts"], s["total"], rk, rt,
                          spec_rows=rows, spec_ranges=ranges,
                          spec_fields=fields)


# ---------------------------------------------------------------------------
# wide calls: more specs or columns than one launch takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 16, 17, 33])
@pytest.mark.parametrize("V", [1, 64, 65, 130])
def test_launch_slices_cover_specs_and_columns(S, V):
    """⌈S/16⌉ × ⌈V/64⌉ launches, specs outer, each slice at most
    MAX_SPECS × MAX_COLS, together covering every (spec, column) once."""
    got = _build.launch_slices(S, V)
    assert len(got) == -(-S // _build.MAX_SPECS) * -(-V // _build.MAX_COLS)
    assert list(got) == sorted(got)
    cover = np.zeros((S, V), np.int32)
    for s0, s1, c0, c1 in got:
        assert 0 < s1 - s0 <= _build.MAX_SPECS
        assert 0 < c1 - c0 <= _build.MAX_COLS
        cover[s0:s1, c0:c1] += 1
    assert (cover == 1).all()
    spec_cuts = sorted({(s0, s1) for s0, s1, _, _ in got})
    assert _build.launch_slices(S, 0) == tuple((s0, s1, 0, 0)
                                               for s0, s1 in spec_cuts)


@pytest.mark.parametrize("what,n", [("specs", 17), ("specs", 33),
                                    ("cols", 65), ("cols", 130)])
def test_wide_calls_pass_validation(what, n):
    """17+ specs and 65+ columns pass the checks that used to refuse
    them; a CUDA wrapper given CPU tensors then stops only at the device."""
    s, rk, rt = _small_ring()
    V = s["values"].shape[2]
    rows = (4,) * (n if what == "specs" else 2)
    cols = tuple(i % V for i in range(n if what == "cols" else 3))
    assert _build.check_cols(cols, V) == cols
    assert len(spec_table(rows, (None,) * len(rows),
                          (("sum",),) * len(rows))[3]) == len(rows)
    with pytest.raises(ValueError, match="CUDA"):
        fused_window_cuda(s["values"], s["ts"], s["total"], rk, rt,
                          spec_rows=rows, spec_ranges=(None,) * len(rows),
                          spec_fields=(("sum",),) * len(rows), cols=cols)


def _as_floats(addr, shape, strides):
    """A float32 numpy view of ``shape`` with element ``strides`` at a raw
    address (what a kernel writes through its output pointer)."""
    n = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
    base = np.ctypeslib.as_array((ctypes.c_float * n).from_address(addr))
    return np.lib.stride_tricks.as_strided(
        base, shape, tuple(4 * st for st in strides))


def _names(bits, order):
    return tuple(f for f in order if bits & _build.field_bits((f,)))


class _FakeCard:
    """The kernels' launch contract modelled on the CPU: each launch
    function computes its slice with the plain version, from the inputs
    its pointers name and the columns and specs its device table holds,
    and writes it through the output pointers and strides it is given."""

    def __init__(self, tensors):
        self.t = {x.data_ptr(): x for x in tensors}
        self.calls = []

    def table(self, addr, n_cols, n_specs):
        words = np.ctypeslib.as_array((ctypes.c_int32 * (
            _build.MAX_COLS + 3 * _build.MAX_SPECS)).from_address(addr))
        c, s = _build.MAX_COLS, _build.MAX_SPECS
        return (tuple(int(x) for x in words[:n_cols]),
                tuple(int(x) for x in words[c:c + n_specs]),
                tuple(int(x) for x in words[c + s:c + s + n_specs]),
                tuple(float(x) for x in words[c + 2 * s:c + 2 * s + n_specs]
                      .view(np.float32)))

    def write(self, addr, got, shape, strides):
        if addr is not None:
            _as_floats(addr, shape, strides)[...] = got.numpy()

    def window_agg_launch(self, values, ts, total, key, rts, mask, table, B,
                          K, C, V, n, oC, rows, rng, al, bits, *outs):
        cols = self.table(table, n, 0)[0]
        order = ("sum", "sumsq", "count", "min", "max", "first", "last")
        self.calls.append(("window_agg", cols, bits))
        got = tref.window_agg_ref(
            self.t[values], self.t[ts], self.t[total], self.t[key],
            self.t[rts], cols=cols, evt_mask=self.t.get(mask),
            rows_preceding=rows if rows >= 0 else None,
            range_preceding=rng if rows < 0 else None, assume_latest=bool(al),
            fields=_names(bits, order))
        for f, addr in zip(order, outs):
            if f in got:
                self.write(addr, got[f], got[f].shape,
                           (1,) if f == "count" else (oC, 1))
        return 0

    def preagg_window_launch(self, values, ts, total, ps, pq, pn, pm, pc,
                             key, rts, table, B, K, C, V, NB, bsz, n, oC,
                             rows, rng, al, bits, *outs):
        cols = self.table(table, n, 0)[0]
        order = ("sum", "sumsq", "count", "min", "max")
        self.calls.append(("preagg_window", cols, bits))
        got = tref.preagg_window_ref(
            *(self.t[a] for a in (values, ts, total, ps, pq, pn, pm, pc, key,
                                  rts)),
            bucket_size=bsz, cols=cols, assume_latest=bool(al),
            rows_preceding=rows if rows >= 0 else None,
            range_preceding=rng if rows < 0 else None,
            fields=_names(bits, order))
        for f, addr in zip(order, outs):
            if f in got:
                self.write(addr, got[f], got[f].shape,
                           (1,) if f == "count" else (oC, 1))
        return 0

    def fused_window_launch(self, values, ts, total, key, rts, mask, table,
                            B, K, C, V, n, S, oS, oC, any_range, al, present,
                            *outs):
        cols, rows, fbits, spans = self.table(table, n, S)
        self.calls.append(("fused_window", cols, present))
        assert bool(any_range) == any(r < 0 for r in rows)
        got = tref.fused_window_ref(
            self.t[values], self.t[ts], self.t[total], self.t[key],
            self.t[rts], cols=cols, evt_mask=self.t.get(mask),
            spec_rows=tuple(r if r >= 0 else None for r in rows),
            spec_ranges=tuple(g if r < 0 else None
                              for r, g in zip(rows, spans)),
            spec_fields=tuple(_names(b, FUSED_FIELDS) for b in fbits),
            assume_latest=bool(al))
        for f, addr in zip(FUSED_FIELDS, outs):
            if present & _build.field_bits((f,)):
                v = got.get(f, torch.zeros((B, S) if f == "count"
                                           else (B, S, n)))
                self.write(addr, v, v.shape,
                           (oS, 1) if f == "count" else (oS * oC, oC, 1))
        return 0

    def last_join_launch(self, values, ts, total, key, rts, table, B, K, C,
                         V, n, oC, al, row, matched, sel_ts, stream):
        cols = self.table(table, n, 0)[0]
        self.calls.append(("last_join", cols, matched is not None))
        r, m, t = tref.last_join_ref(
            self.t[values], self.t[ts], self.t[total], self.t[key],
            self.t[rts], col_idx=cols, assume_latest=bool(al), with_ts=True)
        self.write(row, r, r.shape, (oC, 1))
        if matched is not None:
            np.ctypeslib.as_array((ctypes.c_bool * B).from_address(
                matched))[...] = m.numpy()
        self.write(sel_ts, t, t.shape, (1,))
        return 0


def _wide_inputs(V=70, seed=3):
    s, rk, rt = _small_ring()
    K, C = s["ts"].shape
    rng = np.random.default_rng(seed)
    NB = C // 8
    x = {"values": _t(rng.normal(size=(K, C, V)).astype(np.float32)),
         "ts": s["ts"], "total": s["total"], "key": rk, "rts": rt,
         "mask": _t(rng.uniform(size=(K, C)) < 0.7)}
    for f in ("pa_sum", "pa_sumsq", "pa_min", "pa_max"):
        x[f] = _t(rng.normal(size=(K, NB, V)).astype(np.float32))
    x["pa_count"] = _t(rng.integers(0, 9, (K, NB)).astype(np.float32))
    return x


@pytest.mark.parametrize("kernel,S,n_cols,fields", [
    ("window_agg", 1, 1, None), ("window_agg", 1, 65, None),
    ("window_agg", 1, 130, ("sum", "count", "last")),
    ("window_agg", 1, 130, ("count",)),
    ("preagg_window", 1, 65, None), ("preagg_window", 1, 130, ("max",)),
    ("preagg_window", 1, 130, ("count",)),
    ("last_join", 1, 1, None), ("last_join", 1, 65, None),
    ("last_join", 1, 130, None),
    ("fused_window", 3, 1, None), ("fused_window", 17, 65, None),
    ("fused_window", 33, 130, None), ("fused_window", 17, 130, "count"),
])
def test_wrappers_write_each_slice_in_place(monkeypatch, kernel, S, n_cols,
                                            fields):
    """A wide call launches once per slice of :func:`_build.launch_slices`
    (once where only counts are asked for), each launch's device table
    holds its slice's columns and specs, its output pointers and strides
    put the slice in place in the one set of outputs, and the counts (and
    LAST JOIN's matched and ts) come with the first column slice only.
    Modelled on the CPU: every launch computes its slice with the plain
    version, and the outputs start as NaN."""
    x = _wide_inputs()
    V = x["values"].shape[2]
    cols = tuple((7 * i + 3) % V for i in range(n_cols))
    fake = _FakeCard(list(x.values()))
    empty = torch.empty

    def poisoned(*a, **kw):
        t = empty(*a, **kw)
        return t.fill_(True if t.dtype == torch.bool else float("nan"))

    monkeypatch.setattr(torch, "empty", poisoned)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: t.device)
    monkeypatch.setattr(_build, "function",
                        lambda name, argtypes: getattr(fake, name))
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)
    ring = (x["values"], x["ts"], x["total"])
    tiers = tuple(x[f] for f in ("pa_sum", "pa_sumsq", "pa_min", "pa_max",
                                 "pa_count"))
    req = (x["key"], x["rts"])
    every = ("sum", "sumsq", "count", "min", "max", "first", "last")
    if kernel == "fused_window":
        kw = dict(spec_rows=tuple(None if i % 3 == 2 else 1 + 5 * i
                                  for i in range(S)),
                  spec_ranges=tuple(40.0 * (i + 1) if i % 3 == 2 else None
                                    for i in range(S)),
                  spec_fields=tuple(("count",) if fields == "count"
                                    else every[i % 7:] + every[:i % 2]
                                    for i in range(S)),
                  cols=cols, evt_mask=x["mask"], assume_latest=False)
        call, plain = (lambda: fused_window_cuda(*ring, *req, **kw),
                       lambda: tref.fused_window_ref(*ring, *req, **kw))
    elif kernel == "window_agg":
        kw = dict(cols=cols, rows_preceding=9, evt_mask=x["mask"],
                  fields=fields)
        call, plain = (lambda: window_agg_cuda(*ring, *req, **kw),
                       lambda: tref.window_agg_ref(*ring, *req, **kw))
    elif kernel == "preagg_window":
        kw = dict(cols=cols, bucket_size=8, range_preceding=300.0,
                  fields=fields)
        call, plain = (
            lambda: preagg_window_cuda(*ring, *tiers, *req, **kw),
            lambda: tref.preagg_window_ref(*ring, *tiers, *req, **kw))
    else:
        kw = dict(col_idx=cols, with_ts=True)
        call, plain = (lambda: last_join_cuda(*ring, *req, **kw),
                       lambda: tref.last_join_ref(*ring, *req, **kw))
    module = {"window_agg": window_agg, "fused_window": fused_window,
              "preagg_window": preagg_window, "last_join": last_join}[kernel]
    before = module.launches
    got, want = call(), plain()
    only_counts = fields in ("count", ("count",))
    slices = _build.launch_slices(S, 0 if only_counts else n_cols)
    assert module.launches - before == len(fake.calls) == len(slices)
    counted = fields is None or "count" in fields
    for (s0, s1, c0, c1), (_, tcols, flag) in zip(slices, fake.calls):
        assert tcols == cols[c0:c1]
        first = (flag if kernel == "last_join"
                 else bool(flag & _build.field_bits(("count",))))
        assert first == (c0 == 0 and counted)
    if not isinstance(got, dict):
        got = dict(enumerate(got))
        want = dict(enumerate(want))
    assert set(got) == set(want)
    for f in want:
        if f in EXACT or isinstance(f, int):
            assert torch.equal(got[f], want[f]), f
        else:
            torch.testing.assert_close(got[f], want[f], rtol=2e-4, atol=2e-4)


def test_empty_outputs_are_views_of_one_allocation():
    shapes = {"sum": (5, 2, 3), "count": (5, 2), "min": (5, 2, 3),
              "last": (5, 2, 0)}
    out = _build.empty_outputs(shapes, torch.device("cpu"))
    assert list(out) == list(shapes)
    base = out["sum"].untyped_storage().data_ptr()
    spans = []
    for f, t in out.items():
        assert tuple(t.shape) == shapes[f] and t.dtype == torch.float32
        assert t.is_contiguous()
        assert t.untyped_storage().data_ptr() == base
        spans.append((t.storage_offset(), t.storage_offset() + t.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert _build.empty_outputs({}, torch.device("cpu")) == {}


def test_device_table_is_built_once_per_table():
    """The layout csrc/warp_window.cuh reads: MAX_COLS column words, then
    MAX_SPECS words each of ROWS lengths, field bits and RANGE spans as
    float32 bits, zero-padded; one tensor per table."""
    cpu = torch.device("cpu")
    specs = ((10, 5, 0.0), (-1, 3, 50.0))
    t = _build.device_table((3, 1, 2), cpu, specs)
    assert _build.device_table((3, 1, 2), cpu, specs) is t
    assert t.dtype == torch.int32
    words = t.tolist()
    C, S = _build.MAX_COLS, _build.MAX_SPECS
    assert len(words) == C + 3 * S
    assert words[:C] == [3, 1, 2] + [0] * (C - 3)
    assert words[C:C + S] == [10, -1] + [0] * (S - 2)
    assert words[C + S:C + 2 * S] == [5, 3] + [0] * (S - 2)
    spans = np.asarray(words[C + 2 * S:], np.int32).view(np.float32)
    assert list(spans) == [0.0, 50.0] + [0.0] * (S - 2)
    assert _build.device_table((0,), cpu).tolist() == [0] * (C + 3 * S)


@pytest.mark.parametrize("bucket", [4, 16])
@pytest.mark.parametrize("point_in_time", [False, True])
def test_preagg_window_split_matches_a_walk(bucket, point_in_time):
    """window_split against a walk over each window's positions: the full
    buckets are the aligned runs of ``bucket`` positions inside [p0, p1),
    the rest of the window is raw, and the shapes follow from both."""
    s, rk, rt = _small_ring()
    if not point_in_time:
        rt = torch.full_like(rt, float(s["ts"].max()) + 1.0)
    frames = [dict(rows_preceding=r, range_preceding=None)
              for r in (0, 1, 3, 9, 17, 40)]
    frames += [dict(rows_preceding=None, range_preceding=g)
               for g in (50.0, 300.0)]
    every = set()
    for frame in frames:
        kw = dict(frame, assume_latest=not point_in_time)
        got = window_split(s["ts"], s["total"], rk, rt, bucket_size=bucket,
                           **kw)
        k = rk.long()
        p0, p1 = tref.window_bounds(s["ts"][k], s["total"][k], rt, **kw)
        shapes = set()
        for i, (a, b) in enumerate(zip(p0.tolist(), p1.tolist())):
            full = [q for q in range(a, b) if q % bucket == 0
                    and q + bucket <= b]
            raw = b - a - bucket * len(full)
            assert int(got["buckets"][i]) == len(full), (frame, i)
            assert int(got["raw"][i]) == raw, (frame, i)
            if b > a and not full:
                shapes.add("head only")
            if full:
                shapes.add("one bucket" if len(full) == 1
                           else "many buckets")
            if full and full[0] > a and full[-1] + bucket < b:
                shapes.add("head + buckets + tail")
        assert got["shapes"] == shapes, frame
        every |= shapes
    assert every == set(SHAPES)


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
