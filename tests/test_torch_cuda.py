"""CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card: it is marked ``cuda`` and skips where
there is none. The file imports no JAX, so it runs on a GPU machine that
has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: exact for count, min, max, first, last and the LAST JOIN
outputs; ``rtol 2e-4`` for sum and sumsq (another summation order).
"""
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import EventStreamConfig, generate_events
from repro_torch.featurestore.table import Table, TableSchema
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

EXACT = ("count", "min", "max", "first", "last")
SPEC_ROWS = (10, None, 31, None)
SPEC_RANGES = (None, 50.0, None, 400.0)
SPEC_FIELDS = (
    ("sum", "count", "max"),
    ("sum", "sumsq", "count"),
    ("sum", "sumsq", "count", "min", "max", "first", "last"),
    ("min", "first", "last", "count"),
)


@pytest.fixture(scope="module")
def table():
    """A CUDA table whose hot keys wrap their rings, with empty keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=6000, n_keys=24, n_features=3, seed=5))
    t = Table(TableSchema("events", "k", "ts", ("a", "b", "c")),
              max_keys=32, capacity=128, bucket_size=16, device="cuda")
    t.insert(keys.tolist(), ts.tolist(), rows)
    assert int(t.state.total.max()) > 2 * t.capacity
    return t


def _requests(t, B, point_in_time, seed=9):
    rng = np.random.default_rng(seed)
    keys = torch.tensor(rng.integers(0, t.max_keys, B), dtype=torch.int32,
                        device=t.device)              # keys >= 24 are empty
    if point_in_time:
        ts = rng.uniform(-50.0, t.watermark + 10.0, B)
    else:
        ts = np.full(B, t.watermark + 1.0)
    return keys, torch.tensor(ts, dtype=torch.float32, device=t.device)


def _assert_same(got, want):
    if not isinstance(got, dict):
        got = dict(enumerate(got))
        want = dict(enumerate(want))
    for f in want:
        g, w = got[f].cpu(), want[f].cpu()
        if f in EXACT or isinstance(f, int):
            assert torch.equal(g, w), f
        else:
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4, msg=f)


@pytest.mark.parametrize("point_in_time", [False, True])
@pytest.mark.parametrize("frame", [dict(rows_preceding=10),
                                   dict(rows_preceding=200),
                                   dict(range_preceding=80.0)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_agg_kernel(table, point_in_time, frame, with_mask):
    key, rts = _requests(table, 64, point_in_time)
    st = table.state
    mask = (st.values[:, :, 1] > 0) if with_mask else None
    kw = dict(cols=(2, 0), evt_mask=mask,
              assume_latest=not point_in_time, **frame)
    args = (st.values, st.ts, st.total, key, rts)
    _assert_same(ops.window_agg(*args, **kw),
                 ref.window_agg_ref(*args, **kw))


@pytest.mark.parametrize("point_in_time", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_window_kernel(table, point_in_time, with_mask):
    key, rts = _requests(table, 64, point_in_time)
    st = table.state
    kw = dict(spec_rows=SPEC_ROWS, spec_ranges=SPEC_RANGES,
              spec_fields=SPEC_FIELDS, cols=(0, 1, 2),
              evt_mask=(st.values[:, :, 0] > 0) if with_mask else None,
              assume_latest=not point_in_time)
    args = (st.values, st.ts, st.total, key, rts)
    _assert_same(ops.fused_window(*args, **kw),
                 ref.fused_window_ref(*args, **kw))


@pytest.mark.parametrize("point_in_time", [False, True])
@pytest.mark.parametrize("frame", [dict(rows_preceding=20),
                                   dict(rows_preceding=100),
                                   dict(range_preceding=150.0)])
def test_preagg_window_kernel(table, point_in_time, frame):
    key, rts = _requests(table, 64, point_in_time)
    st, pa = table.state, table.preagg
    kw = dict(bucket_size=table.bucket_size, cols=(1,),
              assume_latest=not point_in_time, **frame)
    args = (st.values, st.ts, st.total, pa.sum, pa.sumsq, pa.min, pa.max,
            pa.count, key, rts)
    _assert_same(ops.preagg_window(*args, **kw),
                 ref.preagg_window_ref(*args, **kw))


@pytest.mark.parametrize("point_in_time", [False, True])
def test_last_join_kernel(table, point_in_time):
    key, rts = _requests(table, 64, point_in_time)
    st = table.state
    kw = dict(col_idx=(2, 0, 1), assume_latest=not point_in_time,
              with_ts=True)
    got = ops.last_join(st.values, st.ts, st.total, key, rts, **kw)
    want = ref.last_join_ref(st.values, st.ts, st.total, key, rts, **kw)
    assert not bool(want[1].all())                 # some unmatched
    _assert_same(got, want)


def test_launch_counters_count_kernel_launches(table):
    from repro_torch.kernels import window_agg
    key, rts = _requests(table, 8, False)
    st = table.state
    before = window_agg.launches
    ops.window_agg(st.values, st.ts, st.total, key, rts, rows_preceding=5)
    ref.window_agg_ref(st.values, st.ts, st.total, key, rts,
                       rows_preceding=5)
    assert window_agg.launches == before + 1


def test_wrapper_rejects_bad_inputs(table):
    key, rts = _requests(table, 8, False)
    st = table.state
    with pytest.raises(TypeError, match="req_key must be torch.int32"):
        ops.window_agg(st.values, st.ts, st.total, key.long(), rts,
                       rows_preceding=5)
    with pytest.raises(ValueError, match="outside"):
        ops.window_agg(st.values, st.ts, st.total, key, rts, cols=(3,),
                       rows_preceding=5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.last_join(st.values[:, ::2], st.ts[:, ::2], st.total, key, rts,
                      col_idx=(0,))
    with pytest.raises(ValueError, match="is on cpu"):
        ops.window_agg(st.values, st.ts, st.total, key.cpu(), rts,
                       rows_preceding=5)
