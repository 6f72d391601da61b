"""CUDA kernels against their plain PyTorch versions, on the card, and
the live-serving path on the card against the CPU (a streamed load, the
execution modes, a hot swap under a request thread, the chunked
pre-aggregate rebuild and compaction, first launches from several
threads); the model tier's Mamba-2, MoE and hybrid blocks, mixtral's ring
decode, a jamba train step and the encoder-decoder on the card against
the CPU; the int8-compressed train step on a one-rank NCCL group; the
sharded path's kernel calls on local heads against the full call, and a
two-process (1, 2) mesh sharing the card (gloo) against the meshless
step.

Every test here needs a CUDA card: it is marked ``cuda`` and skips where
there is none. The file imports no JAX, so it runs on a GPU machine that
has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: exact for count, min, max, first, last and the LAST JOIN
outputs; ``rtol 2e-4`` for sum and sumsq (another summation order). The
attention kernels keep the logits in f32 where the plain versions round
them to the input dtype (in bf16 both round the probabilities to bf16
before PV): ``rtol = atol = 2e-2`` in bf16 and ``2e-5`` in f32, as
``tests/test_kernels.py`` holds the Pallas kernels. The backward kernel's
gradients are held at the same tolerances to autograd of the plain version
in f32. Only ``test_flash_attention_backward_rows_without_keys`` has a
query that keeps no key (there the kernels write 0 and give it zero
gradient, the plain versions the uniform average).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import EventStreamConfig, generate_events
from repro_torch.featurestore.table import Table, TableSchema
from repro_torch.kernels import (_build, fused_window, last_join, ops,
                                 preagg_window, ref, window_agg)
from repro_torch.kernels.decode_attention import SPLIT
from repro_torch.kernels.preagg_window import SHAPES, window_split

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


# ---------------------------------------------------------------------------
# the warp-per-request kernels (fused_window, preagg_window) at their edges
# ---------------------------------------------------------------------------

FIELDS = ("sum", "sumsq", "count", "min", "max", "first", "last")
EDGE_ROWS = (0, 1, 31, 32, 33, 100, 1023)


def _edge_requests(t, B, point_in_time):
    """Requests whose keys include out-of-range ones (negative and past
    max_keys), empty and wrapped ones. The kernels read an out-of-range key
    as an empty ring; the plain version is given an empty key there."""
    key, rts = _requests(t, B, point_in_time, seed=B)
    oor = key.clone()
    bad = torch.tensor([-1, t.max_keys, t.max_keys + 9, -7],
                       dtype=torch.int32, device=t.device)
    idx = torch.arange(0, B, 7, device=t.device)[:len(bad)]
    oor[idx] = bad[:len(idx)]
    plain = torch.where(oor == key, key, torch.full_like(key, t.max_keys - 1))
    assert int(t.state.total[t.max_keys - 1]) == 0
    return oor, plain, rts


@pytest.mark.parametrize("B", [1, 31, 33, 499])
@pytest.mark.parametrize("point_in_time", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_window_kernel_geometry(table, B, point_in_time, with_mask):
    """Ragged blocks, out-of-range keys, the ROWS edges of a warp's walk
    and RANGE frames in one spec table."""
    key, plain_key, rts = _edge_requests(table, B, point_in_time)
    st = table.state
    kw = dict(spec_rows=EDGE_ROWS + (None, None),
              spec_ranges=(None,) * len(EDGE_ROWS) + (50.0, 400.0),
              spec_fields=tuple(FIELDS[i % 7:] + FIELDS[:i % 3]
                                for i in range(len(EDGE_ROWS) + 2)),
              cols=(1, 2, 0),
              evt_mask=(st.values[:, :, 0] > 0) if with_mask else None,
              assume_latest=not point_in_time)
    _assert_same(ops.fused_window(st.values, st.ts, st.total, key, rts, **kw),
                 ref.fused_window_ref(st.values, st.ts, st.total, plain_key,
                                      rts, **kw))


@pytest.mark.parametrize("V", [68, 70])
@pytest.mark.parametrize("point_in_time", [False, True])
def test_fused_window_kernel_16_specs_64_columns(table, V, point_in_time):
    """16 specs over 64 columns: many chunks of specs and columns, read
    as aligned groups of four (V=68) or column by column (V=70)."""
    key, plain_key, rts = _edge_requests(table, 64, point_in_time)
    st = table.state
    K, C = st.ts.shape
    wide = torch.from_numpy(np.random.default_rng(V).normal(
        size=(K, C, V)).astype(np.float32)).to(table.device)
    rows = tuple(None if i % 4 == 3 else 9 * i for i in range(16))
    kw = dict(spec_rows=rows,
              spec_ranges=tuple(25.0 * (i + 1) if r is None else None
                                for i, r in enumerate(rows)),
              spec_fields=tuple(FIELDS[:1 + i % 7] if i % 2 else FIELDS[i % 7:]
                                for i in range(16)),
              evt_mask=(wide[:, :, 0] > 0) if point_in_time else None,
              assume_latest=not point_in_time)
    for cols in (tuple(range(64)), tuple((7 * i) % V for i in range(64))):
        _assert_same(
            ops.fused_window(wide, st.ts, st.total, key, rts, cols=cols,
                             **kw),
            ref.fused_window_ref(wide, st.ts, st.total, plain_key, rts,
                                 cols=cols, **kw))


@pytest.mark.parametrize("B", [1, 31, 33, 499])
@pytest.mark.parametrize("point_in_time", [False, True])
def test_preagg_window_kernel_geometry(table, B, point_in_time):
    """Ragged blocks, out-of-range keys, and every window shape: head
    only, one bucket, many buckets, head + buckets + tail; one to 64
    columns."""
    key, plain_key, rts = _edge_requests(table, B, point_in_time)
    st, pa = table.state, table.preagg
    shapes = set()
    for frame in (dict(rows_preceding=r) for r in (0, 1, 10, 16, 31, 100,
                                                   112, 127)):
        for cols, fields in (((1,), ("sum", "sumsq", "count")),
                             ((0,), ("count", "max")),
                             ((1, 2, 0), ("count", "max", "min", "sum")),
                             (tuple(i % 3 for i in range(64)), None)):
            kw = dict(bucket_size=table.bucket_size, cols=cols, fields=fields,
                      assume_latest=not point_in_time, **frame)
            args = (st.values, st.ts, st.total, pa.sum, pa.sumsq, pa.min,
                    pa.max, pa.count)
            _assert_same(ops.preagg_window(*args, key, rts, **kw),
                         ref.preagg_window_ref(*args, plain_key, rts, **kw))
        shapes |= window_split(st.ts, st.total, plain_key, rts,
                               bucket_size=table.bucket_size,
                               assume_latest=not point_in_time,
                               **frame)["shapes"]
    if B == 499:
        assert shapes == set(SHAPES)


@pytest.fixture(scope="module", params=[16, 256])
def wide_table(request):
    """A CUDA table of capacity 1024 whose hot keys wrap their rings: with
    buckets of 16 a window spans up to 63 of its 64 buckets, with buckets
    of 256 a window without a full bucket holds up to 510 raw rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=40000, n_keys=24, n_features=3, seed=6))
    t = Table(TableSchema("events", "k", "ts", ("a", "b", "c")),
              max_keys=32, capacity=1024, bucket_size=request.param,
              device="cuda")
    t.insert(keys.tolist(), ts.tolist(), rows)
    assert int(t.state.total.max()) > 2 * t.capacity
    return t


@pytest.mark.parametrize("B", [33, 499])
@pytest.mark.parametrize("point_in_time", [False, True])
def test_preagg_window_kernel_wide_buckets(wide_table, B, point_in_time):
    """More than 32 full buckets (a lane takes a second bucket) and raw
    walks of more than 128 rows (more than one group of four steps)."""
    t = wide_table
    key, plain_key, rts = _edge_requests(t, B, point_in_time)
    st, pa = t.state, t.preagg
    most_buckets = most_raw = 0
    for frame in (dict(rows_preceding=r) for r in (100, 300, 500, 700, 1000,
                                                   1023)):
        for cols, fields in (((1,), ("sum", "sumsq", "count")),
                             ((1, 2, 0), ("count", "max", "min", "sum")),
                             (tuple(i % 3 for i in range(9)), None)):
            kw = dict(bucket_size=t.bucket_size, cols=cols, fields=fields,
                      assume_latest=not point_in_time, **frame)
            args = (st.values, st.ts, st.total, pa.sum, pa.sumsq, pa.min,
                    pa.max, pa.count)
            _assert_same(ops.preagg_window(*args, key, rts, **kw),
                         ref.preagg_window_ref(*args, plain_key, rts, **kw))
        split = window_split(st.ts, st.total, plain_key, rts,
                             bucket_size=t.bucket_size,
                             assume_latest=not point_in_time, **frame)
        most_buckets = max(most_buckets, int(split["buckets"].max()))
        most_raw = max(most_raw, int(split["raw"].max()))
    if B == 499:
        assert most_buckets > 32 if t.bucket_size == 16 else most_raw > 128


# ---------------------------------------------------------------------------
# window_agg and last_join (one warp per request) at their edges, and the
# calls wider than one launch
# ---------------------------------------------------------------------------

def _wide_values(t, V, seed):
    K, C = t.state.ts.shape
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(K, C, V)).astype(np.float32)).to(t.device)


@pytest.mark.parametrize("B", [1, 31, 33, 499])
@pytest.mark.parametrize("point_in_time", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("V", [68, 70])
def test_window_agg_kernel_geometry(table, B, point_in_time, with_mask, V):
    """Ragged blocks, out-of-range keys, the ROWS edges of a warp's walk
    and RANGE frames; columns in aligned groups of four (V=68) or read
    one by one (V=70, and scattered columns); every field, moments only,
    and count/first/last alone (no walk without a mask)."""
    key, plain_key, rts = _edge_requests(table, B, point_in_time)
    st = table.state
    wide = _wide_values(table, V, V + B)
    mask = (wide[:, :, 0] > 0) if with_mask else None
    frames = [dict(rows_preceding=r) for r in EDGE_ROWS]
    frames += [dict(range_preceding=g) for g in (50.0, 400.0)]
    for frame in frames:
        for cols, fields in ((tuple(range(8)), None), ((1, 0), None),
                             (tuple((7 * i) % V for i in range(9)),
                              ("sum", "max", "min")),
                             ((3, 66), ("count", "first", "last"))):
            kw = dict(cols=cols, fields=fields, evt_mask=mask,
                      assume_latest=not point_in_time, **frame)
            _assert_same(
                ops.window_agg(wide, st.ts, st.total, key, rts, **kw),
                ref.window_agg_ref(wide, st.ts, st.total, plain_key, rts,
                                   **kw))


@pytest.mark.parametrize("B", [33, 499])
@pytest.mark.parametrize("point_in_time", [False, True])
def test_window_agg_kernel_long_walks(wide_table, B, point_in_time):
    """Windows of up to 1023 rows: walks of many groups of steps."""
    t = wide_table
    key, plain_key, rts = _edge_requests(t, B, point_in_time)
    st = t.state
    for frame in ([dict(rows_preceding=r) for r in (127, 300, 700, 1023)]
                  + [dict(range_preceding=g) for g in (500.0, 5000.0)]):
        for mask in (None, st.values[:, :, 1] > 0):
            kw = dict(cols=(2, 0), evt_mask=mask,
                      assume_latest=not point_in_time, **frame)
            _assert_same(
                ops.window_agg(st.values, st.ts, st.total, key, rts, **kw),
                ref.window_agg_ref(st.values, st.ts, st.total, plain_key,
                                   rts, **kw))


@pytest.fixture(scope="module", params=[64, 1024])
def join_table(request):
    """A CUDA right table of capacity 64 or 1024 whose hot keys wrap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=40000, n_keys=24, n_features=3, seed=7))
    t = Table(TableSchema("right", "k", "ts", ("a", "b", "c")),
              max_keys=32, capacity=request.param, bucket_size=16,
              device="cuda")
    t.insert(keys.tolist(), ts.tolist(), rows)
    assert int(t.state.total.max()) > 2 * t.capacity
    return t


@pytest.mark.parametrize("B", [1, 31, 33, 499])
@pytest.mark.parametrize("point_in_time", [False, True])
def test_last_join_kernel_geometry(join_table, B, point_in_time):
    """Ragged blocks, out-of-range and empty keys, requests before a key's
    history (unmatched) and inside it, online and point in time."""
    t = join_table
    key, plain_key, rts = _edge_requests(t, B, point_in_time)
    st = t.state
    for cols in ((2, 0, 1), (1,), tuple(i % 3 for i in range(40))):
        kw = dict(col_idx=cols, assume_latest=not point_in_time,
                  with_ts=True)
        got = ops.last_join(st.values, st.ts, st.total, key, rts, **kw)
        want = ref.last_join_ref(st.values, st.ts, st.total, plain_key, rts,
                                 **kw)
        if B == 499:
            assert not bool(want[1].all()) and bool(want[1].any())
        _assert_same(got, want)


@pytest.mark.parametrize("S", [17, 33])
@pytest.mark.parametrize("point_in_time", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_window_kernel_many_specs(table, S, point_in_time, with_mask):
    """More specs than one launch takes: ⌈S/16⌉ launches over one set of
    outputs."""
    key, plain_key, rts = _edge_requests(table, 64, point_in_time)
    st = table.state
    rows = tuple(None if i % 4 == 3 else 7 * i for i in range(S))
    kw = dict(spec_rows=rows,
              spec_ranges=tuple(20.0 * (i + 1) if r is None else None
                                for i, r in enumerate(rows)),
              spec_fields=tuple(FIELDS[i % 7:] + FIELDS[:i % 3]
                                for i in range(S)),
              cols=(1, 2, 0),
              evt_mask=(st.values[:, :, 0] > 0) if with_mask else None,
              assume_latest=not point_in_time)
    before = fused_window.launches
    got = ops.fused_window(st.values, st.ts, st.total, key, rts, **kw)
    assert fused_window.launches - before == -(-S // 16)
    _assert_same(got, ref.fused_window_ref(st.values, st.ts, st.total,
                                           plain_key, rts, **kw))


@pytest.mark.parametrize("kernel", ["window_agg", "fused_window",
                                    "preagg_window", "last_join"])
@pytest.mark.parametrize("n_cols", [65, 130])
@pytest.mark.parametrize("point_in_time", [False, True])
def test_kernels_take_wide_column_sets(table, kernel, n_cols, point_in_time):
    """65 and 130 columns: ⌈V_out/64⌉ launches (times ⌈S/16⌉ for
    fused_window at 17 specs), each writing its columns in place; V=68
    with contiguous columns (aligned groups of four) and V=70 with
    scattered ones."""
    key, plain_key, rts = _edge_requests(table, 64, point_in_time)
    st, pa = table.state, table.preagg
    V = 68 if n_cols == 65 else 70
    wide = _wide_values(table, V, n_cols)
    cols = (tuple(range(n_cols)) if n_cols < V
            else tuple((7 * i) % V for i in range(n_cols)))
    ring = (wide, st.ts, st.total)
    al = not point_in_time
    if kernel == "window_agg":
        kw = dict(cols=cols, rows_preceding=40, assume_latest=al,
                  evt_mask=(wide[:, :, 0] > 0) if point_in_time else None)
        call = lambda k, fn: fn(*ring, k, rts, **kw)
        fns, n_launch = (ops.window_agg, ref.window_agg_ref), 1
    elif kernel == "fused_window":
        rows = tuple(None if i % 4 == 3 else 9 * i for i in range(17))
        kw = dict(cols=cols, assume_latest=al, spec_rows=rows,
                  spec_ranges=tuple(30.0 if r is None else None
                                    for r in rows),
                  spec_fields=tuple(FIELDS[i % 7:] for i in range(17)))
        call = lambda k, fn: fn(*ring, k, rts, **kw)
        fns, n_launch = (ops.fused_window, ref.fused_window_ref), 2
    elif kernel == "preagg_window":
        K, NB = pa.count.shape
        g = np.random.default_rng(n_cols)
        tiers = tuple(torch.from_numpy(g.normal(size=(K, NB, V)).astype(
            np.float32)).to(table.device) for _ in range(4)) + (pa.count,)
        kw = dict(cols=cols, bucket_size=table.bucket_size,
                  range_preceding=150.0, assume_latest=al)
        call = lambda k, fn: fn(*ring, *tiers, k, rts, **kw)
        fns, n_launch = (ops.preagg_window, ref.preagg_window_ref), 1
    else:
        kw = dict(col_idx=cols, assume_latest=al, with_ts=True)
        call = lambda k, fn: fn(*ring, k, rts, **kw)
        fns, n_launch = (ops.last_join, ref.last_join_ref), 1
    module = {"window_agg": window_agg, "fused_window": fused_window,
              "preagg_window": preagg_window, "last_join": last_join}[kernel]
    before = module.launches
    got = call(key, fns[0])
    assert module.launches - before == n_launch * len(
        _build.launch_slices(1, n_cols))
    _assert_same(got, call(plain_key, fns[1]))


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


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 128, 128, 4, 4, 64),      # MHA
    (1, 128, 128, 8, 2, 64),      # GQA 4x
    (2, 64, 128, 4, 1, 32),       # MQA, Sq < Sk
    (2, 37, 53, 6, 2, 80),        # ragged lengths
    (1, 200, 200, 12, 2, 128),    # qwen2-1.5b's heads
    (1, 33, 70, 4, 2, 96),
    (1, 512, 512, 12, 2, 128),    # the main path's prefill call, one prompt
    (2, 65, 65, 4, 2, 64),        # Sq one past a 64-row query tile
    (1, 127, 200, 4, 2, 16),      # Sq one short of two tiles, D 16
    (2, 127, 127, 6, 2, 80),
    (2, 100, 100, 6, 2, 64),      # three query heads of a KV group a block
])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (True, 8), (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(card, B, Sq, Sk, Hq, Hkv, D, causal, window,
                                dtype):
    q = _randn((B, Sq, Hq, D), dtype, card, 0)
    k = _randn((B, Sk, Hkv, D), dtype, card, 1)
    v = _randn((B, Sk, Hkv, D), dtype, card, 2)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 64, 128, 12, 2, 128),     # a rank's rows of the mesh's CP training
    (2, 32, 64, 12, 2, 128),      # ... and of its CP prefill
    (1, 100, 300, 4, 2, 64),      # ragged query and key tiles
    (2, 48, 200, 6, 2, 80),       # the mma.sync kernel
])
@pytest.mark.parametrize("where", ["zero", "mid", "right"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_a_query_offset(card, B, Sq, Sk, Hq, Hkv,
                                                  D, where, causal, window,
                                                  dtype):
    """A context-parallel rank's call: Sq query rows at ``q_offset`` (0,
    a point off every tile edge in between, ``Sk − Sq``) against all Sk
    keys, the kernel against the plain version at the same offset."""
    off = {"zero": 0, "mid": (Sk - Sq) // 2 + 3, "right": Sk - Sq}[where]
    q = _randn((B, Sq, Hq, D), dtype, card, 26)
    k = _randn((B, Sk, Hkv, D), dtype, card, 27)
    v = _randn((B, Sk, Hkv, D), dtype, card, 28)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=off)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=off)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if where == "right":       # the default offset is the right-aligned one
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal,
                                                    window=window))


def test_flash_attention_gradient_at_a_query_offset(card):
    """The autograd Function at a nonzero ``q_offset``: the kernel forward
    and the backward kernel's gradients (one launch), held to autograd of
    the plain version in f32 at that offset."""
    from repro_torch.kernels import flash_attention_bwd
    B, Sq, Sk, Hq, Hkv, D, off = 2, 64, 128, 12, 2, 128, 64
    q = _randn((B, Sq, Hq, D), torch.bfloat16, card, 29).requires_grad_()
    k = _randn((B, Sk, Hkv, D), torch.bfloat16, card, 30).requires_grad_()
    v = _randn((B, Sk, Hkv, D), torch.bfloat16, card, 31).requires_grad_()
    dout = _randn((B, Sq, Hq, D), torch.bfloat16, card, 32)
    out = ops.flash_attention(q, k, v, q_offset=off)
    n0 = flash_attention_bwd.launches
    grads, routes = _bwd_routes(
        lambda: torch.autograd.grad(out, (q, k, v), dout))
    assert flash_attention_bwd.launches == n0 + 1
    assert routes == {"wgmma": 1}
    ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = ref.flash_attention_ref(*ins, q_offset=off)
    wgrads = torch.autograd.grad(want, ins, dout.float())
    torch.cuda.synchronize()
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.detach(), rtol=tol,
                               atol=tol)
    for g, w in zip(grads, wgrads):
        torch.testing.assert_close(g.float(), w, rtol=tol, atol=tol)


# lengths at the edges of a split: one slot, a split less one, one split,
# one slot into the next, the whole cache and past it
SPLIT_EDGES = (1, SPLIT - 1, SPLIT, SPLIT + 1, 300, 309)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,lengths", [
    (4, 128, 4, 4, 64, None), (2, 256, 8, 2, 64, None),
    (3, 64, 4, 1, 32, None), (16, 1024, 12, 2, 128, None),
    (2, 100, 9, 3, 80, None),
    (6, 300, 12, 2, 128, SPLIT_EDGES),  # S not a multiple of the split
    (6, 300, 4, 1, 16, SPLIT_EDGES)])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_prefix(card, B, S, Hq, Hkv, D, lengths,
                                        window, dtype):
    """Random lengths (the first past the cache), or the given ones; a
    window of 48 spans a split boundary for lengths SPLIT + 1 and 300."""
    q = _randn((B, Hq, D), dtype, card, 3)
    kc = _randn((B, S, Hkv, D), dtype, card, 4)
    vc = _randn((B, S, Hkv, D), dtype, card, 5)
    if lengths is None:
        lengths = np.random.default_rng(2).integers(1, S + 1, B)
        lengths[0] = S + 9              # a length past the cache counts as S
    lengths = torch.tensor(lengths, dtype=torch.int32, device=card)
    got = ops.decode_attention(q, kc, vc, lengths, window=window)
    want = ref.decode_attention_ref(q, kc, vc, lengths, window=window)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,window", [(16, 8), (64, 64), (300, 100),
                                      (300, None), (300, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_ring(card, S, window, dtype):
    """Ring layout: positions before, at and far past the ring's size."""
    B, Hq, Hkv, D = 6, 8, 2, 64
    q = _randn((B, Hq, D), dtype, card, 6)
    kc = _randn((B, S, Hkv, D), dtype, card, 7)
    vc = _randn((B, S, Hkv, D), dtype, card, 8)
    pos = torch.tensor([0, S // 2, S - 1, S, 3 * S + 5, 10 * S + 1],
                       dtype=torch.int32, device=card)
    got = ops.decode_attention(q, kc, vc, pos, window=window, ring=True)
    want = ref.decode_attention_ref(q, kc, vc, pos, window=window, ring=True)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_attention_launch_counters(card):
    from repro_torch.kernels import decode_attention, flash_attention
    q = _randn((1, 16, 4, 64), torch.bfloat16, card, 9)
    k = _randn((1, 16, 2, 64), torch.bfloat16, card, 10)
    f0, d0 = flash_attention.launches, decode_attention.launches
    ops.flash_attention(q, k, k)
    ref.flash_attention_ref(q, k, k)
    lengths = torch.full((1,), 16, dtype=torch.int32, device=card)
    ops.decode_attention(q[:, 0].contiguous(), k, k, lengths)
    assert flash_attention.launches == f0 + 1
    assert decode_attention.launches == d0 + 1


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 64, 64, 4, 2, 64), (1, 128, 128, 12, 2, 128), (2, 37, 53, 6, 2, 80),
    (1, 512, 512, 12, 2, 128)])        # qwen2-1.5b's training shape
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradient(card, B, Sq, Sk, Hq, Hkv, D, causal,
                                  window, dtype):
    """Inputs that need a gradient go through the kernel inside its
    autograd Function: the forward is the kernel's (one launch), the
    gradients the backward kernel's (one launch), in the inputs' dtype,
    held to autograd of the plain version in f32."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    if not causal:
        window = None
    q = _randn((B, Sq, Hq, D), dtype, card, 20).requires_grad_()
    k = _randn((B, Sk, Hkv, D), dtype, card, 21).requires_grad_()
    v = _randn((B, Sk, Hkv, D), dtype, card, 22).requires_grad_()
    dout = _randn((B, Sq, Hq, D), dtype, card, 23)
    n0 = flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n0 + 1 and out.grad_fn is not None
    b0 = flash_attention_bwd.launches
    grads, routes = _bwd_routes(
        lambda: torch.autograd.grad(out, (q, k, v), dout))
    assert flash_attention_bwd.launches == b0 + 1
    assert routes == {_bwd_route(dtype, D): 1}
    assert flash_attention.launches == n0 + 1
    with torch.no_grad():
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
    ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
    wgrads = torch.autograd.grad(
        ref.flash_attention_ref(*ins, causal=causal, window=window),
        ins, dout.float())
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                               atol=tol)
    for g, w, t in zip(grads, wgrads, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        torch.testing.assert_close(g.float(), w, rtol=tol, atol=tol)


def _plain_f32_grads(q, k, v, dout, **kw):
    """Autograd of the plain version in f32: out, (dq, dk, dv)."""
    ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = ref.flash_attention_ref(*ins, **kw)
    return out.detach(), torch.autograd.grad(out, ins, dout.float())


def _kernel_grads(q, k, v, dout, **kw):
    """The Function's output and gradients on fresh leaves of q, k, v."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*ins, **kw)
    return out.detach(), torch.autograd.grad(out, ins, dout)


def _assert_grads(got, want, dtype, what):
    tol = ATTN_TOL[dtype]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype, (what, name)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{what} {name}: {m}")


def _bwd_route(dtype, D):
    """The backward route a call takes: the wgmma kernels for bf16 at head
    dims 64 and 128, mma.sync for bf16 at the others, FMA for f32."""
    return ("fma" if dtype == torch.float32 else
            "wgmma" if D in (64, 128) else "mma")


def _bwd_routes(fn):
    """``fn()`` and the backward launches it made, by route."""
    from repro_torch.kernels import flash_attention_bwd
    before = dict(flash_attention_bwd.route_launches)
    res = fn()
    return res, {r: n - before[r]
                 for r, n in flash_attention_bwd.route_launches.items()
                 if n != before[r]}


@pytest.mark.parametrize("D", [16, 32, 64, 80, 96, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_every_head_dim(card, D, causal,
                                                        window, dtype):
    """Every head dim the kernels are built for, ragged lengths (70 queries
    over 90 keys, neither a tile multiple) and GQA rep 3: the backward
    kernel against autograd of the plain version in f32, and against the
    plain backward (``ref.flash_attention_bwd_ref``) fed the kernel
    forward's output and log-sum-exp; the forward's log-sum-exp against
    the plain one."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    if not causal:
        window = None
    B, Sq, Sk, Hq, Hkv = 2, 70, 90, 6, 2
    q = _randn((B, Sq, Hq, D), dtype, card, 40)
    k = _randn((B, Sk, Hkv, D), dtype, card, 41)
    v = _randn((B, Sk, Hkv, D), dtype, card, 42)
    dout = _randn((B, Sq, Hq, D), dtype, card, 43)
    kw = dict(causal=causal, window=window)
    scale = D ** -0.5
    out, lse = torch.ops.repro_torch.flash_attention_fwd_lse(
        q, k, v, causal, window, scale, Sk - Sq)
    assert torch.equal(out, flash_attention.flash_attention_cuda(q, k, v,
                                                                 **kw))
    _, want_lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, want_lse, rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])
    got, routes = _bwd_routes(
        lambda: flash_attention_bwd.flash_attention_bwd_cuda(
            dout, q, k, v, out, lse, **kw))
    assert routes == {_bwd_route(dtype, D): 1}
    _assert_grads(got, ref.flash_attention_bwd_ref(dout, q, k, v, out, lse,
                                                   **kw),
                  dtype, f"D={D} vs the plain backward")
    _, want = _plain_f32_grads(q, k, v, dout, **kw)
    _assert_grads(got, want, dtype, f"D={D} vs autograd")
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 64, 128, 12, 2, 128),     # a rank's rows of the mesh's CP training
    (1, 100, 300, 4, 2, 64),      # ragged query and key tiles
    (2, 48, 200, 6, 2, 80),       # the mma.sync forward
    (1, 37, 150, 6, 3, 16)])
@pytest.mark.parametrize("where", ["zero", "mid", "right"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_at_a_query_offset(
        card, B, Sq, Sk, Hq, Hkv, D, where, causal, window, dtype):
    """A context-parallel rank's rows at ``q_offset`` 0, a point off every
    tile edge in between, and ``Sk − Sq``: the backward kernel's inverse
    band against autograd of the plain version in f32 at that offset."""
    off = {"zero": 0, "mid": (Sk - Sq) // 2 + 3, "right": Sk - Sq}[where]
    q = _randn((B, Sq, Hq, D), dtype, card, 44)
    k = _randn((B, Sk, Hkv, D), dtype, card, 45)
    v = _randn((B, Sk, Hkv, D), dtype, card, 46)
    dout = _randn((B, Sq, Hq, D), dtype, card, 47)
    kw = dict(causal=causal, window=window, q_offset=off)
    (_, got), routes = _bwd_routes(lambda: _kernel_grads(q, k, v, dout,
                                                         **kw))
    assert routes == {_bwd_route(dtype, D): 1}
    _, want = _plain_f32_grads(q, k, v, dout, **kw)
    _assert_grads(got, want, dtype, f"q_offset {off}")
    torch.cuda.synchronize()


@pytest.mark.parametrize("D", [16, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_rows_without_keys(card, D, dtype):
    """Query rows that keep no key: causal rows before every key
    (``q_offset`` −10, whole query tiles of them and a tile that mixes
    them with rows that keep keys) and, non-causal, rows whose window
    starts past the last key. The forward writes 0 and the −1e30
    log-sum-exp there; their dq is exactly 0 and they add nothing to dk
    and dv: the gradients equal autograd of the plain version in f32 over
    the rows that keep keys alone."""
    B, Hq, Hkv = 2, 4, 2
    for Sq, Sk, kw, n_empty in (
            (100, 64, dict(causal=True, q_offset=-70), 70),
            (40, 64, dict(causal=True, window=16, q_offset=-10), 10),
            (40, 64, dict(causal=False, window=8, q_offset=60), 29)):
        q = _randn((B, Sq, Hq, D), dtype, card, 48)
        k = _randn((B, Sk, Hkv, D), dtype, card, 49)
        v = _randn((B, Sk, Hkv, D), dtype, card, 50)
        dout = _randn((B, Sq, Hq, D), dtype, card, 51)
        mask = ref._attention_mask(Sq, Sk, kw["causal"], kw.get("window"),
                                   kw["q_offset"], card)
        empty = ~mask.any(-1)
        assert int(empty.sum()) == n_empty
        out, lse = torch.ops.repro_torch.flash_attention_fwd_lse(
            q, k, v, kw["causal"], kw.get("window"), D ** -0.5,
            kw["q_offset"])
        assert not bool(out[:, empty].any())
        assert bool((lse[:, :, empty] == ref.ATTN_NEG_INF).all())
        (out, (dq, dk, dv)), routes = _bwd_routes(
            lambda: _kernel_grads(q, k, v, dout, **kw))
        assert routes == {_bwd_route(dtype, D): 1}
        assert not bool(dq[:, empty].any())
        rows = (~empty).nonzero()[:, 0]
        r0, r1 = int(rows[0]), int(rows[-1]) + 1
        assert r1 - r0 == len(rows)            # the kept rows are one run
        sub = [t[:, r0:r1].contiguous() for t in (q, dout)]
        kw_r = dict(kw, q_offset=kw["q_offset"] + r0)
        _, want = _plain_f32_grads(sub[0], k, v, sub[1], **kw_r)
        _assert_grads((dq[:, r0:r1], dk, dv), want, dtype,
                      f"{(Sq, Sk)} {kw}")
    torch.cuda.synchronize()


def test_flash_attention_backward_calls_no_plain_version(card, monkeypatch):
    """On the card the Function's backward is the kernel: with the plain
    attention versions and the plain backward made to raise, a training
    call (forward and backward, f32 and bf16) still runs, and the
    library's attention is never called."""
    import torch.nn.functional as F

    def boom(*a, **kw):
        raise AssertionError("the card's backward reached a plain version")

    for name in ("flash_attention_ref", "flash_attention_stream",
                 "flash_attention_lse_ref", "flash_attention_bwd_ref"):
        monkeypatch.setattr(ref, name, boom)
    monkeypatch.setattr(F, "scaled_dot_product_attention", boom)
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((2, 64, 12, 128), dtype, card, 52)
        k = _randn((2, 64, 2, 128), dtype, card, 53)
        dout = _randn((2, 64, 12, 128), dtype, card, 54)
        (_, grads), routes = _bwd_routes(lambda: _kernel_grads(q, k, k,
                                                               dout))
        assert routes == {_bwd_route(dtype, 128): 1}
        assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(card, dtype):
    """No atomics: two backward passes of the same inputs give bit-equal
    gradients (qwen2-1.5b's training heads, 12 over 2 of 128, causal)."""
    q = _randn((2, 256, 12, 128), dtype, card, 55)
    k = _randn((2, 256, 2, 128), dtype, card, 56)
    v = _randn((2, 256, 2, 128), dtype, card, 57)
    dout = _randn((2, 256, 12, 128), dtype, card, 58)
    (_, first), routes = _bwd_routes(lambda: _kernel_grads(q, k, v, dout))
    _, second = _kernel_grads(q, k, v, dout)
    torch.cuda.synchronize()
    assert routes == {_bwd_route(dtype, 128): 1}
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (B, Sq, Sk, flash options): a ragged causal length (no tile multiple),
# the non-causal 512 x 1024 of an encoder-decoder's cross call, a window
# of 37, a context-parallel rank's rows at q_offset -13 (rows before every
# key) and mid-sequence
WGMMA_CASES = {"ragged": (2, 200, 200, {}),
               "cross": (1, 512, 1024, {"causal": False}),
               "window": (1, 190, 190, {"window": 37}),
               "offset_neg": (2, 130, 150, {"q_offset": -13}),
               "offset_mid": (1, 100, 300, {"q_offset": 103})}


@pytest.mark.parametrize("case", list(WGMMA_CASES))
@pytest.mark.parametrize("rep", [1, 3, 6, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_backward_wgmma_route(card, case, rep, D):
    """The wgmma route at head dims 64 and 128 and GQA rep 1, 3, 6 and 8
    (two KV heads; the plan's split parts and warpgroups with them): the
    gradients against autograd of the plain version in f32 at 2e-2, the
    route counted, and a rerun bit-equal. Rows that keep no key (the
    first 13 at ``q_offset`` −13) get dq 0, and the rest are held to the
    plain version over those rows alone (which averages V over no key
    at the others)."""
    B, Sq, Sk, kw = WGMMA_CASES[case]
    Hkv = 2
    Hq = rep * Hkv
    dtype = torch.bfloat16
    q = _randn((B, Sq, Hq, D), dtype, card, 60 + rep)
    k = _randn((B, Sk, Hkv, D), dtype, card, 61 + rep)
    v = _randn((B, Sk, Hkv, D), dtype, card, 62 + rep)
    dout = _randn((B, Sq, Hq, D), dtype, card, 63 + rep)
    (_, got), routes = _bwd_routes(lambda: _kernel_grads(q, k, v, dout,
                                                         **kw))
    assert routes == {"wgmma": 1}
    off = kw.get("q_offset", Sk - Sq)
    mask = ref._attention_mask(Sq, Sk, kw.get("causal", True),
                               kw.get("window"), off, card)
    rows = mask.any(-1).nonzero()[:, 0]
    r0, r1 = int(rows[0]), int(rows[-1]) + 1
    assert r1 - r0 == len(rows) and r1 == Sq
    assert r0 == (13 if case == "offset_neg" else 0)
    assert not bool(got[0][:, :r0].any())
    _, want = _plain_f32_grads(q[:, r0:].contiguous(), k, v,
                               dout[:, r0:].contiguous(),
                               **dict(kw, q_offset=off + r0))
    _assert_grads((got[0][:, r0:], got[1], got[2]), want, dtype,
                  f"rep {rep} D {D} {case}")
    _, again = _kernel_grads(q, k, v, dout, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_flash_attention_cuda_refuses_inputs_that_need_a_gradient(card):
    from repro_torch.kernels import flash_attention
    q = _randn((1, 16, 4, 64), torch.float32, card, 24).requires_grad_()
    k = _randn((1, 16, 2, 64), torch.float32, card, 25)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention.flash_attention_cuda(q, k, k)
    with torch.no_grad():                 # no gradient asked: it runs
        flash_attention.flash_attention_cuda(q, k, k)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_train_step_on_the_card_equals_the_cpu(card, remat):
    """One train step of a reduced qwen2-1.5b (f32) on the card and on
    the CPU from the same parameters: loss ``rtol 1e-4``, the new
    parameters within ``1e-2·lr``, and within ``2·lr`` where the gradient
    is within ``100·eps`` of 0 (the first Adam step is
    ``lr·g/(|g|+eps)``), through the flash kernel's Function."""
    import dataclasses
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.tree import tree_flatten_with_path, tree_map
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              remat=remat)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                                    dtype=torch.int32),
             "targets": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                                     dtype=torch.int32)}
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    step = steps.make_train_step(cfg, ocfg)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), params)
        n0 = flash_attention.launches
        p2, s2, m = step(p, adamw.adamw_init(p, ocfg),
                         {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(m["loss"]),
                    [a.cpu() for _, a in tree_flatten_with_path(p2)],
                    [a.cpu() for _, a in tree_flatten_with_path(s2.m)],
                    flash_attention.launches - n0)
    assert out["cpu"][3] == 0 and out["cuda"][3] >= cfg.n_layers
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for a, b, m in zip(out["cuda"][1], out["cpu"][1], out["cpu"][2]):
        # a gradient within 100·eps of 0 moves its element by up to lr
        # either way; the others agree to 1e-2·lr
        near = m.abs() / (1.0 - ocfg.b1) < 100 * ocfg.eps
        torch.testing.assert_close(a[~near], b[~near], rtol=0,
                                   atol=1e-2 * ocfg.lr)
        assert bool(((a - b).abs()[near] <= 2 * ocfg.lr).all())


# ---------------------------------------------------------------------------
# Mamba-2, MoE and hybrid blocks: card against CPU
# ---------------------------------------------------------------------------

def _family(arch, **changes):
    import dataclasses
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    return cfg, lm.init_lm(torch.Generator().manual_seed(0), cfg)


def _on(tree, dev):
    from repro_torch.models.tree import tree_map
    return tree_map(lambda a: a.to(dev), tree)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_ssd_prefill_and_decode_card_equals_cpu(card, arch):
    """A prefill of 21 tokens (two chunks of 8 and a padded tail), then 6
    decode steps, f32: logits and the {conv, ssm} caches within 1e-4, the
    same greedy tokens."""
    from repro_torch.models import lm
    from repro_torch.models.tree import tree_leaves
    cfg, params = _family(arch)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 27)), dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _on(params, dev)
        logits, caches = lm.prefill(p, cfg, toks[:, :21].to(dev), 32)
        steps = [logits.cpu()]
        for i in range(21, 27):
            logits, caches = lm.decode_step(
                p, cfg, caches, toks[:, i].to(dev),
                torch.full((3,), i, dtype=torch.int32, device=dev))
            steps.append(logits.cpu())
        out[dev] = (torch.stack(steps), [c.cpu() for c in tree_leaves(caches)])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out["cuda"][0].argmax(-1), out["cpu"][0].argmax(-1))
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4])
def test_moe_card_equals_cpu_and_repeats_bit_for_bit(card, groups, dtype):
    """``apply_moe`` of reduced granite (4 experts, top-2, capacity factor
    0.5 so assignments drop): the chosen experts and the dropped share
    exactly the CPU's, f32 outputs within 1e-5; two runs on the card give
    the same bits (the combine gathers, it adds with no atomics)."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.models.tree import tree_map
    cfg, _ = _family("granite-moe-3b-a800m", moe_groups=groups)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (4, 32, cfg.d_model)), dtype=torch.float32)
    p = tree_map(lambda a: a.to(dtype), p)
    x = x.to(dtype)
    ys, ms, routes = {}, {}, {}
    for dev in ("cpu", "cuda"):
        pd = _on(p, dev)
        ys[dev], ms[dev] = moe.apply_moe(pd, x.to(dev), cfg)
        routes[dev] = moe.route(pd["router"], x.reshape(-1, cfg.d_model)
                                .to(dev), cfg.moe.top_k)[3].cpu()
    again, _ = moe.apply_moe(_on(p, "cuda"), x.to("cuda"), cfg)
    assert torch.equal(again, ys["cuda"])
    assert torch.equal(routes["cuda"], routes["cpu"])
    drop = float(ms["cpu"]["moe_drop_frac"])
    assert float(ms["cuda"]["moe_drop_frac"]) == drop > 0
    if dtype == torch.float32:
        torch.testing.assert_close(ys["cuda"].cpu(), ys["cpu"], rtol=1e-5,
                                   atol=1e-5)
        for k in ("moe_aux", "moe_zloss"):
            torch.testing.assert_close(ms["cuda"][k].cpu(), ms["cpu"][k],
                                       rtol=1e-5, atol=1e-5)
    else:
        a, b = ys["cuda"].cpu().double(), ys["cpu"].double()
        assert float((a - b).norm() / b.norm()) < 2e-2


def test_mixtral_ring_decode_past_the_window_card_equals_cpu(card):
    """Reduced mixtral (window 16) through ModelServer with cache_len 24:
    the 16-slot ring, admissions at two times and an idle slot, decoding
    to position 40; the same greedy tokens on the card as on the CPU, f32
    logits within 1e-4, and the decode kernel launched."""
    from repro_torch.kernels import decode_attention
    from repro_torch.serving.server import ModelServer
    cfg, params = _family("mixtral-8x22b")
    rng = np.random.default_rng(4)
    p1 = rng.integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        srv = ModelServer(cfg, _on(params, dev), batch=4, cache_len=24)
        assert tuple(srv.caches[0]["k"].shape[2:3]) == (16,)
        n0 = decode_attention.launches
        srv.prefill(p1)
        srv.decode(6)
        srv.prefill(p2)
        srv.decode(20)
        out[dev] = (srv.generated, srv.logits.cpu(),
                    decode_attention.launches - n0)
    assert out["cuda"][0] == out["cpu"][0]
    assert max(len(g) for g in out["cuda"][0]) == 27     # to position 40
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-4)
    assert out["cpu"][2] == 0 and out["cuda"][2] == 26 * cfg.n_layers


def test_jamba_train_step_with_remat_dots_card_equals_cpu(card):
    """One train step of a reduced jamba (one period: Mamba-2, MoE and
    attention blocks; remat ``dots``, its config's) on the card and on the
    CPU from the same parameters: loss and MoE losses ``rtol 1e-4``, the
    new parameters within the first Adam step's bounds, as the dense
    model's train-step test holds them."""
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import steps
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw
    cfg, params = _family("jamba-v0.1-52b")
    assert cfg.remat == "dots"
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                                    dtype=torch.int32),
             "targets": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                                     dtype=torch.int32)}
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    step = steps.make_train_step(cfg, ocfg)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _on(params, dev)
        n0 = flash_attention.launches
        p2, s2, m = step(p, adamw.adamw_init(p, ocfg),
                         {k: v.to(dev) for k, v in batch.items()})
        out[dev] = ({k: float(m[k]) for k in ("loss", "moe_aux",
                                              "moe_zloss")},
                    [a.cpu() for _, a in tree_flatten_with_path(p2)],
                    [a.cpu() for _, a in tree_flatten_with_path(s2.m)],
                    flash_attention.launches - n0)
    assert out["cpu"][3] == 0 and out["cuda"][3] >= 1
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out["cuda"][0][k], v, rtol=1e-4,
                                   err_msg=k)
    for a, b, m in zip(out["cuda"][1], out["cpu"][1], out["cpu"][2]):
        near = m.abs() / (1.0 - ocfg.b1) < 100 * ocfg.eps
        torch.testing.assert_close(a[~near], b[~near], rtol=0,
                                   atol=1e-2 * ocfg.lr)
        assert bool(((a - b).abs()[near] <= 2 * ocfg.lr).all())


# ---------------------------------------------------------------------------
# the encoder-decoder's attention shapes and model, and the compressed step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 200, 37, 16, 16, 64),     # cross-attention, decoder longer
    (2, 64, 1024, 16, 16, 64),    # seamless: 64 tokens over 1024 frames
    (1, 1024, 1024, 16, 16, 64)])  # its encoder's self-attention
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_noncausal_cross_shapes(card, B, Sq, Sk, Hq,
                                                       Hkv, D, dtype):
    """Non-causal flash attention with Sq != Sk (the query longer than the
    keys too), as cross-attention runs it."""
    q = _randn((B, Sq, Hq, D), dtype, card, 13)
    k = _randn((B, Sk, Hkv, D), dtype, card, 14)
    v = _randn((B, Sk, Hkv, D), dtype, card, 15)
    got = ops.flash_attention(q, k, v, causal=False, window=None)
    want = ref.flash_attention_ref(q, k, v, causal=False, window=None)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_over_the_whole_encoder(card, dtype):
    """One decoder token per slot over 1024 encoder frames, 16/16 heads of
    64, every length the encoder's: the cross-attention decode call, on
    K/V that are views of a linear layer's output."""
    from repro_torch.models.layers import apply_linear
    B, Se, H, D = 8, 1024, 16, 64
    enc = _randn((B, Se, H * D), dtype, card, 16)
    w = {"w": _randn((H * D, H * D), dtype, card, 17) * 0.03,
         "b": _randn((H * D,), dtype, card, 18)}
    kc = apply_linear(w, enc).view(B, Se, H, D)
    vc = apply_linear(w, enc * 0.5).view(B, Se, H, D)
    q = _randn((B, H, D), dtype, card, 19)
    lengths = torch.full((B,), Se, dtype=torch.int32, device=card)
    got = ops.decode_attention(q, kc, vc, lengths, window=None)
    want = ref.decode_attention_ref(q, kc, vc, lengths, window=None)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_encdec_card_equals_cpu(card):
    """Reduced seamless-m4t-medium (2 + 2 layers, d 64, 8 frames, f32):
    a prefill of 5 tokens and 6 decode steps, logits within 1e-4 and the
    same greedy tokens; the loss within rtol 1e-4 and every gradient
    within 1e-4 relative L2 (the cross-attention's K bias, zero in exact
    arithmetic, within 1e-6 absolute)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.models.tree import tree_flatten_with_path
    cfg = reduced(get_config("seamless-m4t-medium"))
    params = steps.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(3)
    frames = torch.tensor(rng.standard_normal((2, 8, cfg.d_model)),
                          dtype=torch.float32)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 11)),
                        dtype=torch.int32)
    batch = {"enc_embeds": frames, "tokens": toks[:, :10],
             "targets": toks[:, 1:]}
    out = {}
    for dev in ("cpu", "cuda"):
        p = _on(params, dev)
        f0, d0 = flash_attention.launches, decode_attention.launches
        logits, caches = steps.make_prefill_step(cfg, 16)(
            p, frames.to(dev), toks[:, :5].to(dev))
        enc = encdec.encode(p, cfg, frames.to(dev))
        got = [logits.cpu()]
        for i in range(5, 11):
            logits, caches = steps.make_serve_step(cfg)(
                p, caches, toks[:, i].to(dev),
                torch.full((2,), i, dtype=torch.int32, device=dev), enc)
            got.append(logits.cpu())
        loss, _, grads = steps._value_and_grad(
            p, cfg, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (torch.stack(got), float(loss),
                    [(path, g.cpu()) for path, g in
                     tree_flatten_with_path(grads)],
                    (flash_attention.launches - f0,
                     decode_attention.launches - d0))
    assert out["cpu"][3] == (0, 0)
    # flash: the prefill step (2 encoder + 2 self + 2 cross), the encoder
    # for the serve steps (2), the training forward (2 + 2 + 2); decode:
    # 6 steps x (2 self + 2 cross)
    assert out["cuda"][3] == (14, 24)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out["cuda"][0].argmax(-1), out["cpu"][0].argmax(-1))
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    for (path, a), (_, b) in zip(out["cuda"][2], out["cpu"][2]):
        if path[1:] == ("cross_attn", "wk", "b"):
            assert float(a.abs().max()) < 1e-6
            assert float(b.abs().max()) < 1e-6
            continue
        rel = float((a.double() - b.double()).norm()
                    / b.double().norm().clamp_min(1e-30))
        assert rel < 1e-4, (path, rel)


def test_compressed_step_on_a_one_rank_nccl_group(card, tmp_path):
    """A one-rank NCCL group (FileStore) and a (1, 1, 1) CUDA mesh over
    ("pod", "data", "model"): ``crosspod_grad_mean(compress=True)`` is the
    int8 round trip, within half a quantization step of each gradient and
    not the identity; the compressed step's parameters equal AdamW applied
    to that round trip, bit for bit, and the uncompressed step on the mesh
    equals the meshless plain step bit for bit."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw
    cfg = reduced(get_config("qwen1.5-0.5b"))
    params = _on(steps.init_params(torch.Generator().manual_seed(1), cfg),
                 "cuda")
    rng = np.random.default_rng(4)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32, device=card)
             for k in ("tokens", "targets")}
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=120))
    try:
        mesh = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
        _, _, g = steps._value_and_grad(params, cfg, batch)
        gc = collectives.crosspod_grad_mean(g, mesh, compress=True)
        moved = 0
        for (_, a), (_, b) in zip(tree_flatten_with_path(gc),
                                  tree_flatten_with_path(g)):
            half = float(b.abs().max()) / 127.0 * 0.5
            assert float((a - b).abs().max()) <= half * (1 + 1e-6)
            moved += int((a != b).sum())
        assert moved > 0
        step = steps.make_train_step(cfg, ocfg, mesh=mesh,
                                     compress_crosspod=True)
        p2, _, m = step(params, adamw.adamw_init(params, ocfg), batch)
        want, _, _ = adamw.adamw_update(gc, adamw.adamw_init(params, ocfg),
                                        params, ocfg)
        assert np.isfinite(float(m["loss"])) and float(m["skipped"]) == 0
        for (_, a), (_, b) in zip(tree_flatten_with_path(p2),
                                  tree_flatten_with_path(want)):
            assert torch.equal(a, b)
        # uncompressed: the f32 mean over one rank, the plain step
        p3 = steps.make_train_step(cfg, ocfg, mesh=mesh)(
            params, adamw.adamw_init(params, ocfg), batch)[0]
        p4 = steps.make_train_step(cfg, ocfg)(
            params, adamw.adamw_init(params, ocfg), batch)[0]
        for (_, a), (_, b) in zip(tree_flatten_with_path(p3),
                                  tree_flatten_with_path(p4)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_attention_wrappers_reject_bad_inputs(card):
    q = _randn((1, 16, 4, 64), torch.bfloat16, card, 11)
    k = _randn((1, 16, 2, 64), torch.bfloat16, card, 12)
    lengths = torch.full((1,), 16, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="takes"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="k must be"):
        ops.flash_attention(q, k.float(), k)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            k[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, k)
    with pytest.raises(TypeError, match="lengths must be torch.int32"):
        ops.decode_attention(q[:, 0].contiguous(), k, k, lengths.long())
    with pytest.raises(ValueError, match="is on cpu"):
        ops.decode_attention(q[:, 0].contiguous(), k, k, lengths.cpu())


# ---------------------------------------------------------------------------
# the live-serving path on the card: streamed ingest, hot swap, execution
# modes, retention, and the kernels under several host threads
# ---------------------------------------------------------------------------

LIVE_SQL = """
SELECT SUM(a) OVER w1 AS s1, MAX(b) OVER w1 AS mx1, LAST(c) OVER w1 AS l1,
       COUNT(a) OVER w2 AS c2, AVG(b) OVER w2 AS a2, STD(a) OVER w1 AS sd1
FROM events
WINDOW w1 AS (PARTITION BY k ORDER BY ts
              ROWS BETWEEN 10 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY k ORDER BY ts
              ROWS BETWEEN 40 PRECEDING AND CURRENT ROW)
"""
LIVE_EXACT = ("mx1", "l1", "c2")


@pytest.fixture(scope="module")
def live_source():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.streaming import StreamSource
    src = StreamSource.from_config(EventStreamConfig(
        n_events=3000, n_keys=48, n_features=3, seed=12))
    return src.with_disorder(jitter=0.5, seed=2)


def _live_engine(device, src, flags=None):
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    from repro_torch.streaming import PipelineConfig
    eng = Engine(flags or OptFlags(), device=device)
    eng.create_table(TableSchema("events", "k", "ts", ("a", "b", "c")),
                     max_keys=64, capacity=64, bucket_size=8)
    pipe = eng.attach_stream("events", PipelineConfig(
        lateness=0.5, flush_interval_s=0.001, max_flush_batch=512))
    src.replay(pipe, batch_size=128)
    pipe.flush()
    assert pipe.last_error is None
    eng.deploy("f", LIVE_SQL)
    return eng


def _live_requests(src, B=40, seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 52, B)                  # 48..51 unknown
    ts = float(src.ts.max()) + 1.0 + np.arange(B, dtype=np.float32)
    return keys.tolist(), ts.tolist()


def _assert_frames(got, want, std_atol):
    np.testing.assert_array_equal(got.status, want.status)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if c in LIVE_EXACT:
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4,
                                       atol=std_atol if "sd" in c else 1e-4,
                                       err_msg=c)


def test_streamed_load_card_equals_cpu(live_source):
    engines = {d: _live_engine(d, live_source) for d in ("cuda", "cpu")}
    std_atol = 4e-4 * float(np.abs(live_source.rows[:, 0]).max())
    a, b = (engines[d].tables["events"] for d in ("cuda", "cpu"))
    assert sorted(a.key_to_idx) == sorted(b.key_to_idx)
    # the flushes may differ in batching, so dense indices may differ
    ia = torch.tensor([a.key_to_idx[k] for k in sorted(a.key_to_idx)])
    ib = torch.tensor([b.key_to_idx[k] for k in sorted(b.key_to_idx)])
    for f in ("values", "ts", "total"):
        assert torch.equal(getattr(a.state, f).cpu()[ia],
                           getattr(b.state, f)[ib]), f
    keys, ts = _live_requests(live_source)
    got, want = (engines[d].request("f", keys, ts) for d in ("cuda", "cpu"))
    assert got.n_unknown > 0
    _assert_frames(got, want, std_atol)
    got, want = (engines[d].query_offline("f", batch_size=500)
                 for d in ("cuda", "cpu"))
    order = []
    for res, t in ((got, a), (want, b)):
        rev = {i: k for k, i in t.key_to_idx.items()}
        orig = np.asarray([rev[int(i)] for i in res["__key"]])
        order.append(np.lexsort((res["__ts"], orig)))
    _assert_frames(_as_frame(got, order[0]), _as_frame(want, order[1]),
                   std_atol)
    for e in engines.values():
        e.close()


def _as_frame(d, order):
    """An offline result as a frame, rows in ``order``."""
    from repro_torch.core.results import FeatureFrame
    return FeatureFrame({k: v[order] for k, v in d.items()
                         if k == "__ts" or not k.startswith("__")},
                        status=np.zeros(len(order), np.int8))


def test_execution_modes_on_the_card_equal_batched(live_source):
    from repro_torch.core.optimizer import OptFlags
    std_atol = 4e-4 * float(np.abs(live_source.rows[:, 0]).max())
    keys, ts = _live_requests(live_source, B=37)
    base = _live_engine("cuda", live_source)
    want = base.request("f", keys, ts)
    base.close()
    for flags in (OptFlags(parallel_workers=4), OptFlags(vectorized=False)):
        eng = _live_engine("cuda", live_source, flags)
        _assert_frames(eng.request("f", keys, ts), want, std_atol)
        eng.close()


def test_hot_swap_under_a_request_thread_mixes_no_versions(live_source):
    import threading
    eng = _live_engine("cuda", live_source)
    keys, ts = _live_requests(live_source, B=16)
    v1 = eng.request("f", keys, ts)
    short = LIVE_SQL.replace("10 PRECEDING", "3 PRECEDING")
    frames, errs = [], []
    stop, running, got_v2 = (threading.Event(), threading.Event(),
                             threading.Event())

    def serve():
        while not stop.is_set():
            try:
                fr = eng.request("f", keys, ts)
            except Exception as e:                 # pragma: no cover
                errs.append(e)
                return
            frames.append(fr)
            running.set()
            if fr.version == 2:
                got_v2.set()

    th = threading.Thread(target=serve)
    th.start()
    assert running.wait(60.0)
    misses = eng.cache.stats.misses
    eng.deploy("f", short)
    assert got_v2.wait(60.0)
    stop.set()
    th.join(60.0)
    assert not th.is_alive() and not errs
    # the redeploy built one executor; serving v2 added no miss
    assert eng.cache.stats.misses == misses + 1
    v2 = eng.request("f", keys, ts)
    for fr in frames:
        want = v1 if fr.version == 1 else v2
        assert fr.version in (1, 2)
        for c in ("s1", "mx1", "l1"):
            np.testing.assert_array_equal(fr[c], want[c], err_msg=c)
    eng.close()


def test_chunked_preagg_and_device_compaction_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.featurestore import preagg
    from repro_torch.streaming import compact_expired
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=20000, n_keys=300, n_features=3, seed=4))
    tabs = {}
    for d in ("cuda", "cpu"):
        tabs[d] = Table(TableSchema("events", "k", "ts", ("a", "b", "c")),
                        max_keys=320, capacity=64, bucket_size=8, device=d)
        tabs[d].insert(keys.tolist(), ts.tolist(), rows)
    chunk = 7 * 64 * 3                             # 7 keys a chunk: 46 chunks
    g = preagg.rebuild_preagg(tabs["cuda"].state, bucket_size=8,
                              chunk_elems=chunk)
    w = preagg.rebuild_preagg(tabs["cpu"].state, bucket_size=8)
    for f in ("min", "max", "count"):
        assert torch.equal(getattr(g, f).cpu(), getattr(w, f)), f
    for f in ("sum", "sumsq"):
        torch.testing.assert_close(getattr(g, f).cpu(), getattr(w, f),
                                   rtol=2e-4, atol=2e-4)
    ok, err = preagg.verify_preagg(tabs["cuda"].state, tabs["cuda"].preagg,
                                   bucket_size=8, chunk_elems=chunk)
    assert ok, err
    cutoff = float(np.quantile(ts, 0.9))
    gs, gp, gd = compact_expired(tabs["cuda"].state, cutoff=cutoff,
                                 bucket_size=8, chunk_elems=chunk)
    ws, wp, wd = compact_expired(tabs["cpu"].state, cutoff=cutoff,
                                 bucket_size=8)
    assert gd == wd > 0
    for f in ("values", "ts", "total"):
        assert torch.equal(getattr(gs, f).cpu(), getattr(ws, f)), f
    for f in ("min", "max", "count"):
        assert torch.equal(getattr(gp, f).cpu(), getattr(wp, f)), f
    ok, err = preagg.verify_preagg(gs, gp, bucket_size=8)
    assert ok, err


def test_concurrent_first_launches_build_once_and_count_all(table,
                                                            monkeypatch):
    import threading
    digests = []
    real_digest = _build._digest

    def counting_digest(files):
        digests.append(1)
        return real_digest(files)

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_digest", counting_digest)
    _build.function.cache_clear()      # the launch functions look it up
    key, rts = _requests(table, 64, False)
    st = table.state
    before = window_agg.launches
    barrier = threading.Barrier(4)
    outs, errs = [], []

    def launch():
        barrier.wait(60.0)
        try:
            for _ in range(50):
                outs.append(ops.window_agg(st.values, st.ts, st.total, key,
                                           rts, rows_preceding=5))
        except Exception as e:                     # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    torch.cuda.synchronize()
    assert not errs and len(outs) == 200
    assert len(digests) == 1                       # one build-and-load
    assert window_agg.launches == before + 200
    want = ref.window_agg_ref(st.values, st.ts, st.total, key, rts,
                              rows_preceding=5)
    for out in outs[::17]:
        _assert_same(out, want)


# ---------------------------------------------------------------------------
# the sharded runtime on the card
# ---------------------------------------------------------------------------

SHARD_WINDOWS = """
WINDOW w1 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 10 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 40 PRECEDING AND CURRENT ROW)
"""
SHARD_SQL = {
    # preagg_window x2 and last_join against a replicated table
    "joined": """
SELECT SUM(amount) OVER w1 AS s1, STD(amount) OVER w1 AS sd1,
       COUNT(amount) OVER w2 AS c2, MAX(amount) OVER w2 AS mx2,
       merchants.risk AS risk, merchants.volume AS vol
FROM events
LAST JOIN merchants ORDER BY mts ON merchant
""" + SHARD_WINDOWS,
    # window_agg (a LAST over w1) and preagg_window
    "windows": """
SELECT SUM(amount) OVER w1 AS s1, MAX(amount) OVER w1 AS mx1,
       LAST(amount) OVER w1 AS l1, AVG(lat) OVER w2 AS a2,
       MIN(amount) OVER w2 AS mn2
FROM events
""" + SHARD_WINDOWS,
    # LASTs over both windows: one fused_window launch
    "fused": """
SELECT SUM(amount) OVER w1 AS s1, LAST(amount) OVER w1 AS l1,
       AVG(lat) OVER w2 AS a2, LAST(lat) OVER w2 AS l2
FROM events
""" + SHARD_WINDOWS,
}
SHARD_KERNELS = {"joined": (preagg_window, last_join),
                 "windows": (window_agg, preagg_window),
                 "fused": (fused_window,)}


def _shard_data():
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=8000, n_keys=60, n_features=4, seed=21))
    rows[:, 3] = np.floor(np.abs(rows[:, 3])) % 6          # merchant ids
    return keys, ts, rows


def _fill(eng, keys, ts, rows, replicate=None):
    kw = {} if replicate is None else {"replicate": replicate}
    eng.create_table(TableSchema("events", "user", "ts",
                                 ("amount", "lat", "lon", "merchant")),
                     max_keys=64, capacity=64, bucket_size=8)
    eng.create_table(TableSchema("merchants", "merchant", "mts",
                                 ("risk", "volume")),
                     max_keys=8, capacity=16, bucket_size=4, **kw)
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    rng = np.random.default_rng(3)
    for t0 in (float(ts[0]), float(ts[len(ts) // 2])):
        eng.insert("merchants", list(range(6)), [t0] * 6,
                   rng.uniform(0, 1, (6, 2)).astype(np.float32))


@pytest.mark.parametrize("shape", sorted(SHARD_SQL))
def test_sharded_card_engine_equals_unsharded(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    from repro_torch.shard import ShardConfig, ShardedEngine
    keys, ts, rows = _shard_data()
    ref = Engine(OptFlags(), device="cuda")
    se = ShardedEngine(ShardConfig(n_shards=3), device="cuda")
    _fill(ref, keys, ts, rows)
    _fill(se, keys, ts, rows, replicate=True)
    assert int(ref.tables["events"].state.total.max()) > 64
    ref.deploy("f", SHARD_SQL[shape])
    se.deploy("f", SHARD_SQL[shape])
    rng = np.random.default_rng(5)
    for B in (1, 37, 500):
        idx = rng.integers(0, len(keys), B)
        rk = keys[idx].tolist()
        rk[0] = 10_000                                   # an unknown key
        rts = [float(ts.max()) + 1.0] * B
        for m in SHARD_KERNELS[shape]:
            m.launches = 0
        got = se.request("f", rk, rts, rows=rows[idx])
        assert all(m.launches > 0 for m in SHARD_KERNELS[shape])
        want = ref.request("f", rk, rts, rows=rows[idx])
        np.testing.assert_array_equal(got.status, want.status)
        for c in want:                                   # bit for bit
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    got, want = se.query_offline("f"), ref.query_offline("f")
    inv = {i: k for k, i in ref.tables["events"].key_to_idx.items()}
    ka = np.asarray([inv[int(i)] for i in want["__key"]])
    ia, ib = np.lexsort((want["__ts"], ka)), np.lexsort((got["__ts"],
                                                        got["__key"]))
    np.testing.assert_array_equal(ka[ia], got["__key"][ib])
    for c in ref.handle("f").phys.feature_names:
        np.testing.assert_array_equal(got[c][ib], want[c][ia], err_msg=c)
    assert len(got["__version_vector"]) == 3
    se.close()
    ref.close()


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_process_engine_on_the_card_equals_in_process():
    """Two worker processes, each with its own CUDA context on the card,
    serve every shape bit for bit like the in-process card engine; each
    worker's kernels launch in that worker; close() leaves no worker."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.shard import ShardConfig, ShardedEngine
    keys, ts, rows = _shard_data()
    ref = ShardedEngine(ShardConfig(n_shards=2), device="cuda")
    se = ShardedEngine(ShardConfig(n_shards=2, backend="process"),
                       device="cuda")
    pids = se.backend.pids
    try:
        for eng in (ref, se):
            _fill(eng, keys, ts, rows, replicate=True)
            for shape, sql in SHARD_SQL.items():
                eng.deploy(shape, sql)
        assert all(c.ping()["device"].startswith("cuda")
                   for c in se.shards)
        rng = np.random.default_rng(5)
        for shape in SHARD_SQL:
            for c in se.shards:
                c.launch_counts(reset=True)
            for B in (1, 37, 500):
                idx = rng.integers(0, len(keys), B)
                rk = keys[idx].tolist()
                rk[0] = 10_000                           # an unknown key
                rts = [float(ts.max()) + 1.0] * B
                got = se.request(shape, rk, rts, rows=rows[idx])
                want = ref.request(shape, rk, rts, rows=rows[idx])
                np.testing.assert_array_equal(got.status, want.status)
                for c in want:                           # bit for bit
                    np.testing.assert_array_equal(got[c], want[c],
                                                  err_msg=c)
            counts = [c.launch_counts() for c in se.shards]
            for m in SHARD_KERNELS[shape]:
                name = m.__name__.rsplit(".", 1)[-1]
                assert all(n[name] > 0 for n in counts), (shape, counts)
        got, want = se.query_offline("windows"), ref.query_offline("windows")
        for res in (got, want):
            order = np.lexsort((res["__ts"], res["__key"]))
            for c in list(res):
                if c != "__version_vector":
                    res[c] = np.asarray(res[c])[order]
        for c in ref.handle("windows").phys.feature_names:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    finally:
        se.close()
        ref.close()
    assert all(_gone(p) for p in pids)


def test_process_worker_respawn_on_the_card_loads_the_library(
        tmp_path, monkeypatch):
    """A SIGKILLed worker on the card comes back (a warm standby adopted)
    with its catalog, deployments and WAL; neither it nor any other
    worker ran nvcc (the parent built the library, into an empty build
    directory, before spawning); its frames equal a never-killed
    in-process card engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import shutil
    import signal
    import tempfile
    import time
    from repro_torch.shard import ShardConfig, ShardedEngine
    # a build directory with no library in it, for this process and the
    # workers it spawns: the parent's build is then a real one
    root = tmp_path / "kernels"
    monkeypatch.setenv("REPRO_KERNEL_BUILD_ROOT", str(root))
    monkeypatch.setattr(_build, "BUILD_ROOT", root)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "builds", 0)
    _build.function.cache_clear()
    keys, ts, rows = _shard_data()
    wal_dir = tempfile.mkdtemp(prefix="card-wal-")
    se = ShardedEngine(ShardConfig(n_shards=2, backend="process",
                                   wal_dir=wal_dir, standby_workers=1),
                       device="cuda")
    assert _build.builds == 1
    assert len(list(root.glob("*/librepro_torch_kernels.so"))) == 1
    ref = ShardedEngine(ShardConfig(n_shards=2), device="cuda")
    try:
        for eng in (ref, se):
            eng.create_table(TableSchema("events", "user", "ts",
                                         ("amount", "lat", "lon",
                                          "merchant")),
                             max_keys=64, capacity=64, bucket_size=8)
            pipe = eng.attach_stream("events", flush_interval_s=0.02)
            pipe.push_batch(keys, ts, rows)
            pipe.flush()
            eng.deploy("w", SHARD_SQL["windows"])
        rk = np.unique(keys)[:40].tolist()
        rts = [float(ts.max()) + 1.0] * len(rk)
        want = ref.request("w", rk, rts)
        deadline = time.monotonic() + 120.0
        while se.backend.standby.n_warm == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        proc = se.shards[1].proc.proc
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        while se.worker_restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert se.worker_restarts == 1 and se._await_ready(120.0)
        assert se.backend.recovery_stats["last_adopted"] == 1.0
        got = se.request("w", rk, rts)
        np.testing.assert_array_equal(got.status, want.status)
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
        assert [c.ping()["kernel_builds"] for c in se.shards] == [0, 0]
        assert _build.builds == 1
    finally:
        se.close()
        ref.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
        _build.function.cache_clear()   # the next test looks up its own
    assert all(_gone(p) for p in se.backend.pids)


def test_extract_events_device_gather_equals_host_enumeration(table):
    from repro_torch.shard import migrate

    class _Eng:
        tables = {"events": table}

    sel = [5, 23, 0, 999, 11, 3]
    ks, ts, rows = migrate.extract_events(_Eng, "events", sel)
    st = table.snapshot().state
    tot, tsa, val = (st.total.cpu().numpy(), st.ts.cpu().numpy(),
                     st.values.cpu().numpy())
    C = table.capacity
    host = []
    for k in sel:
        i = table.key_to_idx.get(k)
        if i is None:
            continue
        for p in range(max(int(tot[i]) - C, 0), int(tot[i])):
            host.append((tsa[i, p % C], k, val[i, p % C]))
    order = sorted(range(len(host)), key=lambda j: host[j][0])
    assert len(ks) == len(host) > C
    assert ks == [host[j][1] for j in order]
    np.testing.assert_array_equal(ts, np.asarray([host[j][0]
                                                  for j in order]))
    np.testing.assert_array_equal(rows, np.stack([host[j][2]
                                                  for j in order]))


def test_migration_under_a_live_serving_thread():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    from repro_torch.core.results import STATUS_OK, STATUS_SHED
    from repro_torch.shard import ShardConfig, ShardedEngine
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=3000, n_keys=48, n_features=4, seed=8))
    rows[:, 3] = np.floor(np.abs(rows[:, 3])) % 6
    ref = Engine(OptFlags(), device="cuda")
    se = ShardedEngine(ShardConfig(n_shards=2), device="cuda")
    for eng in (ref, se):            # no ring wraps: every key stays exact
        eng.create_table(TableSchema("events", "user", "ts",
                                     ("amount", "lat", "lon", "merchant")),
                         max_keys=64, capacity=1024, bucket_size=64)
        eng.insert("events", keys.tolist(), ts.tolist(), rows)
        eng.deploy("f", SHARD_SQL["windows"])
    assert int(ref.tables["events"].state.total.max()) <= 1024
    rk = list(range(48))
    rts = [float(ts.max()) + 1.0] * 48
    want = ref.request("f", rk, rts)
    stop, first, errs, served = (threading.Event(), threading.Event(), [],
                                 [0])

    def serve():
        while not stop.is_set():
            try:
                fr = se.request("f", rk, rts)
            except Exception as e:                 # pragma: no cover
                errs.append(e)
                return
            finally:
                first.set()
            if (fr.status == STATUS_SHED).all():
                continue
            if not (fr.status == STATUS_OK).all() or any(
                    not np.array_equal(fr[c], want[c]) for c in want):
                errs.append(AssertionError("a mixed or wrong batch"))
                return
            served[0] += 1

    th = threading.Thread(target=serve)
    th.start()
    try:
        assert first.wait(60.0)
        se.add_shard()
        assert se.remove_shard(0) > 0
    finally:
        stop.set()
        th.join(120.0)
    assert not th.is_alive() and not errs and served[0] > 0
    got = se.request("f", rk, rts)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    se.close()
    ref.close()


def test_shards_pinned_to_every_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    from repro_torch.shard import ShardConfig, ShardedEngine
    D = torch.cuda.device_count()
    keys, ts, rows = _shard_data()
    ref = Engine(OptFlags(), device="cuda")
    se = ShardedEngine(ShardConfig(n_shards=2 * D), device="cuda")
    _fill(ref, keys, ts, rows)
    _fill(se, keys, ts, rows, replicate=True)
    assert se.router.n_lanes == D
    for s, eng in enumerate(se.shards):
        dev = torch.device("cuda", s % D)
        assert eng.device == dev
        for t in eng.tables.values():
            st = t.snapshot()
            assert st.state.values.device == dev
            assert st.preagg.sum.device == dev
    for name in sorted(SHARD_SQL):
        ref.deploy(name, SHARD_SQL[name])
        se.deploy(name, SHARD_SQL[name])
        rng = np.random.default_rng(6)
        idx = rng.integers(0, len(keys), 200)
        rk, rts = keys[idx].tolist(), [float(ts.max()) + 1.0] * 200
        for m in SHARD_KERNELS[name]:
            m.launches = 0
        got = se.request(name, rk, rts, rows=rows[idx])
        # every shard reached launched on its own card: one launch of
        # each kernel per shard sub-batch
        reached = len(set(se.owners_of(np.asarray(rk)).tolist()))
        assert all(m.launches >= reached for m in SHARD_KERNELS[name])
        want = ref.request(name, rk, rts, rows=rows[idx])
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    se.close()
    ref.close()


def test_preagg_tier_is_independent_of_insert_batching_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=20000, n_keys=300, n_features=3, seed=4))
    tabs = {}
    for d, split in (("cuda", 1), ("cuda_split", 4), ("cpu", 1)):
        t = Table(TableSchema("events", "k", "ts", ("a", "b", "c")),
                  max_keys=320, capacity=128, bucket_size=16,
                  device="cpu" if d == "cpu" else "cuda")
        for s in range(split):
            idx = np.flatnonzero(keys % split == s)
            t.insert(keys[idx].tolist(), ts[idx], rows[idx], donate=False)
        tabs[d] = t
    order = {d: torch.tensor([t.key_to_idx[k] for k in sorted(t.key_to_idx)])
             for d, t in tabs.items()}
    want = tabs["cpu"]
    for d in ("cuda", "cuda_split"):
        for f in ("sum", "sumsq", "min", "max", "count"):
            assert torch.equal(
                getattr(tabs[d].preagg, f).cpu()[order[d]],
                getattr(want.preagg, f)[order["cpu"]]), (d, f)


# ---------------------------------------------------------------------------
# control and observability on the card
# ---------------------------------------------------------------------------

OBS_SQL = """SELECT SUM(a) OVER w1 AS s1, COUNT(a) OVER w1 AS c1,
  LAST(a) OVER w1 AS l1, MAX(b) OVER w2 AS mx2, COUNT(b) OVER w2 AS c2
FROM events
WINDOW w1 AS (PARTITION BY k ORDER BY ts
              ROWS BETWEEN 10 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY k ORDER BY ts
              ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""
OBS_EXACT = ("c1", "l1", "mx2", "c2")     # w1 a raw scan (LAST), w2 preagg


def _obs_engine(device, model=None):
    from repro_torch.core.engine import Engine
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=8000, n_keys=40, n_features=3, seed=21))
    eng = Engine(device=device, cost_model=model)
    eng.create_table(TableSchema("events", "k", "ts", ("a", "b", "c")),
                     max_keys=64, capacity=256, bucket_size=32)
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    eng.deploy("f", OBS_SQL)
    return eng, float(ts.max())


def _obs_batches(t_max, n=6, B=48, seed=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 44, B).tolist(),             # 40..43 unknown
             (t_max + 1.0 + i + np.arange(B, dtype=np.float32)).tolist())
            for i in range(n)]


def test_replan_flips_preagg_to_raw_scan_kernels():
    """A re-plan with ``preagg_el=10`` moves w2 off the pre-aggregate
    tier: the launch counters show ``fused_window`` where
    ``window_agg`` and ``preagg_window`` launched, and the frames equal
    a CPU engine's on the new plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.control import Replanner
    from repro_torch.core.optimizer import CostModel
    eng, t_max = _obs_engine("cuda")
    (rk, rt), = _obs_batches(t_max, n=1)
    counters = (window_agg, fused_window, preagg_window)
    for m in counters:
        m.launches = 0
    before = eng.request("f", rk, rt)
    assert window_agg.launches and preagg_window.launches
    assert fused_window.launches == 0
    rp = Replanner(eng, "f", min_health_batches=2)
    assert rp.maybe_replan(CostModel(preagg_el=10.0))["action"] == "swapped"
    assert dict(eng.handle("f").plan.window_impl)["w2"] != "preagg"
    for m in counters:
        m.launches = 0
    after = eng.request("f", rk, rt)
    assert fused_window.launches
    assert window_agg.launches == 0 and preagg_window.launches == 0
    cpu, _ = _obs_engine("cpu", model=CostModel(preagg_el=10.0))
    want = cpu.request("f", rk, rt)
    np.testing.assert_array_equal(after.status, want.status)
    for c in want:
        if c in OBS_EXACT:
            np.testing.assert_array_equal(after[c], want[c], err_msg=c)
            np.testing.assert_array_equal(after[c], before[c], err_msg=c)
        else:
            np.testing.assert_allclose(after[c], want[c], rtol=2e-4,
                                       atol=1e-4, err_msg=c)
    for e in (eng, cpu):
        e.close()


def _sketch_moved(a, b):
    """Values in other buckets between two sketch dicts of one column."""
    da = {("p", i): c for i, c in a["pos"]}
    da.update({("n", i): c for i, c in a["neg"]})
    db = {("p", i): c for i, c in b["pos"]}
    db.update({("n", i): c for i, c in b["neg"]})
    da["z"], db["z"] = a["zero"], b["zero"]
    return sum(abs(da.get(k, 0) - db.get(k, 0))
               for k in set(da) | set(db)) / 2


def test_freshness_and_drift_on_the_card_equal_the_cpu():
    """The same requests on a card engine and a CPU engine: equal
    freshness snapshots (age, ingest-column and key sketches, watermark,
    versions) bit for bit, equal drift sketches bit for bit for the
    columns the frames hold exactly; the sum column ``s1`` can move a
    value into a neighbouring bucket by rounding, so it is held to equal
    counts and at most 2 % of its values in other buckets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    engines = {d: _obs_engine(d) for d in ("cuda", "cpu")}
    t_max = engines["cpu"][1]
    for i, (rk, rt) in enumerate(_obs_batches(t_max)):
        for d, (eng, _) in engines.items():
            eng.request("f", rk, rt)
            if i == 2:
                eng.pin_drift_reference()
    snaps = {}
    for d, (eng, _) in engines.items():
        f = eng.freshness_snapshot()
        for ent in f.values():
            ent.pop("published_at")
        snaps[d] = (f, eng.drift.snapshot(), eng.drift_report())
    (fa, da, ra), (fb, db, rb) = snaps["cuda"], snaps["cpu"]
    assert fa == fb
    assert fa["events"]["serve_rows"] == 6 * 48
    for side in ("live", "ref"):
        assert sorted(da[side]) == sorted(db[side])
        for c in da[side]:
            if c in OBS_EXACT:
                assert da[side][c] == db[side][c], (side, c)
            else:
                assert da[side][c]["count"] == db[side][c]["count"]
                assert _sketch_moved(da[side][c], db[side][c]) <= max(
                    2, 0.02 * db[side][c]["count"]), (side, c)
    for c in OBS_EXACT:
        assert ra[c] == rb[c], c
    for eng, _ in engines.values():
        eng.close()


def test_collectors_neither_sync_nor_copy():
    """``MetricsCollector.sample()`` and ``freshness_snapshot()`` run on
    the control plane's thread while requests are served: they read host
    state only. Across one call of each, torch.cuda.synchronize is never
    called, and the profiler sees no kernel, no copy and no sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.control import MetricsCollector
    eng, t_max = _obs_engine("cuda")
    for rk, rt in _obs_batches(t_max):
        eng.request("f", rk, rt)
    col = MetricsCollector(eng)
    col.sample()
    torch.cuda.synchronize()
    calls = [0]
    real = torch.cuda.synchronize

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    def device_events(fn):
        # the profiler syncs the card itself when it stops: count what a
        # no-op profile shows and what fn's shows, and compare
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize = counted
            try:
                fn()
            finally:
                torch.cuda.synchronize = real
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      or any(x in e.name.lower() for x in
                             ("memcpy", "memset", "synchronize",
                              "launchkernel")))

    idle = device_events(lambda: None)
    got = device_events(lambda: (col.sample(), eng.freshness_snapshot()))
    assert calls[0] == 0
    assert got == idle
    eng.close()


# ---------------------------------------------------------------------------
# the sharded path: kernels on local heads, a world of processes on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Hq,Hkv,D,m", [
    (12, 2, 128, 2),     # qwen2-1.5b at model=2: q and kv heads sharded
    (12, 2, 128, 4),     # replicated K/V: each rank slices its kv head
    (4, 1, 16, 2),       # reduced qwen2-1.5b: the one kv head whole
    (24, 8, 64, 2),      # granite-moe-3b-a800m at model=2: 12/4 a rank
    (48, 8, 128, 2),     # mixtral-8x22b at model=2: 24/4 a rank
    (32, 8, 128, 2),     # jamba-v0.1-52b at model=2: 16/4 a rank
    (28, 4, 128, 2),     # qwen2-vl-7b at model=2: 14/2 a rank
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_heads_kernel_calls_equal_the_full_call(card, Hq, Hkv, D, m,
                                                      dtype):
    """What each ``model`` rank of a wide mesh gives the kernels
    (``sharding.head_layout``: its q heads, the kv heads they use) against
    the one full call: flash (causal prefill) and decode, the ranks'
    outputs concatenated over heads within the kernels' tolerance of the
    full call's and of the plain version's."""
    from repro_torch.distributed import sharding
    lay = sharding.head_layout(
        sharding.AbstractMesh((1, m), ("data", "model")), Hq, Hkv)
    assert lay.q_sharded and lay.hq_local % lay.kv_local == 0

    def kv_heads(r):
        lo = r * lay.kv_local if lay.kv_sharded else lay.kv_lo(r)
        return slice(lo, lo + lay.kv_local)

    B, S = 2, 200
    q = _randn((B, S, Hq, D), dtype, card, 1)
    k = _randn((B, S, Hkv, D), dtype, card, 2)
    v = _randn((B, S, Hkv, D), dtype, card, 3)
    full = ops.flash_attention(q, k, v, causal=True)
    parts = [ops.flash_attention(
        q[:, :, r * lay.hq_local:(r + 1) * lay.hq_local].contiguous(),
        k[:, :, kv_heads(r)].contiguous(), v[:, :, kv_heads(r)].contiguous(),
        causal=True) for r in range(m)]
    torch.testing.assert_close(torch.cat(parts, 2), full, rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])
    torch.testing.assert_close(
        torch.cat(parts, 2), ref.flash_attention_ref(q, k, v, causal=True),
        rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    qd = _randn((B, Hq, D), dtype, card, 4)
    lengths = torch.tensor([S, 77], dtype=torch.int32, device=card)
    full = ops.decode_attention(qd, k, v, lengths)
    parts = [ops.decode_attention(
        qd[:, r * lay.hq_local:(r + 1) * lay.hq_local].contiguous(),
        k[:, :, kv_heads(r)].contiguous(), v[:, :, kv_heads(r)].contiguous(),
        lengths) for r in range(m)]
    torch.testing.assert_close(torch.cat(parts, 1), full, rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])
    torch.testing.assert_close(
        torch.cat(parts, 1), ref.decode_attention_ref(qd, k, v, lengths),
        rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk", [
    (2, 128, 256),       # mesh_encdec trains: 128 tokens over 256 frames
    (2, 64, 1024),       # and serves: 64-token prompts over 1024 frames
    (2, 256, 256),       # the encoder's own calls
    (2, 1024, 1024),
    (3, 37, 16),         # a decoder longer than the encoder, odd rows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encdec_local_heads_kernel_calls_equal_the_full_call(card, B, Sq,
                                                             Sk, dtype):
    """seamless-m4t-medium at model=2 (16 q and 16 kv heads of 64: 8 and
    8 a rank, ``sharding.head_layout``) on one data rank's rows: the
    non-causal flash call of its encoder and of its cross-attention (``Sq``
    tokens over ``Sk`` frames) and the cross decode call at every length
    ``Sk``, each rank's local heads against the one full call and the
    plain version, within the kernels' tolerance."""
    from repro_torch.distributed import sharding
    lay = sharding.head_layout(
        sharding.AbstractMesh((2, 2), ("data", "model")), 16, 16)
    assert (lay.q_sharded, lay.kv_sharded, lay.hq_local) == (True, True, 8)
    D, m, h = 64, 2, 8
    q = _randn((B, Sq, 16, D), dtype, card, 31)
    k = _randn((B, Sk, 16, D), dtype, card, 32)
    v = _randn((B, Sk, 16, D), dtype, card, 33)
    full = ops.flash_attention(q, k, v, causal=False)
    parts = [ops.flash_attention(*(t[:, :, r * h:(r + 1) * h].contiguous()
                                   for t in (q, k, v)), causal=False)
             for r in range(m)]
    for want in (full, ref.flash_attention_ref(q, k, v, causal=False)):
        torch.testing.assert_close(torch.cat(parts, 2), want,
                                   rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    qd = _randn((B, 16, D), dtype, card, 34)
    lengths = torch.full((B,), Sk, dtype=torch.int32, device=card)
    full = ops.decode_attention(qd, k, v, lengths)
    parts = [ops.decode_attention(qd[:, r * h:(r + 1) * h].contiguous(),
                                  k[:, :, r * h:(r + 1) * h].contiguous(),
                                  v[:, :, r * h:(r + 1) * h].contiguous(),
                                  lengths) for r in range(m)]
    for want in (full, ref.decode_attention_ref(qd, k, v, lengths)):
        torch.testing.assert_close(torch.cat(parts, 1), want,
                                   rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


def test_ssd_block_on_a_one_rank_cuda_mesh_equals_the_meshless_block(
        card, tmp_path):
    """One mamba2-780m SSD block at full width (f32; 48 heads of 64,
    d_state 128) on the local pieces of a one-rank CUDA mesh over
    ("data", "model") against the meshless block on the card: the
    training forward over 2 x 320 rows (past the 256-row chunk, a padded
    tail) and its gradients, the prefill's ``conv``/``ssm`` caches, and
    one decode step written into those caches in place, within 1e-5
    relative L2."""
    from datetime import timedelta
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import ssm
    from repro_torch.models.tree import tree_flatten_with_path, tree_map

    def rel(a, b):
        a, b = a.detach().double(), b.detach().double()
        return float((a - b).norm() / b.norm())

    cfg = get_config("mamba2-780m")
    p = ssm.init_mamba(torch.Generator(device=card).manual_seed(0), cfg)
    x = _randn((2, 320, cfg.d_model), torch.float32, card, 1)
    tok = _randn((2, cfg.d_model), torch.float32, card, 2)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=120))
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"))
        pd = sharding.distribute(p, mesh, sharding.param_specs(p, mesh))
        leaves = [t for _, t in tree_flatten_with_path(pd)]
        for t in leaves:
            t.requires_grad_()
        xd = sharding.distribute(x, mesh, sharding.Spec())
        y = ssm.mamba_train(pd, xd, cfg)
        g = torch.autograd.grad((y * y).sum(), leaves)
        plain = tree_map(lambda t: t.detach().clone().requires_grad_(), p)
        want = ssm.mamba_train(plain, x, cfg)
        gw = torch.autograd.grad((want * want).sum(),
                                 [t for _, t in tree_flatten_with_path(plain)])
        assert isinstance(y, DTensor)
        assert rel(y.to_local(), want) <= 1e-5
        for a, b in zip(g, gw):
            assert rel(a.full_tensor(), b) <= 1e-5
        with torch.no_grad():
            _, cache = ssm.mamba_prefill(pd, xd, cfg)
            _, cw = ssm.mamba_prefill(p, x, cfg)
            for n in ("conv", "ssm"):
                assert rel(cache[n].to_local(), cw[n]) <= 1e-5
            o, cache = ssm.mamba_decode(
                pd, sharding.distribute(tok, mesh, sharding.Spec()), cfg,
                cache)
            ow, cw = ssm.mamba_decode(p, tok, cfg, cw)
            assert rel(o.to_local(), ow) <= 1e-5
            for n in ("conv", "ssm"):
                assert rel(cache[n].to_local(), cw[n]) <= 1e-5
    finally:
        dist.destroy_process_group()


MESH_RANK = """
import dataclasses, pickle, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.distributed import gloo_cuda, sharding
from repro_torch.kernels import flash_attention
from repro_torch.launch import mesh as tmesh, steps
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.optim import adamw

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
# optional: the arch, the (data, model) shape and moe_groups
arch = sys.argv[4] if len(sys.argv) > 4 else "qwen2-1.5b"
shape = (tuple(int(x) for x in sys.argv[5].split(","))
         if len(sys.argv) > 5 else (1, 2))
groups = int(sys.argv[6]) if len(sys.argv) > 6 else 0
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("cpu:gloo,cuda:gloo",
                        store=dist.FileStore(store, 2), rank=rank,
                        world_size=2, timeout=timedelta(seconds=120))
gloo_cuda.install()
try:
    cfg = dataclasses.replace(reduced(get_config(arch)), moe_groups=groups)
    mesh = tmesh.make_mesh(shape, ("data", "model"))
    p0 = steps.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32, device="cuda")
             for k in ("tokens", "targets")}
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.tensor(
            rng.standard_normal((4, 24, cfg.d_model)), dtype=torch.float32,
            device="cuda")
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    p = sharding.distribute(p0, mesh, sharding.param_specs(p0, mesh))
    s = adamw.adamw_init(p, ocfg)
    step = steps.make_train_step(cfg, ocfg, mesh=mesh)
    before = flash_attention.launches
    losses, norms = [], []
    for _ in range(3):
        p, s, m = step(p, s, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = [t.full_tensor().cpu().double().numpy()
              for _, t in tree_flatten_with_path(p)]
    res = {"losses": losses, "norms": norms, "params": params,
           "flash": flash_attention.launches - before,
           "device": str(next(iter(tree_flatten_with_path(p)))[1]
                         .to_local().device)}
finally:
    dist.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def test_two_process_mesh_on_the_card_matches_the_meshless_step(card,
                                                                tmp_path):
    """Two processes share the card (gloo over CUDA tensors, the funcol
    collectives through ``distributed/gloo_cuda.py``) on a (1, 2) mesh
    over ("data", "model"): 3 steps of reduced qwen2-1.5b (f32) against
    the meshless step on the card, losses and gradient norms within 1e-5
    relative and the parameters within 1e-4 relative L2; the flash
    kernel launched on each rank's local heads."""
    import pickle
    import subprocess
    import sys
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw
    _build.library()            # built once here; the ranks load it
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    (tmp_path / "rank.py").write_text(MESH_RANK)
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), str(r),
         str(tmp_path / "store"), str(tmp_path / f"out{r}.pkl")],
        env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [pickle.loads((tmp_path / f"out{r}.pkl").read_bytes())
             for r in (0, 1)]
    cfg = reduced(get_config("qwen2-1.5b"))
    params = _on(steps.init_params(torch.Generator().manual_seed(0), cfg),
                 "cuda")
    rng = np.random.default_rng(1)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32, device=card)
             for k in ("tokens", "targets")}
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    step = steps.make_train_step(cfg, ocfg)
    s = adamw.adamw_init(params, ocfg)
    losses, norms = [], []
    for _ in range(3):
        params, s, m = step(params, s, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    want = [t.cpu().double().numpy() for _, t in
            tree_flatten_with_path(params)]
    for res in ranks:
        assert res["device"].startswith("cuda")
        assert res["flash"] == 2 * 2 * 3     # 2 layers + remat, 3 steps
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-5)
        num = sum(float(((a - b) ** 2).sum())
                  for a, b in zip(res["params"], want))
        den = sum(float((b ** 2).sum()) for b in want)
        assert (num / den) ** 0.5 <= 1e-4


@pytest.mark.parametrize("groups", [2, 0])
def test_two_process_moe_mesh_on_the_card_matches_the_meshless_step(
        card, tmp_path, groups):
    """Two processes share the card on a (2, 1) mesh over ("data",
    "model"): reduced granite (4 experts, so EP, 2 a rank) at
    ``moe_groups`` 2 (local groups: the slab rows go to their experts'
    owner by the all-to-all, carried over gloo on CUDA tensors by
    ``distributed/gloo_cuda.py``) and 0 (the token stream gathered, the
    outputs all-gathered); 3 steps against the meshless step on the
    card, losses and gradient norms within 1e-5 relative, parameters
    within 1e-4 relative L2."""
    import dataclasses
    import pickle
    import subprocess
    import sys
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw
    _build.library()            # built once here; the ranks load it
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    (tmp_path / "rank.py").write_text(MESH_RANK)
    env = dict(os.environ, PYTHONPATH=src)
    arch = "granite-moe-3b-a800m"
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), str(r),
         str(tmp_path / "store"), str(tmp_path / f"out{r}.pkl"), arch,
         "2,1", str(groups)],
        env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [pickle.loads((tmp_path / f"out{r}.pkl").read_bytes())
             for r in (0, 1)]
    cfg = dataclasses.replace(reduced(get_config(arch)), moe_groups=groups)
    params = _on(steps.init_params(torch.Generator().manual_seed(0), cfg),
                 "cuda")
    rng = np.random.default_rng(1)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32, device=card)
             for k in ("tokens", "targets")}
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    step = steps.make_train_step(cfg, ocfg)
    s = adamw.adamw_init(params, ocfg)
    losses, norms = [], []
    for _ in range(3):
        params, s, m = step(params, s, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    want = [t.cpu().double().numpy() for _, t in
            tree_flatten_with_path(params)]
    for res in ranks:
        assert res["device"].startswith("cuda")
        assert res["flash"] == 2 * 3       # 2 layers, no remat, 3 steps
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-5)
        num = sum(float(((a - b) ** 2).sum())
                  for a, b in zip(res["params"], want))
        den = sum(float((b ** 2).sum()) for b in want)
        assert (num / den) ** 0.5 <= 1e-4


@pytest.mark.parametrize("shapes", [((256, 3072), (3072, 6144)),
                                    ((4, 64, 512), (4, 512, 256))])
def test_mm_f32_on_the_card_is_one_bf16_gemm_with_f32_sums(card, shapes):
    """``sharding.mm_f32`` of bf16 operands on the card (mixtral's
    attention ``wo`` partial sum at model=2; an expert slab's last
    product): an f32 result within 1e-4 of the largest entry of the
    exact product, not rounded to bf16 (the bf16 product's rounding
    exceeds 1e-3 of it); gradients in bf16, those of the plain bf16
    product."""
    from repro_torch.distributed import sharding
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(*shapes[0], generator=g, device=card).bfloat16()
    w = torch.randn(*shapes[1], generator=g, device=card).bfloat16()
    x.requires_grad_(), w.requires_grad_()
    y = sharding.mm_f32(x, w)
    exact = x.detach().double() @ w.detach().double()
    scale = float(exact.abs().max())
    assert y.dtype == torch.float32
    assert float((y.detach().double() - exact).abs().max()) <= 1e-4 * scale
    assert float(((x @ w).detach().double() - exact).abs().max()
                 ) > 1e-3 * scale
    gy = torch.randn(y.shape, generator=g, device=card).bfloat16()
    got = torch.autograd.grad(y, (x, w), gy.float())
    want = torch.autograd.grad(x @ w, (x, w), gy)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("shape", ["1,2", "2,1"])
def test_two_process_encdec_mesh_on_the_card_matches_the_meshless_step(
        card, tmp_path, shape):
    """Two processes share the card on a (1, 2) mesh (the heads and the
    vocab over ``model``) and a (2, 1) mesh (the batch and the frames
    over ``data``): reduced seamless-m4t-medium, 3 steps of 4 x 16 tokens
    over 24 frames (f32), against the meshless step on the card: losses
    and gradient norms within 1e-5 relative, parameters within 1e-4
    relative L2; the flash kernel launched for the encoder, the decoder's
    self- and its cross-attention on each rank's local heads."""
    import pickle
    import subprocess
    import sys
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim import adamw
    _build.library()            # built once here; the ranks load it
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    (tmp_path / "rank.py").write_text(MESH_RANK)
    env = dict(os.environ, PYTHONPATH=src)
    arch = "seamless-m4t-medium"
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), str(r),
         str(tmp_path / "store"), str(tmp_path / f"out{r}.pkl"), arch,
         shape, "0"],
        env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [pickle.loads((tmp_path / f"out{r}.pkl").read_bytes())
             for r in (0, 1)]
    cfg = reduced(get_config(arch))
    params = _on(steps.init_params(torch.Generator().manual_seed(0), cfg),
                 "cuda")
    rng = np.random.default_rng(1)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32, device=card)
             for k in ("tokens", "targets")}
    batch["enc_embeds"] = torch.tensor(
        rng.standard_normal((4, 24, cfg.d_model)), dtype=torch.float32,
        device=card)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    step = steps.make_train_step(cfg, ocfg)
    s = adamw.adamw_init(params, ocfg)
    losses, norms = [], []
    for _ in range(3):
        params, s, m = step(params, s, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    want = [t.cpu().double().numpy() for _, t in
            tree_flatten_with_path(params)]
    for res in ranks:
        assert res["device"].startswith("cuda")
        # 2 encoder + 2 x 2 decoder calls a step, no remat, 3 steps
        assert res["flash"] == (cfg.encoder_layers + 2 * cfg.n_layers) * 3
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-5)
        num = sum(float(((a - b) ** 2).sum())
                  for a, b in zip(res["params"], want))
        den = sum(float((b ** 2).sum()) for b in want)
        assert (num / den) ** 0.5 <= 1e-4
