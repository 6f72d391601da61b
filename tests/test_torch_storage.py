"""Port storage: the same event stream through the JAX ``Table`` and the
port's ``Table(device="cpu")`` gives the same ring and pre-aggregate state,
key lookups agree, and ingest keeps its snapshot contract.

Tolerances: values, ts, total and the count/min/max tiers exactly; the
sum/sumsq tiers within 1e-5 relative (several events of one key in one
batch accumulate in another order).
"""
import numpy as np
import pytest
import torch

from repro.featurestore.keydir import KeyDirectory as JKeyDirectory
from repro.featurestore.table import Table as JTable
from repro.featurestore.table import TableSchema as JSchema
from repro_torch import convert
from repro_torch.featurestore.keydir import KeyDirectory
from repro_torch.featurestore.table import Table, TableSchema

torch.set_num_threads(1)

COLS = ("c0", "c1", "c2")


def _stream(n_keys, n_events, seed, key_space=None):
    """Keys drawn from a small set so one batch holds several events of a
    key; sorted timestamps; enough events to wrap every ring."""
    rng = np.random.default_rng(seed)
    space = (np.arange(n_keys) if key_space is None
             else np.asarray(key_space))
    keys = space[rng.integers(0, n_keys, n_events)]
    ts = np.sort(rng.uniform(0.0, 1000.0, n_events)).astype(np.float32)
    rows = rng.normal(0, 2, (n_events, len(COLS))).astype(np.float32)
    return keys, ts, rows


def _tables(n_keys, capacity, bucket, preagg=True):
    j = JTable(JSchema("events", "k", "ts", COLS), max_keys=n_keys,
               capacity=capacity, bucket_size=bucket, enable_preagg=preagg)
    t = Table(TableSchema("events", "k", "ts", COLS), max_keys=n_keys,
              capacity=capacity, bucket_size=bucket, enable_preagg=preagg,
              device="cpu")
    return j, t


def _assert_same_state(j, t):
    np.testing.assert_array_equal(t.state.values.numpy(),
                                  np.asarray(j.state.values))
    np.testing.assert_array_equal(t.state.ts.numpy(), np.asarray(j.state.ts))
    np.testing.assert_array_equal(t.state.total.numpy(),
                                  np.asarray(j.state.total))
    if j.preagg is None:
        assert t.preagg is None
        return
    for f in ("count", "min", "max"):
        np.testing.assert_array_equal(getattr(t.preagg, f).numpy(),
                                      np.asarray(getattr(j.preagg, f)),
                                      err_msg=f)
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(getattr(t.preagg, f).numpy(),
                                   np.asarray(getattr(j.preagg, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("n_keys,capacity,bucket,batch", [
    (4, 32, 8, 32),       # 8 events of a key per batch, rings wrap 6x
    (6, 64, 16, 50),      # batches that straddle bucket starts
    (3, 16, 4, 16),       # tiny ring: every batch wraps some key
])
def test_same_stream_same_state(n_keys, capacity, bucket, batch):
    j, t = _tables(n_keys, capacity, bucket)
    keys, ts, rows = _stream(n_keys, 12 * capacity, seed=capacity)
    for s in range(0, len(keys), batch):
        sl = slice(s, s + batch)
        j.insert(keys[sl].tolist(), ts[sl].tolist(), rows[sl])
        t.insert(keys[sl].tolist(), ts[sl].tolist(), rows[sl])
    assert int(t.state.total.sum()) == len(keys)
    assert t.state.total.max() > 2 * capacity       # every ring wrapped
    _assert_same_state(j, t)
    assert t.version == j.version
    assert t.watermark == j.watermark
    assert t.key_to_idx == j.key_to_idx


def test_one_large_insert_splits_at_capacity():
    j, t = _tables(3, 32, 8)
    keys, ts, rows = _stream(3, 200, seed=4)
    j.insert(keys.tolist(), ts.tolist(), rows)
    t.insert(keys.tolist(), ts.tolist(), rows)
    _assert_same_state(j, t)


def test_table_without_preagg():
    j, t = _tables(4, 32, 8, preagg=False)
    keys, ts, rows = _stream(4, 100, seed=2)
    j.insert(keys.tolist(), ts.tolist(), rows)
    t.insert(keys.tolist(), ts.tolist(), rows)
    _assert_same_state(j, t)


def test_key_lookups_agree():
    """Same inserts, same probes: equal (idx, found), for integer keys
    spread over the int32 range (negative, large, colliding) and for keys
    never inserted."""
    rng = np.random.default_rng(0)
    keys = np.unique(np.concatenate([
        rng.integers(-2**31 + 1, 2**31 - 1, 300),
        np.arange(0, 64) * 128,                  # same low bits: collide
        [-1, 0, 1, 2**31 - 1, -2**31 + 1]]))
    n_first = 2 * len(keys) // 3
    jd, td = JKeyDirectory(512), KeyDirectory(512, device="cpu")
    for i, k in enumerate(keys[:n_first]):
        jd.insert(int(k), i)
        td.insert(int(k), i)
    assert td.max_probe == jd.max_probe and td.n == jd.n
    probe = np.concatenate([keys, rng.integers(-2**31 + 1, 2**31 - 1, 50)])
    assert td.covers(probe) and jd.covers(probe)
    ji, jf = jd.lookup(probe)
    ti, tf = td.lookup(probe)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tf[:n_first].all() and not tf[n_first:len(keys)].any()
    # incremental patch: keys inserted after the first lookup
    for i, k in enumerate(keys[n_first:], start=n_first):
        jd.insert(int(k), i)
        td.insert(int(k), i)
    ji, jf = jd.lookup(probe)
    ti, tf = td.lookup(probe)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tf[:len(keys)].all()


def test_keydir_deactivates_on_non_integer_keys():
    td = KeyDirectory(16, device="cpu")
    td.insert(3, 0)
    td.insert("user-7", 1)
    assert not td.active and not td.covers(np.asarray([3]))


def test_snapshot_unchanged_by_copying_insert():
    """``donate=False`` ingests into copies: a snapshot taken before keeps
    its tensors and values; ``donate=True`` updates them in place."""
    _, t = _tables(4, 32, 8)
    keys, ts, rows = _stream(4, 120, seed=9)
    t.insert(keys[:60].tolist(), ts[:60].tolist(), rows[:60])
    snap = t.snapshot()
    before = {n: getattr(snap.state, n).clone()
              for n in ("values", "ts", "total")}
    sum_before = snap.preagg.sum.clone()
    t.insert(keys[60:90].tolist(), ts[60:90].tolist(), rows[60:90],
             donate=False)
    for n, v in before.items():
        assert torch.equal(getattr(snap.state, n), v), n
    assert torch.equal(snap.preagg.sum, sum_before)
    assert t.snapshot().version == snap.version + 1
    assert int(t.state.total.sum()) == 90
    live = t.snapshot()
    t.insert(keys[90:].tolist(), ts[90:].tolist(), rows[90:])
    assert t.state.values is live.state.values          # in place
    assert int(live.state.total.sum()) == 120


def test_out_of_order_insert_rejected_before_any_write():
    _, t = _tables(4, 32, 8)
    t.insert([1, 1], [5.0, 6.0], np.ones((2, 3), np.float32))
    total = t.state.total.clone()
    with pytest.raises(ValueError, match="out-of-order"):
        t.insert([2, 1], [7.0, 4.0], np.ones((2, 3), np.float32))
    assert torch.equal(t.state.total, total)


def test_cuda_table_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Table(TableSchema("events", "k", "ts", COLS))


def test_convert_loads_jax_state_and_keeps_ingesting():
    """State carried across: a port table loaded from the JAX table's
    arrays equals it, and the same further events keep both equal."""
    j, _ = _tables(5, 32, 8)
    keys, ts, rows = _stream(5, 300, seed=11, key_space=[10, 20, 30, 40, 50])
    j.insert(keys[:200].tolist(), ts[:200].tolist(), rows[:200])
    _, t = _tables(5, 32, 8)
    pa = j.preagg
    convert.load_table(
        t, values=np.asarray(j.state.values), ts=np.asarray(j.state.ts),
        total=np.asarray(j.state.total), key_to_idx=j.key_to_idx,
        preagg={f: np.asarray(getattr(pa, f))
                for f in ("sum", "sumsq", "min", "max", "count")})
    _assert_same_state(j, t)
    assert t.last_ts_by_key() == j.last_ts_by_key()
    assert t.watermark == j.watermark
    j.insert(keys[200:].tolist(), ts[200:].tolist(), rows[200:])
    t.insert(keys[200:].tolist(), ts[200:].tolist(), rows[200:])
    _assert_same_state(j, t)
    idx, found = t.keydir.lookup(np.asarray([10, 50, 60]))
    assert idx.tolist()[:2] == [j.key_to_idx[10], j.key_to_idx[50]]
    assert found.tolist() == [True, True, False]


def test_convert_rejects_mismatched_state():
    _, t = _tables(4, 32, 8)
    with pytest.raises(ValueError, match="do not fit"):
        convert.load_table(t, values=np.zeros((4, 16, 3), np.float32),
                           ts=np.zeros((4, 16), np.float32),
                           total=np.zeros(4, np.int32), key_to_idx={},
                           preagg=None)
