#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the feature engine on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a). It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``,
then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the kernels and prints the build seconds;
3. sets up one node of a fraud-serving deployment at production key space
   (events: 2^20 keys, capacity 1024, bucket 64, 4 columns, about 21 GiB
   of table state; 2,000,000 Zipf-1.2 events; merchants: 12 keys, two
   profile publishes) and prints the ingest rate and each deployment's
   EXPLAIN;
4. holds each of the four kernels against its plain PyTorch version on the
   card — wrapped, unwrapped and empty rings, ROWS and RANGE frames,
   assume_latest on and off, with and without a WHERE mask, unmatched
   joins — exact for count/min/max/first/last and the join outputs,
   ``rtol 2e-4`` for sum/sumsq; then times each kernel and its plain
   version on the calls the main path makes at B=500: device time per
   launch (a CUDA graph of 20 calls, median of 20 replays) and time per
   call with host work (CUDA events, median of 30, L2 flushed);
5. holds a ``device="cuda"`` engine against a ``device="cpu"`` engine on
   the same 20,000 events: ``request`` (B=64) and ``query_offline`` give
   equal FeatureFrames;
6. drives the main path: 200 batches of 100 and 200 of 500 requests on
   each deployment, asserting OK status, finite outputs and that every
   kernel's launch counter rose, and prints requests/s and batch p50/p99.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before doing anything.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
SRC = Path(__file__).resolve().parent / "src"

WINDOWS = """
WINDOW w1 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 10 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""
FRAUD_FEATURES = ("amt_avg_10", "amt_max_100", "amt_std_10", "amt_sum_10",
                  "m_risk", "m_volume", "txn_cnt_100")
DEPLOYMENTS = {
    # examples/fraud_serving.py FEATURE_SQL + PREDICT: w1, w2 preagg + JOIN
    "fraud_scored": """
SELECT
  SUM(amount)   OVER w1 AS amt_sum_10,
  AVG(amount)   OVER w1 AS amt_avg_10,
  STD(amount)   OVER w1 AS amt_std_10,
  COUNT(amount) OVER w2 AS txn_cnt_100,
  MAX(amount)   OVER w2 AS amt_max_100,
  merchants.risk   AS m_risk,
  merchants.volume AS m_volume,
  PREDICT(fraud, """ + ", ".join(FRAUD_FEATURES) + """) AS score
FROM events
LAST JOIN merchants ORDER BY mts ON merchant
""" + WINDOWS,
    # launch/serve.py FEATURE_SQL: w1 naive (LAST), w2 preagg
    "serve_features": """
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
""" + WINDOWS,
}
# the same plus a LAST over w2: both windows fuse into one launch
DEPLOYMENTS["serve_features_last"] = DEPLOYMENTS["serve_features"].replace(
    "LAST(amount) OVER w1 AS amt_last",
    "LAST(amount) OVER w1 AS amt_last,\n  LAST(lat) OVER w2 AS lat_last_100")

KERNELS = {   # name -> (CUDA source, the TPU kernel it replaces)
    "window_agg": ("src/repro_torch/kernels/csrc/window_agg.cu",
                   "src/repro/kernels/window_agg.py:108"),
    "fused_window": ("src/repro_torch/kernels/csrc/fused_window.cu",
                     "src/repro/kernels/fused_window.py:131"),
    "preagg_window": ("src/repro_torch/kernels/csrc/preagg_window.cu",
                      "src/repro/kernels/preagg_window.py:149"),
    "last_join": ("src/repro_torch/kernels/csrc/last_join.cu",
                  "src/repro/kernels/last_join.py:77"),
}
EXACT_FIELDS = ("count", "min", "max", "first", "last")


@dataclasses.dataclass(frozen=True)
class Sizes:
    keys: int = 1 << 20          # events table key space
    capacity: int = 1024
    bucket: int = 64
    events: int = 2_000_000
    merchants: int = 12
    check_events: int = 20_000   # CUDA-vs-CPU engine comparison
    check_keys: int = 256
    batches: tuple = (100, 500)
    n_batches: int = 200
    timing_batch: int = 500
    reps: int = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def make_engine(device, sz: Sizes, keys: int):
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    from repro_torch.featurestore.table import TableSchema
    eng = Engine(OptFlags(), device=device)
    eng.create_table(TableSchema("events", key_col="user", ts_col="ts",
                                 value_cols=("amount", "lat", "lon",
                                             "merchant")),
                     max_keys=keys, capacity=sz.capacity,
                     bucket_size=sz.bucket)
    eng.create_table(TableSchema("merchants", key_col="merchant",
                                 ts_col="mts",
                                 value_cols=("risk", "volume")),
                     max_keys=sz.merchants, capacity=64, bucket_size=8)
    return eng


def fill_merchants(eng, ts: np.ndarray, sz: Sizes) -> None:
    """Merchant risk profiles published at the stream's start and middle
    (examples/fraud_serving.py)."""
    rng = np.random.default_rng(7)
    for t0 in (float(ts[0]), float(ts[len(ts) // 2])):
        eng.insert("merchants", list(range(sz.merchants)),
                   [t0] * sz.merchants,
                   np.stack([rng.uniform(0, 1, sz.merchants),
                             rng.uniform(10, 500, sz.merchants)], -1)
                   .astype(np.float32))


def deploy_all(eng, model_params) -> None:
    """The three deployments; PREDICT is a logistic scorer over
    standardised features with seeded random weights."""
    def scorer(p, feats):
        mu, sd, w, b = p
        return torch.sigmoid(((feats - mu) / sd) @ w + b)

    eng.register_model("fraud", scorer, model_params)
    for name, sql in DEPLOYMENTS.items():
        eng.deploy(name, sql)


def scorer_params(rows: np.ndarray, device):
    from repro_torch.convert import to_tensors
    rng = np.random.default_rng(11)
    F = len(FRAUD_FEATURES)
    scale = np.abs(rows[:, 0]).mean()
    mu = np.asarray([scale, 3 * scale, scale, 10 * scale, 0.5, 250.0, 50.0],
                    np.float32)
    sd = np.asarray([scale, 3 * scale, scale, 10 * scale, 0.3, 150.0, 30.0],
                    np.float32)
    return to_tensors((mu, sd, rng.normal(0, 1, F).astype(np.float32),
                       np.float32(rng.normal())), device)


# ---------------------------------------------------------------------------
# kernel checks and timing
# ---------------------------------------------------------------------------

def _max_err(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             what: str) -> float:
    """Exact for selects and order-free reductions, rtol 2e-4 for sums.
    Returns the largest absolute difference."""
    err = 0.0
    for f, w in want.items():
        g = got[f]
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {f} shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        gd, wd = g.double(), w.double()
        d = float((gd - wd).abs().max()) if g.numel() else 0.0
        err = max(err, d)
        if f in EXACT_FIELDS or g.dtype == torch.bool:
            ok = torch.equal(gd, wd)
        else:
            ok = bool(torch.allclose(gd, wd, rtol=2e-4, atol=2e-4))
        if not ok:
            raise AssertionError(f"{what}: field {f} differs from the plain "
                                 f"version (max abs diff {d})")
    return err


def _as_dict(out) -> Dict[str, torch.Tensor]:
    if isinstance(out, dict):
        return out
    return {n: t for n, t in zip(("row", "matched", "sel_ts"), out)}


def kernel_cases(state, preagg, sz: Sizes, n_keys: int, t_max: float,
                 device) -> Dict[str, float]:
    """Every kernel against its plain version over the coverage cases.
    Returns the largest absolute difference per kernel."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(5)
    B = sz.timing_batch
    total = state.total.cpu().numpy()
    hot = np.argsort(-total[:n_keys])[:B // 8]              # wrapped rings
    cold = rng.integers(0, n_keys, B // 2)                  # mostly unwrapped
    empty = rng.integers(n_keys, state.max_keys, B - len(hot) - len(cold))
    keys = np.concatenate([hot, cold, empty]).astype(np.int32)
    assert (total[hot] > sz.capacity).all() and (total[empty] == 0).all()
    key = torch.from_numpy(keys).to(device)
    fresh = torch.full((B,), t_max + 1.0, device=device)
    # point-in-time: inside each key's history, or before all of it
    last = state.ts[key.long(), ((state.total[key.long()] - 1)
                                 % sz.capacity).long()]
    past = torch.where(torch.rand(B, device=device) < 0.2,
                       torch.full_like(last, -1.0),
                       last - torch.rand(B, device=device) * 50.0)
    ring = (state.values, state.ts, state.total)
    tiers = (preagg.sum, preagg.sumsq, preagg.min, preagg.max, preagg.count)
    # the batch's own rows, for the WHERE-mask cases (as the engine does)
    kl = key.long()
    local = (state.values[kl].contiguous(), state.ts[kl].contiguous(),
             state.total[kl].contiguous(),
             torch.arange(B, dtype=torch.int32, device=device))
    mask = local[0][:, :, 0] > 20.0
    errs = {k: 0.0 for k in KERNELS}
    frames = (dict(rows_preceding=10), dict(rows_preceding=100),
              dict(range_preceding=500.0))
    for assume_latest, rts in ((True, fresh), (False, past)):
        for fr in frames:
            for inp, m in ((ring, None), (local, mask)):
                kw = dict(cols=(0, 2), assume_latest=assume_latest,
                          evt_mask=m, **fr)
                args = (*inp[:3], inp[3] if m is not None else key, rts)
                errs["window_agg"] = max(errs["window_agg"], _max_err(
                    ops.window_agg(*args, **kw),
                    ref.window_agg_ref(*args, **kw),
                    f"window_agg {kw}"))
            p = dict(bucket_size=sz.bucket, cols=(0, 1),
                     assume_latest=assume_latest, **fr)
            errs["preagg_window"] = max(errs["preagg_window"], _max_err(
                ops.preagg_window(*ring, *tiers, key, rts, **p),
                ref.preagg_window_ref(*ring, *tiers, key, rts, **p),
                f"preagg_window {p}"))
        for inp, m in ((ring, None), (local, mask)):
            f = dict(spec_rows=(10, None, 100), spec_ranges=(None, 500.0,
                                                             None),
                     spec_fields=(("sum", "sumsq", "count", "last"),
                                  ("count", "min", "max", "first"),
                                  ("sum", "count", "max", "last")),
                     cols=(0, 1, 2), evt_mask=m, assume_latest=assume_latest)
            args = (*inp[:3], inp[3] if m is not None else key, rts)
            errs["fused_window"] = max(errs["fused_window"], _max_err(
                ops.fused_window(*args, **f), ref.fused_window_ref(*args, **f),
                f"fused_window mask={m is not None}"))
        j = dict(col_idx=(3, 0), assume_latest=assume_latest, with_ts=True)
        got = _as_dict(ops.last_join(*ring, key, rts, **j))
        want = _as_dict(ref.last_join_ref(*ring, key, rts, **j))
        if not assume_latest and bool(want["matched"].all()):
            raise AssertionError("no unmatched LAST JOIN in the cases")
        errs["last_join"] = max(errs["last_join"], _max_err(
            got, {k: v for k, v in want.items()}, f"last_join {j}"))
    return errs


def capture_calls(eng, reqs) -> Dict[str, tuple]:
    """The (args, kwargs) of each kernel call one B=500 batch of every
    deployment makes — the shapes the main path gives each kernel."""
    from repro_torch.kernels import ops
    calls: Dict[str, tuple] = {}
    originals = {k: getattr(ops, k) for k in KERNELS}

    def recorder(name):
        def rec(*a, **kw):
            calls.setdefault(name, (a, kw))
            return originals[name](*a, **kw)
        return rec

    try:
        for k in KERNELS:
            setattr(ops, k, recorder(k))
        for name in DEPLOYMENTS:
            keys, ts, rows = reqs[name]
            eng.request(name, keys, ts, rows=rows)
    finally:
        for k, fn in originals.items():
            setattr(ops, k, fn)
    return calls


def _call_ms(fn: Callable[[], object], reps: int, flush: torch.Tensor
             ) -> float:
    """Median wall time of one call as its caller sees it (host work
    included), CUDA events around it, L2 flushed before each."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn: Callable[[], object], reps: int) -> float:
    """Device time of one call: ``reps`` calls captured back to back in a
    CUDA graph, the median of 20 replays divided by ``reps``. No host work
    is inside the replay, so this is what the card spends."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def needed_bytes(name: str, a: tuple, kw: dict, out) -> int:
    """Bytes the call must move with this run's data: each needed input
    element read once (the windows' rows, the timestamps a bound scans,
    the buckets and the head/tail rows), each output written once."""
    from repro_torch.kernels import ref
    outs = list(out.values()) if isinstance(out, dict) else list(out)
    n = sum(t.numel() * t.element_size() for t in outs if t is not None)
    if name == "preagg_window":
        values, ts, total = a[0], a[1], a[2]
        req_key, req_ts = a[8], a[9]
    else:
        values, ts, total, req_key, req_ts = a[:5]
    B, C = req_key.shape[0], ts.shape[1]
    cols = kw.get("cols") or kw.get("col_idx") or range(values.shape[2])
    vo = len(tuple(cols))
    n += B * 12                                   # req_key, req_ts, total
    kl = req_key.long()
    t_rows, tot = ts[kl], total[kl]
    retained = torch.clamp(tot, max=C).long()
    al = kw.get("assume_latest", False)
    if name == "last_join":
        p1 = ref._upper_bound(t_rows, tot, ref._positions(t_rows, tot)[1],
                              req_ts, al)
        matched = p1 > torch.clamp(tot - C, min=0)
        n += int(matched.sum()) * (vo + 1) * 4
        return n + (0 if al else int(retained.sum()) * 4)
    specs = ([(kw["rows_preceding"], kw["range_preceding"])]
             if name != "fused_window"
             else list(zip(kw["spec_rows"], kw["spec_ranges"])))
    spans = torch.stack([
        (lambda p: p[1] - p[0])(ref.window_bounds(
            t_rows, tot, req_ts, rows_preceding=r, range_preceding=g,
            assume_latest=al)) for r, g in specs], 1).long()
    needs_ts = (not al) or any(r is None for r, _ in specs)
    if needs_ts:
        n += int(retained.sum()) * 4
    if name == "preagg_window":
        bsz = kw["bucket_size"]
        p0, p1 = ref.window_bounds(t_rows, tot, req_ts,
                                   rows_preceding=specs[0][0],
                                   range_preceding=specs[0][1],
                                   assume_latest=al)
        b0, b1 = (p0 + bsz - 1) // bsz, p1 // bsz
        nbk = torch.clamp(b1 - b0, min=0).long()
        raw = (p1 - p0).long() - nbk * bsz
        tier_fields = sum(f in kw["fields"]
                          for f in ("sum", "sumsq", "min", "max"))
        per_bucket = tier_fields * vo * 4 + (4 if "count" in kw["fields"]
                                             else 0)
        return n + int((nbk * per_bucket + raw * vo * 4).sum())
    span = spans.max(1).values                    # windows share p1
    n += int(span.sum()) * vo * 4
    if kw.get("evt_mask") is not None:
        n += int(span.sum())
    return n


def time_calls(calls: Dict[str, tuple], reps: int, device
               ) -> Dict[str, Dict[str, float]]:
    """Kernel vs plain version on each captured main-path call."""
    from repro_torch.kernels import ops, ref
    plain = {"window_agg": ref.window_agg_ref,
             "fused_window": ref.fused_window_ref,
             "preagg_window": ref.preagg_window_ref,
             "last_join": ref.last_join_ref}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    res = {}
    for name, (a, kw) in calls.items():
        kfn = getattr(ops, name)
        got, want = kfn(*a, **kw), plain[name](*a, **kw)
        err = _max_err(_as_dict(got), _as_dict(want), f"{name} main path")
        nbytes = needed_bytes(name, a, kw, got)
        res[name] = {
            "ms": _device_ms(lambda: kfn(*a, **kw), 20),
            "plain_ms": _device_ms(lambda: plain[name](*a, **kw), 20),
            "call_ms": _call_ms(lambda: kfn(*a, **kw), reps, flush),
            "plain_call_ms": _call_ms(lambda: plain[name](*a, **kw), reps,
                                      flush),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bytes": nbytes, "max_abs_err": err,
                     "batch": int(a[8 if name == "preagg_window" else 3]
                                  .shape[0])}
    return res


# ---------------------------------------------------------------------------
# CUDA engine vs CPU engine
# ---------------------------------------------------------------------------

def compare_frames(got, want, what: str, std_atol: float,
                   score_atol: float) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: columns {sorted(got)} != "
                             f"{sorted(want)}")
    for c in want:
        g = np.asarray(got[c], np.float64)
        w = np.asarray(want[c], np.float64)
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {c} shape {g.shape} != {w.shape}")
        if c.startswith(("__", "m_")) or any(
                x in c for x in ("max", "min", "cnt", "last")):
            ok, d = np.array_equal(g, w), float(np.abs(g - w).max(initial=0))
        else:
            atol = (score_atol if c == "score" else
                    std_atol if "std" in c else 1e-4)
            ok = np.allclose(g, w, rtol=2e-4, atol=atol)
            d = float(np.abs(g - w).max(initial=0))
        if not ok:
            raise AssertionError(f"{what}: column {c} differs (max abs "
                                 f"diff {d})")


def cuda_vs_cpu(sz: Sizes, device) -> None:
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.check_events, n_keys=sz.check_keys, n_features=4))
    engines = {}
    for dev in (device, "cpu"):
        eng = make_engine(dev, sz, sz.check_keys)
        eng.insert("events", keys.tolist(), ts.tolist(), rows)
        fill_merchants(eng, ts, sz)
        deploy_all(eng, scorer_params(rows, dev))
        engines[dev] = eng
    rng = np.random.default_rng(3)
    B = 64
    rk = rng.integers(0, sz.check_keys + 8, B)          # some unknown keys
    rts = (float(ts.max()) + 1.0 + np.arange(B)).astype(np.float32)
    rrows = rows[rng.integers(0, len(rows), B)]
    # STD cancels to ~0 on constant windows: allow sqrt(4·eps)·|mean|
    std_atol = 4e-4 * float(np.abs(rows[:, 0]).max())
    for name in DEPLOYMENTS:
        a = engines[device].request(name, rk.tolist(), rts.tolist(),
                                    rows=rrows)
        b = engines["cpu"].request(name, rk.tolist(), rts.tolist(),
                                   rows=rrows)
        if not np.array_equal(a.status, b.status) or a.all_ok:
            raise AssertionError(f"{name}: status differs or no unknown key")
        compare_frames(a, b, f"{name} online", std_atol, std_atol)
        oa = engines[device].query_offline(name)
        ob = engines["cpu"].query_offline(name)
        compare_frames(oa, ob, f"{name} offline", std_atol, std_atol)
        log(f"cuda==cpu {name}: online B={B} ({a.n_unknown} unknown keys), "
            f"offline {len(oa['__key'])} rows")
    for eng in engines.values():
        eng.close()


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import (fused_window, last_join, preagg_window,
                                     window_agg)
    mods = {"window_agg": window_agg, "fused_window": fused_window,
            "preagg_window": preagg_window, "last_join": last_join}
    return {k: m.launches for k, m in mods.items()}


def reset_launch_counts() -> None:
    from repro_torch.kernels import (fused_window, last_join, preagg_window,
                                     window_agg)
    for m in (window_agg, fused_window, preagg_window, last_join):
        m.launches = 0


def request_batches(keys, ts, rows, B: int, n: int, seed: int):
    """Batches of in-flight transactions: a sampled event's key and row,
    at a fresh request time (the online path runs with assume_latest)."""
    rng = np.random.default_rng(seed)
    t_max = float(ts.max())
    for i in range(n):
        idx = rng.integers(0, len(keys), B)
        yield (keys[idx], np.full(B, t_max + 1.0 + i, np.float32),
               rows[idx])


def serve(eng, keys, ts, rows, sz: Sizes, device) -> Dict[str, dict]:
    report = {}
    for name in DEPLOYMENTS:
        for B in sz.batches:
            lat: List[float] = []
            t0 = time.perf_counter()
            for rk, rts, rr in request_batches(keys, ts, rows, B,
                                               sz.n_batches, seed=B):
                t1 = time.perf_counter()
                fr = eng.request(name, rk, rts, rows=rr)
                lat.append(time.perf_counter() - t1)
                if not fr.all_ok:
                    raise AssertionError(f"{name}: a known key came back "
                                         f"with status != OK")
                for c, v in fr.items():
                    if v.shape[0] != B or not np.isfinite(v).all():
                        raise AssertionError(f"{name}: column {c} is not "
                                             f"finite of length {B}")
            wall = time.perf_counter() - t0
            ms = np.asarray(lat) * 1e3
            report[f"{name}/B={B}"] = {
                "requests_per_s": B * sz.n_batches / wall,
                "batch_p50_ms": float(np.percentile(ms, 50)),
                "batch_p99_ms": float(np.percentile(ms, 99))}
            log(f"serve {name} B={B}: {B * sz.n_batches / wall:.1f} req/s, "
                f"batch p50 {np.percentile(ms, 50):.4f} ms, "
                f"p99 {np.percentile(ms, 99):.4f} ms")
    return report


def device_busy(eng, keys, ts, rows, sz: Sizes, report: Dict[str, dict]
                ) -> Dict[str, dict]:
    """Device time per batch from a torch.profiler trace of 20 batches
    (B = the largest batch size) of each deployment, and its share of the
    unprofiled batch p50 from the serve phase."""
    from torch.profiler import ProfilerActivity, profile
    B, n = sz.batches[-1], 20
    out = {}
    for name in DEPLOYMENTS:
        batches = list(request_batches(keys, ts, rows, B, n, seed=99))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for rk, rts, rr in batches:
                eng.request(name, rk, rts, rows=rr)
        per_kernel: Dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                      + e.time_range.elapsed_us())
        dev_ms = sum(per_kernel.values()) / 1e3 / n
        p50 = report[f"{name}/B={B}"]["batch_p50_ms"]
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"device_ms_per_batch": dev_ms,
                     "busy_share_of_p50": dev_ms / p50 if dev_ms else None,
                     "device_events": len(per_kernel)}
        if not dev_ms:
            log(f"busy {name} B={B}: the profiler recorded no device "
                f"events; device time not measured")
            continue
        log(f"busy {name} B={B}: device {dev_ms:.5f} ms per batch = "
            f"{dev_ms / p50:.4f} of the batch p50; top: " + "; ".join(
                f"{k[:60]} {v / 1e3 / n:.5f} ms" for k, v in top))
    return out


def run(device, sz: Sizes) -> Dict[str, object]:
    """All phases on ``device``; raises on any failure."""
    from repro_torch.data.synthetic import EventStreamConfig, generate_events

    # ---- setup: one node at production key space --------------------------
    eng = make_engine(device, sz, sz.keys)
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.events, n_keys=sz.keys, n_features=4, seed=0))
    t0 = time.perf_counter()
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    if device != "cpu":
        torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    fill_merchants(eng, ts, sz)
    table = eng.tables["events"]
    log(f"ingest: {sz.events} events in {ingest_s:.3f} s = "
        f"{sz.events / ingest_s:.1f} events/s; {table.n_keys} keys used of "
        f"{sz.keys}; table state {table.memory_bytes() / 2**30:.3f} GiB")
    deploy_all(eng, scorer_params(rows, device))
    for name in DEPLOYMENTS:
        log(eng.explain(name))

    # ---- kernels against their plain versions -----------------------------
    snap = table.snapshot()
    errs = kernel_cases(snap.state, snap.preagg, sz, table.n_keys,
                        float(ts.max()), device)
    log(f"kernel checks passed; max abs diff per kernel: {errs}")
    reqs = {name: next(request_batches(keys, ts, rows, sz.timing_batch, 1,
                                       seed=17))
            for name in DEPLOYMENTS}
    timing = time_calls(capture_calls(eng, reqs), sz.reps, device)
    for k, v in timing.items():
        errs[k] = max(errs[k], v["max_abs_err"])
        log(f"time {k} (B={v['batch']}): device per launch: kernel "
            f"{v['ms']:.6f} ms, plain {v['plain_ms']:.6f} ms, bound "
            f"{v['bound_ms']:.6f} ms ({v['bytes']} bytes); per call with "
            f"host work: kernel {v['call_ms']:.5f} ms, plain "
            f"{v['plain_call_ms']:.5f} ms")

    # ---- the CUDA engine against the CPU engine ---------------------------
    cuda_vs_cpu(sz, device)

    # ---- the main path ----------------------------------------------------
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats0 = eng.stats.snapshot()
    report = serve(eng, keys, ts, rows, sz, device)
    launches = launch_counts()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    stats = {k: v - stats0[k] for k, v in eng.stats.snapshot().items()}
    log(f"main path launches: {launches}; peak device memory {peak} bytes; "
        f"engine stats over the serve phase: {stats}")
    busy = device_busy(eng, keys, ts, rows, sz, report) \
        if device != "cpu" else {}
    eng.close()
    kernels = [{
        "name": k, "route": "cuda", "source": KERNELS[k][0],
        "replaces": KERNELS[k][1], "launches": launches[k],
        "max_abs_err": errs[k], "ms": timing[k]["ms"],
        "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "call_ms": timing[k]["call_ms"],
        "plain_call_ms": timing[k]["plain_call_ms"]} for k in KERNELS]
    return {"kernels": kernels, "serve": report, "ingest_s": ingest_s,
            "peak_bytes": peak, "engine_stats": stats, "busy": busy}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this script runs the port "
              "on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"kernel build: {_build.build_seconds():.3f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    res = run("cuda", Sizes())
    log(json.dumps({k: res[k] for k in ("serve", "ingest_s", "peak_bytes",
                                        "engine_stats", "busy")}))
    log(card)
    log(json.dumps({"kernels": res["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
