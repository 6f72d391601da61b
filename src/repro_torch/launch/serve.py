"""End-to-end serving run: the paper's online mode on one device.

Pipeline (paper Figure 4/5): synthetic event stream -> feature tables ->
deployed SQL window queries -> real-time feature vectors; ``--decode``
adds LM token generation with a reduced assigned architecture through
``ModelServer`` (``--arch``: any registered config — dense, MoE, Mamba-2,
the jamba hybrid, qwen2-vl's backbone on tokens, and the seamless-m4t
encoder-decoder over stub audio frames; attention layers prefill through
the flash-attention kernel and decode through the decode-attention
kernel).

Reports the paper's headline metrics: QPS, latency percentiles, and the
L = L_parse + L_plan + L_exec decomposition.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 2000 \\
        --batch 64 [--decode] [--device cpu]

Runs on the CUDA card by default; ``--device cpu`` takes the kernels'
plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags
from repro_torch.data.synthetic import (EventStreamConfig, generate_events,
                                        request_stream)
from repro_torch.featurestore.table import TableSchema
from repro_torch.launch.steps import init_params
from repro_torch.models.frontend import stub_audio_frames
from repro_torch.serving.server import ModelServer

FEATURE_SQL = """
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
WINDOW w1 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 10 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY user ORDER BY ts
              ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""


def build_engine(n_events: int, n_keys: int, *,
                 flags: OptFlags = OptFlags(), device="cuda") -> Engine:
    eng = Engine(flags, device=device)
    schema = TableSchema("events", key_col="user", ts_col="ts",
                         value_cols=("amount", "lat", "lon", "cat",
                                     "drift", "drift2"))
    eng.create_table(schema, max_keys=n_keys, capacity=1024, bucket_size=64)
    ev = EventStreamConfig(n_events=n_events, n_keys=n_keys, n_features=6)
    keys, ts, rows = generate_events(ev)
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    eng.deploy("fraud_features", FEATURE_SQL)
    return eng


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64,
                    help="client-side request batch size")
    ap.add_argument("--events", type=int, default=20000)
    ap.add_argument("--keys", type=int, default=256)
    ap.add_argument("--decode", action="store_true",
                    help="also run LM decode on top of the features")
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    eng = build_engine(args.events, args.keys, device=args.device)
    ev = EventStreamConfig(n_events=args.events, n_keys=args.keys)
    keys, ts, rows = generate_events(ev)

    # ---- warm the plan cache (paper: compile charged to first request) ----
    warm = eng.request("fraud_features", keys[:args.batch].tolist(),
                       (ts[:args.batch] + 1e4).tolist())
    n_feat = len(warm)

    # ---- replay the online workload ---------------------------------------
    lat: List[float] = []
    n_served = 0
    t_start = time.perf_counter()
    for ks, rts in request_stream(keys, ts, batch=args.batch,
                                  n_batches=args.requests // args.batch):
        t0 = time.perf_counter()
        eng.request("fraud_features", ks.tolist(), rts.tolist())
        lat.append(time.perf_counter() - t0)
        n_served += len(ks)
    wall = time.perf_counter() - t_start
    lat_ms = np.asarray(lat) * 1e3 / args.batch      # per request amortised
    batch_ms = np.asarray(lat) * 1e3

    report = {
        "device": str(eng.device),
        "qps": n_served / wall,
        "latency_ms_per_request_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_per_batch_p50": float(np.percentile(batch_ms, 50)),
        "latency_ms_per_batch_p99": float(np.percentile(batch_ms, 99)),
        "n_features": n_feat,
        "decomposition": eng.latency_decomposition(),
    }
    eng.close()

    if args.decode:
        cfg = reduced(get_config(args.arch))
        gen = torch.Generator(device=eng.device).manual_seed(0)
        params = init_params(gen, cfg)
        srv = ModelServer(cfg, params, batch=8, cache_len=64)
        prompt = np.ones((4, 8), np.int32)
        frames = None
        if cfg.is_encdec:
            frames = stub_audio_frames(
                torch.Generator(device=eng.device).manual_seed(1), cfg, 4,
                n_frames=srv.enc_len)
        slots = srv.prefill(prompt, frames)
        _sync(eng.device)
        t0 = time.perf_counter()
        srv.decode(steps=16)
        _sync(eng.device)
        report["decode_tokens_per_s"] = 4 * 16 / (time.perf_counter() - t0)
        report["decode_arch"] = cfg.name
        report["decode_tokens"] = [srv.generated[s] for s in slots]
        srv.release(slots)

    print(json.dumps(report, indent=2))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
