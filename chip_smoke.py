#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (feature engine and model server) on one
NVIDIA GPU.

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
   ``rtol 2e-4`` for sum/sumsq; all four also at the edges of their
   warp-per-request design and with 17 specs and 65 columns, more than
   one launch takes (``window_cases``); then times each kernel and its
   plain version on every call the main path makes at B=500 and B=100
   (each deployment's calls in order) and on the point-in-time calls of
   ``query_offline``'s first batch: device time per launch (a CUDA graph
   of 20 calls, median of 20 replays) and time per call with host work
   (CUDA events, median of 30, L2 flushed);
5. holds a ``device="cuda"`` engine against a ``device="cpu"`` engine on
   the same 20,000 events: ``request`` (B=64) and ``query_offline`` give
   equal FeatureFrames; the same for a deployment of 17 raw-scan windows
   over 65 columns;
6. the live path at that size, card against CPU: both engines take the
   same disordered stream through ``attach_stream`` (0.5 reorder window,
   20 ms flushes of up to 2048 events, a TTL that compacts), then
   redeploy serve_features with a 5-row w1, canary the original at 0.5,
   promote and roll back, and serve every deployment batched, pooled (4
   workers) and per row; asserts the same version sequence, equal frames
   between the engines and between the modes, ``online_offline_consistency``
   and ``verify_preagg`` after the compaction; and their freshness
   snapshots equal and drift sketches equal (bit for bit where the
   frames are exact) after serving the same requests;
7. drives the feature main path: 200 batches of 100 and 200 of 500
   requests on each deployment, asserting OK status, finite outputs and
   that every kernel's launch counter rose, and prints requests/s and
   batch p50/p99;
8. at full size on the same engine, control and observability: the
   tracer at rate 0 and 1.0 (each traced batch an ``engine.serve`` root
   whose kernel spans sum to its exec seconds), EXPLAIN ANALYZE of the
   three deployments beside the kernels' device ms, freshness and drift,
   the 256th buffered batch's fold, a ControlPlane ticking on real
   traffic (its fitted cost model, and no device work in its collectors),
   a forced re-plan of serve_features to the raw-scan plan under a
   serving thread (no failed request, no mixed version, ``fused_window``
   launching where ``window_agg`` and ``preagg_window`` did, frames equal
   to a CPU engine's on that plan; the health gate's wall-clock decision
   printed, not asserted), a latency SLO alerting with the flight
   recorder's dump, and the registry's Prometheus text; then the execution modes (batched, pooled,
   per row; B=100) with their batch p50/p99; a hot swap of serve_features
   under a serving thread (build+warm ms, the first new batch against the
   p50, no mixed versions, no plan-cache miss); a stream attached to the
   21 GiB table replayed off, at 1,000 events/s and unpaced while
   serve_features and fraud_scored take 200 batches of 500 (batch p50/p99,
   events made visible, flushes, flush ms, peak device memory; three
   copy-on-write inserts time one flush's copy first); and
   ``FeatureServer`` with 6, then 12 client threads of single-row requests
   while ``FeatureServer.ingest`` streams events (per-request p50/p99, QPS,
   mean batch). Each of these paths resets the launch counters before it
   runs and asserts after it that its kernels launched;
9. with that engine closed, the same node on four shards of the card
   (``repro_torch.shard.ShardedEngine``; ``merchants`` replicated): the
   same events through ``ShardedEngine.insert`` (load seconds and its
   copy-on-write clones), frames of fixed B=100 and B=500 request sets
   bit-identical to the unsharded engine's (captured right after step
   7) and ``query_offline`` equal after sorting by (key, ts); batch
   p50/p99 at B=100 and B=500 beside the unsharded ones, launches per
   batch (= dispatches x the plan's launches), the shard engines' own
   serve and exec ms, the coalescing wait's share and the device's busy
   share; ``add_shard`` then ``remove_shard(0)`` under a serving thread
   (every batch wholly served or wholly shed, never raised; every served
   row bit-identical to the reference, keys that wrapped their rings
   included, during the reshard and after it; the card's allocated
   memory falls by at least 6 GiB across ``remove_shard(0)`` while a
   handle is kept); merged freshness, one traced request's tree across
   admission, router lanes and shard engines and EXPLAIN ANALYZE merged
   over the shards; a FeatureServer round of 6 clients; peak device
   memory;
10. with that engine closed too, the same node on four worker processes
   (``ShardedEngine(backend="process")``, one warm standby, a WAL dir):
   spawn seconds and the workers' pids, load seconds against the clone
   bound with the card's peak memory in use (``mem_get_info``, every
   process's), frames and ``query_offline`` against the unsharded
   engine's, batch p50/p99 at B=100 and B=500 beside the in-process
   sharded and unsharded ones, the workers' launch counters (zeroed
   before, read after), one traced request whose workers' spans nest in
   their lanes, ``add_shard`` (the standby adopted) then
   ``remove_shard(0)`` under a serving thread, a worker SIGKILLed under
   that thread (every batch returns, wholly SHED, or OK rows equal to the
   reference and DEGRADED rows equal in every column, ``score``
   included, to their keys' last fresh rows; ready time; then the killed
   shard's bulk-loaded keys UNKNOWN_KEY, the rest equal); at check size, 2 workers fed through a
   ShardedPipeline with a WAL, SIGKILLed under traffic with and without
   a standby (MTTR; frames bit-identical to a never-killed card engine;
   a ControlPlane tick reports ``recovering``), and the seeded fault
   plan ``seed=1337,drop=0.01,dup=0.02,corrupt=0.01`` over 200 batches
   (all OK and equal, retries and corrupt frames in the registry's
   ``transport`` group); no worker outlives the phase and the card's
   memory comes back within 1 GiB;
11. the paper's baseline execution models (``repro_torch.core.baselines``)
   over the same 2,000,000 events and benchmarks/common.py's
   FEATURE_SQL, one full-size engine per flag set in turn: every profile
   within 1e-3 of ``openmldb`` on fixed B=100 requests, batch p50/p99
   and requests/s at B=100 and B=500 (the row interpreter over 3 B=100
   batches), the full scan at check size (20,000 events, 256 keys),
   card == CPU for every profile there, and openmldb's requests/s over
   each baseline's beside the paper's Table 1 ratios; its feature
   kernels' launches counted;
12. training on the card: qwen2-1.5b at full width, 2 layers, f32, card
   against CPU (loss within 1e-4, gradients within 1e-4 relative L2, one
   AdamW step within 1e-5); at full width and depth (bf16, remat
   ``dots``), 4 × 512 tokens, 10 steps on one batch: a falling finite
   loss, no skipped step, the flash kernel launched inside its autograd
   Function and its backward kernel once a layer a step; step p50,
   tokens/s, the model-FLOPs share of the bf16 peak, peak memory and a
   profiled step's device time; on the first flash call of that run, the
   backward kernel held to the plain backward and to autograd of the
   plain version in f32 and timed beside that plain recompute,
   ``scaled_dot_product_attention``'s backward and its bound; a 2-layer checkpointed
   resume bit for bit; ``python -m repro_torch.launch.train --reduced
   --steps 5`` on its default device;
13. holds the two attention kernels against their plain versions, bf16 and
   f32 (MHA/GQA/MQA; causal, windowed and full; Sq < Sk and ragged
   lengths, query counts around the 64-row tiles; decode in prefix mode
   with and without a window, at lengths around its split edges, past
   the cache, and in ring mode past the window; and the families' head
   shapes: 24/8 heads of 64 (granite), 32/8 and 28/4 of 128 over 1,088
   rows (jamba, qwen2-vl), mixtral's 48/8 of 128 in a 4096-slot ring
   past its window, the mesh phases' local heads (6/1 of 128, 12/4 of
   64, 24/4 of 128 in a 72-slot ring, 16/4 of 128 over 320 and 328
   rows, 14/2 of 128 rotated by M-RoPE), and seamless's 16/16 of 64 at the
   ``encdec`` phase's
   shapes: flash non-causal at Sq > Sk, 64 over 1024 and 1024 over 1024,
   the decoder's and the training calls, decode over 1024 rows at every
   length 1024 and at 65-93): ``rtol = atol = 2e-2`` in bf16, ``2e-5``
   in f32; the flash backward kernel at the same tolerances on the
   training calls of the families, seamless and the mesh phases;
14. holds ``ModelServer`` for qwen2-1.5b on the card against the same
   server on the CPU (full width, 2 layers, the same seeded parameters;
   2 prompts of 64 tokens, 8 teacher-forced steps): f32 logits within
   ``1e-4`` with equal greedy tokens, bf16 logits within a relative L2 of
   ``2e-2``;
15. drives the model main path: ``ModelServer`` for qwen2-1.5b at full
   width and depth (bf16, random seeded weights), 16 slots, a 1024-long
   cache: 8 prompts of 512, 32 decode steps, 8 prompts of 384, 128 decode
   steps; asserts finite logits and that both attention kernels' launch
   counters rose; prints prefill ms per admission, decode step p50/p99,
   tokens/s, peak device memory and the device-busy share of one decode
   step; then times each attention kernel, its plain version and
   ``scaled_dot_product_attention`` on the main path's arguments;
16. runs ``python -m repro_torch.launch.serve --decode`` with its defaults;
17. the other decoder-only families (``families``, about 300 s; each
   model freed before the next): card against CPU in f32 (mamba2-780m,
   granite-moe-3b-a800m and qwen2-vl-7b at full width, 2 layers, the
   last with 256 patch embeddings; jamba's period of 8 at d_model 512
   with its 16 experts top-2; mixtral at reduced width, a 4090-token
   prompt decoded past its 4096 window): logits within ``1e-4``, greedy
   tokens and every router's chosen experts equal, a training loss
   within ``1e-4`` and gradients within ``1e-4`` relative L2; then each
   served at full width in bf16 with seeded random weights (jamba one
   period of 8 with 8 slots, mamba2-780m at full depth with 16 slots,
   granite at full depth with 16 slots, qwen2-vl at full depth through
   ``make_prefill_step`` with 1,024 patch embeddings ahead of 64 tokens
   for 4 sequences, mixtral 2 layers with 4 slots past its window):
   prefill ms, decode step p50/p99, tokens/s, the device's busy share of
   a step, peak memory, ``moe_drop_frac``, and flash and decode launches
   equal to its attention layers times the calls (none for mamba2, whose
   cache bytes do not grow with ``cache_len``); then mamba2-780m (full
   depth) and granite (8 of 32 layers) trained 10 steps on 4 x 512
   tokens in bf16: a falling loss, no skipped step, the MoE losses in the
   metrics, step p50, tokens/s, the model-FLOPs share of the bf16 peak
   over active parameters, peak memory and one backward launch a layer a
   step;
18. the encoder-decoder and the pod axis (``encdec``, about 150 s):
   seamless-m4t-medium at full width with 2 + 2 layers in f32, card
   against CPU (ModelServer over 256 frames, 2 prompts of 32 tokens, 8
   teacher-forced steps: logits within ``1e-4``, equal greedy tokens; the
   loss within ``1e-4`` and gradients within ``1e-4`` relative L2); at
   full width and depth in bf16, ModelServer with 8 slots, a 1024-long
   cache and 1024 frames a slot (8 prompts of 64, 32 decode steps:
   prefill ms, step p50/p99, tokens/s, busy share, peak memory; flash
   launches 12 encoder + 12 self + 12 cross a prefill and decode launches
   12 self + 12 cross a step, asserted) and a TrainLoop on
   ``make_batches`` (4 x 512 tokens over 512 frames, 10 steps: finite
   losses, step p50, tokens/s, the model-FLOPs share, 36 flash and 36
   backward launches a step); then the int8-compressed train step of reduced qwen1.5-0.5b
   on a one-rank NCCL group's (1, 1, 1) CUDA mesh over ("pod", "data",
   "model"): the round trip within half a quantization step and not the
   identity, the step AdamW of it, its first step within what the int8
   error allows of the plain step's, and held to the CPU port's steps on
   a one-rank gloo mesh;
19. the sharded path (``mesh``, about 150 s): 4 processes share the card
   as a (2, 2) mesh over ("data", "model"), talking over gloo (NCCL
   takes one rank a device; DTensor's functional collectives on CUDA
   tensors go through ``repro_torch.distributed.gloo_cuda``), each
   holding only its shards of qwen2-1.5b at full width, 2 layers:
   ``TrainLoop(mesh=)`` 2 steps in f32 against the meshless loop on the
   card (losses within 1e-5 relative, parameters within 1e-4 relative
   L2), each rank's parameter and optimizer bytes as
   ``memory_allocated`` measures them beside the specs' share, the
   prefill and decode bundles against ``ModelServer``, teacher-forced,
   in f32 (every greedy token equal) and bf16 (logits' relative L2; a
   greedy token may differ only at a near-tie), the flash and decode
   kernels' launches on each rank's local heads, the JAX package's
   streaming layout (``act_dp`` ("data",), ``act_sp`` "model": 2
   training steps and the f32 prefill with every head on every rank and
   the flash kernel on each rank's half of the rows at its ``q_offset``,
   against the same meshless references; ``mesh_cp_check``, about 25
   s), and a reduced
   checkpoint saved on the world restored onto the meshless loop bit
   for bit; each rank's first training step runs under the dry run's
   ``StepCounter`` (its collective bytes by kind and mesh axis) with
   the peak reset before it (``max_memory_allocated``), and each rank's
   state bytes asked of the allocator are kept, for step 23;
20. the MoE families on that world (``mesh_moe``, a budget of 240 s, the
   same 4 processes): granite-moe-3b-a800m at full width, 2 of 32
   layers, ``TrainLoop(mesh=)`` 2 steps of 4 x 128 tokens in f32 at
   ``moe_groups=2`` (one group a data rank: EP's all-to-all, 20 experts
   a data rank) against the meshless loop on the card (losses and
   gradient norms within 1e-5 relative, parameters within 1e-4 relative
   L2), its per-rank state bytes beside the specs' share; granite in f32
   and bf16 and mixtral-8x22b at full width, 1 of 56 layers, in bf16
   served by the bundles at ``moe_groups=0`` against ``ModelServer`` as
   in step 19; the bytes the MoE layers hand their exchanges and the
   attention launches by rank printed, the launches asserted;
21. the SSD scan and the vision frontend on that world (``mesh_families``,
   a budget of 300 s, the same 4 processes), at full width:
   mamba2-780m (48 SSD heads of 64, d_state 128, d_proj 6448, conv_ch
   3328; 2 of 48 layers) ``TrainLoop(mesh=)`` 2 steps of 4 x 320 tokens
   in f32 (320 crosses the 256-row chunk and pads its tail) and
   qwen2-vl-7b (1 of 28 layers) 2 steps of 4 x (256 patch embeddings +
   64 tokens) in f32 at lr 1e-5, each against the meshless loop on the
   card (losses and gradient norms within 1e-5 relative, parameters
   within 1e-4 relative L2; where the meshless loop's own spread from a
   1e-7 start moves a later gradient norm by more than 1e-6, that step's
   norm is held at the parameters the mesh reached; each rank's state
   bytes asked of the allocator within 4 KiB of the specs' share);
   mamba2 served in f32 and bf16 and
   jamba-v0.1-52b (one period of 8 of 32 layers, about 26.5 GB in bf16,
   its shards drawn by one rank at a time) in bf16 by the bundles
   against ``ModelServer``, qwen2-vl in bf16 over its patch embeddings
   against the meshless prefill and serve steps, 4 prompts and 4
   teacher-forced steps each, as in step 19 (a bf16 case within 2e-2,
   or within its meshless run's own distance from an f32 twin where
   that is larger: jamba, whose top-2-of-16 routings flip under the
   mesh's rounding; the flipped routings printed); the card's bytes in
   use, and the attention launches by rank printed and asserted;
22. the encoder-decoder on a second (2, 2) world (``mesh_encdec``, a
   budget of 100 s, 4 more processes, beside those of steps 19-21):
   seamless-m4t-medium at full width (8 of its 16 heads of 64 a model
   rank, its 256,206 vocab rows 128,103 a model rank), 2 + 2 of 12 +
   12 layers, ``TrainLoop(mesh=)`` 2 steps of 4 x 128 tokens over 256
   frames in f32 at lr 1e-5 against the meshless
   loop on the card (losses and gradient norms within 1e-5 relative,
   parameters within 1e-4 relative L2, each rank's state bytes asked of
   the allocator within 4 KiB of the specs' share); served in f32 and
   bf16 by the prefill and decode bundles, 4 prompts of 64 over 1024
   frames and 4 teacher-forced steps, the encoder output a server keeps
   from ``make_prefill_step(with_enc_out=True)`` placed by the ``enc_out``
   spec, against ``ModelServer`` as in step 19 (f32: every greedy token
   equal; bf16: within 2e-2); the attention launches by rank printed and
   asserted;
23. the dry run (``dryrun``, a budget of 90 s on one host core at the
   lowest priority, run beside steps 15-18 and joined before step 19):
   ``repro_torch.launch.dryrun.run_cell``, one subprocess running a
   cell after another, on fake CUDA tensors for the ``train``
   phase's main path (no mesh), the ``mesh`` phase's training on a fake
   (2, 2) world, qwen2-1.5b ``train_4k`` and mixtral-8x22b ``decode_32k``
   on a fake (16, 16) pod; held to the card: the (2, 2) cell's argument
   bytes within 4 KiB of each mesh rank's state bytes asked of the
   allocator plus its share of the batch, its collective bytes by kind
   equal to those the dry run's counter read on rank 0's first training
   step, its predicted peak (arguments + temporaries) within 15 % of
   each rank's first-step ``max_memory_allocated``, and the no-mesh
   cell's within 15 % of the ``train`` phase's peak (reset after the
   loop is built); the pod cells' fit, dominant term and three terms
   printed (datasheet figures: computed, not measured).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before doing anything.

    python3 chip_smoke.py --calls

runs only step 3, the timing of step 4 (every main-path call at B=500
and B=100, and the point-in-time calls of ``query_offline``'s first
batch) and the serve phase of step 7 on an engine with the default
flags, and prints the card and ``{"calls": [...], "serve": {...}}``: the
quick way to time two trees of the kernels and of the request path
against each other in one run.

    python3 chip_smoke.py --train

runs only step 12's full-depth main path and prints the card and
``{"train": {...}}`` (step p50, first step, peak): the same for two
trees of the training step.

    python3 chip_smoke.py --decode

runs only step 15's main path (qwen2-1.5b served at full depth, its
admissions and decode steps) and prints the card and ``{"decode":
{...}}`` (decode step p50 and p99, the device's busy share): the same
for two trees of the decode step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

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
    mode_batch: int = 100        # execution modes at full size
    mode_batches: int = 50       # batched and pooled
    row_batches: int = 20        # per-row
    swap_batches: int = 50       # hot swap: batches before and after
    stream_events: int = 300_000  # streamed past the table's newest event
    stream_window_s: float = 3.0  # serving window per ingest rate
    stream_batches: int = 200    # per ingest rate, at least
    server_events: int = 20_000  # of those, for FeatureServer.ingest
    server_clients: tuple = (6, 12)   # the paper's 6-12 parallel requests
    server_requests: int = 200   # per client
    obs_batches: int = 100       # traced and untraced, each (B=500)
    plane_batches: int = 800     # the control plane on real traffic
    plane_every: int = 50        # batches per tick (8 ticks to a fit)
    flip_batches: int = 16       # the health gate's batches after a swap
    shards: int = 4              # the sharded fraud node
    shard_batches: int = 100     # per deployment and batch size
    shard_server_requests: int = 100   # per client, 6 clients
    proc_batches: int = 100      # process node: per deployment, batch size
    fault_batches: int = 200     # process node: under the fault plan
    baseline_batches: int = 30   # baselines: per profile and batch size
    baseline_row_batches: int = 3      # the row interpreter, B=100
    baseline_fullscan_batches: int = 3  # the full scan, at check size


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

# the paper's execution modes (Fig. 2 axes) are engine flags; an engine
# made by make_engine with workers=4 owns a pool of 4 workers and serves
# batched until set_mode selects another mode
MODES = {"batched": dict(parallel_workers=1, vectorized=True),
         "pooled": dict(parallel_workers=4, vectorized=True),
         "per_row": dict(parallel_workers=1, vectorized=False)}


def set_mode(eng, mode: str) -> None:
    eng.flags = dataclasses.replace(eng.flags, **MODES[mode])


def make_engine(device, sz: Sizes, keys: int, workers: int = 1):
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    from repro_torch.featurestore.table import TableSchema
    eng = Engine(OptFlags(parallel_workers=workers), device=device)
    if workers > 1:
        set_mode(eng, "batched")
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


def fraud_scorer(p, feats):
    """PREDICT's logistic scorer over standardised features. Its dot
    product is summed column by column, so a row's score does not depend
    on the batch it came in: a matrix product's rounding does (the BLAS
    picks its blocking by shape), and a sharded node serves each row in a
    sub-batch of another size than the unsharded one. A module-level
    function, so a process-backend worker can import it by name."""
    mu, sd, w, b = p
    z = (feats - mu) / sd * w
    acc = b + z[:, 0]
    for j in range(1, z.shape[1]):
        acc = acc + z[:, j]
    return torch.sigmoid(acc)


def deploy_all(eng, model_params, scorer=fraud_scorer) -> None:
    """The three deployments; PREDICT scores with ``scorer`` and seeded
    random weights (``scorer_params``)."""
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


def score_atol(rows: np.ndarray, std_atol: float) -> float:
    """The PREDICT score's tolerance: the STD feature's, through the
    scorer (standardised by its sd, a sigmoid of slope at most 0.25);
    every other input is exact or within the score's own rtol."""
    _, sd, w, _ = scorer_params(rows, "cpu")
    i = FRAUD_FEATURES.index("amt_std_10")
    return 0.25 * abs(float(w[i])) / float(sd[i]) * std_atol


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


def kernel_cases(state, preagg, merchants, sz: Sizes, n_keys: int,
                 t_max: float, device) -> Dict[str, float]:
    """Every kernel against its plain version over the coverage cases.
    Returns the largest absolute difference per kernel."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(5)
    B = sz.timing_batch
    total = state.total.cpu().numpy()
    hot = np.argsort(-total[:n_keys])[:B // 8]              # wrapped rings
    cold = rng.integers(0, n_keys, B // 2)                  # mostly unwrapped
    empty = rng.integers(n_keys, state.max_keys, B - len(hot) - len(cold))
    keys = rng.permutation(np.concatenate([hot, cold, empty])
                           ).astype(np.int32)
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
    mask = mask_of(local[0])
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
    oor = key.clone()                       # out-of-range keys: empty rings
    oor[[0, 5, 32, 100]] = torch.tensor([-1, state.max_keys,
                                         state.max_keys + 7, -5],
                                        dtype=torch.int32, device=device)
    plain_key = torch.where(oor == key, key, torch.full_like(key,
                                                             int(empty[0])))
    for k, e in window_cases(state, preagg, merchants, sz, oor, plain_key,
                             fresh, past, device).items():
        errs[k] = max(errs[k], e)
    return errs


def window_cases(state, preagg, merchants, sz: Sizes, key, plain_key, fresh,
                 past, device) -> Dict[str, float]:
    """All four feature kernels against their plain versions at the edges
    of the warp-per-request design: batches of 1, 31, 33 and 499 requests
    (ragged blocks), out-of-range keys (``key``; the plain version gets an
    empty key there, ``plain_key``) among empty and wrapped ones, fresh and
    point-in-time requests; window_agg and fused: ROWS 0, 1, 31, 32, 33,
    100 and 1023 beside RANGE frames, the table's aligned four columns and
    the batch's rows with a derived fifth column (4-byte column loads),
    with and without a WHERE mask, 64 and 65 columns, and fused 16 and 17
    specs (65 columns and 17 specs take more than one launch); preagg:
    every window shape of ``preagg_window.SHAPES``, one to 65 columns;
    last_join: the events ring (capacity 1024, wrapped) and the merchants
    ring (capacity 64), 2 to 65 columns, unmatched requests. Returns the
    largest absolute difference per kernel."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.preagg_window import SHAPES, window_split
    every = ("sum", "sumsq", "count", "min", "max", "first", "last")
    edge = dict(spec_rows=(0, 1, 31, 32, 33, 100, 1023, None),
                spec_ranges=(None,) * 7 + (500.0,),
                spec_fields=tuple(every[i % 7:] + every[:i % 3]
                                  for i in range(8)))
    rows17 = tuple(None if i % 4 == 3 else 1 + 63 * i for i in range(17))
    many = [dict(spec_rows=rows17[:n],
                 spec_ranges=tuple(40.0 * (i + 1) if r is None else None
                                   for i, r in enumerate(rows17[:n])),
                 spec_fields=tuple(every[:1 + i % 7] if i % 2 else
                                   every[i % 7:] for i in range(n)))
            for n in (16, 17)]
    frames = ([dict(rows_preceding=r) for r in (0, 1, 31, 32, 33, 100, 1023)]
              + [dict(range_preceding=500.0)])
    cols64 = tuple((3 * i) % 4 for i in range(64))
    cols65 = tuple((3 * i + 1) % 4 for i in range(65))
    ring = (state.values, state.ts, state.total)
    ring_mask = mask_of(state.values)
    mring = (merchants.values, merchants.ts, merchants.total)
    errs = {k: 0.0 for k in KERNELS}
    shapes: set = set()
    tiers = (preagg.sum, preagg.sumsq, preagg.min, preagg.max, preagg.count)
    for B in (1, 31, 33, 499):
        kb, kp = key[:B], plain_key[:B]
        lk = kp.long()
        lv = state.values[lk]
        local = (torch.cat([lv, lv[..., :1] * lv[..., :1]], -1).contiguous(),
                 state.ts[lk].contiguous(), state.total[lk].contiguous())
        lkey = torch.arange(B, dtype=torch.int32, device=device)
        mask = mask_of(lv)
        for al, rts in ((True, fresh[:B]), (False, past[:B])):
            inputs = ((ring, kb, kp, None, (0, 1, 2, 3)),
                      (ring, kb, kp, None, cols64),
                      (ring, kb, kp, ring_mask, cols65),
                      (local, lkey, lkey, mask, (4, 0, 2)),
                      (local, lkey, lkey, None, tuple(i % 5
                                                      for i in range(64))),
                      (local, lkey, lkey, mask, tuple((2 * i) % 5
                                                      for i in range(65))))
            for src, k_kernel, k_plain, m, cols in inputs:
                for specs in [edge] + many:
                    f = dict(specs, cols=cols, evt_mask=m, assume_latest=al)
                    errs["fused_window"] = max(errs["fused_window"], _max_err(
                        ops.fused_window(*src, k_kernel, rts, **f),
                        ref.fused_window_ref(*src, k_plain, rts, **f),
                        f"fused_window B={B} S={len(specs['spec_rows'])} "
                        f"cols={len(cols)} mask={m is not None} al={al}"))
                for fr in frames:
                    w = dict(fr, cols=cols, evt_mask=m, assume_latest=al)
                    errs["window_agg"] = max(errs["window_agg"], _max_err(
                        ops.window_agg(*src, k_kernel, rts, **w),
                        ref.window_agg_ref(*src, k_plain, rts, **w),
                        f"window_agg B={B} {fr} cols={len(cols)} "
                        f"mask={m is not None} al={al}"))
            mkey = torch.from_numpy(np.random.default_rng(B).integers(
                0, merchants.total.shape[0], B).astype(np.int32)).to(device)
            for jring, jk, jp, cols in ((ring, kb, kp, (3, 0)),
                                        (ring, kb, kp, cols65),
                                        (mring, mkey, mkey, (1, 0))):
                j = dict(col_idx=cols, assume_latest=al, with_ts=True)
                got = _as_dict(ops.last_join(*jring, jk, rts, **j))
                want = _as_dict(ref.last_join_ref(*jring, jp, rts, **j))
                if (B == 499 and (jring is ring or not al)
                        and bool(want["matched"].all())):
                    raise AssertionError("no unmatched LAST JOIN in the "
                                         "edge cases")
                errs["last_join"] = max(errs["last_join"], _max_err(
                    got, want, f"last_join B={B} C={jring[1].shape[1]} "
                               f"cols={len(cols)} al={al}"))
            for fr in (dict(rows_preceding=0), dict(rows_preceding=10),
                       dict(rows_preceding=64), dict(rows_preceding=100),
                       dict(rows_preceding=500), dict(rows_preceding=1023),
                       dict(range_preceding=500.0)):
                for cols, fields in (((0,), ("sum", "sumsq", "count")),
                                     ((0,), ("count", "max")),
                                     ((1, 2, 0), ("count", "max", "min",
                                                  "sum")),
                                     (cols64, None), (cols65, None)):
                    p = dict(bucket_size=sz.bucket, cols=cols, fields=fields,
                             assume_latest=al, **fr)
                    errs["preagg_window"] = max(
                        errs["preagg_window"], _max_err(
                            ops.preagg_window(state.values, state.ts,
                                              state.total, *tiers, kb, rts,
                                              **p),
                            ref.preagg_window_ref(state.values, state.ts,
                                                  state.total, *tiers, kp,
                                                  rts, **p),
                            f"preagg_window B={B} {fr} cols={len(cols)} "
                            f"al={al}"))
                shapes |= window_split(state.ts, state.total, kp, rts,
                                       bucket_size=sz.bucket,
                                       assume_latest=al, **fr)["shapes"]
    missing = [s for s in SHAPES if s not in shapes]
    if missing:
        raise AssertionError(f"no preagg_window case took the shapes "
                             f"{missing}")
    return errs


def mask_of(values: torch.Tensor) -> torch.Tensor:
    """A WHERE mask over a ring's rows: amount above 20."""
    return values[:, :, 0] > 20.0


def capture_calls(serve_batch: Callable[[str], object], names,
                  suffix: str = "") -> List[dict]:
    """Every kernel call that ``serve_batch(name)`` makes for each
    deployment name, in call order, labelled ``deployment#order`` plus
    ``suffix``: the shapes the path gives each kernel."""
    from repro_torch.kernels import ops
    calls: List[dict] = []
    originals = {k: getattr(ops, k) for k in KERNELS}
    current = {"deployment": None, "order": 0}

    def recorder(name):
        def rec(*a, **kw):
            calls.append({"call": f"{current['deployment']}#"
                                  f"{current['order']}{suffix}",
                          "kernel": name, "args": a, "kw": kw})
            current["order"] += 1
            return originals[name](*a, **kw)
        return rec

    try:
        for k in KERNELS:
            setattr(ops, k, recorder(k))
        for name in names:
            current.update(deployment=name, order=0)
            serve_batch(name)
    finally:
        for k, fn in originals.items():
            setattr(ops, k, fn)
    return calls


def offline_first_batch(eng, name: str):
    """The first batch ``query_offline(name)`` runs: the retained events of
    the table's keys in key order, the first ``OFFLINE_BATCH`` of them,
    each requested point in time at its own timestamp."""
    dep = eng.handle(name)
    table = dep.table
    snap = table.snapshot()
    st, C = snap.state, table.capacity
    tot = st.total.cpu().numpy()
    kidx, slots = [], []
    for k in range(table.n_keys):
        t = int(tot[k])
        for p in range(t - min(t, C), t):
            kidx.append(k)
            slots.append(p % C)
        if len(kidx) >= eng.OFFLINE_BATCH:
            break
    kidx, slots = kidx[:eng.OFFLINE_BATCH], slots[:eng.OFFLINE_BATCH]
    kt = torch.tensor(kidx, device=st.ts.device)
    sl = torch.tensor(slots, device=st.ts.device)
    return eng._request_batched(
        dep, np.asarray(kidx, np.int32), st.ts[kt, sl].cpu().numpy(),
        st.values[kt, sl].cpu().numpy(), snap=snap,
        join_snaps=dep.join_snapshots(), assume_latest=False,
        record_joins=False)


def main_path_calls(eng, keys, ts, rows, sz: Sizes, device) -> List[dict]:
    """Each kernel against its plain version, timed, on every call the
    main path makes: one batch of each deployment at B=500 (``name#i``)
    and at B=100 (``name#i@B=100``), and the calls of the first batch of
    ``query_offline`` that reach window_agg and last_join, point in time
    (``name#i@offline``)."""
    calls: List[dict] = []
    for B in sorted(sz.batches, key=lambda b: b != sz.timing_batch):
        reqs = {name: next(request_batches(keys, ts, rows, B, 1, seed=17))
                for name in DEPLOYMENTS}
        calls += capture_calls(
            lambda n: eng.request(n, *reqs[n][:2], rows=reqs[n][2]),
            DEPLOYMENTS, "" if B == sz.timing_batch else f"@B={B}")
    calls += [c for c in capture_calls(
        lambda n: offline_first_batch(eng, n),
        ("fraud_scored", "serve_features"), "@offline")
        if c["kernel"] in ("window_agg", "last_join")]
    calls = time_calls(calls, sz.reps, device)
    for v in calls:
        log(f"time {v['kernel']} {v['call']} (B={v['batch']}): device per "
            f"launch: kernel {v['ms']} ms, plain {v['plain_ms']} ms, bound "
            f"{v['bound_ms']} ms ({v['bytes']} bytes); per call with host "
            f"work: kernel {v['call_ms']} ms, plain {v['plain_call_ms']} ms")
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


def time_calls(calls: List[dict], reps: int, device) -> List[dict]:
    """Kernel vs plain version on each captured main-path call: device ms
    per launch, ms per call with host work, the bound."""
    from repro_torch.kernels import ops, ref
    plain = {"window_agg": ref.window_agg_ref,
             "fused_window": ref.fused_window_ref,
             "preagg_window": ref.preagg_window_ref,
             "last_join": ref.last_join_ref}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    res = []
    for c in calls:
        name, a, kw = c["kernel"], c["args"], c["kw"]
        kfn = getattr(ops, name)
        got, want = kfn(*a, **kw), plain[name](*a, **kw)
        err = _max_err(_as_dict(got), _as_dict(want),
                       f"{name} main path {c['call']}")
        nbytes = needed_bytes(name, a, kw, got)
        res.append({
            "call": c["call"], "kernel": name,
            "ms": _device_ms(lambda: kfn(*a, **kw), 20),
            "plain_ms": _device_ms(lambda: plain[name](*a, **kw), 20),
            "call_ms": _call_ms(lambda: kfn(*a, **kw), reps, flush),
            "plain_call_ms": _call_ms(lambda: plain[name](*a, **kw), reps,
                                      flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "max_abs_err": err,
            "batch": int(a[8 if name == "preagg_window" else 3].shape[0])})
    return res


def per_kernel(timing: List[dict]) -> Dict[str, Dict[str, float]]:
    """Each kernel's numbers over its main-path calls at B=500 (the calls
    labelled without ``@``), weighted by the launches of each call; every
    call site launches once per batch, so the weights are equal."""
    out: Dict[str, Dict[str, float]] = {}
    for k in KERNELS:
        rows = [r for r in timing if r["kernel"] == k and "@" not in r["call"]]
        out[k] = {f: statistics.fmean(r[f] for r in rows)
                  for f in ("ms", "plain_ms", "call_ms", "plain_call_ms",
                            "bound_ms", "max_abs_err")}
        out[k]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


# ---------------------------------------------------------------------------
# CUDA engine vs CPU engine
# ---------------------------------------------------------------------------

def _exact_column(c: str) -> bool:
    """The columns compare_frames holds exactly."""
    return c.startswith(("__", "m_")) or any(
        x in c for x in ("max", "min", "cnt", "last"))


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
        if _exact_column(c):
            ok, d = np.array_equal(g, w), float(np.abs(g - w).max(initial=0))
        else:
            atol = (score_atol if c == "score" else
                    std_atol if "std" in c else 1e-4)
            ok = np.allclose(g, w, rtol=2e-4, atol=atol)
            d = float(np.abs(g - w).max(initial=0))
        if not ok:
            raise AssertionError(f"{what}: column {c} differs (max abs "
                                 f"diff {d})")


WIDE_COLS, WIDE_WINDOWS = 65, 17
_WIDE_AGGS = (("sum", "SUM"), ("max", "MAX"), ("min", "MIN"),
              ("avg", "AVG"), ("cnt", "COUNT"), ("first", "FIRST"))
# 17 raw-scan windows over 65 columns: the plan fuses them into one launch,
# which the CUDA wrapper splits into 16-spec x 64-column launches
WIDE_SQL = (
    "SELECT\n  " + ",\n  ".join(
        [f"{_WIDE_AGGS[j % 6][1]}(c{j}) OVER w{j % WIDE_WINDOWS} "
         f"AS {_WIDE_AGGS[j % 6][0]}_{j}" for j in range(WIDE_COLS)]
        + [f"LAST(c{i}) OVER w{i} AS last_{i}" for i in range(WIDE_WINDOWS)])
    + "\nFROM wide\nWINDOW " + ",\n  ".join(
        f"w{i} AS (PARTITION BY user ORDER BY ts "
        + (f"ROWS BETWEEN {1 + 6 * i}" if i % 2 == 0
           else f"RANGE BETWEEN {15 * (i + 1)}")
        + " PRECEDING AND CURRENT ROW)" for i in range(WIDE_WINDOWS)))


def wide_vs_cpu(device) -> None:
    """The 17-window, 65-column deployment on a card engine against a CPU
    engine: equal FeatureFrames online and offline."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.optimizer import OptFlags
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    from repro_torch.featurestore.table import TableSchema
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=4000, n_keys=64, n_features=WIDE_COLS, rate_hz=2.0, seed=8))
    engines = {}
    for dev in (device, "cpu"):
        eng = Engine(OptFlags(), device=dev)
        eng.create_table(TableSchema("wide", "user", "ts", tuple(
            f"c{j}" for j in range(WIDE_COLS))), max_keys=64, capacity=64,
            bucket_size=8)
        eng.insert("wide", keys.tolist(), ts.tolist(), rows)
        h = eng.deploy("wide17", WIDE_SQL)
        if h.phys.n_kernel_launches != 1:
            raise AssertionError(f"wide17 plans {h.phys.n_kernel_launches} "
                                 f"launches, not one fused launch")
        engines[dev] = eng
    rng = np.random.default_rng(4)
    B = 64
    rk = rng.integers(0, 70, B)
    rts = (float(ts.max()) + 1.0 + np.arange(B)).astype(np.float32)
    a, b = (engines[d].request("wide17", rk.tolist(), rts.tolist())
            for d in (device, "cpu"))
    if not np.array_equal(a.status, b.status) or a.all_ok:
        raise AssertionError("wide17: status differs or no unknown key")
    compare_frames(a, b, "wide17 online", 1e-4, 1e-4)
    oa, ob = (engines[d].query_offline("wide17") for d in (device, "cpu"))
    compare_frames(oa, ob, "wide17 offline", 1e-4, 1e-4)
    log(f"cuda==cpu wide17 ({WIDE_WINDOWS} windows, {WIDE_COLS} columns): "
        f"online B={B}, offline {len(oa['__key'])} rows")
    for eng in engines.values():
        eng.close()


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
    sc_atol = score_atol(rows, std_atol)
    for name in DEPLOYMENTS:
        a = engines[device].request(name, rk.tolist(), rts.tolist(),
                                    rows=rrows)
        b = engines["cpu"].request(name, rk.tolist(), rts.tolist(),
                                   rows=rrows)
        if not np.array_equal(a.status, b.status) or a.all_ok:
            raise AssertionError(f"{name}: status differs or no unknown key")
        compare_frames(a, b, f"{name} online", std_atol, sc_atol)
        oa = engines[device].query_offline(name)
        ob = engines["cpu"].query_offline(name)
        compare_frames(oa, ob, f"{name} offline", std_atol, sc_atol)
        log(f"cuda==cpu {name}: online B={B} ({a.n_unknown} unknown keys), "
            f"offline {len(oa['__key'])} rows")
    observations_vs_cpu(engines, device, rk, rts, rrows)
    for eng in engines.values():
        eng.close()
    wide_vs_cpu(device)


def _without_clock(snap):
    """A freshness snapshot less its wall-clock stamps."""
    return {t: {k: v for k, v in ent.items()
                if k not in ("published_at", "i2v_sketch")}
            for t, ent in snap.items()}


def sketches_close(a: dict, b: dict, exact: bool, what: str) -> None:
    """Two quantile-sketch dicts of the same served column. A column the
    frames hold exactly (counts, min/max, last, joins) must give the same
    sketch bit for bit (its sum too: the same values in the same order).
    A column built from sums moves by rounding, so a value can land in a
    neighbouring bucket: equal counts, and the bucket counts of the two
    may differ by at most max(2, 2 % of the values) moved values."""
    if exact:
        if a != b:
            raise AssertionError(f"{what}: sketches differ")
        return
    if a["count"] != b["count"]:
        raise AssertionError(f"{what}: counts {a['count']} != "
                             f"{b['count']}")
    da = {("p", i): c for i, c in a["pos"]}
    da.update({("n", i): c for i, c in a["neg"]})
    da["z"] = a["zero"]
    db = {("p", i): c for i, c in b["pos"]}
    db.update({("n", i): c for i, c in b["neg"]})
    db["z"] = b["zero"]
    moved = sum(abs(da.get(k, 0) - db.get(k, 0)) for k in set(da) | set(db))
    if moved > 2 * max(2, int(np.ceil(0.02 * a["count"]))):
        raise AssertionError(f"{what}: {moved / 2} values in other buckets "
                             f"of {a['count']}")


def observations_vs_cpu(engines, device, rk, rts, rrows) -> None:
    """The card and CPU engines served the same requests: their freshness
    snapshots (age, ingest-column and key sketches, watermarks, table
    versions) are equal bit for bit, and so are the drift sketches and
    report of every column the frames hold exactly; the columns built
    from sums are held as ``sketches_close`` says. A reference is pinned
    and the same requests served again at later times, so the report's
    PSI compares two real distributions."""
    for eng in engines.values():
        eng.pin_drift_reference()
        for name in DEPLOYMENTS:
            eng.request(name, rk.tolist(), (rts + 1000.0).tolist(),
                        rows=rrows)
    fa, fb = (_without_clock(engines[d].freshness_snapshot())
              for d in (device, "cpu"))
    if fa != fb:
        raise AssertionError("card and CPU freshness snapshots differ")
    da, db = (engines[d].drift.snapshot() for d in (device, "cpu"))
    ra, rb = (engines[d].drift_report() for d in (device, "cpu"))
    if sorted(ra) != sorted(rb):
        raise AssertionError("card and CPU drift columns differ")
    for side in ("live", "ref"):
        for c in da[side]:
            sketches_close(da[side][c], db[side][c], _exact_column(c),
                           f"drift {side} {c}")
    for c in ra:
        if _exact_column(c):
            same = json.dumps(ra[c]) == json.dumps(rb[c])
        else:
            same = (ra[c]["drifted"] == rb[c]["drifted"]
                    and ra[c]["live_count"] == rb[c]["live_count"]
                    and np.isfinite(ra[c]["psi"]) == np.isfinite(rb[c]["psi"]))
        if not same:
            raise AssertionError(f"drift report {c}: {ra[c]} != {rb[c]}")
    ev = fa["events"]
    psi = [r["psi"] for r in ra.values() if np.isfinite(r["psi"])]
    log(f"cuda==cpu freshness and drift: {ev['serve_rows']} rows served, "
        f"age sketch of {ev['age_sketch']['count']} equal; drift over "
        f"{len(ra)} columns (largest psi {max(psi, default=float('nan'))}) "
        f"equal")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     flash_attention_bwd, fused_window,
                                     last_join, preagg_window, window_agg)
    mods = {"window_agg": window_agg, "fused_window": fused_window,
            "preagg_window": preagg_window, "last_join": last_join,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention}
    return {k: m.launches for k, m in mods.items()}


def reset_launch_counts() -> None:
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     flash_attention_bwd, fused_window,
                                     last_join, preagg_window, window_agg)
    for m in (window_agg, fused_window, preagg_window, last_join,
              flash_attention, decode_attention):
        m.launches = 0
    flash_attention_bwd.reset_launches()


def bwd_routes(what: str, n: int, want: str = "wgmma") -> Dict[str, int]:
    """The backward's launches by route since the last reset, which must
    be all ``n`` on ``want`` (the wgmma kernels: every bf16 training call
    at head dim 64 or 128)."""
    from repro_torch.kernels import flash_attention_bwd
    routes = {r: c for r, c in flash_attention_bwd.route_launches.items()
              if c}
    if routes != ({want: n} if n else {}):
        raise AssertionError(f"{what}: backward launches by route {routes},"
                             f" want {n} on {want}")
    return routes


def request_batches(keys, ts, rows, B: int, n: int, seed: int,
                    t0: float = None):
    """Batches of in-flight transactions: a sampled event's key and row,
    at a fresh request time (the online path runs with assume_latest):
    after ``t0``, by default after every event of ``ts``."""
    rng = np.random.default_rng(seed)
    t_max = float(ts.max()) if t0 is None else t0
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


# ---------------------------------------------------------------------------
# the live-serving path: streaming ingest, versions, modes, FeatureServer
# ---------------------------------------------------------------------------

# the pipeline of benchmarks/bench_stream_interference.py: a 0.5 reorder
# window, 20 ms amortisation, flushes of up to 2048 events
LIVE_CFG = dict(lateness=0.5, flush_interval_s=0.02, max_flush_batch=2048)
MODERATE_RATE = 1_000.0        # events/s, that benchmark's MODERATE_RATE


def check_frame(fr, name: str, B: int) -> None:
    """OK status for every (known) key, finite columns of length B."""
    if not fr.all_ok:
        raise AssertionError(f"{name}: a known key came back with status "
                             f"!= OK")
    for c, v in fr.items():
        v = np.asarray(v).reshape(-1)
        if v.shape[0] != B or not np.isfinite(v).all():
            raise AssertionError(f"{name}: column {c} is not finite of "
                                 f"length {B}")


def require_launches(kernels, what: str) -> Dict[str, int]:
    """The launch counts since the last reset; raises unless every kernel
    of ``kernels`` launched."""
    counts = launch_counts()
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{what} never launched {missing}")
    return {k: counts[k] for k in KERNELS}


def _pcts(lat_s) -> Dict[str, float]:
    ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _sync_card() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


SHORT_W1 = ("ROWS BETWEEN 10 PRECEDING AND CURRENT ROW",
            "ROWS BETWEEN 5 PRECEDING AND CURRENT ROW")


def lifecycle(eng, rk, rts, rrows) -> List[list]:
    """Redeploy serve_features with a 5-row w1, canary the original at
    0.5 (four batches), promote, roll back. Returns per step the live
    version, the canary's and the versions that served the batches."""
    name = "serve_features"
    steps = []

    def step(label, n=1):
        served = [eng.request(name, rk, rts, rows=rrows).version
                  for _ in range(n)]
        live = eng.handle(name)
        steps.append([label, live.version,
                      live._canary[0].version if live._canary else None,
                      served])

    eng.deploy(name, DEPLOYMENTS[name].replace(*SHORT_W1))
    step("redeploy")
    eng.deploy(name, DEPLOYMENTS[name], canary=0.5)
    step("canary", 4)
    eng.promote(name)
    step("promote")
    eng.rollback(name)
    step("rollback")
    return steps


def live_path(sz: Sizes, device) -> Dict[str, object]:
    """The live path on a card engine and a CPU engine fed the same
    disordered stream through ``attach_stream`` (with a TTL that compacts):
    equal tables' features, the same version sequence, pooled and per-row
    frames equal to batched, online == offline and a valid pre-aggregate
    tier after the compaction."""
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    from repro_torch.featurestore.preagg import verify_preagg
    from repro_torch.streaming import (PipelineConfig, RetentionPolicy,
                                       StreamSource,
                                       online_offline_consistency)
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.check_events, n_keys=sz.check_keys, n_features=4))
    src = StreamSource(keys, ts, rows).with_disorder(jitter=0.4, seed=6)
    # an eighth of the stream's span: every key keeps fewer events than
    # its ring holds, and every flush compacts
    cfg = PipelineConfig(retention=RetentionPolicy(
        ttl=float(ts.max() - ts.min()) / 8, every_n_flushes=1), **LIVE_CFG)
    std_atol = 4e-4 * float(np.abs(rows[:, 0]).max())
    sc_atol = score_atol(rows, std_atol)
    rng = np.random.default_rng(12)
    B = 64
    rk = rng.integers(0, sz.check_keys + 8, B)           # some unknown
    rts = (float(ts.max()) + 1.0 + np.arange(B)).astype(np.float32)
    rrows = rows[rng.integers(0, len(rows), B)]
    out: Dict[str, dict] = {}
    frames: Dict[str, dict] = {}
    reset_launch_counts()
    for dev in (device, "cpu"):
        eng = make_engine(dev, sz, sz.check_keys, workers=4)
        fill_merchants(eng, ts, sz)
        pipe = eng.attach_stream("events", cfg)
        src.replay(pipe, batch_size=256)
        pipe.flush()
        check_pipe(pipe, f"live stream on {dev}")
        m = pipe.metrics()
        if (m["events_flushed"] != len(src) or m["dropped_late"]
                or m["ttl_compactions"] < 1):
            raise AssertionError(f"live stream on {dev}: {m}")
        snap = eng.tables["events"].snapshot()
        ok, err = verify_preagg(snap.state, snap.preagg,
                                bucket_size=sz.bucket)
        del snap
        if not ok:
            raise AssertionError(f"verify_preagg on {dev}: max err {err}")
        deploy_all(eng, scorer_params(rows, dev))
        ok, errs = online_offline_consistency(eng, "serve_features")
        if not ok:
            raise AssertionError(f"online != offline on {dev}: {errs}")
        steps = lifecycle(eng, rk[:16], rts[:16], rrows[:16])
        frames[dev] = {}
        for mode in MODES:
            set_mode(eng, mode)
            frames[dev][mode] = {n: eng.request(n, rk, rts, rows=rrows)
                                 for n in DEPLOYMENTS}
        set_mode(eng, "batched")
        for mode in ("pooled", "per_row"):
            for n in DEPLOYMENTS:
                compare_frames(frames[dev][mode][n], frames[dev]["batched"][n],
                               f"{n} {mode} vs batched on {dev}", std_atol,
                               sc_atol)
        out[str(dev)] = {"versions": steps, "flushes": m["flushes"],
                         "ttl_compactions": m["ttl_compactions"],
                         "ttl_dropped": m["ttl_dropped"],
                         "reordered": m["reordered"],
                         "verify_preagg_err": err,
                         "consistency_max_err": max(errs.values())}
        eng.close()
        if dev == device:
            launches = require_launches(KERNELS, "the live path")
    if out[str(device)]["versions"] != out["cpu"]["versions"]:
        raise AssertionError(f"version sequences differ: {out}")
    for n in DEPLOYMENTS:
        a, b = frames[device]["batched"][n], frames["cpu"]["batched"][n]
        if not np.array_equal(a.status, b.status) or a.all_ok:
            raise AssertionError(f"{n}: status differs or no unknown key")
        compare_frames(a, b, f"live {n} cuda vs cpu", std_atol, sc_atol)
    log(f"live path (card == cpu, {len(src)} disordered events, "
        f"{sz.check_keys} keys): versions {out['cpu']['versions']}; "
        f"card {out[str(device)]}; launches {launches}")
    out["launches"] = launches
    return out


def execution_modes(eng, keys, ts, rows, sz: Sizes) -> Dict[str, dict]:
    """The paper's Fig. 2 axes at full size: batched, pooled (4 workers)
    and per-row, B = ``sz.mode_batch``; the first batch of each mode is
    held against batched."""
    report: Dict[str, dict] = {}
    first: Dict[tuple, object] = {}
    std_atol = 4e-4 * float(np.abs(rows[:, 0]).max())
    sc_atol = score_atol(rows, std_atol)
    B = sz.mode_batch
    reset_launch_counts()
    for mode in MODES:
        set_mode(eng, mode)
        n = sz.row_batches if mode == "per_row" else sz.mode_batches
        for name in ("serve_features", "fraud_scored"):
            lat = []
            for rk, rts, rr in request_batches(keys, ts, rows, B, n,
                                               seed=31):
                t1 = time.perf_counter()
                fr = eng.request(name, rk, rts, rows=rr)
                lat.append(time.perf_counter() - t1)
                check_frame(fr, name, B)
                first.setdefault((mode, name), fr)
            report[f"{name}/{mode}"] = dict(_pcts(lat), batches=n, B=B)
            log(f"mode {mode} {name} B={B}: batch p50 "
                f"{report[f'{name}/{mode}']['p50_ms']:.4f} ms, p99 "
                f"{report[f'{name}/{mode}']['p99_ms']:.4f} ms ({n} batches)")
    set_mode(eng, "batched")
    for (mode, name), fr in first.items():
        compare_frames(fr, first["batched", name],
                       f"{name} {mode} vs batched", std_atol, sc_atol)
    report["launches"] = require_launches(
        ("window_agg", "preagg_window", "last_join"), "the execution modes")
    return report


def hot_swap(eng, keys, ts, rows, sz: Sizes) -> Dict[str, object]:
    """One thread serves serve_features (B=500) while this thread
    redeploys it with a 5-row w1: build+warm ms, the first post-swap
    batch against the p50, no version mixed in a response, and no
    plan-cache miss on the new version."""
    import threading
    name = "serve_features"
    old = eng.handle(name)
    frames: List[tuple] = []
    errors: List[Exception] = []
    stop, warmed, done = (threading.Event(), threading.Event(),
                          threading.Event())
    B = sz.timing_batch

    def serve():
        try:
            for rk, rts, rr in request_batches(keys, ts, rows, B, 1 << 30,
                                               seed=41):
                if stop.is_set():
                    return
                t1 = time.perf_counter()
                fr = eng.request(name, rk, rts, rows=rr)
                dt = time.perf_counter() - t1
                check_frame(fr, name, B)
                frames.append((fr.version, dt,
                               float(np.max(fr["txn_cnt_10"]))))
                if len(frames) == sz.swap_batches:
                    warmed.set()
                if sum(v != old.version for v, _, _ in frames) >= \
                        sz.swap_batches:
                    done.set()
        except Exception as e:         # raised again by the caller
            errors.append(e)
            warmed.set()
            done.set()

    reset_launch_counts()
    th = threading.Thread(target=serve, name="swap-serve")
    th.start()
    try:
        if not warmed.wait(300.0):
            raise AssertionError("hot swap: the serving thread stalled")
        t0 = time.perf_counter()
        new = eng.deploy(name, DEPLOYMENTS[name].replace(*SHORT_W1))
        swap_ms = (time.perf_counter() - t0) * 1e3
        misses = eng.cache.stats.misses
        if not done.wait(300.0):
            raise AssertionError("hot swap: no batches on the new version")
    finally:
        stop.set()
        th.join(300.0)
    if errors:
        raise errors[0]
    if th.is_alive():
        raise AssertionError("hot swap: the serving thread did not stop")
    if eng.cache.stats.misses != misses:
        raise AssertionError("hot swap: the new version missed the plan "
                             "cache on the serving path")
    versions = [v for v, _, _ in frames]
    i_new = versions.index(new.version)
    if any(v != new.version for v in versions[i_new:]) or \
            set(versions[:i_new]) != {old.version}:
        raise AssertionError(f"hot swap: versions out of order {versions}")
    for v, _, cnt in frames:           # the window each response used
        if cnt > (10 if v == old.version else 5):
            raise AssertionError(f"hot swap: v{v} response with a window "
                                 f"of {cnt} rows")
    old_lat = [dt for v, dt, _ in frames[:i_new]]
    rep = {"build_warm_ms": swap_ms,
           "first_new_batch_ms": frames[i_new][1] * 1e3,
           "old_batch_p50_ms": _pcts(old_lat)["p50_ms"],
           "new_batch_p50_ms": _pcts([dt for _, dt, _ in
                                      frames[i_new:]])["p50_ms"],
           "batches_old": i_new, "batches_new": len(frames) - i_new,
           "versions": [old.version, new.version],
           "launches": require_launches(("window_agg", "preagg_window"),
                                        "the hot swap")}
    log(f"hot swap {name} v{old.version}->v{new.version} under load (B={B}): "
        f"build+warm {swap_ms:.3f} ms; first v{new.version} batch "
        f"{rep['first_new_batch_ms']:.4f} ms against the v{old.version} "
        f"p50 {rep['old_batch_p50_ms']:.4f} ms; {rep}")
    return rep


# ---------------------------------------------------------------------------
# control and observability
# ---------------------------------------------------------------------------

def device_work(fn: Callable[[], object]) -> Dict[str, int]:
    """What ``fn`` asked of the card, from a torch.profiler trace: kernel
    launches, memory copies and synchronisations (runtime calls and
    device events) beyond those of an empty profile (the profiler syncs
    the card itself when it stops), plus the calls of
    ``torch.cuda.synchronize`` made inside ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    real = torch.cuda.synchronize

    def trace(f):
        n = {"kernels": 0, "copies": 0, "syncs": 0, "synchronize_calls": 0}

        def counted(*a, **k):
            n["synchronize_calls"] += 1
            return real(*a, **k)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize = counted
            try:
                f()
            finally:
                torch.cuda.synchronize = real
        for e in prof.events():
            nm = e.name.lower()
            if "memcpy" in nm or "memset" in nm:
                n["copies"] += 1
            elif "synchronize" in nm:
                n["syncs"] += 1
            elif (e.device_type == torch.autograd.DeviceType.CUDA
                  or "launchkernel" in nm):
                n["kernels"] += 1
        return n

    idle, got = trace(lambda: None), trace(fn)
    return {k: got[k] - idle[k] for k in got}


def check_trace(tree, tid: str) -> int:
    """One engine batch's trace: an ``engine.serve`` root whose children
    are the attributed ``kernel.<op>`` spans, and their seconds sum to
    the batch's measured ``exec_s``. Returns the number of children."""
    if tree is None or tree["name"] != "engine.serve":
        raise AssertionError(f"trace {tid}: root {tree and tree['name']}")
    kids = tree["children"]
    if not kids or any(not c["name"].startswith("kernel.") for c in kids):
        raise AssertionError(f"trace {tid}: children "
                             f"{[c['name'] for c in kids]}")
    exec_s = tree["tags"]["exec_s"]
    tot = sum(c["duration_s"] for c in kids)
    if abs(tot - exec_s) > 1e-9 + 1e-6 * exec_s:
        raise AssertionError(f"trace {tid}: kernel spans {tot} s != "
                             f"exec_s {exec_s} s")
    return len(kids)


def hook_cost(eng, name: str, rk, rts, rr) -> Dict[str, float]:
    """Host time of the serve hooks of one batch, on the host that drives
    the card: the calls ``DeploymentHandle._serve`` makes after its serve
    clock stops (the disabled tracer, the latency sketch, feature age,
    the drift buffer, the flight record, the profiler's attribution),
    repeated on fresh recorders with one real B-row batch's host columns
    (``MAX_PENDING - 1`` times, so nothing folds), then the fold of those
    buffers alone."""
    from repro_torch.obs.flight import FlightRecorder
    from repro_torch.obs.freshness import FreshnessTracker
    from repro_torch.obs.profile import OperatorProfiler
    from repro_torch.obs.sketch import DriftMonitor, RollingSketch
    from repro_torch.obs.trace import Tracer
    h = eng.handle(name)
    fr = eng.request(name, rk, rts, rows=rr)
    cols = {k: np.asarray(v) for k, v in fr.columns.items()}
    ts_arr = np.asarray(rts, np.float32)
    wm, B = h.table.snapshot().watermark, len(rk)
    tracer, lat = Tracer(sample_rate=0.0), RollingSketch(window_s=5.0)
    fresh, drift = FreshnessTracker(), DriftMonitor()
    flight, prof = FlightRecorder(), OperatorProfiler()
    n = DriftMonitor.MAX_PENDING - 1
    t0 = time.perf_counter()
    for _ in range(n):
        tracer.start("engine.serve", None, tags={"rows": B})
        lat.observe(2e-3)
        ages = ts_arr[:B].astype(np.float64) - wm
        fresh.observe_age(h.table.schema.name, ages)
        drift.observe(cols, n=B)
        flight.record("serve", trace=None, deployment=h.tag, rows=B,
                      unknown=0, table_version=1, watermark=wm,
                      feature_age=float(ages.max()), serve_ms=2.0)
        prof.record(h, B, exec_s=1e-3, host_s=1e-3, plan_s=0.0,
                    serve_s=2e-3, model=eng.cost_model)
    per_batch = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    drift.snapshot()
    fresh.snapshot()
    fold = time.perf_counter() - t0
    return {"hooks_us_per_batch": per_batch * 1e6,
            "fold_ms": fold * 1e3, "batches_folded": n,
            "fold_us_per_batch": fold / n * 1e6, "columns": len(cols),
            "rows": B}


def _op_kernel(op: str) -> str:
    """The kernel that carries a profiler operator row."""
    if op.startswith("scan:fused"):
        return "fused_window"
    return {"scan": "window_agg", "preagg": "preagg_window",
            "join": "last_join"}[op.split(":", 1)[0]]


def observe_and_control(eng, keys, ts, rows, sz: Sizes, timing, device
                        ) -> Dict[str, object]:
    """The control and observability tier on the full-size engine:
    (1) serve_features with the tracer at rate 0 and 1.0 (alternate
    batches): every traced batch an ``engine.serve`` root with kernel
    children summing to its ``exec_s``; the hooks' host time per batch
    (``hook_cost``); (2) EXPLAIN ANALYZE of the three
    deployments beside the kernels' device ms; (3) freshness and drift
    at full size; the 256th buffered batch's fold; (4) a ControlPlane
    ticking every ``plane_every`` batches on real traffic, and the
    collectors asking nothing of the card; (5) a forced re-plan to the
    raw-scan plan under a serving thread (no failed request, no mixed
    version, the new plan's kernels and not the old plan's, frames equal
    to a CPU engine's on that plan) and the health gate's real decision,
    then the engine back on its old version and model; (6) a latency SLO
    bound below the p50 alerting and the flight recorder's dump; (7) the
    Prometheus text of the engine's registry."""
    import shutil
    import tempfile
    import threading
    from repro_torch.control import ControlPlane, Replanner
    from repro_torch.core.optimizer import CostModel
    from repro_torch.core.results import RequestContext
    from repro_torch.obs import SLOEngine, SLOSpec, registry_from_engine
    from repro_torch.obs.sketch import DriftMonitor
    from repro_torch.obs.slo import ALERTING
    name, B = "serve_features", sz.timing_batch
    out: Dict[str, object] = {}

    def batch(rk, rts, rr, ctx=None):
        t1 = time.perf_counter()
        fr = eng.request(name, rk, rts, rows=rr, ctx=ctx)
        dt = time.perf_counter() - t1
        check_frame(fr, name, B)
        return fr, dt

    # ---- (1) the tracer at rate 0 and 1.0 -------------------------------
    batches = list(request_batches(keys, ts, rows, B, sz.obs_batches,
                                   seed=51))
    lat: Dict[float, List[float]] = {0.0: [], 1.0: []}
    kids = 0
    for i in range(2 * len(batches)):
        rate = float(i % 2)
        eng.tracer.set_sample_rate(rate)
        tid = f"smoke-{i:05d}"
        _, dt = batch(*batches[i // 2], ctx=RequestContext(trace_id=tid))
        lat[rate].append(dt)
        if rate:
            kids += check_trace(eng.tracer.tree(tid), tid)
        elif eng.tracer.trace(tid):
            raise AssertionError("the tracer recorded at rate 0")
    eng.tracer.set_sample_rate(0.0)
    out["tracer"] = {"rate_0": _pcts(lat[0.0]), "rate_1": _pcts(lat[1.0]),
                     "traces_checked": len(lat[1.0]),
                     "kernel_spans": kids, "counters": eng.tracer.snapshot()}
    log(f"tracer {name} B={B}: rate 0 {out['tracer']['rate_0']}, rate 1.0 "
        f"{out['tracer']['rate_1']}; {len(lat[1.0])} traces, {kids} kernel "
        f"spans, each tree's kernel seconds == its exec_s")

    out["hooks"] = hook_cost(eng, name, *batches[0])
    log(f"serve hooks' host time, {name} B={B}: {out['hooks']}")

    # ---- (2) EXPLAIN ANALYZE beside the kernels' device time ------------
    ops = {}
    for d in DEPLOYMENTS:
        log(eng.explain_analyze(d))
        p = eng.profiler.snapshot(d)
        for op, r in p["ops"].items():
            k = _op_kernel(op)
            ops[f"{d}/{op}"] = {
                "attributed_ms_per_batch": r["seconds"] / p["batches"] * 1e3,
                "kernel": k, "kernel_device_ms_per_launch": timing[k]["ms"]}
            log(f"  {d} {op}: attributed {ops[f'{d}/{op}']['attributed_ms_per_batch']:.5f} "
                f"ms per batch; {k} device {timing[k]['ms']:.6f} ms per "
                f"launch")
    out["operators"] = ops

    # ---- (3) freshness and drift at full size; the 256th-batch fold ------
    t1 = time.perf_counter()
    fexp = eng.freshness_export()
    f_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    drep = eng.drift_report()
    d_ms = (time.perf_counter() - t1) * 1e3
    out["freshness"] = {k: v for k, v in fexp.items()
                        if not k.endswith("_sketch")}
    out["drift"] = drep
    log(f"freshness_export ({f_ms:.3f} ms): {out['freshness']}")
    log(f"drift_report ({d_ms:.3f} ms; no reference pinned): {drep}")
    eng.drift.snapshot()               # both buffers empty: the next
    eng.freshness.snapshot()           # MAX_PENDING-th batch folds
    fold_lat = [batch(*b)[1] for b in request_batches(
        keys, ts, rows, B, DriftMonitor.MAX_PENDING, seed=52)]
    if eng.drift._pending or eng.freshness._pending:
        raise AssertionError("the buffers did not fold on their "
                             f"{DriftMonitor.MAX_PENDING}th batch")
    out["fold"] = {"fold_batch_ms": fold_lat[-1] * 1e3,
                   "others": _pcts(fold_lat[:-1])}
    log(f"fold: batch {DriftMonitor.MAX_PENDING} of {name} B={B} (drift and "
        f"freshness fold their buffers) {out['fold']['fold_batch_ms']:.4f} "
        f"ms; the other batches {out['fold']['others']}")

    # ---- (4) the control plane on real traffic -----------------------------
    v0, model0 = eng.handle(name).version, eng.cost_model
    plane = ControlPlane(eng, name)
    ticks = []
    for i, b in enumerate(request_batches(keys, ts, rows, B,
                                          sz.plane_batches, seed=61)):
        batch(*b)
        if (i + 1) % sz.plane_every == 0:
            t1 = time.perf_counter()
            r = plane.tick()
            ticks.append({"tick": r["tick"], "ms": (time.perf_counter()
                                                   - t1) * 1e3,
                          "fed": r["observations_fed"],
                          "replan": r["replan"], "health": r["health"],
                          "knobs": r["knob_decisions"]})
            log(f"tick {r['tick']}: {ticks[-1]}")
    fitted = plane.calibrator.fit(base=eng.cost_model)
    sample_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        plane.collector.sample()
        sample_ms.append((time.perf_counter() - t1) * 1e3)
    out["plane"] = {"ticks": ticks, "fitted": repr(fitted),
                    "installed": repr(eng.cost_model),
                    "sample_ms": sample_ms,
                    "replan_events": plane.replanner.events}
    log(f"control plane: fitted {fitted!r} (installed {eng.cost_model!r}); "
        f"collector.sample() ms {sample_ms}; replan events "
        f"{plane.replanner.events}")
    if device != "cpu":
        work = device_work(lambda: (plane.collector.sample(),
                                    eng.freshness_snapshot()))
        if any(work.values()):
            raise AssertionError(f"the collectors asked the card for {work}")
        out["collector_device_work"] = work
        log(f"collector.sample() + freshness_snapshot(): {work}")
    while eng.handle(name).version != v0:     # the plane re-planned: undo
        eng.rollback(name)
    eng.set_cost_model(model0)

    # ---- (5) a forced re-plan under a serving thread -------------------------
    rp = Replanner(eng, name, min_health_batches=sz.flip_batches)
    frames: List[tuple] = []
    errors: List[Exception] = []
    new_v: List[int] = []
    stop, warmed, fresh, enough = (threading.Event(), threading.Event(),
                                   threading.Event(), threading.Event())

    def serve():
        try:
            for b in request_batches(keys, ts, rows, B, 1 << 30, seed=71):
                if stop.is_set():
                    return
                fr, dt = batch(*b)
                frames.append((fr.version, dt))
                if len(frames) >= sz.flip_batches:
                    warmed.set()
                if new_v and fr.version == new_v[0]:
                    fresh.set()
                    n_new = sum(v == new_v[0] for v, _ in frames)
                    if n_new >= 2 * sz.flip_batches:
                        enough.set()
        except Exception as e:         # raised again by the caller
            errors.append(e)
            warmed.set()
            fresh.set()
            enough.set()

    th = threading.Thread(target=serve, name="replan-serve")
    th.start()
    try:
        if not warmed.wait(300.0):
            raise AssertionError("re-plan: the serving thread stalled")
        t0 = time.perf_counter()
        rep = rp.maybe_replan(CostModel(preagg_el=10.0))
        swap_ms = (time.perf_counter() - t0) * 1e3
        if rep["action"] != "swapped":
            raise AssertionError(f"re-plan: {rep}")
        new_v.append(rep["new_version"])
        if not fresh.wait(300.0):
            raise AssertionError("re-plan: no batch on the new version")
        reset_launch_counts()          # from here on: new-version batches
        if not enough.wait(300.0):
            raise AssertionError("re-plan: too few new-version batches")
        launches = launch_counts()
    finally:
        stop.set()
        th.join(300.0)
    if errors:
        raise errors[0]
    if th.is_alive():
        raise AssertionError("re-plan: the serving thread did not stop")
    versions = [v for v, _ in frames]
    i_new = versions.index(new_v[0])
    if set(versions[:i_new]) != {v0} or \
            any(v != new_v[0] for v in versions[i_new:]):
        raise AssertionError(f"re-plan: versions out of order {versions}")
    impl = dict(eng.handle(name).plan.window_impl)
    if impl.get("w2") == "preagg" or launches["fused_window"] == 0 or \
            launches["window_agg"] or launches["preagg_window"]:
        raise AssertionError(f"re-plan: plan {impl}, launches {launches}")
    log(eng.explain(name))
    naive_vs_cpu(sz, device)
    health = rp.check_health()
    if rp.state != Replanner.IDLE or health["action"] not in (
            "committed", "rolled_back"):
        raise AssertionError(f"re-plan: health {health}, state {rp.state}")
    if health["action"] == "rolled_back" and (
            eng.handle(name).version != v0 or eng.cost_model != model0):
        raise AssertionError("re-plan: the rollback did not restore the "
                             "old version and cost model")
    out["replan"] = {
        "swap_ms": swap_ms, "health": health,
        "batches_old": i_new, "batches_new": len(frames) - i_new,
        "old_p50_ms": _pcts([d for _, d in frames[:i_new]])["p50_ms"],
        "new": _pcts([d for _, d in frames[i_new:]]),
        "launches": {k: launches[k] for k in KERNELS}, "plan": impl}
    log(f"re-plan {name} v{v0}->v{new_v[0]} under load (B={B}): "
        f"maybe_replan {swap_ms:.3f} ms; health gate (wall clock, not "
        f"asserted): {health}; {out['replan']}")
    while eng.handle(name).version != v0:     # later phases: the old plan
        eng.rollback(name)
    eng.set_cost_model(model0)

    # ---- (6) an SLO below the p50 alerts; the flight recorder dumps ------
    bound = 0.5 * out["tracer"]["rate_0"]["p50_ms"] / 1e3
    slo = SLOEngine([SLOSpec("latency", "latency_p99_s", bound=bound)])
    tmp = tempfile.mkdtemp(prefix="flight-")
    prev_dir = eng.flight.out_dir
    eng.flight.out_dir = tmp
    try:
        plane = ControlPlane(eng, name, replan=False, slo=slo)
        for b in request_batches(keys, ts, rows, B, 8, seed=81):
            batch(*b)
            plane.tick()
            if slo.state("latency") == ALERTING:
                break
        if slo.state("latency") != ALERTING or not eng.flight.dumps:
            raise AssertionError(f"SLO: {slo.snapshot()}, dumps "
                                 f"{eng.flight.dumps}")
        with open(eng.flight.dumps[-1], encoding="utf-8") as f:
            recs = [json.loads(line) for line in f]
        if recs[0]["kind"] != "dump" or not any(r["kind"] == "serve"
                                                for r in recs):
            raise AssertionError("flight dump: no header or no serve "
                                 "record")
        out["slo"] = {"bound_s": bound, "export": slo.export(),
                      "dump_records": len(recs),
                      "kinds": sorted({r["kind"] for r in recs})}
    finally:
        eng.flight.out_dir = prev_dir
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"SLO latency_p99_s <= {bound * 1e3:.4f} ms: alerting; flight dump "
        f"of {out['slo']['dump_records']} records {out['slo']['kinds']} "
        f"(removed)")

    # ---- (7) the registry's Prometheus text ------------------------------
    reg = registry_from_engine(eng, slo=slo)
    t1 = time.perf_counter()
    text = reg.render_prometheus()
    out["registry"] = {"ms": (time.perf_counter() - t1) * 1e3,
                       "lines": text.count("\n"), "groups": reg.groups()}
    log(f"registry: {out['registry']}")
    return out


def naive_vs_cpu(sz: Sizes, device) -> None:
    """serve_features planned with ``CostModel(preagg_el=10.0)`` (w2 a
    raw scan, both windows in one fused launch) on a check-size card
    engine against the same on the CPU."""
    from repro_torch.core.optimizer import CostModel
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.check_events, n_keys=sz.check_keys, n_features=4))
    rng = np.random.default_rng(5)
    rk = rng.integers(0, sz.check_keys, 64)
    rts = (float(ts.max()) + 1.0 + np.arange(64)).astype(np.float32)
    frames = {}
    for dev in (device, "cpu"):
        eng = make_engine(dev, sz, sz.check_keys)
        eng.set_cost_model(CostModel(preagg_el=10.0))
        eng.insert("events", keys.tolist(), ts.tolist(), rows)
        eng.deploy("serve_features", DEPLOYMENTS["serve_features"])
        if dict(eng.handle("serve_features").plan.window_impl)["w2"] == \
                "preagg":
            raise AssertionError("preagg_el=10 did not re-plan w2")
        frames[dev] = eng.request("serve_features", rk.tolist(),
                                  rts.tolist())
        eng.close()
    std_atol = 4e-4 * float(np.abs(rows[:, 0]).max())
    compare_frames(frames[device], frames["cpu"], "naive serve_features",
                   std_atol, std_atol)
    log("cuda==cpu serve_features on the raw-scan plan (preagg_el=10)")


def check_pipe(pipe, what: str) -> None:
    """Raise if a flush ever failed: the flusher catches an error, counts
    it, restages the events and retries, so nothing else would show it."""
    if pipe.last_error is not None:
        raise AssertionError(f"{what}: a flush failed ({pipe.stats['errors']}"
                             f" errors)") from pipe.last_error
    if pipe.stats["errors"]:
        raise AssertionError(f"{what}: {pipe.stats['errors']} flush errors")


def visible_events(table) -> int:
    """Events in the published table version: what a request can see."""
    return int(table.state.total.sum())


def stream_interference(eng, keys, rows, sz: Sizes):
    """A stream attached to the full-size events table, replayed off, at
    MODERATE_RATE and unpaced, each for a window of ``sz.stream_window_s``
    (and at least ``sz.stream_batches`` batches) in which serve_features
    and fraud_scored take B=500 batches. Events visible count only what
    the table published inside the window; the unpaced replay must still
    have a backlog when the window ends. Before the stream attaches,
    three copy-on-write inserts of 1024 events time one flush's copy on
    the card. Returns the report, the pipeline, the request time and the
    events left for the FeatureServer phase."""
    import threading
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    from repro_torch.streaming import PipelineConfig, StreamSource
    table = eng.tables["events"]
    skeys, sts, srows = generate_events(EventStreamConfig(
        n_events=sz.stream_events, n_keys=sz.keys, n_features=4, seed=1))
    sts = (sts + np.float32(table.watermark + 1.0)).astype(np.float32)
    t_req = float(sts.max()) + 1.0      # requests stay ahead of the stream
    probe_ms = []
    n_probe = min(1024, sz.capacity)
    for i in range(3):
        sl = slice(i * n_probe, (i + 1) * n_probe)
        _sync_card()
        t0 = time.perf_counter()
        table.insert(skeys[sl].tolist(), sts[sl], srows[sl], donate=False)
        _sync_card()
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"copy-on-write insert of {n_probe} events into the "
        f"{table.memory_bytes()} byte table: {probe_ms} ms")
    rest = StreamSource(skeys[3 * n_probe:], sts[3 * n_probe:],
                        srows[3 * n_probe:]).with_disorder(jitter=0.4,
                                                           seed=8)
    # moderate: twice what its window takes; the FeatureServer phase gets
    # the last sz.server_events; unpaced gets the rest, more than the
    # flusher can publish in one window
    cuts = (0, int(2 * MODERATE_RATE * sz.stream_window_s),
            len(rest) - sz.server_events, len(rest))
    segs = [StreamSource(rest.keys[a:b], rest.ts[a:b], rest.rows[a:b])
            for a, b in zip(cuts[:-1], cuts[1:])]
    pipe = eng.attach_stream("events", PipelineConfig(**LIVE_CFG))
    pipe.warm()
    report: Dict[str, object] = {"cow_insert_ms": probe_ms,
                                 "table_bytes": table.memory_bytes(),
                                 "window_s": sz.stream_window_s}
    names = ("serve_features", "fraud_scored")
    B = sz.timing_batch
    reset_launch_counts()
    for (label, rate), seg in zip((("off", 0.0), ("moderate", MODERATE_RATE),
                                   ("saturating", None)), (None,) + tuple(
                                       segs[:2])):
        _sync_card()
        v0, m0, e0 = table.version, pipe.metrics(), visible_events(table)
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        stop = threading.Event()
        th = None
        if seg is not None:
            th = threading.Thread(target=seg.replay, args=(pipe,), kwargs=dict(
                batch_size=256, rate=rate, stop_event=stop), name="replay")
            th.start()
        lat = []
        t0 = time.perf_counter()
        for i, (rk, rts, rr) in enumerate(request_batches(
                keys, None, rows, B, 1 << 30, seed=51, t0=t_req)):
            if (i >= sz.stream_batches
                    and time.perf_counter() - t0 >= sz.stream_window_s):
                break
            name = names[i % 2]
            t1 = time.perf_counter()
            fr = eng.request(name, rk, rts, rows=rr)
            lat.append(time.perf_counter() - t1)
            check_frame(fr, name, B)
        wall = time.perf_counter() - t0
        m_end = pipe.metrics()
        visible = visible_events(table) - e0     # published in the window
        inserts = m_end["table_version"] - v0
        backlog = m_end["accepted"] - m0["accepted"] - visible
        stop.set()
        t_end = time.perf_counter()
        if th is not None:
            th.join(600.0)
            if th.is_alive():
                raise AssertionError(f"stream {label}: replay did not stop")
        if not pipe.wait_idle(timeout=600.0):
            raise AssertionError(f"stream {label}: the flusher never idled")
        drain_s = time.perf_counter() - t_end
        check_pipe(pipe, f"stream {label}")
        m1 = pipe.metrics()
        flushes = m1["flushes"] - m0["flushes"]
        peak = (torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() else 0)
        if seg is not None and (inserts <= 0 or visible <= 0):
            raise AssertionError(f"stream {label}: nothing was published "
                                 f"inside the window")
        if rate is None and backlog <= 0:
            raise AssertionError(f"stream {label}: the replay ran dry inside "
                                 f"the window (visible {visible})")
        report[label] = dict(
            _pcts(lat), max_ms=float(np.max(lat)) * 1e3,
            requests_per_s=B * len(lat) / wall, window_s=wall,
            events_visible=visible, visible_per_s=visible / wall,
            inserts_in_window=inserts, backlog_at_end=backlog,
            drain_s=drain_s, flushes=flushes,
            mean_flush_ms=(m1["flush_s"] - m0["flush_s"]) / flushes * 1e3
            if flushes else None,
            dropped_late=m1["dropped_late"] - m0["dropped_late"],
            peak_bytes=peak, batches=len(lat))
        r = report[label]
        log(f"stream {label}: {len(lat)} batches in {wall:.3f} s, batch p50 "
            f"{r['p50_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms, max "
            f"{r['max_ms']:.4f} ms, {r['requests_per_s']:.1f} req/s; "
            f"{visible} events visible in the window ({r['visible_per_s']:.1f}"
            f"/s, {inserts} inserts), backlog {backlog}, drained in "
            f"{drain_s:.3f} s; {flushes} flushes (mean {r['mean_flush_ms']} "
            f"ms host); peak device memory {peak} bytes")
    report["launches"] = require_launches(
        ("window_agg", "preagg_window", "last_join"), "the stream phase")
    return report, pipe, t_req, segs[2]


def feature_server(eng, pipe, keys, sz: Sizes, t_req: float, ingest_src
                   ) -> Dict[str, dict]:
    """FeatureServer over serve_features at full size: 6, then 12 client
    threads of single-row requests while ``FeatureServer.ingest`` streams
    events at MODERATE_RATE; each round must publish what it ingested."""
    import threading
    from repro_torch.serving import BatcherConfig, FeatureServer, ServerConfig
    name = "serve_features"
    table = eng.tables["events"]
    report: Dict[str, dict] = {}
    srv = FeatureServer(eng, name, ServerConfig(BatcherConfig(
        max_batch=64, max_delay_s=0.002)))
    pos = 0
    reset_launch_counts()
    try:
        for n_clients in sz.server_clients:
            lat: List[float] = []
            errors: List[BaseException] = []
            stop = threading.Event()
            barrier = threading.Barrier(n_clients + 1)
            ingested = [0, 0]                  # pushed, accepted
            b0, v0 = dict(srv.batcher.stats), table.version
            e0 = visible_events(table)

            def ingest(start):
                try:
                    t0 = time.perf_counter()
                    i = start
                    while not stop.is_set() and i < len(ingest_src):
                        lag = (i - start) / MODERATE_RATE - (
                            time.perf_counter() - t0)
                        if lag > 0:
                            time.sleep(lag)
                        ingested[1] += srv.ingest(int(ingest_src.keys[i]),
                                                  float(ingest_src.ts[i]),
                                                  ingest_src.rows[i])
                        i += 1
                        ingested[0] = i - start
                except BaseException as e:  # raised again below
                    errors.append(e)

            def client(c):
                rng = np.random.default_rng(100 + c)
                try:
                    barrier.wait(300.0)
                    for j in range(sz.server_requests):
                        k = int(keys[rng.integers(0, len(keys))])
                        t1 = time.perf_counter()
                        fr = srv.request(k, t_req + j, timeout=300.0)
                        lat.append(time.perf_counter() - t1)
                        check_frame(fr, name, 1)
                except BaseException as e:  # raised again below
                    errors.append(e)

            feeder = threading.Thread(target=ingest, args=(pos,))
            clients = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            for t in clients:
                t.start()
            feeder.start()
            barrier.wait(300.0)
            t0 = time.perf_counter()
            for t in clients:
                t.join(600.0)
            wall = time.perf_counter() - t0
            stop.set()
            feeder.join(600.0)
            pos += ingested[0]
            if errors:
                raise errors[0]
            if any(t.is_alive() for t in clients + [feeder]):
                raise AssertionError("FeatureServer: a thread did not stop")
            # the reorder window holds the newest 0.5 of event time back:
            # flush what is releasable, then everything must be published
            if not pipe.wait_idle(timeout=600.0):
                raise AssertionError("FeatureServer: the flusher never idled")
            check_pipe(pipe, f"FeatureServer {n_clients} clients")
            published = visible_events(table) - e0
            if ingested[1] <= 0 or published <= 0 or table.version <= v0:
                raise AssertionError(
                    f"FeatureServer {n_clients} clients: ingested "
                    f"{ingested}, published {published}, table version "
                    f"{v0} -> {table.version}")
            st = srv.batcher.stats
            nb = st["batches"] - b0["batches"]
            report[f"clients={n_clients}"] = dict(
                _pcts(lat), qps=len(lat) / wall, requests=len(lat),
                mean_batch=(st["sum_batch"] - b0["sum_batch"]) / nb,
                events_ingested=ingested[0], events_accepted=ingested[1],
                events_published=published,
                table_versions=table.version - v0)
            r = report[f"clients={n_clients}"]
            log(f"FeatureServer {n_clients} clients: per-request p50 "
                f"{r['p50_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms, "
                f"{r['qps']:.1f} req/s, mean batch {r['mean_batch']:.3f}; "
                f"{ingested[0]} events ingested meanwhile ({ingested[1]} "
                f"accepted), {published} published in "
                f"{r['table_versions']} table versions")
    finally:
        srv.close()
    report["launches"] = require_launches(("window_agg", "preagg_window"),
                                          "the FeatureServer phase")
    return report


# ---------------------------------------------------------------------------
# the sharded fraud node: repro_torch.shard at the node's full size
# ---------------------------------------------------------------------------

def _np_frame(fr) -> Dict[str, np.ndarray]:
    cols = {c: np.asarray(v).copy() for c, v in fr.items()}
    cols["__status"] = np.asarray(fr.status).copy()
    return cols


def _sorted_offline(res: Dict[str, np.ndarray], names
                    ) -> Dict[str, np.ndarray]:
    """An offline result with real keys, rows ordered by (key, ts)."""
    order = np.lexsort((res["__ts"], res["__key"]))
    return {c: np.asarray(res[c])[order] for c in
            list(names) + ["__key", "__ts"]}


def shard_reference(eng, keys, ts, rows, sz: Sizes) -> Dict[str, object]:
    """What the sharded node is held to, captured from the unsharded card
    engine before anything changes its tables or deployments: the frames
    of fixed B=100 and B=500 request sets of each deployment, each
    deployment's ``query_offline`` with real keys, and which keys had
    wrapped their rings. Kept as numpy, so the unsharded engine can be
    freed before the shards are built."""
    table = eng.tables["events"]
    sets, frames, offline = {}, {}, {}
    for name in DEPLOYMENTS:
        for B in sz.batches:
            req = next(request_batches(keys, ts, rows, B, 1, seed=300 + B))
            sets[(name, B)] = req
            frames[(name, B)] = _np_frame(eng.request(name, req[0], req[1],
                                                      rows=req[2]))
    inv = np.empty(table.n_keys, np.int64)
    for k, i in table.key_to_idx.items():
        inv[i] = k
    t0 = time.perf_counter()
    for name in DEPLOYMENTS:
        res = eng.query_offline(name)
        res["__key"] = inv[np.asarray(res["__key"])]
        offline[name] = _sorted_offline(
            res, eng.handle(name).phys.feature_names)
    offline_s = time.perf_counter() - t0
    totals = table.snapshot().state.total.cpu().numpy()[:table.n_keys]
    wrapped = set(inv[totals > sz.capacity].tolist())
    log(f"shard reference: {len(sets)} request sets, offline "
        f"{[len(o['__key']) for o in offline.values()]} rows in "
        f"{offline_s:.3f} s; {len(wrapped)} keys wrapped their rings")
    return {"sets": sets, "frames": frames, "offline": offline,
            "wrapped": wrapped, "offline_s": offline_s}


def _check_sharded(fr, want, what: str) -> int:
    """A sharded frame against the unsharded reference: the same status
    and every column bit for bit, on keys that wrapped their rings too (a
    reshard seats a migrated key at its source's ring positions, so its
    pre-aggregate buckets group the same events). Returns how many rows
    of wrapped keys it held."""
    st = np.asarray(fr.status)
    if not np.array_equal(st, want["__status"]):
        raise AssertionError(f"{what}: status differs")
    got = {c: np.asarray(v) for c, v in fr.items()}
    cols = [c for c in want if c not in ("__status", "__wrapped")]
    if sorted(got) != sorted(cols):
        raise AssertionError(f"{what}: columns {sorted(got)} != {cols}")
    for c in cols:
        if not np.array_equal(got[c], want[c]):
            bad = np.flatnonzero(got[c] != want[c])
            raise AssertionError(
                f"{what}: column {c} differs on {len(bad)} rows "
                f"({int(want['__wrapped'][bad].sum())} of wrapped keys)")
    return int(want["__wrapped"].sum())


def sharded_observe(se, ref: Dict[str, object], sz: Sizes,
                    direct_rows: int) -> Dict[str, object]:
    """The sharded tier's observability: merged freshness counts every
    live row the shard engines served (pad rows left out) and equals the
    merge of the shards' own snapshots; one traced B=100 request is a
    tree over admission, the router, its lanes and the shard engines'
    serves with their kernel spans; EXPLAIN ANALYZE merges the four
    shards' profiles. ``direct_rows`` rows per deployment were served on
    shard 0's own handle, outside the sharded handles' counters."""
    from repro_torch.core.results import RequestContext
    from repro_torch.obs import FreshnessTracker
    merged = se.freshness_snapshot()["events"]
    want = (sum(h.metrics.requests for h in se.deployments.values())
            + direct_rows * len(DEPLOYMENTS))
    again = FreshnessTracker.merge(
        [e.freshness_snapshot() for e in se.shards])["events"]
    if merged["serve_rows"] != want or \
            merged["age_sketch"]["count"] != want or \
            again["age_sketch"] != merged["age_sketch"]:
        raise AssertionError(f"sharded freshness: {merged['serve_rows']} "
                             f"rows, {want} served")
    name, B = "fraud_scored", sz.batches[0]
    rk, rts, rr = ref["sets"][(name, B)]
    se.tracer.set_sample_rate(1.0)
    d0 = se.router.stats()["dispatches"]
    fr = se.request(name, rk, rts, rows=rr,
                    ctx=RequestContext(trace_id="smoke-sharded"))
    disp = se.router.stats()["dispatches"] - d0
    se.tracer.set_sample_rate(0.0)
    check_frame(fr, name, B)
    tree = se.tracer.tree("smoke-sharded")
    nodes = se.tracer.walk(tree)
    names = [n["name"] for n in nodes]
    lanes = [n for n in nodes if n["name"] == "lane.execute"]
    serves = [n for n in nodes if n["name"] == "engine.serve"]
    for tier in ("admission", "router.scatter_gather"):
        if tier not in names:
            raise AssertionError(f"sharded trace: no {tier} in {names}")
    if len(serves) != disp or not lanes or any(
            not any(c["name"].startswith("kernel.") for c in s["children"])
            for s in serves) or sum(len(l["children"]) for l in lanes) != \
            disp:
        raise AssertionError(f"sharded trace: {len(lanes)} lanes, "
                             f"{len(serves)} serves for {disp} dispatches")
    txt = se.explain_analyze("serve_features")
    if f"(merged across {sz.shards} shards)" not in txt:
        raise AssertionError(f"sharded EXPLAIN ANALYZE: {txt}")
    log(txt)
    out = {"serve_rows": merged["serve_rows"],
           "age_p99": FreshnessTracker.export({"events": merged})[
               "events/age_p99"],
           "trace_spans": len(nodes), "trace_lanes": len(lanes),
           "trace_serves": len(serves), "dispatches": disp,
           "breakdown": sharded_breakdown(se, ref, sz)}
    log(f"sharded observability: merged freshness {merged['serve_rows']} "
        f"rows == served; trace of one {name} B={B} request: {out}")
    return out


def sharded_breakdown(se, ref: Dict[str, object], sz: Sizes,
                      n: int = 20) -> Dict[str, float]:
    """Where a traced sharded B=500 serve_features batch spends its time,
    the median ms over ``n`` batches (a batch in which the shard engines
    fold their buffers would dominate a mean), from the spans: admission, the router's
    scatter to gather, the wait before the lane starts the first
    sub-batch (queue hand-off and coalescing), the lane's executes (one
    per sub-batch, in turn on the one lane) and the gaps between them,
    the shard engines' serves inside them, the kernels' attributed exec
    seconds inside those, and the gather after the last sub-batch."""
    from repro_torch.core.results import RequestContext
    name = "serve_features"
    rk, rts, rr = ref["sets"][(name, sz.batches[-1])]
    acc: Dict[str, List[float]] = {}

    def add(k, v):
        acc.setdefault(k, []).append(v * 1e3)

    se.tracer.set_sample_rate(1.0)
    try:
        for i in range(n):
            tid = f"smoke-breakdown-{i}"
            check_frame(se.request(name, rk, rts, rows=rr,
                                   ctx=RequestContext(trace_id=tid)),
                        name, len(rk))
            by: Dict[str, list] = {}
            for sp in se.tracer.trace(tid):
                kind = ("kernel" if sp.name.startswith("kernel.")
                        else sp.name)
                by.setdefault(kind, []).append(sp)
            sg, lanes = by["router.scatter_gather"][0], by["lane.execute"]
            for kind in ("admission", "router.scatter_gather",
                         "lane.execute", "engine.serve", "kernel"):
                add(kind, sum(sp.duration_s for sp in by.get(kind, ())))
            first = min(l.start for l in lanes)
            last = max(l.end for l in lanes)
            add("before_first_lane", first - sg.start)
            add("after_last_lane", sg.end - last)
            add("between_lanes", (last - first)
                - sum(l.duration_s for l in lanes))
    finally:
        se.tracer.set_sample_rate(0.0)
    med = {k: float(np.median(v)) for k, v in acc.items()}
    log(f"sharded {name} B={len(rk)} from its spans, median ms a batch: "
        f"{med}")
    return med


def sharded_node(ref: Dict[str, object], unsharded: Dict[str, dict],
                 sz: Sizes, device) -> Dict[str, object]:
    """The fraud node on ``sz.shards`` shards of one card
    (``repro_torch.shard.ShardedEngine``) at its full size: the same
    2,000,000 events through ``ShardedEngine.insert`` (copy-on-write:
    one clone of a shard's table per ``capacity`` events), the three
    deployments, frames and ``query_offline`` equal to the unsharded
    engine's; batch p50/p99 at B=100 and B=500 beside the unsharded
    ones, launches per batch and the device's busy share; ``add_shard``
    then ``remove_shard(0)`` under a serving thread; a FeatureServer
    round of 6 clients. Raises on any failure."""
    import threading
    import weakref
    from repro_torch.core.results import STATUS_SHED
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    from repro_torch.featurestore.table import TableSchema
    from repro_torch.serving import BatcherConfig, FeatureServer, ServerConfig
    from repro_torch.shard import ShardConfig, ShardedEngine
    _sync_card()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    out: Dict[str, object] = {}
    se = ShardedEngine(ShardConfig(n_shards=sz.shards), device=device)
    se.create_table(TableSchema("events", key_col="user", ts_col="ts",
                                value_cols=("amount", "lat", "lon",
                                            "merchant")),
                    max_keys=sz.keys, capacity=sz.capacity,
                    bucket_size=sz.bucket)
    se.create_table(TableSchema("merchants", key_col="merchant",
                                ts_col="mts", value_cols=("risk", "volume")),
                    max_keys=sz.merchants, capacity=64, bucket_size=8,
                    replicate=True)
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.events, n_keys=sz.keys, n_features=4, seed=0))
    per_shard = np.bincount(se.owners_of(keys), minlength=sz.shards)
    clones = int(sum(-(-int(n) // sz.capacity) for n in per_shard))
    shard_bytes = se.tables_of("events")[0].memory_bytes()
    _sync_card()
    t0 = time.perf_counter()
    se.insert("events", keys, ts, rows)
    _sync_card()
    load_s = time.perf_counter() - t0
    fill_merchants(se, ts, sz)
    deploy_all(se, scorer_params(rows, device))
    out["load"] = {
        "seconds": load_s, "events_per_s": sz.events / load_s,
        "events_per_shard": per_shard.tolist(), "clones": clones,
        "shard_table_bytes": shard_bytes,
        "clone_bytes_moved": 2 * clones * shard_bytes,
        "clone_bound_s": 2 * clones * shard_bytes / HBM_BYTES_PER_S,
        "keys_per_shard": [t.n_keys for t in se.tables_of("events")],
        "per_shard_max_keys": se.tables_of("events")[0].max_keys}
    log(f"sharded load: {sz.events} events into {sz.shards} shards in "
        f"{load_s:.3f} s ({sz.events / load_s:.1f} events/s); {clones} "
        f"copy-on-write clones of {shard_bytes} bytes (bound "
        f"{out['load']['clone_bound_s']:.3f} s at the data sheet's rate); "
        f"{out['load']}")
    log(se.explain("fraud_scored"))
    wrapped = ref["wrapped"]
    for (name, B), want in ref["frames"].items():
        want["__wrapped"] = np.isin(ref["sets"][(name, B)][0],
                                    list(wrapped))

    def check_all(what: str) -> int:
        wrapped_rows = 0
        for (name, B), (rk, rts, rr) in ref["sets"].items():
            fr = se.request(name, rk, rts, rows=rr)
            wrapped_rows += _check_sharded(
                fr, ref["frames"][(name, B)], f"{what} {name} B={B}")
        return wrapped_rows

    # ---- equal to the unsharded card engine: online, bit for bit --------
    for (name, B), (rk, rts, rr) in ref["sets"].items():
        fr = se.request(name, rk, rts, rows=rr)
        want = ref["frames"][(name, B)]
        if len(fr.version_vector) != sz.shards:
            raise AssertionError(f"sharded {name}: version vector "
                                 f"{fr.version_vector}")
        for c in want:
            got = (np.asarray(fr.status) if c == "__status" else
                   None if c == "__wrapped" else np.asarray(fr[c]))
            if got is not None and not np.array_equal(got, want[c]):
                raise AssertionError(f"sharded {name} B={B}: {c} differs "
                                     f"from the unsharded card engine")
    log(f"sharded == unsharded, bit for bit: {len(ref['sets'])} request "
        f"sets (B={list(sz.batches)})")
    # ---- offline ----------------------------------------------------------
    t0 = time.perf_counter()
    for name in DEPLOYMENTS:
        res = se.query_offline(name)
        vv = res["__version_vector"]
        got = _sorted_offline(res, se.handle(name).phys.feature_names)
        want = ref["offline"][name]
        for c in want:
            if not np.array_equal(got[c], want[c]):
                raise AssertionError(f"sharded offline {name}: {c} differs")
        if len(vv) != sz.shards:
            raise AssertionError(f"sharded offline {name}: version vector "
                                 f"{vv}")
    out["offline_s"] = time.perf_counter() - t0
    log(f"sharded query_offline == unsharded (sorted by key, ts), three "
        f"deployments in {out['offline_s']:.3f} s (unsharded "
        f"{ref['offline_s']:.3f} s); version vector {vv.tolist()}")
    # ---- serving ----------------------------------------------------------
    plan = {}
    for name in DEPLOYMENTS:       # one shard-level executor call each
        reset_launch_counts()
        rk, rts, rr = ref["sets"][(name, sz.batches[0])]
        se.shards[0].handle(name).request(rk[:4], rts[:4], rows=rr[:4])
        plan[name] = {k: v for k, v in launch_counts().items() if v}
    report: Dict[str, dict] = {}
    reset_launch_counts()
    for name in DEPLOYMENTS:
        for B in sz.batches:
            lat: List[float] = []
            d0 = se.router.stats()["dispatches"]
            c0 = launch_counts()
            e0 = [e.stats.snapshot() for e in se.shards]
            reached = 0
            t0 = time.perf_counter()
            for rk, rts, rr in request_batches(keys, ts, rows, B,
                                               sz.shard_batches, seed=B):
                reached += len(np.unique(se.owners_of(rk)))
                t1 = time.perf_counter()
                fr = se.request(name, rk, rts, rows=rr)
                lat.append(time.perf_counter() - t1)
                check_frame(fr, name, B)
            wall = time.perf_counter() - t0
            # the shard engines' own clocks: serve (request to frame) and
            # exec (executor to device sync), summed over a batch's
            # sub-batches; the rest of the batch is the router's
            e1 = [e.stats.snapshot() for e in se.shards]
            eng_ms = {f: sum(b[f] - a[f] for a, b in zip(e0, e1))
                      / sz.shard_batches * 1e3 for f in ("serve_s",
                                                         "exec_s")}
            disp = se.router.stats()["dispatches"] - d0
            got = {k: v - c0[k] for k, v in launch_counts().items()}
            want = {k: disp * n for k, n in plan[name].items()}
            # a lane dispatches each shard's sub-batch (more than one
            # when a sub-batch outgrows dispatch_rows), and each dispatch
            # launches the plan's kernels once
            if disp < reached or any(got[k] != want[k] for k in want):
                raise AssertionError(
                    f"sharded {name} B={B}: {disp} dispatches for "
                    f"{reached} shard sub-batches, launches {got} != "
                    f"{want}")
            ms = np.asarray(lat) * 1e3
            key = f"{name}/B={B}"
            report[key] = {
                "requests_per_s": B * sz.shard_batches / wall,
                "batch_p50_ms": float(np.percentile(ms, 50)),
                "batch_p99_ms": float(np.percentile(ms, 99)),
                "unsharded_p50_ms": unsharded[key]["batch_p50_ms"],
                "unsharded_p99_ms": unsharded[key]["batch_p99_ms"],
                "shards_reached_per_batch": reached / sz.shard_batches,
                "dispatches_per_batch": disp / sz.shard_batches,
                "shard_serve_ms_per_batch": eng_ms["serve_s"],
                "shard_exec_ms_per_batch": eng_ms["exec_s"],
                "launches_per_batch": {k: v / sz.shard_batches
                                       for k, v in want.items()}}
            log(f"sharded serve {key}: batch p50 "
                f"{report[key]['batch_p50_ms']:.4f} ms, p99 "
                f"{report[key]['batch_p99_ms']:.4f} ms (unsharded "
                f"{report[key]['unsharded_p50_ms']:.4f} / "
                f"{report[key]['unsharded_p99_ms']:.4f}); "
                f"{report[key]['requests_per_s']:.1f} req/s; shard "
                f"engines' serve {eng_ms['serve_s']:.4f} ms and exec "
                f"{eng_ms['exec_s']:.4f} ms per batch; shards "
                f"reached per batch {reached / sz.shard_batches:.2f}, "
                f"launches per batch {report[key]['launches_per_batch']}")
    out["launches"] = require_launches(KERNELS, "the sharded serve phase")
    # the lanes' coalescing wait: the same batches without it
    prev = se.router.set_coalesce_delay(0.0)
    for name in ("serve_features",):
        B = sz.batches[-1]
        lat = []
        for rk, rts, rr in request_batches(keys, ts, rows, B,
                                           sz.shard_batches, seed=B):
            t1 = time.perf_counter()
            check_frame(se.request(name, rk, rts, rows=rr), name, B)
            lat.append(time.perf_counter() - t1)
        report[f"{name}/B={B}"]["no_coalesce_wait"] = _pcts(lat)
        log(f"sharded serve {name}/B={B} with coalesce_delay_s=0: "
            f"{_pcts(lat)}")
    se.router.set_coalesce_delay(prev)
    out["serve"] = report
    out["busy"] = (device_busy(se, keys, ts, rows, sz, report)
                   if device != "cpu" else {})
    out["observe"] = sharded_observe(se, ref, sz, direct_rows=4)
    # ---- elastic reshard under a serving thread -----------------------------
    stop, errors = threading.Event(), []
    seen = {"ok": 0, "shed": 0, "wrapped_rows": 0}
    started = threading.Event()
    small = [(n, B) for (n, B) in ref["sets"] if B == min(sz.batches)]

    def serve():
        i = 0
        try:
            while not stop.is_set():
                name, B = small[i % len(small)]
                i += 1
                rk, rts, rr = ref["sets"][(name, B)]
                fr = se.request(name, rk, rts, rows=rr)
                st = np.asarray(fr.status)
                if (st == STATUS_SHED).all():
                    seen["shed"] += 1
                elif (st == STATUS_SHED).any():
                    raise AssertionError(f"reshard: a mixed batch {st}")
                else:
                    seen["wrapped_rows"] += _check_sharded(
                        fr, ref["frames"][(name, B)], f"reshard {name}")
                    seen["ok"] += 1
                started.set()
        except BaseException as e:          # raised again below
            errors.append(e)
            started.set()

    th = threading.Thread(target=serve, name="reshard-serve")
    th.start()
    try:
        if not started.wait(300.0):
            raise AssertionError("reshard: the serving thread stalled")
        t0 = time.perf_counter()
        s_new = se.add_shard()
        add_ms = (time.perf_counter() - t0) * 1e3
        counts = se._routing.shard_counts()
        # a handle kept across the removal: it must not pin shard 0
        kept = se.handle("fraud_scored")
        shard0 = se.shards[0].tables["events"].memory_bytes()
        table0 = weakref.ref(se.shards[0].tables["events"])
        mem_before = (torch.cuda.memory_allocated()
                      if device != "cpu" else 0)
        t0 = time.perf_counter()
        moved = se.remove_shard(0)
        remove_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stop.set()
        th.join(600.0)
    if errors:
        raise errors[0]
    if th.is_alive() or seen["ok"] == 0:
        raise AssertionError(f"reshard: serving thread {seen}")
    import gc
    gc.collect()
    if table0() is not None:
        raise AssertionError(
            "remove_shard(0): shard 0's table is still referenced by "
            + ", ".join(type(r).__name__ for r in gc.get_referrers(table0())))
    mem_after = torch.cuda.memory_allocated() if device != "cpu" else 0
    log(f"remove_shard(0) with a handle kept ({kept!r}): memory "
        f"allocated {mem_before} bytes before, {mem_after} after (shard "
        f"0's tables: {shard0} bytes; version vector "
        f"{kept.version_vector()})")
    if device != "cpu" and mem_before - mem_after < 6 * 2**30:
        raise AssertionError(f"remove_shard(0) freed only "
                             f"{mem_before - mem_after} bytes")
    del kept
    after = check_all("after the reshard")
    out["reshard"] = {
        "add_shard_ms": add_ms, "remove_shard_ms": remove_ms,
        "new_shard": s_new, "arcs_after_add": counts,
        "events_moved_by_remove": moved, "n_shards": se.n_shards,
        "allocated_before_remove": mem_before,
        "allocated_after_remove": mem_after, "shard0_table_bytes": shard0,
        "batches_ok": seen["ok"], "batches_shed": seen["shed"],
        "wrapped_rows_exact_during": seen["wrapped_rows"],
        "wrapped_rows_exact_after": after,
        "keys_per_shard": [t.n_keys for t in se.tables_of("events")]}
    log(f"reshard under a serving thread: add_shard {add_ms:.3f} ms "
        f"(arcs {counts}), remove_shard(0) {remove_ms:.3f} ms ({moved} "
        f"events moved); {seen['ok']} batches checked, {seen['shed']} "
        f"shed; every row bit for bit, {seen['wrapped_rows']} rows of "
        f"wrapped keys during and {after} after")
    # ---- FeatureServer over the sharded engine ------------------------------
    srv = FeatureServer(se, "serve_features", ServerConfig(BatcherConfig(
        max_batch=64, max_delay_s=0.002)))
    lat: List[float] = []
    errs: List[BaseException] = []
    n_clients = 6
    barrier = threading.Barrier(n_clients + 1)
    t_req = float(ts.max()) + 1.0

    def client(c):
        rng = np.random.default_rng(500 + c)
        try:
            barrier.wait(300.0)
            for j in range(sz.shard_server_requests):
                k = int(keys[rng.integers(0, len(keys))])
                t1 = time.perf_counter()
                fr = srv.request(k, t_req + j, timeout=300.0)
                lat.append(time.perf_counter() - t1)
                check_frame(fr, "sharded FeatureServer", 1)
        except BaseException as e:        # raised again below
            errs.append(e)

    b0 = dict(srv.batcher.stats)
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in clients:
        t.start()
    barrier.wait(300.0)
    t0 = time.perf_counter()
    for t in clients:
        t.join(600.0)
    wall = time.perf_counter() - t0
    srv.close()
    if errs:
        raise errs[0]
    st = srv.batcher.stats
    nb = st["batches"] - b0["batches"]
    out["server"] = dict(_pcts(lat), qps=len(lat) / wall,
                         requests=len(lat), clients=n_clients,
                         mean_batch=(st["sum_batch"] - b0["sum_batch"])
                         / max(nb, 1))
    log(f"sharded FeatureServer {n_clients} clients: {out['server']}")
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if device != "cpu" else 0)
    log(f"sharded phase peak device memory {out['peak_bytes']} bytes")
    se.close()
    return out


# ---------------------------------------------------------------------------
# the process-backed node: one worker process per shard on the card
# ---------------------------------------------------------------------------

PROC_FAULT_PLAN = "seed=1337,drop=0.01,dup=0.02,corrupt=0.01"


def card_used_bytes(device) -> int:
    """Bytes in use on the whole card, every process's (0 on the CPU)."""
    if device == "cpu":
        return 0
    free, total = torch.cuda.mem_get_info()
    return total - free


def compute_apps() -> List[str]:
    """``pid, used_memory`` of each process on the card, as nvidia-smi
    lists them (a container may hide the processes' own pids)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


class CardPeak:
    """The card's largest bytes in use while the block runs, sampled from
    ``mem_get_info`` every 20 ms on a thread (it sees the workers' memory,
    which the parent's allocator statistics do not)."""

    def __init__(self, device):
        import threading
        self.device = device
        self.peak = card_used_bytes(device)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, card_used_bytes(self.device))

    def __enter__(self) -> "CardPeak":
        if self.device != "cpu":
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(10.0)
        self.peak = max(self.peak, card_used_bytes(self.device))


def _exited(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _await(pred: Callable[[], bool], timeout: float, what: str) -> float:
    """Poll ``pred`` every 20 ms; raise if it is still false after
    ``timeout`` seconds; return the seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _recovered(se, restarts: int, timeout: float = 300.0) -> float:
    """Seconds until the supervisor has made ``restarts`` respawns in all
    and every worker serves again."""
    return _await(lambda: se.worker_restarts >= restarts
                  and not se.recovering, timeout,
                  f"recovery to {restarts} respawn(s)")


def check_rows(fr, want, keys, what: str, unknown_ok=frozenset()) -> str:
    """A frame served while a shard is down or back without its data:
    either wholly SHED, or every OK row equal to the reference under
    ``_check_sharded``'s rules, DEGRADED rows (the stale tier's last row
    served for that key, possibly for another request time or row: not
    comparable) and UNKNOWN_KEY only for keys in ``unknown_ok``
    (``keys`` are the request's). Returns the frame's worst status."""
    from repro_torch.core.results import (STATUS_DEGRADED, STATUS_OK,
                                          STATUS_SHED, STATUS_UNKNOWN_KEY,
                                          FeatureFrame)
    st = np.asarray(fr.status)
    if (st == STATUS_SHED).any():
        if not (st == STATUS_SHED).all():
            raise AssertionError(f"{what}: a mixed shed batch {st}")
        return "shed"
    unk = st == STATUS_UNKNOWN_KEY
    if unk.any() and not set(np.asarray(keys)[unk].tolist()) <= unknown_ok:
        raise AssertionError(f"{what}: UNKNOWN_KEY for a key whose shard "
                             f"kept its data")
    rows, deg = st == STATUS_OK, st == STATUS_DEGRADED
    if not (rows | deg | unk).all():
        raise AssertionError(f"{what}: unexpected statuses {set(st)}")
    cols = [c for c in want if not c.startswith("__")]
    if sorted(fr.columns) != sorted(cols):
        raise AssertionError(f"{what}: columns {sorted(fr.columns)}")
    sub = FeatureFrame({c: np.asarray(fr[c])[rows] for c in cols},
                       status=np.full(int(rows.sum()), STATUS_OK, np.int8))
    _check_sharded(sub, dict({c: want[c][rows] for c in cols},
                             __status=want["__status"][rows],
                             __wrapped=want["__wrapped"][rows]), what)
    return "degraded" if deg.any() else "unknown" if unk.any() else "ok"


def serving_thread(se, sets, check):
    """A thread serving ``sets`` round robin, each frame through
    ``check(fr, name, B)`` (its return value counted), every request with
    a 30 s deadline; ``stop()`` ends it and returns the counts, raising
    the first error it met."""
    import threading
    from repro_torch.core.results import RequestContext
    stop, started = threading.Event(), threading.Event()
    seen: Dict[str, object] = {"batches": 0, "slowest_s": 0.0}
    errors: List[BaseException] = []

    def loop():
        i = 0
        try:
            while not stop.is_set():
                (name, B), (rk, rts, rr) = sets[i % len(sets)]
                i += 1
                t0 = time.perf_counter()
                fr = se.request(name, rk, rts, rows=rr,
                                ctx=RequestContext.with_timeout(30.0))
                dt = time.perf_counter() - t0
                kind = check(fr, name, B)
                seen[kind] = seen.get(kind, 0) + 1
                seen["batches"] += 1
                seen["slowest_s"] = max(seen["slowest_s"], dt)
                started.set()
        except BaseException as e:          # raised again by stop()
            errors.append(e)
            started.set()

    th = threading.Thread(target=loop, name="process-serve")
    th.start()
    if not started.wait(300.0):
        raise AssertionError("the serving thread stalled")

    def halt() -> Dict[str, object]:
        stop.set()
        th.join(600.0)
        if errors:
            raise errors[0]
        if th.is_alive():
            raise AssertionError(f"the serving thread hung: {seen}")
        return dict(seen)
    return halt


def process_full(ref, unsharded, sharded, sz: Sizes, device, tmp: str,
                 scorer) -> Dict[str, object]:
    """The fraud node at full size on ``sz.shards`` worker processes
    (``ShardConfig(backend="process")``, one warm standby). Returns its
    report; every process it started has exited when it returns."""
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    from repro_torch.featurestore.table import TableSchema
    from repro_torch.shard import ShardConfig, ShardedEngine
    out: Dict[str, object] = {}
    started_pids = set()
    t0 = time.perf_counter()
    se = ShardedEngine(ShardConfig(
        n_shards=sz.shards, backend="process", standby_workers=1,
        wal_dir=os.path.join(tmp, "wal-full")), device=device)
    out["spawn_s"] = time.perf_counter() - t0
    se.flight.out_dir = tmp
    try:
        started_pids.update(se.backend.pids)
        out["worker_pids"] = [c.proc.pid for c in se.shards]
        log(f"process node: {sz.shards} workers up in {out['spawn_s']:.3f} "
            f"s (pids {out['worker_pids']}, standby "
            f"{se.backend.standby.pids}); card in use "
            f"{card_used_bytes(device)} bytes; per process "
            f"{compute_apps() if device != 'cpu' else []}")
        se.create_table(TableSchema("events", key_col="user", ts_col="ts",
                                    value_cols=("amount", "lat", "lon",
                                                "merchant")),
                        max_keys=sz.keys, capacity=sz.capacity,
                        bucket_size=sz.bucket)
        se.create_table(TableSchema("merchants", key_col="merchant",
                                    ts_col="mts",
                                    value_cols=("risk", "volume")),
                        max_keys=sz.merchants, capacity=64, bucket_size=8,
                        replicate=True)
        keys, ts, rows = generate_events(EventStreamConfig(
            n_events=sz.events, n_keys=sz.keys, n_features=4, seed=0))
        with CardPeak(device) as peak:
            t0 = time.perf_counter()
            se.insert("events", keys, ts, rows)
            load_s = time.perf_counter() - t0
        fill_merchants(se, ts, sz)
        deploy_all(se, scorer_params(rows, device), scorer)
        bound = sharded["load"]["clone_bound_s"]
        out["load"] = {"seconds": load_s,
                       "events_per_s": sz.events / load_s,
                       "clone_bound_s": bound,
                       "inprocess_seconds": sharded["load"]["seconds"],
                       "card_peak_bytes": peak.peak,
                       "card_after_bytes": card_used_bytes(device)}
        log(f"process load: {sz.events} events into {sz.shards} workers in "
            f"{load_s:.3f} s (in process {sharded['load']['seconds']:.3f} "
            f"s; clone bound {bound:.3f} s); card at most {peak.peak} "
            f"bytes in use during the load; per process "
            f"{compute_apps() if device != 'cpu' else []}")
        log(se.explain("fraud_scored"))
        for (name, B), want in ref["frames"].items():
            want["__wrapped"] = np.isin(ref["sets"][(name, B)][0],
                                        list(ref["wrapped"]))

        def check_all(what: str, unknown_ok=frozenset()) -> Dict[str, int]:
            kinds: Dict[str, int] = {}
            for (name, B), (rk, rts, rr) in ref["sets"].items():
                k = check_rows(se.request(name, rk, rts, rows=rr),
                               ref["frames"][(name, B)], rk,
                               f"{what} {name} B={B}", unknown_ok)
                kinds[k] = kinds.get(k, 0) + 1
            return kinds

        # ---- correctness: online, offline --------------------------------
        exact = 0
        for (name, B), (rk, rts, rr) in ref["sets"].items():
            fr = se.request(name, rk, rts, rows=rr)
            want = ref["frames"][(name, B)]
            if len(fr.version_vector) != sz.shards:
                raise AssertionError(f"process {name}: version vector "
                                     f"{fr.version_vector}")
            _check_sharded(fr, want, f"process {name} B={B}")
            exact += all(np.array_equal(np.asarray(fr[c]), want[c])
                         for c in fr.columns)
        t0 = time.perf_counter()
        for name in DEPLOYMENTS:
            res = se.query_offline(name)
            got = _sorted_offline(res, se.handle(name).phys.feature_names)
            for c, v in ref["offline"][name].items():
                if not np.array_equal(got[c], v):
                    raise AssertionError(f"process offline {name}: {c} "
                                         f"differs")
        out["offline_s"] = time.perf_counter() - t0
        log(f"process == unsharded: {len(ref['sets'])} request sets under "
            f"the sharded rules, {exact} of them bit for bit in every "
            f"column; query_offline equal (sorted by key, ts) for the "
            f"three deployments in {out['offline_s']:.3f} s")
        # ---- serving: this path's launch counters, zeroed first ----------
        for c in se.shards:
            c.launch_counts(reset=True)
        e0 = [c.stats.snapshot() for c in se.shards]
        d0 = se.router.stats()["dispatches"]
        report: Dict[str, dict] = {}
        for name in DEPLOYMENTS:
            for B in sz.batches:
                lat: List[float] = []
                t0 = time.perf_counter()
                for rk, rts, rr in request_batches(keys, ts, rows, B,
                                                   sz.proc_batches, seed=B):
                    t1 = time.perf_counter()
                    fr = se.request(name, rk, rts, rows=rr)
                    lat.append(time.perf_counter() - t1)
                    check_frame(fr, name, B)
                wall = time.perf_counter() - t0
                key = f"{name}/B={B}"
                report[key] = dict(
                    {f"batch_{k}": v for k, v in _pcts(lat).items()},
                    requests_per_s=B * sz.proc_batches / wall,
                    inprocess_p50_ms=sharded["serve"][key]["batch_p50_ms"],
                    inprocess_p99_ms=sharded["serve"][key]["batch_p99_ms"],
                    unsharded_p50_ms=unsharded[key]["batch_p50_ms"],
                    unsharded_p99_ms=unsharded[key]["batch_p99_ms"])
                r = report[key]
                log(f"process serve {key}: batch p50 "
                    f"{r['batch_p50_ms']:.4f} ms, p99 "
                    f"{r['batch_p99_ms']:.4f} ms; in process "
                    f"{r['inprocess_p50_ms']:.4f} / "
                    f"{r['inprocess_p99_ms']:.4f}; unsharded "
                    f"{r['unsharded_p50_ms']:.4f} / "
                    f"{r['unsharded_p99_ms']:.4f}; "
                    f"{r['requests_per_s']:.1f} req/s")
        counts = {k: 0 for k in KERNELS}
        for c in se.shards:
            for k, v in c.launch_counts().items():
                counts[k] += v
        e1 = [c.stats.snapshot() for c in se.shards]
        disp = se.router.stats()["dispatches"] - d0
        stats_launches = sum(b["kernel_launches"] - a["kernel_launches"]
                             for a, b in zip(e0, e1))
        # a worker's own serve clock per sub-batch, the 4 serving at once,
        # then one serving alone (every key of a batch on one shard)
        serve_ms = sum(b["serve_s"] - a["serve_s"]
                       for a, b in zip(e0, e1)) / max(disp, 1) * 1e3
        out["solo"] = process_solo(se, keys, ts, rows, sz)
        out["solo"]["worker_serve_ms_all_serving"] = serve_ms
        log(f"process worker serve per sub-batch: {serve_ms:.4f} ms with "
            f"all {sz.shards} serving, {out['solo']['worker_serve_ms']:.4f}"
            f" ms alone ({out['solo']})")
        missing = [k for k in KERNELS if counts[k] == 0]
        if missing or stats_launches <= 0:
            raise AssertionError(f"the process serve phase never launched "
                                 f"{missing} (engine stats: "
                                 f"{stats_launches})")
        # the lanes' coalescing wait: the same batches without it
        prev = se.router.set_coalesce_delay(0.0)
        name, B = "serve_features", sz.batches[-1]
        lat = []
        for rk, rts, rr in request_batches(keys, ts, rows, B,
                                           sz.proc_batches, seed=B):
            t1 = time.perf_counter()
            check_frame(se.request(name, rk, rts, rows=rr), name, B)
            lat.append(time.perf_counter() - t1)
        se.router.set_coalesce_delay(prev)
        report[f"{name}/B={B}"]["no_coalesce_wait"] = _pcts(lat)
        log(f"process serve {name}/B={B} with coalesce_delay_s=0: "
            f"{_pcts(lat)}")
        out["serve"] = report
        out["launches"] = counts
        out["stats_kernel_launches"] = stats_launches
        log(f"process serve phase: the workers' launch counters {counts}; "
            f"their engine stats count {stats_launches} plan launches")
        out["trace"] = process_trace(se, ref, sz)
        txt = se.explain_analyze("serve_features")
        if f"(merged across {sz.shards} shards)" not in txt:
            raise AssertionError(f"process EXPLAIN ANALYZE: {txt}")
        log("process EXPLAIN ANALYZE, the workers' profiles over RPC:\n"
            + txt)
        # ---- reshard under a serving thread ------------------------------
        small = [(k, v) for k, v in ref["sets"].items()
                 if k[1] == min(sz.batches)]
        halt = serving_thread(se, small, lambda fr, name, B: check_rows(
            fr, ref["frames"][(name, B)], ref["sets"][(name, B)][0],
            f"reshard {name}"))
        try:
            t0 = time.perf_counter()
            s_new = se.add_shard()
            add_s = time.perf_counter() - t0
            started_pids.update(se.backend.pids)
            card_add = card_used_bytes(device)
            t0 = time.perf_counter()
            moved = se.remove_shard(0)
            remove_s = time.perf_counter() - t0
        finally:
            seen = halt()
        out["reshard"] = {"add_shard_s": add_s, "remove_shard_s": remove_s,
                          "new_shard": s_new, "events_moved": moved,
                          "adopted": bool(se.shards[s_new].proc.adopted),
                          "card_after_add_bytes": card_add,
                          "card_after_remove_bytes":
                              card_used_bytes(device), "served": seen,
                          "after": check_all("after the reshard")}
        log(f"process reshard under a serving thread: add_shard {add_s:.3f}"
            f" s (standby adopted: {out['reshard']['adopted']}), card "
            f"{card_add} bytes in use; remove_shard(0) {remove_s:.3f} s "
            f"({moved} events moved), card {card_used_bytes(device)} "
            f"bytes; batches {seen}")
        # ---- SIGKILL one worker under the serving thread -----------------
        out["kill"] = process_kill(se, ref, sz, keys,
                                   small, check_all)
        started_pids.update(se.backend.pids)
    finally:
        started_pids.update(se.backend.pids)
        se.close()
    left = [p for p in sorted(started_pids) if not _exited(p)]
    if left:
        raise AssertionError(f"process node: {left} outlived close()")
    return out


def process_solo(se, keys, ts, rows, sz: Sizes, n: int = 40
                 ) -> Dict[str, float]:
    """``n`` B=100 serve_features batches whose keys all live on one
    shard: one worker serves while the others idle. Its serve clock per
    batch against the batch p50 shows what the workers cost each other
    (one card, one host) when all four serve at once."""
    name, B = "serve_features", sz.batches[0]
    s = se._active_ids()[1]
    mine = keys[se.owners_of(keys) == s]
    rng = np.random.default_rng(77)
    c = se.shards[s]
    e0 = c.stats.snapshot()
    lat = []
    for i in range(n):
        idx = rng.integers(0, len(mine), B)
        rk = mine[idx]
        rts = np.full(B, float(ts.max()) + 1.0 + i, np.float32)
        rr = rows[rng.integers(0, len(rows), B)]
        t1 = time.perf_counter()
        check_frame(se.request(name, rk, rts, rows=rr), name, B)
        lat.append(time.perf_counter() - t1)
    e1 = c.stats.snapshot()
    return dict(_pcts(lat), shard=s,
                worker_serve_ms=(e1["serve_s"] - e0["serve_s"]) / n * 1e3)


def process_trace(se, ref, sz: Sizes) -> Dict[str, object]:
    """One traced B=100 fraud_scored request: the workers' engine.serve
    spans, re-based onto this clock, nest inside their lanes' windows and
    carry their kernel children."""
    from repro_torch.core.results import RequestContext
    name, B = "fraud_scored", sz.batches[0]
    rk, rts, rr = ref["sets"][(name, B)]
    se.tracer.set_sample_rate(1.0)
    try:
        check_frame(se.request(name, rk, rts, rows=rr,
                               ctx=RequestContext(trace_id="smoke-proc")),
                    name, B)
    finally:
        se.tracer.set_sample_rate(0.0)
    spans = se.tracer.trace("smoke-proc")
    lanes = {s.span_id: s for s in spans if s.name == "lane.execute"}
    serves = [s for s in spans if s.name == "engine.serve"]
    kernels = [s for s in spans if s.name.startswith("kernel.")
               and any(s.parent_id == v.span_id for v in serves)]
    bad = [s for s in serves if s.parent_id not in lanes
           or not (lanes[s.parent_id].start <= s.start <= s.end
                   <= lanes[s.parent_id].end)]
    if not serves or bad or not kernels:
        raise AssertionError(f"process trace: {len(serves)} serves, "
                             f"{len(bad)} outside their lane, "
                             f"{len(kernels)} kernel spans")
    tree = se.tracer.walk(se.tracer.tree("smoke-proc"))
    log("process trace of one fraud_scored B=100 request: " + "; ".join(
        f"{n['name']} {n['duration_s'] * 1e3:.4f} ms" for n in tree))
    return {"spans": len(spans), "lanes": len(lanes), "serves": len(serves),
            "kernel_spans": len(kernels),
            "serve_ms": [s.duration_s * 1e3 for s in serves],
            "lane_ms": [s.duration_s * 1e3 for s in lanes.values()],
            "adopted": se.tracer.counters["spans_adopted"]}


def process_kill(se, ref, sz: Sizes, keys, small, check_all
                 ) -> Dict[str, object]:
    """SIGKILL a worker of the full-size node under the serving thread:
    every batch returns, wholly SHED or with OK rows equal to the
    reference and DEGRADED rows equal, in every column (PREDICT's score
    included), to the last row served fresh for that key; time to ready
    with the standby adopted; afterwards the other shards' keys equal the
    reference and the killed shard's bulk-loaded keys are UNKNOWN_KEY (a
    bulk insert is not in the WAL)."""
    import signal
    from repro_torch.core.results import (STATUS_DEGRADED, STATUS_OK,
                                          STATUS_SHED)
    victim = next(s for s in se._active_ids() if s != 0)
    down = frozenset(
        k for k in np.unique(np.concatenate(
            [np.asarray(v[0]) for v in ref["sets"].values()])).tolist()
        if se.shard_of(k) == victim)
    _await(lambda: se.backend.standby.n_warm > 0, 300.0, "a warm standby")
    restarts = se.worker_restarts
    # the stale tier's content, mirrored: the last row served OK per
    # (deployment, key), from frames with no SHED or DEGRADED row
    last: Dict[tuple, Dict[str, np.ndarray]] = {}
    degraded = {"rows": 0, "score_rows": 0}

    def check(fr, name, B):
        rk = ref["sets"][(name, B)][0]
        kind = check_rows(fr, ref["frames"][(name, B)], rk, f"kill {name}",
                          down)
        st = np.asarray(fr.status)
        cols = {c: np.asarray(fr[c]) for c in fr.columns}
        for i in np.flatnonzero(st == STATUS_DEGRADED):
            want = last.get((name, rk[i]))
            if want is None:
                raise AssertionError(f"kill {name}: key {rk[i]} DEGRADED "
                                     f"without a fresh row before")
            for c, v in want.items():
                if not np.array_equal(cols[c][i], v):
                    raise AssertionError(f"kill {name}: DEGRADED {c} of key "
                                         f"{rk[i]} is not its last fresh "
                                         f"value")
            degraded["rows"] += 1
            degraded["score_rows"] += "score" in want
        if not ((st == STATUS_SHED) | (st == STATUS_DEGRADED)).any():
            for i in np.flatnonzero(st == STATUS_OK):
                last[(name, rk[i])] = {c: v[i] for c, v in cols.items()}
        return kind

    for (name, B), (rk, rts, rr) in small:   # fill the tier and the mirror
        if check(se.request(name, rk, rts, rows=rr), name, B) != "ok":
            raise AssertionError(f"kill {name}: not OK before the kill")
    halt = serving_thread(se, small, check)
    try:
        pid = se.shards[victim].proc.pid
        os.kill(pid, signal.SIGKILL)
        ready_s = _recovered(se, restarts + 1)
    finally:
        seen = halt()
    rec = dict(se.backend.recovery_stats)
    after = check_all("after the kill", down)
    if after.get("shed") or after.get("degraded"):
        raise AssertionError(f"after the kill: {after}")
    out = {"shard": victim, "pid": pid, "kill_to_ready_s": ready_s,
           "recovery": rec, "served": seen, "after": after,
           "down_keys_in_sets": len(down), "degraded_rows": degraded}
    log(f"process kill of shard {victim} (pid {pid}) under a serving "
        f"thread: ready {ready_s:.3f} s after the kill ({rec}); batches "
        f"{seen} (slowest {seen['slowest_s']:.3f} s); DEGRADED rows equal "
        f"to their keys' last fresh rows: {degraded}; after it {after}, "
        f"the killed shard's {len(down)} bulk-loaded keys UNKNOWN_KEY")
    return out


def process_check(sz: Sizes, device, tmp: str, scorer) -> Dict[str, object]:
    """At check size on the card: (1) WAL recovery — 2 workers fed every
    event through a ShardedPipeline with a WAL, a worker SIGKILLed under a
    serving thread, first with a warm standby, then without one; after
    each recovery the frames bit-identical to an in-process card engine
    that was never killed; a ControlPlane tick during the first recovery
    reports ``recovering``. (2) The seeded fault plan over
    ``sz.fault_batches`` batches: every batch OK and equal to that
    engine's, the retries and corrupt frames in the registry's
    ``transport`` group."""
    import signal
    from repro_torch.control.plane import ControlPlane
    from repro_torch.core.results import (STATUS_DEGRADED, STATUS_OK,
                                          STATUS_SHED)
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    from repro_torch.featurestore.table import TableSchema
    from repro_torch.obs.export import registry_from_engine
    from repro_torch.shard import ShardConfig, ShardedEngine
    from repro_torch.shard.proc.faults import FaultPlan
    ck = dataclasses.replace(sz, keys=sz.check_keys)
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.check_events, n_keys=ck.keys, n_features=4, seed=5))
    params = scorer_params(rows, device)
    sets = {(name, B): next(request_batches(keys, ts, rows, B, 1,
                                            seed=700 + B))
            for name in DEPLOYMENTS for B in sz.batches}

    def build(eng, stream: bool):
        eng.create_table(TableSchema("events", key_col="user", ts_col="ts",
                                     value_cols=("amount", "lat", "lon",
                                                 "merchant")),
                         max_keys=ck.keys, capacity=sz.capacity,
                         bucket_size=sz.bucket)
        eng.create_table(TableSchema("merchants", key_col="merchant",
                                     ts_col="mts",
                                     value_cols=("risk", "volume")),
                         max_keys=sz.merchants, capacity=64, bucket_size=8,
                         replicate=True)
        if stream:
            pipe = eng.attach_stream("events", **LIVE_CFG)
            for i in range(0, len(keys), 2000):
                pipe.push_batch(keys[i:i + 2000], ts[i:i + 2000],
                                rows[i:i + 2000])
            pipe.flush()
        else:
            eng.insert("events", keys, ts, rows)
        fill_merchants(eng, ts, sz)
        deploy_all(eng, params, scorer)

    def same(eng, twin, what: str) -> None:
        for (name, B), (rk, rts, rr) in sets.items():
            got = eng.request(name, rk, rts, rows=rr)
            want = twin.request(name, rk, rts, rows=rr)
            check_frame(got, f"{what} {name}", B)
            if not np.array_equal(got.status, want.status) or any(
                    not np.array_equal(np.asarray(got[c]),
                                       np.asarray(want[c])) for c in want):
                raise AssertionError(f"{what} {name} B={B}: not bit-"
                                     f"identical to the never-killed "
                                     f"engine")

    out: Dict[str, object] = {}
    started = set()
    twin = ShardedEngine(ShardConfig(n_shards=2), device=device)
    se = ShardedEngine(ShardConfig(
        n_shards=2, backend="process", standby_workers=1,
        wal_dir=os.path.join(tmp, "wal-check")), device=device)
    se.flight.out_dir = tmp
    try:
        started.update(se.backend.pids)
        build(twin, stream=True)
        build(se, stream=True)
        same(se, twin, "process check size")
        plane = ControlPlane(se, "serve_features", replan=False)
        plane.tick()
        small = [((n, B), v) for (n, B), v in sets.items()
                 if B == min(sz.batches)]

        def ok_or_shed(fr, name, B):
            """Wholly SHED, or OK and DEGRADED rows only."""
            st = np.asarray(fr.status)
            if (st == STATUS_SHED).all():
                return "shed"
            if not set(st.tolist()) <= {STATUS_OK, STATUS_DEGRADED}:
                raise AssertionError(f"recovery {name}: statuses {st}")
            return "degraded" if (st == STATUS_DEGRADED).any() else "ok"

        for label in ("standby", "cold"):
            if label == "standby":
                _await(lambda: se.backend.standby.n_warm > 0, 300.0,
                       "a warm standby")
            else:                      # no standby: a cold spawn
                pool, se.backend.standby = se.backend.standby, None
                started.update(pool.pids)
                pool.close()
            restarts = se.worker_restarts
            victim = 1 if label == "standby" else 0
            halt = serving_thread(se, small, ok_or_shed)
            try:
                started.add(se.shards[victim].proc.pid)
                os.kill(se.shards[victim].proc.pid, signal.SIGKILL)
                ready_s = _recovered(se, restarts + 1)
            finally:
                seen = halt()
            started.update(se.backend.pids)
            rec = dict(se.backend.recovery_stats)
            if label == "standby":
                tick = plane.tick()
                if tick["recovering"] is not True:
                    raise AssertionError(f"a tick after a respawn: {tick}")
                out["plane_tick"] = {k: tick[k] for k in
                                     ("recovering", "replan", "health")}
            same(se, twin, f"after the {label} recovery")
            if bool(rec["last_adopted"]) != (label == "standby"):
                raise AssertionError(f"{label} recovery: {rec}")
            out[label] = {"kill_to_ready_s": ready_s, "recovery": rec,
                          "served": seen,
                          "wal": dict(se.recovery_stats)}
            log(f"process recovery ({label}, check size): ready "
                f"{ready_s:.3f} s after the kill of shard {victim}; "
                f"{rec}; WAL {se.recovery_stats}; batches {seen}; frames "
                f"bit-identical to the never-killed card engine")
        log(f"control plane tick during the recovery: {out['plane_tick']}")
    finally:
        started.update(se.backend.pids)
        se.close()
    # ---- the seeded fault plan --------------------------------------------
    plan = FaultPlan.parse(PROC_FAULT_PLAN)
    fe = ShardedEngine(ShardConfig(n_shards=2, backend="process",
                                   fault_plan=plan), device=device)
    try:
        started.update(fe.backend.pids)
        build(fe, stream=False)
        names = list(DEPLOYMENTS)
        t0 = time.perf_counter()
        for i, rb in enumerate(request_batches(keys, ts, rows,
                                               sz.batches[0],
                                               sz.fault_batches, seed=9)):
            name = names[i % len(names)]
            got = fe.request(name, *rb[:2], rows=rb[2])
            want = twin.request(name, *rb[:2], rows=rb[2])
            check_frame(got, f"fault plan {name}", sz.batches[0])
            if any(not np.array_equal(np.asarray(got[c]),
                                      np.asarray(want[c])) for c in want):
                raise AssertionError(f"fault plan {name}: a frame differs")
        wall = time.perf_counter() - t0
        transport = registry_from_engine(fe).collect()["transport"]
        injected = [dict(c.proc.ch.fault_injector.stats)
                    for c in fe.shards]
        if transport["retries"] + transport["frame_corrupt"] == 0:
            raise AssertionError(f"fault plan: nothing retried "
                                 f"{transport}")
        out["faults"] = {"plan": PROC_FAULT_PLAN,
                         "batches": sz.fault_batches, "seconds": wall,
                         "transport": transport,
                         "client_injectors": injected,
                         "worker_restarts": fe.worker_restarts}
        log(f"fault plan {PROC_FAULT_PLAN}: {sz.fault_batches} batches all "
            f"OK and equal to the in-process engine's in {wall:.3f} s; "
            f"registry transport {transport}; parent-side injectors "
            f"{injected}")
    finally:
        started.update(fe.backend.pids)
        fe.close()
        twin.close()
    left = [p for p in sorted(started) if not _exited(p)]
    if left:
        raise AssertionError(f"process check: {left} outlived close()")
    return out


def process_node(ref: Dict[str, object], unsharded: Dict[str, dict],
                 sharded: Dict[str, object], sz: Sizes, device
                 ) -> Dict[str, object]:
    """The process-backed shard runtime on the card: the full-size fraud
    node on ``sz.shards`` worker processes (``process_full``), then WAL
    recovery and the fault plan at check size (``process_check``). Every
    worker and standby has exited when it returns, and the card's memory
    is back within 1 GiB of where it was. Raises on any failure."""
    import gc
    import importlib
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    # the workers import this module by name for PREDICT's scorer (a
    # function of __main__ would not unpickle in them); the phases after
    # this one get the import path back as it was
    here = str(Path(__file__).resolve().parent)
    saved_env, saved_path = os.environ.get("PYTHONPATH"), list(sys.path)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in [saved_env] if p])
    if here not in sys.path:
        sys.path.insert(0, here)
    gc.collect()
    _sync_card()
    if device != "cpu":
        torch.cuda.empty_cache()
    before = card_used_bytes(device)
    cpus = sorted(os.sched_getaffinity(0))
    info = torch.cuda.mem_get_info() if device != "cpu" else None
    log(f"process node: card in use before any worker {before} bytes "
        f"(mem_get_info {info}); {os.cpu_count()} CPUs, affinity {cpus}")
    out: Dict[str, object] = {"card_before_bytes": before,
                              "cpu_count": os.cpu_count(),
                              "affinity": len(cpus)}
    tmp = tempfile.mkdtemp(prefix="smoke-proc-")
    try:
        scorer = importlib.import_module("chip_smoke").fraud_scorer
        out["full"] = process_full(ref, unsharded, sharded, sz, device,
                                   tmp, scorer)
        out["check"] = process_check(sz, device, tmp, scorer)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_env
        sys.path[:] = saved_path
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
        _await(lambda: card_used_bytes(device) - before < 2**30, 60.0,
               "the card's memory back within 1 GiB after the workers")
    out["card_after_bytes"] = card_used_bytes(device)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"process node phase: {out['seconds']:.3f} s; card in use "
        f"{out['card_after_bytes']} bytes after it (before: {before})")
    return out


def setup(device, sz: Sizes, workers: int = 1):
    """One node at production key space: the engine with its tables
    filled and the three deployments, and the events it ingested."""
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    eng = make_engine(device, sz, sz.keys, workers)
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
    return eng, (keys, ts, rows), ingest_s


def run(device, sz: Sizes) -> Dict[str, object]:
    """All phases on ``device``; raises on any failure."""
    eng, (keys, ts, rows), ingest_s = setup(device, sz, workers=4)
    table = eng.tables["events"]

    # ---- kernels against their plain versions -----------------------------
    # (no snapshot outlives this call: under the stream phase below every
    # version a caller holds is a 21 GiB table on the card)
    errs = kernel_cases(table.state, table.preagg,
                        eng.tables["merchants"].state, sz,
                        table.n_keys, float(ts.max()), device)
    log(f"kernel checks passed; max abs diff per kernel: {errs}")
    calls = main_path_calls(eng, keys, ts, rows, sz, device)
    timing = per_kernel(calls)
    for k, v in timing.items():
        errs[k] = max(errs[k], v["max_abs_err"])

    # ---- the CUDA engine against the CPU engine ---------------------------
    cuda_vs_cpu(sz, device)
    live = live_path(sz, device)

    # ---- the main path ----------------------------------------------------
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats0 = eng.stats.snapshot()
    report = serve(eng, keys, ts, rows, sz, device)
    launches = launch_counts()
    missing = [k for k in KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    stats = {k: v - stats0[k] for k, v in eng.stats.snapshot().items()}
    log(f"main path launches: {launches}; peak device memory {peak} bytes; "
        f"engine stats over the serve phase: {stats}")
    busy = device_busy(eng, keys, ts, rows, sz, report) \
        if device != "cpu" else {}
    # before the hot swap redeploys serve_features and the stream adds
    # events: what the sharded node must equal
    shard_ref = shard_reference(eng, keys, ts, rows, sz)

    # ---- control and observability ----------------------------------------
    observe = observe_and_control(eng, keys, ts, rows, sz, timing, device)

    # ---- the live path: modes, hot swap, stream, FeatureServer ------------
    modes = execution_modes(eng, keys, ts, rows, sz)
    swap = hot_swap(eng, keys, ts, rows, sz)
    stream, pipe, t_req, rest = stream_interference(eng, keys, rows, sz)
    server = feature_server(eng, pipe, keys, sz, t_req, rest)
    log(f"stream after the FeatureServer phase: {pipe.metrics()}")
    eng.close()                       # drains the stream
    check_pipe(pipe, "the stream's final drain")
    log(f"stream after the final drain: {pipe.metrics()}")
    kernels = [{
        "name": k, "route": "cuda", "source": KERNELS[k][0],
        "replaces": KERNELS[k][1], "launches": launches[k],
        "max_abs_err": errs[k], "ms": timing[k]["ms"],
        "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "call_ms": timing[k]["call_ms"],
        "plain_call_ms": timing[k]["plain_call_ms"]} for k in KERNELS]
    return {"kernels": kernels, "serve": report, "ingest_s": ingest_s,
            "peak_bytes": peak, "engine_stats": stats, "busy": busy,
            "calls": calls, "live": live, "modes": modes, "swap": swap,
            "stream": stream, "server": server, "shard_ref": shard_ref,
            "observe": observe}


# ---------------------------------------------------------------------------
# the paper's baseline execution models (Table 1, Figure 1)
# ---------------------------------------------------------------------------

# benchmarks/common.py's FEATURE_SQL (the benchmarks' deployment; the
# smoke may not import benchmarks/, which imports the JAX package): the
# same text as serve_features
BASELINE_SQL = DEPLOYMENTS["serve_features"]
# the Table 1 systems each execution model stands for
PAPER_SYSTEMS = {"row_interpreter": ("PostgreSQL", "MySQL"),
                 "microbatch": ("SparkSQL", "FlinkSQL"),
                 "columnar_scan": ("ClickHouse",),
                 "columnar_fullscan": ("ClickHouse",)}
FEATURE_KERNELS = ("window_agg", "fused_window", "preagg_window")


def baseline_engine(profile: str, device, keys, ts, rows, n_keys: int,
                    sz: Sizes):
    """``make_engine(profile)`` with the fraud node's events table filled
    and BASELINE_SQL deployed as ``features``; (engine, load seconds)."""
    from repro_torch.core import baselines
    from repro_torch.featurestore.table import TableSchema
    eng = baselines.make_engine(profile, device=device)
    eng.create_table(TableSchema("events", key_col="user", ts_col="ts",
                                 value_cols=("amount", "lat", "lon",
                                             "merchant")),
                     max_keys=n_keys, capacity=sz.capacity,
                     bucket_size=sz.bucket)
    t0 = time.perf_counter()
    eng.insert("events", keys.tolist(), ts.tolist(), rows)
    _sync_card()
    load_s = time.perf_counter() - t0
    eng.deploy("features", BASELINE_SQL)
    return eng, load_s


def _frame_np(out) -> Dict[str, np.ndarray]:
    return {c: np.asarray(out[c]) for c in out}


def _agree(got, want, what: str, tol: float = 1e-3) -> float:
    """``tests/test_engine.py::test_baseline_profiles_agree_on_results``'s
    rule: every column within rtol = atol = 1e-3 of openmldb's."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: columns {sorted(got)}")
    worst = 0.0
    for c in want:
        g, w = np.asarray(got[c], np.float64), np.asarray(want[c],
                                                          np.float64)
        if not np.allclose(g, w, rtol=tol, atol=tol):
            raise AssertionError(f"{what}: {c} differs from openmldb (max "
                                 f"abs diff {np.abs(g - w).max()})")
        worst = max(worst, float(np.abs(g - w).max(initial=0)))
    return worst


def time_profile(runner, sets) -> Dict[str, float]:
    """Batch latencies of ``runner.serve_batch`` over ``sets`` (one
    batch first to warm, untimed): p50/p99 and requests/s."""
    rk, rts, _ = sets[0]
    runner.serve_batch(list(rk), list(rts))
    lat = []
    for rk, rts, _ in sets:
        t0 = time.perf_counter()
        out = runner.serve_batch(list(rk), list(rts))
        _frame_np(out)                     # the results on the host
        lat.append(time.perf_counter() - t0)
    n = sum(len(s[0]) for s in sets)
    return dict(_pcts(lat), requests_per_s=n / sum(lat), batches=len(sets),
                requests=n)


def baselines_phase(sz: Sizes, device) -> Dict[str, object]:
    """The five profiles of ``repro_torch.core.baselines`` on the card,
    over the fraud node's events (2^20 keys, capacity 1024, bucket 64,
    2,000,000 Zipf-1.2 events) and benchmarks/common.py's FEATURE_SQL.
    One full-size engine per flag set, one at a time: ``openmldb`` (the
    row interpreter reads its table; the row kind ignores flags), then
    ``microbatch``/``columnar_scan``. Fixed B=100 request sets: every
    profile within 1e-3 of openmldb; B=100 and B=500 batch p50/p99 and
    requests/s for the engine kinds, a few row-interpreter batches; the
    full scan (K·C per request by design) at check size only. At check
    size each profile on the card equals the same profile on a CPU
    engine. Prints openmldb's speed over each baseline beside the ratios
    of the paper's Table 1. Raises on any failure."""
    from repro_torch.core import baselines
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    t_phase = time.perf_counter()
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.events, n_keys=sz.keys, n_features=4, seed=0))
    sets = {B: list(request_batches(keys, ts, rows, B,
                                    sz.baseline_batches, seed=900 + B))
            for B in sz.batches}
    check = sets[min(sz.batches)][0]
    out: Dict[str, object] = {"timing": {}, "agree_max_abs": {},
                              "launches": {}}
    ref = None
    for flags_of in ("openmldb", "microbatch"):
        eng, load_s = baseline_engine(flags_of, device, keys, ts, rows,
                                      sz.keys, sz)
        log(f"baselines: {flags_of} flags, {sz.events} events in "
            f"{load_s:.3f} s; {eng.tables['events'].memory_bytes()} bytes "
            f"of table state\n" + eng.explain("features"))
        profiles = (("openmldb", "row_interpreter") if flags_of == "openmldb"
                    else ("microbatch", "columnar_scan"))
        for prof in profiles:
            r = baselines.BaselineRunner(eng, "features", prof)
            got = _frame_np(r.serve_batch(list(check[0]), list(check[1])))
            if ref is None:
                ref = got
                for c, v in got.items():
                    if v.shape != (len(check[0]),) or not np.isfinite(
                            v).all():
                        raise AssertionError(f"openmldb {c}: not finite "
                                             f"of length {len(check[0])}")
            out["agree_max_abs"][prof] = _agree(got, ref, f"{prof} B=100")
        reset_launch_counts()
        for prof in profiles:
            r = baselines.BaselineRunner(eng, "features", prof)
            if prof == "row_interpreter":
                out["timing"][prof] = {"B=100": time_profile(
                    r, sets[min(sz.batches)][:sz.baseline_row_batches])}
            else:
                out["timing"][prof] = {f"B={B}": time_profile(r, sets[B])
                                       for B in sz.batches}
            log(f"baselines {prof}: {out['timing'][prof]}")
        launched = require_launches(
            ["preagg_window"] if flags_of == "openmldb"
            else ["fused_window"], f"baselines ({flags_of} flags)")
        out["launches"][flags_of] = launched
        log(f"baselines {flags_of} flags: launches {launched}")
        eng.close()
        del eng, r
        torch.cuda.empty_cache()
    out["fullscan"] = baselines_check_size(sz, device)
    out["agree_max_abs"]["columnar_fullscan"] = out["fullscan"]["agree"]
    # openmldb's speed over each baseline, beside the paper's ratios
    paper = baselines.PAPER_TABLE1
    ours = out["timing"]["openmldb"]
    ratios = {}
    for prof, systems in PAPER_SYSTEMS.items():
        for key, t in out["timing"].get(prof, {}).items():
            ratios[f"{prof}@{key}"] = {
                "openmldb_over_profile": ours[key]["requests_per_s"]
                / t["requests_per_s"],
                "paper": {sname: paper["OpenMLDB(paper)"][0]
                          / paper[sname][0] for sname in systems}}
    fs = out["fullscan"]
    ratios["columnar_fullscan@check_size"] = {
        "openmldb_over_profile": fs["openmldb"]["requests_per_s"]
        / fs["columnar_fullscan"]["requests_per_s"],
        "paper": {"ClickHouse": paper["OpenMLDB(paper)"][0]
                  / paper["ClickHouse"][0]}}
    out["ratios"] = ratios
    for k, v in ratios.items():
        log(f"baselines ratio {k}: openmldb/profile requests/s "
            f"{v['openmldb_over_profile']:.3f}; the paper's Table 1 QPS "
            f"ratios (paper's numbers, not measured here): {v['paper']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"baselines phase: {out['seconds']:.3f} s")
    return out


def baselines_check_size(sz: Sizes, device) -> Dict[str, object]:
    """At check size (``check_events`` events, ``check_keys`` keys):
    every profile on the card against the same profile on a CPU engine
    (the row interpreter exact, the others under ``compare_frames``), the
    full scan within 1e-3 of openmldb, and the full scan's and
    openmldb's batch times at B=100 there."""
    from repro_torch.core import baselines
    from repro_torch.data.synthetic import EventStreamConfig, generate_events
    keys, ts, rows = generate_events(EventStreamConfig(
        n_events=sz.check_events, n_keys=sz.check_keys, n_features=4,
        seed=3))
    B = min(sz.batches)
    sets = list(request_batches(keys, ts, rows, B,
                                sz.baseline_fullscan_batches, seed=950))
    rk, rts, _ = sets[0]
    std_atol = 4e-4 * float(np.abs(rows[:, 0]).max())
    frames: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    out: Dict[str, object] = {"events": sz.check_events,
                              "keys": sz.check_keys}
    for flags_of, profiles in (("openmldb", ("openmldb", "row_interpreter")),
                               ("microbatch", ("microbatch", "columnar_scan",
                                               "columnar_fullscan"))):
        for i, dev in enumerate((device, "cpu")):
            eng, _ = baseline_engine(flags_of, dev, keys, ts, rows,
                                     sz.check_keys, sz)
            for prof in profiles:
                r = baselines.BaselineRunner(eng, "features", prof)
                frames.setdefault(prof, []).append(_frame_np(
                    r.serve_batch(list(rk), list(rts))))
                if i == 0 and prof in ("openmldb", "columnar_fullscan"):
                    out[prof] = time_profile(r, sets)
            eng.close()
    for prof, (card, cpu) in frames.items():
        if prof == "row_interpreter":
            for c in cpu:
                if not np.array_equal(card[c], cpu[c]):
                    raise AssertionError(f"row interpreter card vs CPU: {c}")
        else:
            compare_frames(card, cpu, f"{prof} card vs cpu", std_atol, 0.0)
    out["agree"] = _agree(frames["columnar_fullscan"][0],
                          frames["openmldb"][0],
                          "columnar_fullscan B=100 (check size)")
    log(f"baselines at check size ({sz.check_events} events, "
        f"{sz.check_keys} keys): every profile card == CPU (row "
        f"interpreter exact); full scan B={B}: {out['columnar_fullscan']}, "
        f"openmldb there: {out['openmldb']}")
    return out


# ---------------------------------------------------------------------------
# training on one card
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainSizes:
    arch: str = "qwen2-1.5b"
    check_layers: int = 2        # card vs CPU: full width, 2 layers, f32
    check_batch: int = 2
    check_seq: int = 64
    batch: int = 4               # full width and depth, bf16, remat dots
    seq: int = 512
    steps: int = 10
    resume_steps: int = 4        # 2-layer run, checkpointed half way


def _leaves_of(tree) -> List[torch.Tensor]:
    from repro_torch.models.tree import tree_flatten_with_path
    return [t for _, t in tree_flatten_with_path(tree)]


def _sq_diff(got: torch.Tensor, want: torch.Tensor, device,
             chunk: int = 1 << 26) -> Tuple[float, float]:
    """sum((got - want)^2) and sum(want^2) in f64, computed on ``device``
    a chunk of ``chunk`` elements at a time (on the card: the host's f64
    passes over a full-width model's billion elements take seconds each)."""
    g, w = got.detach().reshape(-1), want.detach().reshape(-1)
    num = den = 0.0
    for i in range(0, w.numel(), chunk):
        a = g[i:i + chunk].to(device).double()
        b = w[i:i + chunk].to(device).double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return num, den


def _rel_l2(got: List[torch.Tensor], want: List[torch.Tensor], device
            ) -> float:
    """The largest relative L2 distance of a leaf of ``got`` from its
    ``want`` (f64, on ``device``)."""
    out = 0.0
    for a, b in zip(got, want):
        num, den = _sq_diff(a, b, device)
        out = max(out, num ** 0.5 / max(den ** 0.5, 1e-30))
    return out


def train_cuda_vs_cpu(ts_: TrainSizes, device) -> Dict[str, float]:
    """``loss_fn``, its gradients and one AdamW step of qwen2-1.5b at full
    width, ``check_layers`` layers, f32, on the card and on the CPU from
    the same seeded parameters: loss within 1e-4 relative, every gradient
    within 1e-4 relative L2, the parameters after the step within 1e-5
    relative L2, over every element and over the elements whose gradient
    is not within 100·eps of 0 (those move by lr·g/(|g|+eps) and are also
    held to the step's bound 2·lr each)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import _value_and_grad, init_params
    from repro_torch.models.tree import tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    cfg = dataclasses.replace(get_config(ts_.arch),
                              n_layers=ts_.check_layers, dtype="float32",
                              param_dtype="float32")
    params = init_params(torch.Generator().manual_seed(9), cfg)
    rng = np.random.default_rng(13)
    shape = (ts_.check_batch, ts_.check_seq)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, shape),
                                    dtype=torch.int32),
             "targets": torch.tensor(rng.integers(0, cfg.vocab_size, shape),
                                     dtype=torch.int32)}
    ocfg = AdamWConfig(warmup_steps=0, schedule="constant")
    res = {}
    for dev in (device, "cpu"):
        p = params if dev == "cpu" else tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _, grads = _value_and_grad(p, cfg, b)
        new, state, _ = adamw_update(grads, adamw_init(p, ocfg), p, ocfg)
        res[dev] = (float(loss), [g.cpu() for g in _leaves_of(grads)],
                    [t.cpu() for t in _leaves_of(new)],
                    [m.cpu() for m in _leaves_of(state.m)])
        del p, b, grads, new, state
    (la, ga, pa, _), (lb, gb, pb, mb) = res[device], res["cpu"]
    if abs(la - lb) > 1e-4 * abs(lb):
        raise AssertionError(f"train loss card {la} vs CPU {lb}")
    g_rel = _rel_l2(ga, gb, device)
    if g_rel > 1e-4:
        raise AssertionError(f"train gradients card vs CPU: relative L2 "
                             f"{g_rel}")
    p_rel, n_near, num, den = 0.0, 0, 0.0, 0.0
    for a, b, m in zip(pa, pb, mb):
        a, b, m = (t.to(device) for t in (a, b, m))
        near = m.abs() / (1.0 - ocfg.b1) < 100 * ocfg.eps
        n_near += int(near.sum())
        a, b = a.double(), b.double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
        p_rel = max(p_rel, float((a - b)[~near].norm()
                                 / b[~near].norm().clamp_min(1e-30)))
        if bool(((a - b).abs()[near] > 2 * ocfg.lr).any()):
            raise AssertionError("train step: an element near eps moved "
                                 "past the step's bound")
    p_all = (num / den) ** 0.5
    if p_rel > 1e-5 or p_all > 1e-5:
        raise AssertionError(f"train step card vs CPU: relative L2 {p_rel} "
                             f"({p_all} over every element)")
    out = {"loss_card": la, "loss_cpu": lb, "grad_rel_l2": g_rel,
           "param_rel_l2": p_rel, "elements_near_eps": n_near,
           "elements": sum(t.numel() for t in pb),
           "param_rel_l2_all_elements": p_all}
    log(f"train card==cpu {ts_.arch} (full width, {ts_.check_layers} layers,"
        f" f32, B={ts_.check_batch} S={ts_.check_seq}): {out}")
    return out


def train_main_path(ts_: TrainSizes, device) -> Dict[str, object]:
    """qwen2-1.5b at full width and depth (bf16, remat ``dots``), batch
    ``batch`` x ``seq``, ``steps`` AdamW steps on one repeated batch:
    finite loss that falls, no skipped step, the flash kernel launched
    (inside its autograd Function: forward and remat recompute) and its
    backward kernel once a layer a step. The first flash call that needs
    a gradient is captured, and the backward kernel is held to its plain
    versions and timed on it (``flash_backward``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(ts_.arch)
    loop = TrainLoop(cfg, opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=2,
                                              total_steps=ts_.steps),
                     seed=0, device=device)
    n_params = sum(t.numel() for t in _leaves_of(loop.params))
    # the peak of the steps: the state held, and what a step adds to it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(17)
    toks = rng.integers(0, cfg.vocab_size, (ts_.batch, ts_.seq + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    lat: List[float] = []
    t = [time.perf_counter()]

    def on_metrics(step, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        lat.append(now - t[0])
        t[0] = now

    captured: List[tuple] = []
    flash_fn = ops.flash_attention

    def capture(q, k, v, **kw):
        if not captured and q.requires_grad:
            captured.append(((q.detach(), k.detach(), v.detach()), kw))
        return flash_fn(q, k, v, **kw)

    reset_launch_counts()
    ops.flash_attention = capture
    try:
        hist = loop.run(iter([batch] * ts_.steps), steps=ts_.steps,
                        log_every=0, on_metrics=on_metrics)["history"]
    finally:
        ops.flash_attention = flash_fn
    require_launches(["flash_attention"], "training")
    flash = launch_counts()["flash_attention"]
    flash_bwd = launch_counts()["flash_attention_bwd"]
    if flash_bwd != cfg.n_layers * ts_.steps:
        raise AssertionError(f"training: {flash_bwd} backward launches in "
                             f"{ts_.steps} steps of {cfg.n_layers} layers")
    bwd_by_route = bwd_routes("training", flash_bwd)
    losses = [m["loss"] for m in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    if any(m["skipped"] for m in hist):
        raise AssertionError(f"a skipped step: {hist}")
    steady = lat[1:]
    step_ms = float(np.percentile(np.asarray(steady) * 1e3, 50))
    tokens = ts_.batch * ts_.seq
    attn = (6 * ts_.batch * cfg.n_heads * ts_.seq * ts_.seq * cfg.hd
            * cfg.n_layers)            # causal: half of 12·B·H·S²·D
    flops = 6 * n_params * tokens + attn
    out = {"params": n_params, "losses": losses, "step_ms_p50": step_ms,
           "first_step_ms": lat[0] * 1e3,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu_bf16_dense_peak": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "flash_launches": flash,
           "flash_launches_per_step": flash / ts_.steps,
           "flash_bwd_launches": flash_bwd,
           "flash_bwd_launches_per_step": flash_bwd / ts_.steps,
           "flash_bwd_routes": bwd_by_route}
    out["busy"] = train_busy(loop, batch, step_ms)
    log(f"train main path {ts_.arch} (full width and depth, bf16, remat "
        f"{cfg.remat}, B={ts_.batch} S={ts_.seq}, {ts_.steps} steps): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step p50 {step_ms:.3f} ms "
        f"(first {lat[0] * 1e3:.3f} ms); {out['tokens_per_s']:.1f} tokens/s;"
        f" model FLOPs {flops:.4e}/step = {out['mfu_bf16_dense_peak']:.4f} "
        f"of the 989 TFLOP/s bf16 dense peak; peak device memory "
        f"{out['peak_bytes']} bytes; flash_attention launches {flash} "
        f"({flash / ts_.steps:.1f} per step), flash_attention_bwd "
        f"{flash_bwd} ({flash_bwd / ts_.steps:.1f} per step); "
        f"{card_line()}")
    del loop
    (a, kw), = captured
    out["flash_backward"] = flash_backward(a, kw, device)
    out["flash_backward_d64"] = flash_backward(granite_attention(device), {},
                                               device)
    return out


def granite_attention(device) -> tuple:
    """Seeded q, k, v of granite-moe-3b-a800m's training attention call in
    the families phase (bf16, 4 x 512, 24 query heads of 64 over 8): the
    backward's head dim 64 beside the main path's 128."""
    from repro_torch.configs.registry import get_config
    cfg, fs = get_config("granite-moe-3b-a800m"), FamilySizes()
    return tuple(_randn((fs.train_batch, fs.train_seq, h, cfg.hd),
                        torch.bfloat16, device, 80 + i)
                 for i, h in enumerate((cfg.n_heads, cfg.n_kv_heads,
                                        cfg.n_kv_heads)))


# the backward's device ms per call at the training call before its
# redesign for Hopper (mma.sync, 64 dK/dV blocks; H100 80GB HBM3, 700 W),
# logged beside this run's time and kept out of the measured kernels line
BWD_REDESIGNED_FROM_MS = 0.2402
BWD_KERNEL = {   # name -> (CUDA source, what it replaces)
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "none: no TPU kernel; JAX differentiates src/repro/kernels/ref.py:451 "
        "(flash_attention_ref)"),
}


def _grads_err(got, want, what: str) -> float:
    """Largest absolute difference of dq, dk, dv from ``want`` (any float
    dtype), held at ATTN_TOL of ``got``'s dtype."""
    err = 0.0
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        tol = ATTN_TOL[g.dtype]
        g, w = g.float(), w.float()
        d = float((g - w).abs().max())
        if not bool(torch.isfinite(g).all()) or not torch.allclose(
                g, w, rtol=tol, atol=tol):
            raise AssertionError(f"{what} {name}: max abs diff {d}, "
                                 f"tolerance {tol}")
        err = max(err, d)
    return err


def _backward_inputs(a: tuple, kw: dict, seed: int):
    """A flash call's q, k, v (detached), its options resolved (scale,
    q_offset), a seeded dO and the training forward's out and lse."""
    q, k, v = a
    D, Sq, Sk = q.shape[-1], q.shape[1], k.shape[1]
    opts = dict(causal=kw.get("causal", True), window=kw.get("window"),
                scale=kw.get("scale") or D ** -0.5,
                q_offset=Sk - Sq if kw.get("q_offset") is None
                else kw["q_offset"])
    dout = _randn(tuple(q.shape), q.dtype, q.device, seed)
    out, lse = torch.ops.repro_torch.flash_attention_fwd_lse(
        q, k, v, opts["causal"], opts["window"], opts["scale"],
        opts["q_offset"])
    return q, k, v, dout, out, lse, opts


def _plain_recompute(q, k, v, dout, opts):
    """The backward the port had before its kernel: the plain version
    recomputed in f32 under autograd, gradients cast back."""
    from repro_torch.kernels import ref
    ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
    o = ref.flash_attention_ref(*ins, **opts)
    return tuple(g.to(q.dtype) for g in torch.autograd.grad(o, ins,
                                                           dout.float()))


def check_flash_backward(a: tuple, kw: dict, what: str, seed: int) -> float:
    """The backward kernel on one call's inputs against the plain backward
    (fed the kernel forward's out and lse) and against autograd of the
    plain version in f32; returns the largest absolute difference."""
    from repro_torch.kernels import flash_attention_bwd as fb, ref
    q, k, v, dout, out, lse, opts = _backward_inputs(a, kw, seed)
    got = fb.flash_attention_bwd_cuda(dout, q, k, v, out, lse, **opts)
    err = _grads_err(got, ref.flash_attention_bwd_ref(
        dout, q, k, v, out, lse, **opts), f"{what} vs the plain backward")
    ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*ins, **opts), ins,
                               dout.float())
    return max(err, _grads_err(got, want, f"{what} vs autograd"))


def _sdpa_backend(fn: Callable[[], object]) -> str:
    """Which of scaled_dot_product_attention's backends ran: the aten op
    it dispatched to (``_scaled_dot_product_<backend>_attention``), from
    torch.profiler's host-side events of one call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops_ = {e.name for e in prof.events()
            if "scaled_dot_product" in e.name
            and e.name.endswith("_attention")}
    for backend in ("cudnn", "flash", "efficient"):
        if any(f"_scaled_dot_product_{backend}_attention" in n for n in ops_):
            return backend
    return "math" if ops_ else "not seen (no attention op profiled)"


def kernel_ms_by_name(fn: Callable[[], object], n: int = 10
                      ) -> Dict[str, dict]:
    """Device ms of each CUDA kernel ``fn`` launches, from torch.profiler
    over ``n`` calls after one unprofiled call: the mean over the launches
    the profiler recorded, and their number (it may miss some of a
    ctypes library's launches; empty where it records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t and e.count:
            times[e.key[:60]] = {"ms": t / 1e3 / e.count,
                                 "recorded": e.count, "calls": n}
    return times


def flash_backward(a: tuple, kw: dict, device) -> Dict[str, object]:
    """The backward kernel on the training main path's first flash call
    (its q, k, v; a seeded dO): held to its plain versions, then device
    time per call (``_device_ms``) of the kernel (and of each of its
    launches, ``kernel_ms_by_name``); of the plain backward
    the port had before it (the plain version recomputed in f32 under
    autograd); and of the library, scaled_dot_product_attention's
    backward by ``torch.autograd.grad`` (``enable_gqa``): its forward
    plus backward less its forward, both timed with inputs that need a
    gradient. The bound counts q, k, v, out, dO, lse, Di, dq, dk and dv
    once and the five products over the kept pairs (10·B·Hq·D a pair);
    beside it the plan's route, grid and f32 scratch, and the bound with
    that scratch written and read once."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels.flash_attention import kept_pairs
    t0 = time.perf_counter()
    err = check_flash_backward(a, kw, "flash_attention_bwd main path", 61)
    q, k, v, dout, out, lse, opts = _backward_inputs(a, kw, 61)
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]

    def kernel():
        return fb.flash_attention_bwd_cuda(dout, q, k, v, out, lse, **opts)

    res = {"ms": _device_ms(kernel, 20),
           "plain_ms": _device_ms(lambda: _plain_recompute(q, k, v, dout,
                                                           opts), 5),
           "kernels_ms": kernel_ms_by_name(kernel)}
    lib = None
    if opts["window"] is None and opts["q_offset"] == Sk - Sq and (
            not opts["causal"] or Sq == Sk):
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dt = dout.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=opts["causal"], scale=opts["scale"],
                enable_gqa=True)

        def lib_both():
            return torch.autograd.grad(lib_fwd(), (qt, kt, vt), dt)

        both, fwd = _device_ms(lib_both, 20), _device_ms(lib_fwd, 20)
        lib = {"library_ms": both - fwd, "library_fwd_bwd_ms": both,
               "library_fwd_ms": fwd, "library_backend":
                   _sdpa_backend(lib_both)}
    res.update(lib or {"library_ms": None,
                       "library_backend": "none at this mask"})
    pairs = kept_pairs(Sq, Sk, opts["causal"], opts["window"],
                       opts["q_offset"])
    nbytes = (q.element_size() * (4 * q.numel() + 4 * k.numel())
              + 2 * 4 * B * Hq * Sq)
    flops = 10.0 * B * Hq * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS_PER_S * 1e3
    p = fb.plan(B, Sq, Sk, Hq, k.shape[2], D, q.dtype)
    res.update(bound_ms=max(t_bytes, t_flops),
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               bytes=nbytes, flops=flops, max_abs_err=err, route=p.route,
               split=p.split, blocks=dict(p.blocks),
               scratch_bytes=p.scratch_bytes,
               bound_with_scratch_ms=max(
                   (nbytes + 2 * p.scratch_bytes) / HBM_BYTES_PER_S * 1e3,
                   t_flops),
               shape=[list(t.shape) for t in (q, k, v)], dtype=str(q.dtype),
               options={k_: v_ for k_, v_ in opts.items()},
               seconds=time.perf_counter() - t0)
    log(f"time flash_attention_bwd {res['shape']} {q.dtype} {opts}: device "
        f"per call: kernel {res['ms']:.6f} ms, plain (f32 recompute under "
        f"autograd) {res['plain_ms']:.6f} ms, library backward "
        f"{res['library_ms']} ms ({res['library_backend']}), bound "
        f"{res['bound_ms']:.6f} ms ({res['bound_by']}: {nbytes} bytes, "
        f"{flops} flops); route {p.route}, split {p.split}, blocks "
        f"{dict(p.blocks)}, scratch {p.scratch_bytes} bytes (bound with it "
        f"{res['bound_with_scratch_ms']:.6f} ms); by kernel (torch.profiler)"
        f" {res['kernels_ms'] or 'not measured'}; max abs diff {err}; "
        f"{res['seconds']:.3f} s; {card_line()}")
    return res


def train_busy(loop, batch, p50_ms: float) -> Dict[str, object]:
    """One more train step under torch.profiler: device time by kernel
    (the top 10) and the step's device busy share of the unprofiled
    p50."""
    from torch.profiler import ProfilerActivity, profile
    b = {k: torch.as_tensor(v, device=loop.device) for k, v in batch.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.params, loop.opt_state, _ = loop.train_step(
            loop.params, loop.opt_state, b)
        torch.cuda.synchronize()
    per_kernel: Dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
    dev_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {"device_ms_per_step": dev_ms,
           "busy_share_of_p50": dev_ms / p50_ms if dev_ms else None,
           "device_launches": launches,
           "top": [[k[:70], v / 1e3] for k, v in top]}
    if not dev_ms:
        log("busy train step: the profiler recorded no device events; "
            "device time not measured")
    else:
        log(f"busy train step: device {dev_ms:.3f} ms = "
            f"{dev_ms / p50_ms:.4f} of the step p50, {launches} device "
            f"operations; top: " + "; ".join(
                f"{k} {v:.3f} ms" for k, v in out["top"]))
    return out


def train_resume(ts_: TrainSizes, device) -> Dict[str, object]:
    """A 2-layer qwen2-1.5b (full width, bf16) trained ``resume_steps``
    steps straight, and again interrupted half way: saved, restored into a
    new TrainLoop and run on. The two end bit for bit equal."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import TrainLoop, make_batches
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_config(ts_.arch), n_layers=2)
    n = ts_.resume_steps
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=n)
    batches = [b for b, _ in zip(make_batches(cfg, batch=2, seq=64, seed=0,
                                              pipeline=False), range(n))]
    tmp = tempfile.mkdtemp(prefix="smoke-ckpt-")
    try:
        straight = TrainLoop(cfg, opt_cfg=ocfg, seed=1, device=device)
        straight.run(iter(batches), steps=n, log_every=0)
        first = TrainLoop(cfg, opt_cfg=ocfg, seed=1, device=device,
                          ckpt_dir=tmp, retain=1)
        first.run(iter(batches[:n // 2]), steps=n // 2, log_every=0)
        t0 = time.perf_counter()
        first.save(block=True)
        save_s = time.perf_counter() - t0
        del first
        second = TrainLoop(cfg, opt_cfg=ocfg, seed=2, device=device,
                           ckpt_dir=tmp, retain=1)
        t0 = time.perf_counter()
        if not second.restore() or second.step != n // 2:
            raise AssertionError("resume: no checkpoint restored")
        restore_s = time.perf_counter() - t0
        second.run(iter(batches[n // 2:]), steps=n, log_every=0)
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(tmp) for f in fs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for a, b in zip(_leaves_of(second.params) + _leaves_of(
            second.opt_state), _leaves_of(straight.params)
            + _leaves_of(straight.opt_state)):
        if not torch.equal(a, b):
            raise AssertionError("resume: not bit for bit the straight run")
    out = {"steps": n, "save_s": save_s, "restore_s": restore_s,
           "checkpoint_bytes": ckpt_bytes}
    log(f"train resume (2 layers, full width, bf16): saved at step "
        f"{n // 2} in {save_s:.3f} s ({ckpt_bytes} bytes), restored in "
        f"{restore_s:.3f} s; after {n} steps parameters and optimizer "
        f"state bit for bit those of the straight run")
    return out


def train_cli(device) -> Dict[str, object]:
    """``python -m repro_torch.launch.train --arch qwen2-1.5b --reduced
    --steps 5`` with its default device, as a user runs it."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--reduced", "--steps", "5"],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=str(SRC.parent))
    if out.returncode != 0:
        raise AssertionError(f"launch.train failed ({out.returncode}):\n"
                             f"{out.stderr[-3000:]}")
    last = out.stdout.strip().splitlines()[-1]
    if not last.startswith("final loss") or f"on {device}" not in last:
        raise AssertionError(f"launch.train: {out.stdout[-2000:]}")
    log(f"launch.train --reduced --steps 5: {last}")
    return {"last_line": last}


def train_phase(device, ts_: TrainSizes = TrainSizes()) -> Dict[str, object]:
    """Training on one card: card vs CPU, the full-depth main path, a
    checkpointed resume, the CLI. Raises on any failure."""
    t_phase = time.perf_counter()
    out = {"cuda_vs_cpu": train_cuda_vs_cpu(ts_, device)}
    torch.cuda.empty_cache()
    out["main"] = train_main_path(ts_, device)
    torch.cuda.empty_cache()
    out["resume"] = train_resume(ts_, device)
    torch.cuda.empty_cache()
    out["cli"] = train_cli(device)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"train phase: {out['seconds']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# the model server: attention kernels, card against CPU, main path
# ---------------------------------------------------------------------------

ATTN_KERNELS = {   # name -> (CUDA source, the TPU kernel it replaces)
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:88"),
}
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version: the kernels keep the logits in f32 where the
# plain versions round them to the input dtype (in bf16 both round the
# probabilities to bf16 before PV)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@dataclasses.dataclass(frozen=True)
class ModelSizes:
    arch: str = "qwen2-1.5b"
    slots: int = 16
    cache_len: int = 1024
    # (prompts admitted, prompt length, decode steps after the admission)
    admissions: tuple = ((8, 512, 32), (8, 384, 128))
    check_layers: int = 2        # card-vs-CPU model: full width, 2 layers
    check_prompts: int = 2
    check_len: int = 64
    check_steps: int = 8
    reps: int = 30


def _randn(shape, dtype, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


def _attn_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    tol = ATTN_TOL[want.dtype]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    d = float((g - w).abs().max())
    if not bool(torch.isfinite(g).all()) or not torch.allclose(
            g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: differs from the plain version (max "
                             f"abs diff {d}, tolerance {tol})")
    return d


def attention_cases(device) -> Dict[str, float]:
    """Both attention kernels against their plain versions, bf16 and f32:
    MHA, GQA and MQA; causal, causal with a window and full; Sq < Sk and
    ragged lengths, and Sq > Sk non-causal (cross-attention); decode in
    prefix mode with and without a window, a length past the cache, and
    in ring mode past the window. No case has a query that keeps no key
    (the kernels write 0 there, the plain versions the uniform average).
    Flash also runs query counts one past and one short of its 64-row
    tiles and a window of 8; decode also runs lengths on and around its
    split edges. Every family's main-path shapes are here, seamless's
    among them: its encoder, decoder and cross flash calls as the
    ``encdec`` phase serves (8 x 64 tokens over 1024 frames) and trains
    (4 x 512 over 512), and its decode calls at 8 x 1024 rows, the cross
    call at every length 1024 and the self-attention cache at 65-93;
    and the ``mesh`` phase's calls on one rank's local heads (qwen2-1.5b
    at model=2: 6 q heads over its one kv head, 128 wide), flash as it
    trains (2 x 128) and prefills (2 x 64), decode over its 72-row cache;
    and ``mesh_moe``'s (granite at model=2: 12 q over 4 kv heads of 64,
    trained and prefilled, decoded over 72 rows; mixtral: 24 over 4 of
    128, prefilled with its 4096 window, decoded in its 72-slot ring);
    and ``mesh_families``' (jamba at model=2: 16 q over 4 kv heads of
    128, prefilled over 320 rows and decoded over 328; qwen2-vl: 14 over
    2 of 128, q and k rotated by M-RoPE, trained and prefilled over 256
    patches and 64 tokens, decoded over 328); and ``mesh_encdec``'s
    (seamless at model=2: 8 of its 16 heads of 64 on a data rank's 2
    rows; the encoder over 256 and 1024 frames, the decoder's self calls
    over 128 and 64 tokens, its cross calls non-causal over the frames,
    decoded over the 72-row cache and every one of 1024 frames); and
    flash at a query offset (0, a point off the tile edges, ``Sk − Sq``)
    at the ``mesh`` phase's context-parallel calls (a rank's 64 of 128
    training rows and 32 of 64 prompt rows, every qwen2-1.5b head) and
    at ragged tiles. Returns the largest absolute difference."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import apply_rope, mrope_positions_text
    from repro_torch.kernels.decode_attention import SPLIT
    errs = {k: 0.0 for k in ATTN_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for B, Sq, Sk, Hq, Hkv, D in ((2, 128, 128, 4, 4, 64),
                                      (1, 128, 128, 8, 2, 64),
                                      (2, 64, 128, 4, 1, 32),
                                      (2, 37, 53, 6, 2, 80),
                                      (1, 200, 200, 12, 2, 128),
                                      (1, 33, 70, 4, 2, 96),
                                      (2, 65, 65, 12, 2, 128),
                                      (1, 127, 127, 6, 2, 16),
                                      # granite, jamba, qwen2-vl heads
                                      (1, 512, 512, 24, 8, 64),
                                      (1, 1088, 1088, 32, 8, 128),
                                      (1, 1088, 1088, 28, 4, 128),
                                      # seamless's cross-attention heads,
                                      # the decoder longer than the encoder
                                      (2, 200, 37, 16, 16, 64),
                                      # seamless served: the decoder's
                                      # self and cross calls, the encoder
                                      (8, 64, 64, 16, 16, 64),
                                      (8, 64, 1024, 16, 16, 64),
                                      (8, 1024, 1024, 16, 16, 64),
                                      # seamless trained: all three calls
                                      (4, 512, 512, 16, 16, 64),
                                      # the mesh phase's local heads:
                                      # trained, prefilled
                                      (2, 128, 128, 6, 1, 128),
                                      (2, 64, 64, 6, 1, 128),
                                      # mesh_moe's: granite trained and
                                      # prefilled, mixtral prefilled
                                      (2, 128, 128, 12, 4, 64),
                                      (2, 64, 64, 12, 4, 64),
                                      (2, 64, 64, 24, 4, 128),
                                      # mesh_families': jamba prefilled
                                      # (qwen2-vl's below, with M-RoPE)
                                      (2, 320, 320, 16, 4, 128),
                                      # mesh_encdec's 8 of seamless's 16
                                      # heads a rank: trained (encoder,
                                      # self, cross), then served
                                      (2, 256, 256, 8, 8, 64),
                                      (2, 128, 128, 8, 8, 64),
                                      (2, 128, 256, 8, 8, 64),
                                      (2, 1024, 1024, 8, 8, 64),
                                      (2, 64, 64, 8, 8, 64),
                                      (2, 64, 1024, 8, 8, 64)):
            q = _randn((B, Sq, Hq, D), dtype, device, 1)
            k = _randn((B, Sk, Hkv, D), dtype, device, 2)
            v = _randn((B, Sk, Hkv, D), dtype, device, 3)
            for causal, window in ((True, None), (True, 32), (True, 8),
                                   (True, 4096), (False, None)):
                if causal and Sq > Sk:
                    continue     # its first queries would keep no key
                kw = dict(causal=causal, window=window)
                errs["flash_attention"] = max(
                    errs["flash_attention"], _attn_err(
                        ops.flash_attention(q, k, v, **kw),
                        ref.flash_attention_ref(q, k, v, **kw),
                        f"flash {dtype} {(B, Sq, Sk, Hq, Hkv, D)} {kw}"))
        # context parallelism: a rank's rows at their global positions
        for B, Sq, Sk, Hq, Hkv, D in ((2, 64, 128, 12, 2, 128),
                                      (2, 32, 64, 12, 2, 128),
                                      (1, 100, 300, 4, 2, 64),
                                      (2, 48, 200, 6, 2, 80)):
            q = _randn((B, Sq, Hq, D), dtype, device, 25)
            k = _randn((B, Sk, Hkv, D), dtype, device, 26)
            v = _randn((B, Sk, Hkv, D), dtype, device, 27)
            for off in (0, (Sk - Sq) // 2 + 3, Sk - Sq):
                for window in (None, 32):
                    kw = dict(causal=True, window=window, q_offset=off)
                    errs["flash_attention"] = max(
                        errs["flash_attention"], _attn_err(
                            ops.flash_attention(q, k, v, **kw),
                            ref.flash_attention_ref(q, k, v, **kw),
                            f"flash {dtype} {(B, Sq, Sk, Hq, Hkv, D)} {kw}"))
        for B, S, Hq, Hkv, D in ((4, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                                 (3, 64, 4, 1, 32), (16, 1024, 12, 2, 128),
                                 (2, 100, 9, 3, 80), (6, 300, 12, 2, 128),
                                 (8, 1024, 24, 8, 64), (8, 1024, 32, 8, 128),
                                 (4, 1120, 28, 4, 128),
                                 (2, 72, 6, 1, 128),     # mesh local heads
                                 (2, 72, 12, 4, 64),     # mesh_moe granite
                                 (2, 328, 16, 4, 128),   # mesh_families:
                                 (2, 328, 14, 2, 128),   # jamba, qwen2-vl
                                 (2, 72, 8, 8, 64)):     # mesh_encdec self
            q = _randn((B, Hq, D), dtype, device, 4)
            kc = _randn((B, S, Hkv, D), dtype, device, 5)
            vc = _randn((B, S, Hkv, D), dtype, device, 6)
            if S == 300:                        # split edges, past the cache
                lengths = np.array([1, SPLIT - 1, SPLIT, SPLIT + 1, S,
                                    S + 9])
            else:
                lengths = np.random.default_rng(S).integers(1, S + 1, B)
                lengths[0] = S + 9              # past the cache: counts as S
            lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
            for window in (None, 48):
                errs["decode_attention"] = max(
                    errs["decode_attention"], _attn_err(
                        ops.decode_attention(q, kc, vc, lengths,
                                             window=window),
                        ref.decode_attention_ref(q, kc, vc, lengths,
                                                 window=window),
                        f"decode prefix {dtype} {(B, S, Hq, Hkv, D)} "
                        f"window={window}"))
        for S, window in ((16, 8), (64, 64), (300, 100)):
            q = _randn((6, 8, 64), dtype, device, 7)
            kc = _randn((6, S, 2, 64), dtype, device, 8)
            vc = _randn((6, S, 2, 64), dtype, device, 9)
            pos = torch.tensor([0, S // 2, S - 1, S, 3 * S + 5, 10 * S + 1],
                               dtype=torch.int32, device=device)
            errs["decode_attention"] = max(
                errs["decode_attention"], _attn_err(
                    ops.decode_attention(q, kc, vc, pos, window=window,
                                         ring=True),
                    ref.decode_attention_ref(q, kc, vc, pos, window=window,
                                             ring=True),
                    f"decode ring {dtype} S={S} window={window}"))
        # seamless: 16/16 heads of 64 over 1024 rows, the cross call at
        # every length 1024 and the self-attention cache after a 64-token
        # prompt; and mesh_encdec's rank, 8 of the heads and 2 rows
        q = _randn((8, 16, 64), dtype, device, 13)
        kc = _randn((8, 1024, 16, 64), dtype, device, 14)
        vc = _randn((8, 1024, 16, 64), dtype, device, 15)
        for lengths in (np.full(8, 1024), np.arange(65, 97, 4)):
            lengths = torch.tensor(lengths, dtype=torch.int32,
                                   device=device)
            errs["decode_attention"] = max(
                errs["decode_attention"], _attn_err(
                    ops.decode_attention(q, kc, vc, lengths),
                    ref.decode_attention_ref(q, kc, vc, lengths),
                    f"decode prefix {dtype} seamless heads S=1024 "
                    f"lengths {lengths.tolist()}"))
        q, kc, vc = (t[:2, ..., 8:, :].contiguous() for t in (q, kc, vc))
        lengths = torch.full((2,), 1024, dtype=torch.int32, device=device)
        errs["decode_attention"] = max(
            errs["decode_attention"], _attn_err(
                ops.decode_attention(q, kc, vc, lengths),
                ref.decode_attention_ref(q, kc, vc, lengths),
                f"decode prefix {dtype} mesh_encdec cross, 8 local heads"))
        # qwen2-vl's local heads in mesh_families: 14/2 of 128, q and k
        # rotated by M-RoPE (sections 16/24/24 over the text positions of
        # 256 patches and 64 tokens), as it trains and prefills; decoded
        # over its 328-row cache at the positions it reaches
        pos = mrope_positions_text(torch.arange(320, device=device)[None]
                                   .expand(2, 320))
        q, k = (apply_rope(_randn((2, 320, h, 128), dtype, device, sd), pos,
                           1e6, (16, 24, 24)) for h, sd in ((14, 19), (2, 20)))
        v = _randn((2, 320, 2, 128), dtype, device, 21)
        errs["flash_attention"] = max(
            errs["flash_attention"], _attn_err(
                ops.flash_attention(q, k, v, causal=True),
                ref.flash_attention_ref(q, k, v, causal=True),
                f"flash {dtype} qwen2-vl local heads M-RoPE"))
        kc = torch.cat([k, _randn((2, 8, 2, 128), dtype, device, 22)], 1)
        vc = torch.cat([v, _randn((2, 8, 2, 128), dtype, device, 23)], 1)
        qd = apply_rope(_randn((2, 1, 14, 128), dtype, device, 24),
                        mrope_positions_text(torch.full(
                            (2, 1), 323, device=device)), 1e6,
                        (16, 24, 24))[:, 0].contiguous()
        lengths = torch.tensor([321, 328], dtype=torch.int32, device=device)
        errs["decode_attention"] = max(
            errs["decode_attention"], _attn_err(
                ops.decode_attention(qd, kc, vc, lengths),
                ref.decode_attention_ref(qd, kc, vc, lengths),
                f"decode {dtype} qwen2-vl local heads M-RoPE"))
        # mixtral's local heads in mesh_moe: 24/4 of 128 in a 72-slot ring
        # (a 64-token prompt and 8 steps, inside the 4096 window)
        q = _randn((2, 24, 128), dtype, device, 16)
        kc = _randn((2, 72, 4, 128), dtype, device, 17)
        vc = _randn((2, 72, 4, 128), dtype, device, 18)
        for p_ in (64, 71):
            pos = torch.full((2,), p_, dtype=torch.int32, device=device)
            errs["decode_attention"] = max(
                errs["decode_attention"], _attn_err(
                    ops.decode_attention(q, kc, vc, pos, window=4096,
                                         ring=True),
                    ref.decode_attention_ref(q, kc, vc, pos, window=4096,
                                             ring=True),
                    f"decode ring {dtype} mixtral local heads pos {p_}"))
        # mixtral: 48/8 heads of 128 in its 4096-slot ring, past the window
        q = _randn((4, 48, 128), dtype, device, 10)
        kc = _randn((4, 4096, 8, 128), dtype, device, 11)
        vc = _randn((4, 4096, 8, 128), dtype, device, 12)
        pos = torch.tensor([4000, 4095, 4096, 4200], dtype=torch.int32,
                           device=device)
        errs["decode_attention"] = max(
            errs["decode_attention"], _attn_err(
                ops.decode_attention(q, kc, vc, pos, window=4096, ring=True),
                ref.decode_attention_ref(q, kc, vc, pos, window=4096,
                                         ring=True),
                f"decode ring {dtype} mixtral heads S=4096 window=4096"))
    torch.cuda.synchronize()
    return errs


def backward_cases(device) -> float:
    """The backward kernel against the plain backward and autograd of the
    plain version in f32 on the other phases' training calls: granite's
    heads (24/8 of 64) and seamless's (16/16 of 64, causal self-attention
    and its non-causal encoder and cross calls) in bf16; in f32 the mesh
    phase's local heads (6/1 of 128), a context-parallel rank's 64 of 128
    rows at ``q_offset`` 64 and mesh_encdec's cross call (128 tokens over
    256 frames); and ragged tiles with a window, one at a query offset.
    Returns the largest absolute difference."""
    bf16, f32 = torch.bfloat16, torch.float32
    err = 0.0
    for i, (B, Sq, Sk, Hq, Hkv, D, dtype, kw) in enumerate((
            (1, 512, 512, 24, 8, 64, bf16, {}),
            (2, 512, 512, 16, 16, 64, bf16, {}),
            (2, 512, 512, 16, 16, 64, bf16, {"causal": False}),
            (2, 128, 128, 6, 1, 128, f32, {}),
            (2, 64, 128, 12, 2, 128, f32, {"q_offset": 64}),
            (2, 128, 256, 8, 8, 64, f32, {"causal": False}),
            (2, 37, 53, 6, 2, 80, bf16, {"window": 16}),
            (1, 100, 300, 4, 2, 16, f32, {"window": 32, "q_offset": 103}))):
        a = (_randn((B, Sq, Hq, D), dtype, device, 70 + 3 * i),
             _randn((B, Sk, Hkv, D), dtype, device, 71 + 3 * i),
             _randn((B, Sk, Hkv, D), dtype, device, 72 + 3 * i))
        err = max(err, check_flash_backward(
            a, kw, f"flash_attention_bwd {dtype} "
            f"{(B, Sq, Sk, Hq, Hkv, D)} {kw}", 90 + i))
    torch.cuda.synchronize()
    return err


def attention_work(name: str, a: tuple, kw: dict) -> Dict[str, float]:
    """Bytes each call must move (inputs read once, the output written
    once; for decode only the cache rows up to each length) and the flops
    of the kept (query, key) pairs (QK^T and PV, 4·D per pair and head)."""
    if name == "flash_attention":
        q, k, _ = a
        B, Sq, Hq, D = q.shape
        Sk = k.shape[1]
        off = kw.get("q_offset")
        qpos = np.arange(Sq) + (Sk - Sq if off is None else off)
        hi = np.minimum(Sk, qpos + 1) if kw.get("causal", True) else \
            np.full(Sq, Sk)
        lo = (np.maximum(0, qpos - kw["window"] + 1)
              if kw.get("window") else np.zeros(Sq, np.int64))
        pairs = int(np.clip(hi - lo, 0, None).sum()) * B * Hq
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        return {"flops": 4.0 * D * pairs, "bytes": float(nbytes)}
    q, kc, _, lengths = a
    B, Hq, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    rows = int(torch.clamp(lengths, min=0, max=S).sum())
    nbytes = (2 * q.numel() + 2 * rows * Hkv * D) * q.element_size() + 4 * B
    return {"flops": 4.0 * D * Hq * rows, "bytes": float(nbytes)}


def library_call(name: str, a: tuple, kw: dict) -> Callable[[], object]:
    """One PyTorch call computing the same function, timed as a yardstick
    only: scaled_dot_product_attention on (B, H, S, D) views, GQA by
    enable_gqa (or K/V repeated first where the installed torch lacks
    it), causal for prefill (at a ``q_offset``, a boolean causal mask
    from it, built beforehand), a boolean length mask (built beforehand)
    for decode."""
    import torch.nn.functional as F
    try:
        x = torch.zeros((1, 2, 1, 16), device=a[0].device)
        F.scaled_dot_product_attention(x, x[:, :1], x[:, :1],
                                       enable_gqa=True)
        gqa = True
    except TypeError:
        gqa = False
    mask = None
    if name == "flash_attention":
        q, k, v = (t.transpose(1, 2) for t in a)
        causal = kw.get("causal", True)
        if kw.get("q_offset") is not None:
            qpos = (torch.arange(q.shape[2], device=q.device)[:, None]
                    + kw["q_offset"])
            mask = torch.arange(k.shape[2], device=q.device)[None, :] <= qpos
            causal = False
    else:
        q0, kc, vc, lengths = a
        q = q0[:, :, None, :]
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        S = kc.shape[1]
        mask = (torch.arange(S, device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        causal = False
    rep = q.shape[1] // k.shape[1]
    if not gqa and rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    extra = {"enable_gqa": True} if gqa else {}
    if name == "flash_attention":
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask,
                                                      is_causal=causal,
                                                      **extra)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  **extra)


def time_attention(calls: Dict[str, tuple], reps: int, device
                   ) -> Dict[str, Dict[str, float]]:
    """Kernel, plain version and library call on the captured main-path
    arguments of each attention kernel."""
    from repro_torch.kernels import ops, ref
    plain = {"flash_attention": ref.flash_attention_ref,
             "decode_attention": ref.decode_attention_ref}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    res = {}
    for name, (a, kw_) in calls.items():
        kfn = getattr(ops, name)
        # the kernel streams whatever ``block_k`` says; its plain version
        # is the dense one
        kw = {k: v for k, v in kw_.items() if k != "block_k"}
        err = _attn_err(kfn(*a, **kw), plain[name](*a, **kw),
                        f"{name} main path")
        work = attention_work(name, a, kw)
        t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
        t_flops = work["flops"] / BF16_FLOPS_PER_S * 1e3
        lib = library_call(name, a, kw)
        res[name] = {
            "ms": _device_ms(lambda: kfn(*a, **kw), 20),
            "plain_ms": _device_ms(lambda: plain[name](*a, **kw), 20),
            "library_ms": _device_ms(lib, 20),
            "call_ms": _call_ms(lambda: kfn(*a, **kw), reps, flush),
            "plain_call_ms": _call_ms(lambda: plain[name](*a, **kw), reps,
                                      flush),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": work["bytes"], "flops": work["flops"],
            "max_abs_err": err,
            "shape": [list(t.shape) for t in a]}
    return res


def model_cuda_vs_cpu(ms: ModelSizes, device) -> Dict[str, float]:
    """ModelServer on the card against ModelServer on the CPU, with the
    same seeded parameters (drawn on the CPU, copied to the card): full
    width, ``check_layers`` layers; prompts, then teacher-forced decode
    steps. f32: logits within rtol = atol = 1e-4 and equal greedy tokens;
    bf16: relative L2 error of the logits <= 2e-2."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import init_params
    from repro_torch.models.tree import tree_map
    from repro_torch.serving.server import ModelServer
    base = get_config(ms.arch)
    rng = np.random.default_rng(21)
    n, L, steps = ms.check_prompts, ms.check_len, ms.check_steps
    toks = rng.integers(0, base.vocab_size, (n, L + steps)).astype(np.int32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, n_layers=ms.check_layers,
                                  dtype=dtype, param_dtype=dtype)
        params = init_params(torch.Generator().manual_seed(5), cfg)
        logits = {}
        for dev in (device, "cpu"):
            p = params if dev == "cpu" else tree_map(
                lambda t: t.to(dev), params)
            srv = ModelServer(cfg, p, batch=n, cache_len=L + steps)
            srv.prefill(toks[:, :L])
            got = [srv.logits.float().cpu()]
            for i in range(steps):
                srv.tokens = torch.as_tensor(toks[:, L + i], device=dev)
                srv.decode(1)
                got.append(srv.logits.float().cpu())
            logits[dev] = torch.stack(got)
            del srv, p
        a, b = logits[device].double(), logits["cpu"].double()
        rel_l2 = float((a - b).norm() / b.norm())
        max_abs = float((a - b).abs().max())
        same_tokens = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
        if dtype == "float32":
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"f32 model logits differ card vs CPU "
                                     f"(max abs diff {max_abs})")
            if not same_tokens:
                raise AssertionError("f32 greedy tokens differ card vs CPU")
        elif rel_l2 > 2e-2:
            raise AssertionError(f"bf16 model logits differ card vs CPU "
                                 f"(relative L2 {rel_l2})")
        out[dtype] = {"rel_l2": rel_l2, "max_abs": max_abs,
                      "same_greedy_tokens": same_tokens}
        log(f"model card==cpu {ms.arch} (full width, {ms.check_layers} "
            f"layers) {dtype}: {n} prompts of {L}, {steps} teacher-forced "
            f"steps; logits max abs diff {max_abs}, relative L2 {rel_l2}, "
            f"same greedy tokens {same_tokens}")
    return out


def _tensor_bytes(tree) -> int:
    from repro_torch.models.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def model_main_path(ms: ModelSizes, device) -> Dict[str, object]:
    """ModelServer for the full model (full width and depth, bf16): admit
    and decode as ``ms.admissions`` says, so slots sit at different
    positions. Returns the report, the launch counts and the captured
    attention calls (the first prefill's flash call, the last decode
    call)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_params
    from repro_torch.models.tree import tree_leaves
    from repro_torch.serving.server import ModelServer
    cfg = get_config(ms.arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # warm-up (cuBLAS handles, first launches) on a small server
    warm = ModelServer(cfg, params, batch=2, cache_len=64)
    warm.prefill(np.ones((2, 16), np.int32))
    warm.decode(2)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    srv = ModelServer(cfg, params, batch=ms.slots, cache_len=ms.cache_len)
    rng = np.random.default_rng(13)
    calls: Dict[str, tuple] = {}
    originals = {k: getattr(ops, k) for k in ATTN_KERNELS}

    def recorder(name):
        def rec(*a, **kw):
            if name == "decode_attention" or name not in calls:
                calls[name] = (a, kw)
            return originals[name](*a, **kw)
        return rec

    prefill_ms: List[float] = []
    step_ms: List[float] = []
    tokens = 0
    bad = []
    reset_launch_counts()
    try:
        for k in ATTN_KERNELS:
            setattr(ops, k, recorder(k))
        for n, L, steps in ms.admissions:
            prompts = rng.integers(0, cfg.vocab_size, (n, L))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            srv.prefill(prompts)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t1) * 1e3)
            if not bool(torch.isfinite(srv.logits).all()):
                bad.append(f"prefill of {n}x{L}")
            for _ in range(steps):
                t1 = time.perf_counter()
                srv.decode(1)                # ends in a device->host copy
                step_ms.append((time.perf_counter() - t1) * 1e3)
                tokens += int(srv.active.sum())
                if not bool(torch.isfinite(srv.logits).all()):
                    bad.append("decode step")
    finally:
        for k, fn in originals.items():
            setattr(ops, k, fn)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - mem0
    if bad:
        raise AssertionError(f"non-finite logits after {bad[:3]}")
    missing = [k for k in ATTN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"model main path never launched {missing}")
    if srv.logits.shape != (ms.slots, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(srv.logits.shape)}")
    if not all(len(srv.generated[s]) > 1 for s in range(ms.slots)):
        raise AssertionError("a slot generated no tokens")
    param_bytes = _tensor_bytes(params)
    cache_bytes = _tensor_bytes(srv.caches)
    head_f32 = (srv.params["head_f32"].numel() * 4
                if srv.params["head_f32"].dtype != params["embed"].dtype
                else 0)
    sa = np.asarray(step_ms)
    report = {
        "arch": ms.arch, "params": sum(t.numel()
                                       for t in tree_leaves(params)),
        "param_init_s": init_s,
        "prefill_ms": prefill_ms,
        "prefill_shapes": [[n, L] for n, L, _ in ms.admissions],
        "decode_step_p50_ms": float(np.percentile(sa, 50)),
        "decode_step_p99_ms": float(np.percentile(sa, 99)),
        "decode_steps": len(step_ms),
        "decode_tokens": tokens,
        "decode_tokens_per_s": tokens / (sa.sum() / 1e3),
        "peak_bytes_over_params": peak,
        "param_bytes": param_bytes, "cache_bytes": cache_bytes,
        "head_f32_bytes": head_f32,
        "positions": srv.positions.cpu().tolist(),
    }
    log(f"model main path {ms.arch}: {report['params']} params "
        f"({param_bytes} bytes, drawn in {init_s:.3f} s); prefill ms per "
        f"admission {prefill_ms} for {report['prefill_shapes']}; decode "
        f"step p50 {report['decode_step_p50_ms']:.4f} ms, p99 "
        f"{report['decode_step_p99_ms']:.4f} ms over {len(step_ms)} steps; "
        f"{report['decode_tokens_per_s']:.2f} tokens/s; peak device memory "
        f"above the parameters {peak} bytes against cache {cache_bytes} + "
        f"f32 head {head_f32} bytes; launches {launches}")
    report["busy"] = decode_busy(lambda: srv.decode(1),
                                 report["decode_step_p50_ms"])
    del srv
    return {"report": report, "launches": launches, "calls": calls}


def decode_busy(step: Callable[[], object], p50_ms: float
                ) -> Dict[str, object]:
    """Device time of one decode step (``step()``) from a torch.profiler
    trace (after a warm step), and its share of the unprofiled step
    p50."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    per_kernel: Dict[str, float] = {}
    launches, host_ops = 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
        elif e.name.startswith("aten::") and not (
                e.cpu_parent is not None
                and e.cpu_parent.name.startswith("aten::")):
            host_ops += 1             # a PyTorch call made by the step
    dev_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_ms_per_step": dev_ms,
           "busy_share_of_p50": dev_ms / p50_ms if dev_ms else None,
           "device_launches": launches, "torch_calls": host_ops,
           "top": [[k[:70], v / 1e3] for k, v in top]}
    log(f"decode step: {host_ops} top-level PyTorch calls, {launches} "
        f"device operations")
    if not dev_ms:
        log("busy decode step: the profiler recorded no device events; "
            "device time not measured")
    else:
        log(f"busy decode step: device {dev_ms:.5f} ms = "
            f"{dev_ms / p50_ms:.4f} of the step p50; top: " + "; ".join(
                f"{k} {v:.5f} ms" for k, v in out["top"]))
    return out


def serve_cli(device) -> Dict[str, object]:
    """``python -m repro_torch.launch.serve --decode`` with its defaults
    (on the card), as a user runs it."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--decode"],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=str(SRC.parent))
    if out.returncode != 0:
        raise AssertionError(f"launch.serve --decode failed "
                             f"({out.returncode}):\n{out.stderr[-3000:]}")
    report = json.loads(out.stdout)
    if not str(report.get("device")).startswith(str(device)):
        raise AssertionError(f"launch.serve ran on {report.get('device')}")
    if not report.get("decode_tokens_per_s", 0) > 0:
        raise AssertionError("launch.serve --decode reported no tokens/s")
    log(f"launch.serve --decode: {report['qps']:.1f} feature req/s, "
        f"{report['decode_tokens_per_s']:.2f} decode tokens/s "
        f"({report['decode_arch']}, reduced), device {report['device']}")
    return {k: report[k] for k in ("qps", "latency_ms_per_batch_p50",
                                   "latency_ms_per_batch_p99",
                                   "decode_tokens_per_s", "device")}


def run_model(device, ms: ModelSizes) -> Dict[str, object]:
    """The model-server phases on ``device``; raises on any failure."""
    errs = attention_cases(device)
    log(f"attention kernel checks passed; max abs diff per kernel: {errs}")
    bwd_err = backward_cases(device)
    log(f"flash backward checks passed; max abs diff {bwd_err}")
    cmp = model_cuda_vs_cpu(ms, device)
    main = model_main_path(ms, device)
    timing = time_attention(main["calls"], ms.reps, device)
    for k, v in timing.items():
        errs[k] = max(errs[k], v["max_abs_err"])
        log(f"time {k} {v['shape']}: device per launch: kernel "
            f"{v['ms']:.6f} ms, plain {v['plain_ms']:.6f} ms, library "
            f"{v['library_ms']:.6f} ms, bound {v['bound_ms']:.6f} ms "
            f"({v['bound_by']}: {v['bytes']} bytes, {v['flops']} flops); "
            f"per call with host work: kernel {v['call_ms']:.5f} ms, plain "
            f"{v['plain_call_ms']:.5f} ms")
    # one context-parallel rank's call (the mesh phase's training: 64 of
    # 128 rows at q_offset 64, every head of qwen2-1.5b, here in bf16)
    q = _randn((2, 64, 12, 128), torch.bfloat16, device, 28)
    k, v = (_randn((2, 128, 2, 128), torch.bfloat16, device, sd)
            for sd in (29, 30))
    cp = time_attention({"flash_attention": (
        (q, k, v), {"causal": True, "q_offset": 64})}, ms.reps,
        device)["flash_attention"]
    errs["flash_attention"] = max(errs["flash_attention"], cp["max_abs_err"])
    log(f"time flash_attention at q_offset 64 {cp['shape']}: device per "
        f"launch: kernel {cp['ms']:.6f} ms, plain {cp['plain_ms']:.6f} ms, "
        f"library {cp['library_ms']:.6f} ms (an explicit causal mask), "
        f"bound {cp['bound_ms']:.6f} ms ({cp['bound_by']}: {cp['bytes']} "
        f"bytes, {cp['flops']} flops)")
    cli = serve_cli(device)
    kernels = [{
        "name": k, "route": "cuda", "source": ATTN_KERNELS[k][0],
        "replaces": ATTN_KERNELS[k][1], "launches": main["launches"][k],
        "max_abs_err": errs[k], "ms": timing[k]["ms"],
        "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
        "bound_by": timing[k]["bound_by"],
        "library_ms": timing[k]["library_ms"],
        "call_ms": timing[k]["call_ms"],
        "plain_call_ms": timing[k]["plain_call_ms"]} for k in ATTN_KERNELS]
    kernels[0]["at_q_offset"] = {
        k: cp[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_by", "max_abs_err", "shape")}
    kernels[0]["at_q_offset"]["q_offset"] = 64
    return {"kernels": kernels, "model": main["report"],
            "model_cuda_vs_cpu": cmp, "serve_cli": cli, "bwd_err": bwd_err}


# ---------------------------------------------------------------------------
# the other decoder-only families: Mamba-2, MoE, the hybrid, vision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FamilyCheck:
    """One family's card-against-CPU check (f32): the config's fields
    changed by ``changes`` (and its MoE fields by ``moe``)."""
    arch: str
    changes: tuple = ()
    moe: tuple = ()
    prompts: int = 2
    prompt_len: int = 64
    steps: int = 4               # teacher-forced decode steps, cut for time
    cache_len: int = 128
    patches: int = 0             # stub frontend embeddings ahead of prompts
    train_len: int = 32          # tokens per sequence of the training check
    train_patches: int = 0
    # logits rtol = atol and gradients' relative L2; above 1e-4 the check
    # also measures the CPU's own spread (the same passes on 1 thread
    # against all of them)
    tol: float = 1e-4


@dataclasses.dataclass(frozen=True)
class FamilyRun:
    """One family's serving main path at full width (bf16)."""
    arch: str
    layers: int
    slots: int
    cache_len: int
    prompt_len: int
    steps: int
    patches: int = 0             # > 0: make_prefill_step with embeddings


@dataclasses.dataclass(frozen=True)
class FamilySizes:
    checks: tuple = (
        FamilyCheck("mamba2-780m", (("n_layers", 2),)),
        FamilyCheck("granite-moe-3b-a800m", (("n_layers", 2),)),
        FamilyCheck("qwen2-vl-7b", (("n_layers", 2),), patches=256,
                    cache_len=384, train_patches=32),
        # one period of 8 at d_model 512, its 16 experts top-2; eight
        # random f32 layers move its logits and gradients by ~1e-4 between
        # two CPU thread counts, so they are held to 1e-3, that spread
        # printed beside
        FamilyCheck("jamba-v0.1-52b", (("d_model", 512), ("d_ff", 1792)),
                    (("d_ff_expert", 1792),), tol=1e-3),
        # reduced width, its window of 4096 and heads 6 per KV head
        FamilyCheck("mixtral-8x22b",
                    (("n_layers", 2), ("d_model", 1024), ("n_heads", 12),
                     ("n_kv_heads", 2), ("d_ff", 2048)),
                    (("d_ff_expert", 2048),), prompts=1, prompt_len=4090,
                    steps=12, cache_len=8192),
    )
    runs: tuple = (
        FamilyRun("jamba-v0.1-52b", 8, 8, 1024, 512, 32),
        FamilyRun("mamba2-780m", 48, 16, 1024, 1024, 32),
        FamilyRun("granite-moe-3b-a800m", 32, 16, 1024, 512, 32),
        FamilyRun("qwen2-vl-7b", 28, 4, 1120, 64, 32, patches=1024),
        FamilyRun("mixtral-8x22b", 2, 4, 8192, 4000, 200),
    )
    # (arch, layers) trained at full width, bf16, 4 x 512 tokens
    train: tuple = (("mamba2-780m", 48), ("granite-moe-3b-a800m", 8))
    train_batch: int = 4
    train_seq: int = 512
    train_steps: int = 10


def family_config(arch: str, changes=(), moe=()):
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    kw = dict(changes)
    if moe:
        kw["moe"] = dataclasses.replace(cfg.moe, **dict(moe))
    return dataclasses.replace(cfg, **kw)


def _n_attention_layers(cfg) -> int:
    from repro_torch.models.blocks import normalize_pattern
    pattern = normalize_pattern(cfg)
    return (sum(t[0] == "a" for t in pattern)
            * (cfg.n_layers // len(pattern)))


ROUTE_TIE = 1e-3    # a logit gap under which two experts are a near-tie


def family_cuda_vs_cpu(fc: FamilyCheck, device) -> Dict[str, object]:
    """The same seeded f32 parameters on the CPU and on the card: a
    prefill (through ModelServer, or ``make_prefill_step`` with stub
    embeddings for a vision model) and teacher-forced decode steps, then
    one ``loss_fn`` with its gradients.

    Routing: each router call on the card computes its own top-k, which
    must equal the CPU's except where the CPU's router logits of the two
    experts lie within ``ROUTE_TIE`` of each other (a near-tie that f32
    noise may order either way: the card's router input differs from the
    CPU's by ~1e-5 relative after a few layers); the card then routes
    with the CPU's choice, so that one near-tie does not change every
    later layer's input. Logits within rtol = atol = ``tol`` with equal
    greedy tokens, the loss and the MoE losses within 1e-4 relative,
    every gradient within ``tol`` relative L2: 1e-4, but 1e-3 for
    jamba's eight layers, whose CPU spread is measured and printed
    beside."""
    from repro_torch.launch.steps import (_value_and_grad, init_params,
                                          make_prefill_step)
    from repro_torch.models import frontend, lm, moe
    from repro_torch.models.tree import tree_map
    from repro_torch.serving.server import ModelServer
    cfg = dataclasses.replace(family_config(fc.arch, fc.changes, fc.moe),
                              dtype="float32", param_dtype="float32")
    params = init_params(torch.Generator(device=device).manual_seed(7), cfg)
    rng = np.random.default_rng(23)
    n, L, steps = fc.prompts, fc.prompt_len, fc.steps
    toks = rng.integers(0, cfg.vocab_size, (n, L + steps)).astype(np.int32)
    tt = rng.integers(0, cfg.vocab_size, (2, fc.train_len + 1))
    batch = {"tokens": torch.tensor(tt[:, :-1], dtype=torch.int32),
             "targets": torch.tensor(tt[:, 1:], dtype=torch.int32)}
    emb = None
    if fc.patches:
        emb = frontend.stub_frontend(
            torch.Generator(device=device).manual_seed(8), cfg, n,
            fc.patches)
        batch["embeds"] = frontend.stub_frontend(
            torch.Generator(device=device).manual_seed(9), cfg, 2,
            fc.train_patches).cpu()
    def serve_logits(p, dev) -> torch.Tensor:
        """Prefill, then teacher-forced steps: every call's logits."""
        logits = []
        if emb is None:
            srv = ModelServer(cfg, p, batch=n, cache_len=fc.cache_len)
            srv.prefill(toks[:, :L])
            logits.append(srv.logits.cpu())
            for i in range(steps):
                srv.tokens = torch.as_tensor(toks[:, L + i], device=dev)
                srv.decode(1)
                logits.append(srv.logits.cpu())
        else:
            ph = lm.with_f32_head(p, cfg)
            lg, caches = make_prefill_step(cfg, fc.cache_len)(
                ph, torch.as_tensor(toks[:, :L], device=dev), emb.to(dev))
            logits.append(lg.cpu())
            for i in range(steps):
                pos = torch.full((n,), fc.patches + L + i,
                                 dtype=torch.int32, device=dev)
                lg, caches = lm.decode_step(
                    ph, cfg, caches,
                    torch.as_tensor(toks[:, L + i], device=dev), pos)
                logits.append(lg.cpu())
        return torch.stack(logits).double()

    orig = moe.route
    cpu_routes: List[tuple] = []
    res = {}
    ties = {"calls": 0, "tokens": 0, "max_gap": 0.0}
    for dev in ("cpu", device):
        p = tree_map(lambda t: t.to(dev), params)
        calls = [0]

        def rec(router, xf, k):
            logits, probs, gates, eidx = orig(router, xf, k)
            if dev == "cpu":
                cpu_routes.append((eidx, logits))
                return logits, probs, gates, eidx
            want, want_logits = cpu_routes[calls[0]]
            calls[0] += 1
            own = eidx.cpu()
            diff = (own != want).any(-1)
            if bool(diff.any()):
                rows = torch.nonzero(diff)[:, 0]
                lg = want_logits[rows]
                gap = (lg.gather(-1, own[rows]).sort(-1).values
                       - lg.gather(-1, want[rows]).sort(-1).values).abs()
                g = float(gap.max())
                if g >= ROUTE_TIE:
                    raise AssertionError(
                        f"{fc.arch}: router call {calls[0] - 1} chose "
                        f"other experts than the CPU for {len(rows)} "
                        f"tokens, logit gap {g} (not a near-tie)")
                ties["calls"] += 1
                ties["tokens"] += len(rows)
                ties["max_gap"] = max(ties["max_gap"], g)
            eidx = want.to(dev)
            gates = probs.gather(-1, eidx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            return logits, probs, gates, eidx

        moe.route = rec
        try:
            logits = serve_logits(p, dev)
            loss, metrics, grads = _value_and_grad(
                p, cfg, {k: v.to(dev) for k, v in batch.items()})
        finally:
            moe.route = orig
        if dev != "cpu" and calls[0] != len(cpu_routes):
            raise AssertionError(f"{fc.arch}: {calls[0]} router calls on the "
                                 f"card, {len(cpu_routes)} on the CPU")
        res[dev] = (logits, float(loss),
                    {k: float(v) for k, v in metrics.items()},
                    [g.cpu() for g in _leaves_of(grads)])
        del p, grads
    (la, lossa, ma, ga), (lb, lossb, mb, gb) = res[device], res["cpu"]

    def rel_l2(ga, gb) -> float:
        return _rel_l2(ga, gb, device)

    max_abs = float((la - lb).abs().max())
    spread = None
    if fc.tol > 1e-4:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            p = tree_map(lambda t: t.cpu(), params)
            one = serve_logits(p, "cpu")
            _, _, g1 = _value_and_grad(p, cfg, batch)
            spread = {"logits_max_abs": float((one - lb).abs().max()),
                      "grad_rel_l2": rel_l2(_leaves_of(g1), gb)}
            del p, g1
        finally:
            torch.set_num_threads(threads)
    tol = fc.tol
    if not torch.allclose(la, lb, rtol=tol, atol=tol):
        raise AssertionError(f"{fc.arch} f32 logits card vs CPU: max abs "
                             f"diff {max_abs} (tolerance {tol}; the CPU's "
                             f"own spread {spread})")
    if not torch.equal(la.argmax(-1), lb.argmax(-1)):
        raise AssertionError(f"{fc.arch} greedy tokens card vs CPU")
    for k in ("loss",) + (("moe_aux", "moe_zloss") if cfg.moe else ()):
        a, b = (lossa, lossb) if k == "loss" else (ma[k], mb[k])
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"{fc.arch} train {k} card {a} vs CPU {b}")
    g_rel = rel_l2(ga, gb)
    if g_rel > tol:
        raise AssertionError(f"{fc.arch} gradients card vs CPU: relative "
                             f"L2 {g_rel} (tolerance {tol}; the CPU's own "
                             f"spread {spread})")
    out = {"logits_max_abs": max_abs, "tol": tol,
           "cpu_spread_1_thread": spread, "router_calls": len(cpu_routes),
           "near_tie_calls": ties["calls"],
           "near_tie_tokens": ties["tokens"],
           "near_tie_max_logit_gap": ties["max_gap"],
           "loss_card": lossa, "loss_cpu": lossb, "grad_rel_l2": g_rel}
    ahead = f" after {fc.patches} patch embeddings" if fc.patches else ""
    log(f"family card==cpu {fc.arch} {dict(fc.changes)} f32: {n} prompts "
        f"of {L}{ahead}, {steps} teacher-forced steps; logits max abs diff "
        f"{max_abs} "
        f"(tolerance {tol}"
        + (f"; the CPU on 1 thread against {torch.get_num_threads()}: "
           f"{spread}" if spread is not None else "")
        + f"), same greedy tokens; {len(cpu_routes)} router calls, the card's "
        f"experts the CPU's but for {ties['tokens']} near-tie tokens in "
        f"{ties['calls']} calls (largest logit gap {ties['max_gap']}); "
        f"train loss {lossa} vs {lossb}, gradients relative L2 {g_rel}")
    return out


def family_serve(run: FamilyRun, device) -> Dict[str, object]:
    """One family at full width (bf16, seeded random weights, ``layers``
    layers): a prefill of every slot, then ``steps`` decode steps, timed;
    the flash and decode launch counts must be the attention layers times
    the prefill and decode calls."""
    from repro_torch.launch.steps import init_params, make_prefill_step
    from repro_torch.models import frontend, lm, moe
    from repro_torch.models.tree import tree_leaves
    from repro_torch.serving.server import ModelServer
    cfg = family_config(run.arch, (("n_layers", run.layers),))
    n_attn = _n_attention_layers(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(31)
    prompts = rng.integers(0, cfg.vocab_size,
                           (run.slots, run.prompt_len)).astype(np.int32)
    state: Dict[str, object] = {}
    if run.patches:
        ph = lm.with_f32_head(params, cfg)
        emb = frontend.stub_frontend(
            torch.Generator(device=device).manual_seed(1), cfg, run.slots,
            run.patches)
        toks = torch.as_tensor(prompts, device=device)
        prefill = make_prefill_step(cfg, run.cache_len)
        warm = make_prefill_step(cfg, 64)(ph, toks[:2, :16], emb[:2, :16])
        lm.decode_step(ph, cfg, warm[1], toks[:2, 0], torch.full(
            (2,), 32, dtype=torch.int32, device=device))
        del warm

        def do_prefill():
            state["logits"], state["caches"] = prefill(ph, toks, emb)
            state["tok"] = torch.argmax(state["logits"], -1).to(torch.int32)
            state["pos"] = torch.full((run.slots,),
                                      run.patches + run.prompt_len,
                                      dtype=torch.int32, device=device)

        def step():
            state["logits"], state["caches"] = lm.decode_step(
                ph, cfg, state["caches"], state["tok"], state["pos"])
            state["tok"] = torch.argmax(state["logits"], -1).to(torch.int32)
            state["pos"] = state["pos"] + 1
            return state["tok"].cpu()

        def logits():
            return state["logits"]
    else:
        warm = ModelServer(cfg, params, batch=2, cache_len=64)
        warm.prefill(np.ones((2, 16), np.int32))
        warm.decode(2)
        del warm
        srv = ModelServer(cfg, params, batch=run.slots,
                          cache_len=run.cache_len)

        def do_prefill():
            srv.prefill(prompts)

        def step():
            return srv.decode(1)

        def logits():
            return srv.logits
    torch.cuda.synchronize()
    drops: Dict[str, List[torch.Tensor]] = {"prefill": [], "decode": []}
    phase = ["prefill"]
    orig = moe.apply_moe

    def rec(p, x, c):
        y, m = orig(p, x, c)
        drops[phase[0]].append(m["moe_drop_frac"])
        return y, m

    step_ms: List[float] = []
    bad = []
    reset_launch_counts()
    moe.apply_moe = rec
    try:
        t0 = time.perf_counter()
        do_prefill()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(logits()).all()):
            bad.append("prefill")
        phase[0] = "decode"
        for _ in range(run.steps):
            t0 = time.perf_counter()
            step()                       # ends in a device->host copy
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(logits()).all()):
                bad.append("decode step")
    finally:
        moe.apply_moe = orig
    launches = {k: v for k, v in launch_counts().items()
                if k in ATTN_KERNELS}
    if bad:
        raise AssertionError(f"{run.arch}: non-finite logits after "
                             f"{bad[:3]}")
    if tuple(logits().shape) != (run.slots, cfg.vocab_size):
        raise AssertionError(f"{run.arch}: logits {tuple(logits().shape)}")
    want = {"flash_attention": n_attn, "decode_attention": n_attn * run.steps}
    if launches != want:
        raise AssertionError(f"{run.arch}: launches {launches}, want "
                             f"{want} ({n_attn} attention layers, 1 prefill,"
                             f" {run.steps} decode calls)")
    sa = np.asarray(step_ms)
    report = {
        "arch": run.arch, "layers": cfg.n_layers, "params": n_params,
        "param_bytes": _tensor_bytes(params), "param_init_s": init_s,
        "slots": run.slots, "prompt_len": run.prompt_len,
        "patches": run.patches, "cache_len": run.cache_len,
        "prefill_ms": prefill_ms,
        "decode_step_p50_ms": float(np.percentile(sa, 50)),
        "decode_step_p99_ms": float(np.percentile(sa, 99)),
        "decode_steps": run.steps,
        "decode_tokens_per_s": run.slots * run.steps / (sa.sum() / 1e3),
        "attention_layers": n_attn, "launches": launches}
    if cfg.moe is not None:
        report["moe_drop_frac"] = {
            k: float(torch.stack(v).float().mean()) for k, v in drops.items()}
    if run.patches:
        report["cache_bytes"] = _tensor_bytes(state["caches"])
        report["positions_last"] = int(state["pos"].max())
    else:
        report["cache_bytes"] = _tensor_bytes(srv.caches)
        report["positions_last"] = int(srv.positions.max())
    if cfg.sliding_window:
        ring = srv.caches[0]["k"].shape[2]
        if ring != cfg.sliding_window or not (
                report["positions_last"] > cfg.sliding_window):
            raise AssertionError(f"{run.arch}: ring {ring}, last position "
                                 f"{report['positions_last']}: decode did "
                                 f"not pass the window")
        report["ring_slots"] = ring
    if n_attn == 0:
        sizes = {L: _tensor_bytes(lm.init_cache(cfg, run.slots, L, device))
                 for L in (run.cache_len, 32768)}
        if len(set(sizes.values())) != 1:
            raise AssertionError(f"{run.arch}: cache bytes grow with "
                                 f"cache_len: {sizes}")
        report["cache_bytes_by_cache_len"] = sizes
    report["busy"] = decode_busy(step, report["decode_step_p50_ms"])
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"family serve {run.arch} ({cfg.n_layers} layers, full width, "
        f"bf16): {n_params} params ({report['param_bytes']} bytes, drawn in "
        f"{init_s:.3f} s); prefill {run.slots}x{run.prompt_len}"
        f"{f' after {run.patches} patch embeddings' if run.patches else ''}"
        f" {prefill_ms:.3f} ms; decode step p50 "
        f"{report['decode_step_p50_ms']:.4f} ms, p99 "
        f"{report['decode_step_p99_ms']:.4f} ms over {run.steps} steps; "
        f"{report['decode_tokens_per_s']:.2f} tokens/s; busy share "
        f"{report['busy']['busy_share_of_p50']}; peak device memory "
        f"{report['peak_bytes']} bytes; cache {report['cache_bytes']} bytes; "
        f"launches {launches} = {n_attn} attention layers x calls"
        + (f"; moe_drop_frac {report['moe_drop_frac']}" if cfg.moe else "")
        + f"; {card_line()}")
    del state, params
    if not run.patches:
        del srv
    return report


def family_train(arch: str, layers: int, fs: FamilySizes, device
                 ) -> Dict[str, object]:
    """``arch`` at full width, ``layers`` layers (bf16, its config's
    remat), ``train_steps`` AdamW steps on one batch of ``train_batch`` x
    ``train_seq`` tokens: a finite falling loss, no skipped step, the MoE
    losses in the metrics of an MoE model."""
    from repro_torch.configs.base import param_count
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim.adamw import AdamWConfig
    cfg = family_config(arch, (("n_layers", layers),))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg, opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=2,
                                              total_steps=fs.train_steps),
                     seed=0, device=device)
    rng = np.random.default_rng(37)
    toks = rng.integers(0, cfg.vocab_size,
                        (fs.train_batch, fs.train_seq + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    lat: List[float] = []
    t = [time.perf_counter()]

    def on_metrics(step, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        lat.append(now - t[0])
        t[0] = now

    reset_launch_counts()
    hist = loop.run(iter([batch] * fs.train_steps), steps=fs.train_steps,
                    log_every=0, on_metrics=on_metrics)["history"]
    flash = launch_counts()["flash_attention"]
    flash_bwd = launch_counts()["flash_attention_bwd"]
    losses = [m["loss"] for m in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training loss did not fall: {losses}")
    if any(m["skipped"] for m in hist):
        raise AssertionError(f"{arch}: a skipped step")
    if cfg.moe is not None and not all("moe_aux" in m and "moe_zloss" in m
                                       for m in hist):
        raise AssertionError(f"{arch}: MoE losses missing from the metrics")
    n_attn = _n_attention_layers(cfg)
    if (flash == 0) != (n_attn == 0) or flash_bwd != n_attn * fs.train_steps:
        raise AssertionError(f"{arch}: {flash} flash and {flash_bwd} "
                             f"backward launches for {n_attn} attention "
                             f"layers")
    bwd_by_route = bwd_routes(f"family train {arch}", flash_bwd)
    step_ms = float(np.percentile(np.asarray(lat[1:]) * 1e3, 50))
    tokens = fs.train_batch * fs.train_seq
    active = param_count(cfg, active=True)
    flops = (6 * active * tokens + 6 * fs.train_batch * cfg.n_heads
             * fs.train_seq * fs.train_seq * cfg.hd * n_attn)
    out = {"arch": arch, "layers": cfg.n_layers, "remat": cfg.remat,
           "active_params": active, "losses": losses,
           "step_ms_p50": step_ms, "first_step_ms": lat[0] * 1e3,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu_bf16_dense_peak": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "flash_launches": flash, "flash_bwd_launches": flash_bwd,
           "flash_bwd_launches_per_step": flash_bwd / fs.train_steps,
           "flash_bwd_routes": bwd_by_route}
    if cfg.moe is not None:
        out["moe_aux_last"] = hist[-1]["moe_aux"]
        out["moe_zloss_last"] = hist[-1]["moe_zloss"]
    log(f"family train {arch} ({cfg.n_layers} layers, full width, bf16, "
        f"remat {cfg.remat}, B={fs.train_batch} S={fs.train_seq}, "
        f"{fs.train_steps} steps): loss {losses[0]:.4f} -> {losses[-1]:.4f};"
        f" step p50 {step_ms:.3f} ms (first {lat[0] * 1e3:.3f} ms); "
        f"{out['tokens_per_s']:.1f} tokens/s; model FLOPs {flops:.4e}/step "
        f"over {active} active params = {out['mfu_bf16_dense_peak']:.4f} of "
        f"the 989 TFLOP/s bf16 dense peak; peak device memory "
        f"{out['peak_bytes']} bytes; flash launches {flash}, backward "
        f"{flash_bwd / fs.train_steps:.1f} a step"
        + (f"; moe_aux {out['moe_aux_last']:.4f}, moe_zloss "
           f"{out['moe_zloss_last']:.4f}" if cfg.moe else "")
        + f"; {card_line()}")
    del loop
    return out


def families_phase(device, fs: FamilySizes = FamilySizes()
                   ) -> Dict[str, object]:
    """Mamba-2, MoE, the jamba hybrid and the vision frontend on the card:
    card against CPU, serving at full width, training; each model freed
    before the next. Budget: about 300 s."""
    t_phase = time.perf_counter()
    out: Dict[str, object] = {"cuda_vs_cpu": {}, "serve": {}, "train": {}}
    for fc in fs.checks:
        out["cuda_vs_cpu"][fc.arch] = family_cuda_vs_cpu(fc, device)
        torch.cuda.empty_cache()
    for run in fs.runs:
        out["serve"][run.arch] = family_serve(run, device)
        torch.cuda.empty_cache()
    for arch, layers in fs.train:
        out["train"][arch] = family_train(arch, layers, fs, device)
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(r["launches"][k] for r in out["serve"].values())
                       for k in ATTN_KERNELS}
    out["launches"]["flash_attention_bwd"] = sum(
        r["flash_bwd_launches"] for r in out["train"].values())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"families phase: {out['seconds']:.3f} s; {card_line()}")
    return out


# ---------------------------------------------------------------------------
# the encoder-decoder (seamless-m4t-medium) and the compressed pod step
# ---------------------------------------------------------------------------

ENCDEC = "seamless-m4t-medium"


@dataclasses.dataclass(frozen=True)
class EncDecSizes:
    check_layers: int = 2        # card vs CPU: full width, 2 + 2 layers, f32
    check_frames: int = 256
    check_prompts: int = 2
    check_len: int = 32
    check_steps: int = 8
    slots: int = 8               # serve: full width and depth, bf16
    cache_len: int = 1024
    enc_len: int = 1024
    prompt_len: int = 64
    steps: int = 32
    train_batch: int = 4         # train: full width and depth, bf16
    train_seq: int = 512         # tokens per sequence, and as many frames
    train_steps: int = 10
    pod_arch: str = "qwen1.5-0.5b"   # the compressed step: reduced, f32
    pod_batch: int = 4
    pod_seq: int = 16
    pod_steps: int = 3
    pod_lr: float = 1e-3


def _encdec_config(layers: int = 0, dtype: str = ""):
    from repro_torch.configs.registry import get_config
    cfg = get_config(ENCDEC)
    kw = {}
    if layers:
        kw.update(n_layers=layers, encoder_layers=layers)
    if dtype:
        kw.update(dtype=dtype, param_dtype=dtype)
    return dataclasses.replace(cfg, **kw)


def _zero_grad_leaf(path) -> bool:
    """The cross-attention's K bias: its gradient is zero in exact
    arithmetic (it adds q·b to every logit of a query alike, which the
    softmax cancels), so it is held absolutely, not relatively."""
    return tuple(path[1:]) == ("cross_attn", "wk", "b")


def encdec_cuda_vs_cpu(es: EncDecSizes, device) -> Dict[str, object]:
    """seamless-m4t-medium at full width, ``check_layers`` encoder and
    decoder layers, f32, the same seeded parameters on the CPU and the
    card: ModelServer prefills ``check_prompts`` prompts of ``check_len``
    tokens over ``check_frames`` frames, then ``check_steps``
    teacher-forced steps; logits within rtol = atol = 1e-4 and equal
    greedy tokens; then ``loss_fn`` and its gradients: the loss within
    1e-4 relative, every gradient within 1e-4 relative L2 (the zero K-bias
    gradient of the cross-attention within 1e-6 absolute). On a failure
    the CPU's own spread (1 thread against all) is printed beside."""
    from repro_torch.launch.steps import _value_and_grad, init_params
    from repro_torch.models.frontend import stub_audio_frames
    from repro_torch.models.tree import tree_flatten_with_path, tree_map
    from repro_torch.serving.server import ModelServer
    cfg = _encdec_config(es.check_layers, "float32")
    params = init_params(torch.Generator().manual_seed(11), cfg)
    rng = np.random.default_rng(41)
    n, L, steps = es.check_prompts, es.check_len, es.check_steps
    toks = rng.integers(0, cfg.vocab_size, (n, L + steps)).astype(np.int32)
    frames = stub_audio_frames(torch.Generator().manual_seed(12), cfg, n,
                               es.check_frames)
    batch = {"enc_embeds": frames,
             "tokens": torch.as_tensor(toks[:, :-1]),
             "targets": torch.as_tensor(toks[:, 1:])}

    def run(p, dev):
        srv = ModelServer(cfg, p, batch=n, cache_len=L + steps,
                          enc_len=es.check_frames)
        srv.prefill(toks[:, :L], frames.to(dev))
        got = [srv.logits.cpu()]
        for i in range(steps):
            srv.tokens = torch.as_tensor(toks[:, L + i], device=dev)
            srv.decode(1)
            got.append(srv.logits.cpu())
        del srv
        loss, _, grads = _value_and_grad(
            p, cfg, {k: v.to(dev) for k, v in batch.items()})
        return (torch.stack(got).double(), float(loss),
                [(path, g.cpu()) for path, g in
                 tree_flatten_with_path(grads)])

    res = {}
    for dev in (device, "cpu"):
        p = params if dev == "cpu" else tree_map(lambda t: t.to(dev),
                                                 params)
        res[dev] = run(p, dev)
        del p
    (la, lossa, ga), (lb, lossb, gb) = res[device], res["cpu"]

    def compare(la, lossa, ga, lb, lossb, gb):
        g_rel, zero = 0.0, 0.0
        for (path, a), (_, b) in zip(ga, gb):
            if _zero_grad_leaf(path):
                zero = max(zero, float(a.abs().max()), float(b.abs().max()))
                continue
            g_rel = max(g_rel, _rel_l2([a], [b], device))
        return {"logits_max_abs": float((la - lb).abs().max()),
                "same_greedy_tokens": bool(torch.equal(la.argmax(-1),
                                                       lb.argmax(-1))),
                "loss_rel": abs(lossa - lossb) / abs(lossb),
                "grad_rel_l2": g_rel, "zero_grad_max_abs": zero}

    out = compare(la, lossa, ga, lb, lossb, gb)
    ok = (torch.allclose(la, lb, rtol=1e-4, atol=1e-4)
          and out["same_greedy_tokens"] and out["loss_rel"] <= 1e-4
          and out["grad_rel_l2"] <= 1e-4 and out["zero_grad_max_abs"] < 1e-6)
    if not ok:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            spread = compare(*run(params, "cpu"), lb, lossb, gb)
        finally:
            torch.set_num_threads(threads)
        raise AssertionError(f"{ENCDEC} card vs CPU: {out}; the CPU on 1 "
                             f"thread against {threads}: {spread}")
    out.update(loss_card=lossa, loss_cpu=lossb)
    log(f"encdec card==cpu {ENCDEC} (full width, {es.check_layers} + "
        f"{es.check_layers} layers, f32, {n} prompts of {L} over "
        f"{es.check_frames} frames, {steps} teacher-forced steps): {out}")
    return out


def encdec_serve(es: EncDecSizes, device) -> Dict[str, object]:
    """seamless-m4t-medium at full width and depth (bf16, seeded random
    weights) through ModelServer: ``slots`` prompts of ``prompt_len``
    tokens over ``enc_len`` stub audio frames each, then ``steps`` decode
    steps. The flash launches of the prefill must be 12 encoder + 12
    decoder self + 12 cross calls, and a decode step's decode launches 12
    self + 12 cross."""
    from repro_torch.launch.steps import init_params
    from repro_torch.models.frontend import stub_audio_frames
    from repro_torch.models.tree import tree_leaves
    from repro_torch.serving.server import ModelServer
    cfg = _encdec_config()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(1)
    warm = ModelServer(cfg, params, batch=2, cache_len=64, enc_len=64)
    warm.prefill(np.ones((2, 16), np.int32),
                 stub_audio_frames(gen, cfg, 2, 64))
    warm.decode(2)
    del warm
    srv = ModelServer(cfg, params, batch=es.slots, cache_len=es.cache_len,
                      enc_len=es.enc_len)
    prompts = np.random.default_rng(43).integers(
        0, cfg.vocab_size, (es.slots, es.prompt_len)).astype(np.int32)
    frames = stub_audio_frames(gen, cfg, es.slots, es.enc_len)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    srv.prefill(prompts, frames)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = launch_counts()
    bad = [] if bool(torch.isfinite(srv.logits).all()) else ["prefill"]
    step_ms: List[float] = []
    for _ in range(es.steps):
        t0 = time.perf_counter()
        srv.decode(1)                    # ends in a device->host copy
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(srv.logits).all()):
            bad.append("decode step")
    counts = launch_counts()
    launches = {k: counts[k] for k in ATTN_KERNELS}
    if bad:
        raise AssertionError(f"{ENCDEC}: non-finite logits after {bad[:3]}")
    if tuple(srv.logits.shape) != (es.slots, cfg.vocab_size):
        raise AssertionError(f"{ENCDEC}: logits {tuple(srv.logits.shape)}")
    want_prefill = cfg.encoder_layers + 2 * cfg.n_layers
    want = {"flash_attention": want_prefill,
            "decode_attention": 2 * cfg.n_layers * es.steps}
    got_prefill = {k: at_prefill[k] for k in ATTN_KERNELS}
    if got_prefill != {"flash_attention": want_prefill,
                       "decode_attention": 0} or launches != want:
        raise AssertionError(
            f"{ENCDEC}: launches {got_prefill} at the prefill and "
            f"{launches} after {es.steps} steps, want {want_prefill} flash "
            f"calls a prefill ({cfg.encoder_layers} encoder, "
            f"{cfg.n_layers} self, {cfg.n_layers} cross) and "
            f"{2 * cfg.n_layers} decode calls a step")
    sa = np.asarray(step_ms)
    # the cross K/V of every layer are projected from the encoder output
    # anew on each step, as in the JAX package
    cross_kv_flops = (cfg.n_layers * 2 * 2 * es.slots * es.enc_len
                      * cfg.d_model * cfg.n_kv_heads * cfg.hd)
    report = {
        "arch": ENCDEC, "layers": [cfg.encoder_layers, cfg.n_layers],
        "params": sum(t.numel() for t in tree_leaves(params)),
        "param_bytes": _tensor_bytes(params), "param_init_s": init_s,
        "slots": es.slots, "prompt_len": es.prompt_len,
        "enc_len": es.enc_len, "cache_len": es.cache_len,
        "prefill_ms": prefill_ms,
        "decode_step_p50_ms": float(np.percentile(sa, 50)),
        "decode_step_p99_ms": float(np.percentile(sa, 99)),
        "decode_steps": es.steps,
        "decode_tokens_per_s": es.slots * es.steps / (sa.sum() / 1e3),
        "launches_prefill": got_prefill,
        "launches_per_step": {k: (launches[k] - got_prefill[k]) / es.steps
                              for k in ATTN_KERNELS},
        "launches": launches,
        "cross_kv_flops_per_step": cross_kv_flops,
        "cache_bytes": _tensor_bytes(srv.caches),
        "enc_out_bytes": _tensor_bytes(srv.enc_out)}
    report["busy"] = decode_busy(lambda: srv.decode(1),
                                 report["decode_step_p50_ms"])
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"encdec serve {ENCDEC} ({cfg.encoder_layers} + {cfg.n_layers} "
        f"layers, full width, bf16): "
        f"{report['params']} params ({report['param_bytes']} bytes, drawn "
        f"in {init_s:.3f} s); prefill {es.slots}x{es.prompt_len} tokens "
        f"over {es.slots}x{es.enc_len} frames {prefill_ms:.3f} ms; decode "
        f"step p50 {report['decode_step_p50_ms']:.4f} ms, p99 "
        f"{report['decode_step_p99_ms']:.4f} ms over {es.steps} steps; "
        f"{report['decode_tokens_per_s']:.2f} tokens/s; busy share "
        f"{report['busy']['busy_share_of_p50']}; cross K/V projection "
        f"{cross_kv_flops:.4e} FLOP a step; peak device memory "
        f"{report['peak_bytes']} bytes; launches {got_prefill} a prefill, "
        f"{report['launches_per_step']} a step; {card_line()}")
    del srv, params
    return report


def encdec_train(es: EncDecSizes, device) -> Dict[str, object]:
    """seamless-m4t-medium at full width and depth (bf16) in a TrainLoop
    on ``make_batches`` (``train_batch`` x ``train_seq`` tokens over as
    many frames), ``train_steps`` steps: finite losses, no skipped step,
    the flash launches of each step 12 encoder + 12 self + 12 cross."""
    from repro_torch.launch.train import TrainLoop, make_batches
    from repro_torch.models.tree import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    cfg = _encdec_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg, opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=2,
                                              total_steps=es.train_steps),
                     seed=0, device=device)
    n_params = sum(t.numel() for t in tree_leaves(loop.params))
    batches = [b for b, _ in zip(make_batches(
        cfg, batch=es.train_batch, seq=es.train_seq, seed=0,
        pipeline=False), range(es.train_steps))]
    if batches[0]["enc_embeds"].shape != (es.train_batch, es.train_seq,
                                          cfg.d_model):
        raise AssertionError(f"enc_embeds {batches[0]['enc_embeds'].shape}")
    lat: List[float] = []
    t = [time.perf_counter()]

    def on_metrics(step, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        lat.append(now - t[0])
        t[0] = now

    reset_launch_counts()
    hist = loop.run(iter(batches), steps=es.train_steps, log_every=0,
                    on_metrics=on_metrics)["history"]
    flash = launch_counts()["flash_attention"]
    flash_bwd = launch_counts()["flash_attention_bwd"]
    losses = [m["loss"] for m in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{ENCDEC} training loss not finite: {losses}")
    if any(m["skipped"] for m in hist):
        raise AssertionError(f"{ENCDEC}: a skipped step")
    per_step = cfg.encoder_layers + 2 * cfg.n_layers
    if (flash != per_step * es.train_steps
            or flash_bwd != per_step * es.train_steps):
        raise AssertionError(f"{ENCDEC}: {flash} flash and {flash_bwd} "
                             f"backward launches in {es.train_steps} steps, "
                             f"want {per_step} a step each")
    bwd_by_route = bwd_routes(f"{ENCDEC} train", flash_bwd)
    step_ms = float(np.percentile(np.asarray(lat[1:]) * 1e3, 50))
    B, S, F_ = es.train_batch, es.train_seq, es.train_seq
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    enc_w = sum(t[0].numel() for t in tree_leaves(loop.params["enc_blocks"])
                if t.dim() == 3)
    dec_w = sum(t[0].numel() for t in tree_leaves(loop.params["dec_blocks"])
                if t.dim() == 3)
    # the matrices of the encoder act on the frames, the decoder's self
    # and MLP matrices on the tokens, the cross-attention's K/V on the
    # frames and its Q/O on the tokens; the head on the tokens
    cross_kv = 2 * d * cfg.n_kv_heads * hd * cfg.n_layers
    mat = (enc_w * cfg.encoder_layers * B * F_
           + (dec_w * cfg.n_layers - cross_kv) * B * S + cross_kv * B * F_
           + d * cfg.vocab_size * B * S)
    attn = (4 * B * H * hd * (F_ * F_ * cfg.encoder_layers
                              + S * S // 2 * cfg.n_layers
                              + S * F_ * cfg.n_layers))
    flops = 3 * (2 * mat + attn)
    tokens = B * S
    out = {"arch": ENCDEC, "params": n_params, "losses": losses,
           "step_ms_p50": step_ms, "first_step_ms": lat[0] * 1e3,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "frames_per_step": B * F_,
           "model_flops_per_step": flops,
           "mfu_bf16_dense_peak": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "flash_launches": flash,
           "flash_launches_per_step": flash / es.train_steps,
           "flash_bwd_launches": flash_bwd,
           "flash_bwd_launches_per_step": flash_bwd / es.train_steps,
           "flash_bwd_routes": bwd_by_route}
    log(f"encdec train {ENCDEC} ({cfg.encoder_layers} + {cfg.n_layers} "
        f"layers, full width, bf16, "
        f"B={B} x {S} tokens over {F_} frames, {es.train_steps} steps on "
        f"make_batches): loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"p50 {step_ms:.3f} ms (first {lat[0] * 1e3:.3f} ms); "
        f"{out['tokens_per_s']:.1f} tokens/s; model FLOPs {flops:.4e}/step "
        f"= {out['mfu_bf16_dense_peak']:.4f} of the 989 TFLOP/s bf16 dense "
        f"peak; peak device memory {out['peak_bytes']} bytes; flash "
        f"launches {flash / es.train_steps:.1f} a step, backward "
        f"{flash_bwd / es.train_steps:.1f} a step; {card_line()}")
    del loop
    return out


def _pod_steps(cfg, params, batch, es: EncDecSizes, mesh, compress: bool):
    """``pod_steps`` train steps on ``mesh``: (losses, the parameters after
    each step as CPU tensors)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    ocfg = AdamWConfig(lr=es.pod_lr, warmup_steps=0)
    step = make_train_step(cfg, ocfg, mesh=mesh, compress_crosspod=compress)
    p, s = params, adamw_init(params, ocfg)
    losses, after = [], []
    for _ in range(es.pod_steps):
        p, s, m = step(p, s, batch)
        losses.append(float(m["loss"]))
        after.append([t.cpu().double()
                      for _, t in tree_flatten_with_path(p)])
    return losses, after


def _steps_apart(a, b) -> Dict[str, float]:
    """Largest element difference of two runs' parameters, and how many
    elements differ by more than 1e-5."""
    mx, far, total = 0.0, 0, 0
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            d = (u - v).abs()
            mx = max(mx, float(d.max()))
            far += int((d > 1e-5).sum())
            total += d.numel()
    return {"max_abs": mx, "beyond_1e-5": far, "elements": total}


def _first_step_int8_share(g, gc, params, comp, plain, ocfg) -> float:
    """The first compressed step's parameters against the plain step's,
    as a share of what the int8 error allows (at most 1 passes). From the
    same parameters and zero moments a first AdamW step moves an element
    by ``lr·f(x)`` and the decay term, with ``f(x) = x / (|x| + eps)`` and
    ``x = s·g`` the clipped gradient (``s = min(1, clip / |g|)``, the
    global norm); the compressed step by ``lr·f(y)``, ``y = s_c·g_c``.
    Each reduced element is within ``d``, half its leaf's quantization
    step, of the f32 one, so ``|y - x| <= s_c·d + |s_c - s|·|g|`` and, f
    increasing, the two steps differ by at most
    ``lr·max(f(x + D) - f(x), f(x) - f(x - D))`` for that ``D``, plus the
    f32 rounding of both new parameters (``2^-20·|p| + 1e-6·lr``)."""
    from repro_torch.models.tree import tree_flatten_with_path
    from repro_torch.optim.adamw import make_schedule
    lr = float(make_schedule(ocfg)(torch.ones((), dtype=torch.int32)))
    leaves = lambda t: [x.detach().cpu().double()
                        for _, x in tree_flatten_with_path(t)]
    gl, gcl, pl = leaves(g), leaves(gc), leaves(params)

    def clip_scale(ls) -> float:
        if ocfg.clip_norm is None:
            return 1.0
        norm = float(sum((x * x).sum() for x in ls)) ** 0.5
        return min(1.0, ocfg.clip_norm / max(norm, 1e-9))

    s, s_c = clip_scale(gl), clip_scale(gcl)
    f = lambda x: x / (x.abs() + ocfg.eps)
    worst = 0.0
    for x0, p0, a, b in zip(gl, pl, comp, plain):
        d = float(x0.abs().max()) / 127.0 * 0.5 * (1 + 1e-6)
        x = s * x0
        D = s_c * d + abs(s_c - s) * x0.abs()
        allow = (lr * torch.maximum(f(x + D) - f(x), f(x) - f(x - D))
                 + 2.0 ** -20 * p0.abs() + 1e-6 * lr)
        worst = max(worst, float(((a - b).abs() / allow).max()))
    return worst


def encdec_pod(es: EncDecSizes, device) -> Dict[str, object]:
    """The int8-compressed cross-pod step on the card: a one-rank NCCL
    process group from a FileStore and a (1, 1, 1) CUDA mesh over ("pod",
    "data", "model"). Reduced ``pod_arch`` (f32): the reduced gradient is
    the int8 round trip, within half a quantization step of each gradient
    element and not the identity; the compressed step applies AdamW to it
    (bit for bit the update ``adamw_update`` computes from it); its first
    step differs from the uncompressed step's by no more than the int8
    error allows (``_first_step_int8_share``). The group is destroyed, a
    one-rank gloo group made, and the same compressed steps of the CPU
    port on a CPU mesh held to the card's: losses within 1e-4 relative,
    every element within 2·lr a step, all but 1e-3 of them within
    1e-2·lr (an element whose int8 code flips at a rounding boundary
    moves by up to lr more or less)."""
    import tempfile
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.collectives import crosspod_grad_mean
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import _value_and_grad, init_params
    from repro_torch.models.tree import tree_flatten_with_path, tree_map
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update)
    cfg = reduced(get_config(es.pod_arch))
    params = init_params(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(47)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size,
                                          (es.pod_batch, es.pod_seq)),
                             dtype=torch.int32)
             for k in ("tokens", "targets")}
    axes = ("pod", "data", "model")
    tmp = tempfile.mkdtemp(prefix="smoke-pod-")
    bound = 2 * es.pod_lr * es.pod_steps
    try:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "nccl"), 1), rank=0, world_size=1,
            timeout=timedelta(seconds=120))
        try:
            mesh = make_mesh((1, 1, 1), axes, device_type="cuda")
            p = tree_map(lambda t: t.to(device), params)
            b = {k: v.to(device) for k, v in batch.items()}
            _, _, g = _value_and_grad(p, cfg, b)
            gc = crosspod_grad_mean(g, mesh, compress=True)
            worst, moved = 0.0, 0
            for (_, a), (_, x) in zip(tree_flatten_with_path(gc),
                                      tree_flatten_with_path(g)):
                half = float(x.abs().max()) / 127.0 * 0.5
                worst = max(worst, float((a - x).abs().max()) / half)
                moved += int((a != x).sum())
            if worst > 1 + 1e-6 or not moved:
                raise AssertionError(f"int8 round trip: largest error "
                                     f"{worst} half-steps, {moved} moved")
            ocfg = AdamWConfig(lr=es.pod_lr, warmup_steps=0)
            want, _, _ = adamw_update(gc, adamw_init(p, ocfg), p, ocfg)
            comp_l, comp_p = _pod_steps(cfg, p, b, es, mesh, True)
            if not all(torch.equal(x.cpu().double(), y) for (_, x), y in zip(
                    tree_flatten_with_path(want), comp_p[0])):
                raise AssertionError("the compressed step is not AdamW of "
                                     "the int8 round trip")
            plain_l, plain_p = _pod_steps(cfg, p, b, es, mesh, False)
            vs_plain = _steps_apart(comp_p, plain_p)
            int8_share = _first_step_int8_share(g, gc, p, comp_p[0],
                                                plain_p[0], ocfg)
            if int8_share > 1 or comp_l[0] != plain_l[0]:
                raise AssertionError(f"compressed vs plain step: the first "
                                     f"step at {int8_share} of the int8 "
                                     f"allowance, {vs_plain}, losses "
                                     f"{comp_l} vs {plain_l}")
            del p, b, g, gc
        finally:
            dist.destroy_process_group()
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "gloo"), 1), rank=0, world_size=1,
            timeout=timedelta(seconds=120))
        try:
            cpu_l, cpu_p = _pod_steps(cfg, params, batch, es,
                                      make_mesh((1, 1, 1), axes,
                                                device_type="cpu"), True)
        finally:
            dist.destroy_process_group()
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    vs_cpu = _steps_apart(comp_p, cpu_p)
    loss_rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(comp_l, cpu_l))
    flips = sum(int(((u - v).abs() > 1e-2 * es.pod_lr).sum())
                for x, y in zip(comp_p, cpu_p) for u, v in zip(x, y))
    if (loss_rel > 1e-4 or vs_cpu["max_abs"] > bound
            or flips > 1e-3 * vs_cpu["elements"]):
        raise AssertionError(f"compressed steps card vs CPU: losses "
                             f"{comp_l} vs {cpu_l}, {vs_cpu}, {flips} "
                             f"elements beyond 1e-2·lr")
    out = {"arch": es.pod_arch, "backend_card": "nccl",
           "backend_cpu": "gloo", "steps": es.pod_steps,
           "losses_compressed": comp_l, "losses_plain": plain_l,
           "losses_cpu": cpu_l, "roundtrip_max_err_half_steps": worst,
           "roundtrip_elements_moved": moved,
           "compressed_vs_plain": vs_plain,
           "first_step_share_of_int8_allowance": int8_share,
           "card_vs_cpu": vs_cpu,
           "card_vs_cpu_beyond_1e-2_lr": flips,
           "card_vs_cpu_loss_rel": loss_rel}
    log(f"encdec pod step (one-rank NCCL mesh (1, 1, 1), reduced "
        f"{es.pod_arch}, f32, {es.pod_steps} steps): the int8 round trip "
        f"within {worst:.4f} half-steps, {moved} elements moved; "
        f"compressed vs plain parameters {vs_plain}, the first step at "
        f"{int8_share:.4f} of the int8 allowance; card vs the CPU port on"
        f" a one-rank gloo mesh {vs_cpu}, {flips} beyond 1e-2·lr, losses "
        f"{comp_l} vs {cpu_l}")
    return out


def encdec_phase(device, es: EncDecSizes = EncDecSizes()
                 ) -> Dict[str, object]:
    """seamless-m4t-medium on the card (card against CPU, serving and
    training at full width) and the compressed pod step. Budget: about
    150 s."""
    t_phase = time.perf_counter()
    out: Dict[str, object] = {"cuda_vs_cpu": encdec_cuda_vs_cpu(es, device)}
    torch.cuda.empty_cache()
    out["serve"] = encdec_serve(es, device)
    torch.cuda.empty_cache()
    out["train"] = encdec_train(es, device)
    torch.cuda.empty_cache()
    out["pod"] = encdec_pod(es, device)
    out["launches"] = {
        "flash_attention": (out["serve"]["launches"]["flash_attention"]
                            + out["train"]["flash_launches"]),
        "flash_attention_bwd": out["train"]["flash_bwd_launches"],
        "decode_attention": out["serve"]["launches"]["decode_attention"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"encdec phase: {out['seconds']:.3f} s; {card_line()}")
    return out


# ---------------------------------------------------------------------------
# the sharded path: a world of processes sharing the card
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshSizes:
    arch: str = "qwen2-1.5b"
    shape: tuple = (2, 2)          # ("data", "model"): 4 processes
    layers: int = 2                # full width, depth cut to 2 of 28
    train_batch: int = 4
    train_seq: int = 128
    train_steps: int = 2           # cut for the smoke's time
    lr: float = 1e-3
    serve_batch: int = 4
    prompt_len: int = 64
    serve_steps: int = 4          # cut for the smoke's time
    ckpt_steps: int = 2            # the reshard check, reduced width
    join_s: float = 900.0          # mesh_moe and mesh_families run on it
    # the streaming layout (act_dp ("data",), act_sp "model"): context
    # parallel training and a prefill, held to the meshless references
    cp_steps: int = 2
    cp_block: int = 64             # attn_block_k: the CPU's streaming form


def _mesh_cfg(ms: MeshSizes, dtype: str):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(ms.arch), n_layers=ms.layers,
                               dtype=dtype, param_dtype=dtype)


def _mesh_inputs(ms: MeshSizes, vocab: int):
    rng = np.random.default_rng(31)
    shape = (ms.train_batch, ms.train_seq)
    batch = {k: rng.integers(0, vocab, shape).astype(np.int32)
             for k in ("tokens", "targets")}
    toks = rng.integers(0, vocab, (ms.serve_batch,
                                   ms.prompt_len + ms.serve_steps)
                        ).astype(np.int32)
    return batch, toks


def _mesh_opt(ms: MeshSizes):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=ms.lr, warmup_steps=0)


def _teacher_forced(prefill, decode, toks, P: int, steps: int
                    ) -> List[torch.Tensor]:
    """Logits (f32, on the host) after the prompts and after each of
    ``steps`` decode steps fed the given next tokens."""
    out = [prefill(toks[:, :P])]
    for i in range(steps):
        out.append(decode(toks[:, P + i], P + i))
    return out


def mesh_reference(ms: MeshSizes, tmp: str) -> Dict[str, object]:
    """The meshless runs on the card that the world is held to: the
    TrainLoop in f32 (losses; the final parameters saved to ``tmp``) and
    ModelServer in bf16 (teacher-forced logits), from the seeds the
    ranks use."""
    from repro_torch.launch.steps import init_params
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.tree import tree_map
    from repro_torch.serving.server import ModelServer
    cfg = _mesh_cfg(ms, "float32")
    batch, toks = _mesh_inputs(ms, cfg.vocab_size)
    loop = TrainLoop(cfg, opt_cfg=_mesh_opt(ms), device="cuda", seed=3)
    times: List[float] = []
    ran = loop.run(iter([batch] * ms.train_steps), steps=ms.train_steps,
                   log_every=0, on_metrics=_step_timer(times))
    torch.save([t.cpu() for t in _leaves_of(loop.params)],
               os.path.join(tmp, "ref_params.pt"))
    del loop
    out = {"losses": [h["loss"] for h in ran["history"]],
           "grad_norms": [h["grad_norm"] for h in ran["history"]],
           "step_ms": times}
    for dtype in MESH_SERVE:
        scfg = _mesh_cfg(ms, dtype)
        params = tree_map(lambda t: t.to("cuda"), init_params(
            torch.Generator().manual_seed(5), scfg))
        srv = ModelServer(scfg, params, batch=ms.serve_batch,
                          cache_len=ms.prompt_len + ms.serve_steps)

        def prefill(t):
            srv.prefill(t)
            return srv.logits.float().cpu()

        def decode(t, _pos):
            srv.tokens = torch.as_tensor(t, device="cuda")
            srv.decode(1)
            return srv.logits.float().cpu()

        out[dtype] = torch.stack(_teacher_forced(
            prefill, decode, toks, ms.prompt_len, ms.serve_steps))
        del srv, params
    torch.cuda.empty_cache()
    return out


MESH_SERVE = ("float32", "bfloat16")


def _step_timer(times: List[float]):
    """A ``TrainLoop.run`` ``on_metrics`` hook appending each step's ms
    (host clock between synced steps)."""
    last = [time.perf_counter()]

    def tick(_step, _m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - last[0]) * 1e3)
        last[0] = now
    return tick


def _spec_shares(tree, specs, mesh) -> List[int]:
    """Bytes of each leaf of ``tree`` one rank holds by its specs: the
    leaf's size over the product of the mesh axes its spec names."""
    from repro_torch.distributed import sharding
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for t, s in zip(_leaves_of(tree), sharding.spec_leaves(specs)):
        n = 1
        for e in s:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= sizes[a]
        out.append(t.numel() // n * t.element_size())
    return out


def _spec_share_bytes(tree, specs, mesh) -> int:
    """Bytes of ``tree`` one rank holds by its specs (``_spec_shares``
    summed)."""
    return sum(_spec_shares(tree, specs, mesh))


def _requested() -> int:
    """Bytes the caching allocator was asked for and still holds."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _freed() -> None:
    """Unreachable objects collected, then the caching allocator's free
    blocks handed back to the card (other processes share it)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _placed_params(cfg, place, gen_device: str, staged: bool):
    """The parameters drawn from seed 5 by a generator on ``gen_device``,
    each rank keeping its shards (``place``): its pieces go to the host,
    the whole model is freed and the pieces come back, so each owns its
    storage (a dim-0 chunk is a view of the whole tensor) in a fresh
    block, not in a hole the model left. ``staged``: the ranks draw one
    after the other, so the card holds one whole copy at a time besides
    the shards."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.steps import init_params
    from repro_torch.models.tree import (tree_flatten_with_path, tree_map,
                                         tree_unflatten)

    def draw():
        params = tree_map(lambda t: t.to("cuda"), init_params(
            torch.Generator(device=gen_device).manual_seed(5), cfg))
        placed = place(params)
        del params
        held = [(t.to_local().cpu(), t.device_mesh, t.placements, t.shape,
                 t.stride()) for _, t in tree_flatten_with_path(placed)]
        skeleton = tree_map(lambda _: 0, placed)
        del placed
        _freed()
        return tree_unflatten(skeleton, [
            DTensor.from_local(loc.to("cuda"), mesh, pl, run_check=False,
                               shape=shape, stride=stride)
            for loc, mesh, pl, shape, stride in held])

    if not staged:
        return draw()
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            log(f"rank {r}: the card's bytes in use "
                f"{card_used_bytes('cuda')} before drawing {cfg.name}")
            out = draw()
            log(f"rank {r}: {cfg.name} drawn and placed, the card's bytes "
                f"in use {card_used_bytes('cuda')}")
        dist.barrier()
    return out


def _mesh_serve(ms, cfg, mesh, toks, rank: int, gen_device: str = "cpu",
                embeds=None, staged: bool = False) -> Dict[str, object]:
    """The prefill and decode bundles on the mesh, teacher-forced, the
    parameters drawn from seed 5 by a generator on ``gen_device``
    (``_placed_params``); ``embeds``, where given, the frontend's
    embeddings ahead of each prompt: launches, the caches' placements,
    the serving seconds, the bytes the parameters asked of the
    allocator beside the specs' share; rank 0 also keeps the logits."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch import steps
    B, P = ms.serve_batch, ms.prompt_len
    F_ = 0 if embeds is None else embeds.shape[1]
    C = F_ + P + ms.serve_steps
    pb = steps.build_step_bundle(cfg, ShapeSpec("prompt", F_ + P, B,
                                                "prefill"),
                                 mesh, cache_len=C)
    db = steps.build_step_bundle(cfg, ShapeSpec("serve", C, B, "decode"),
                                 mesh)
    torch.cuda.synchronize()
    asked = _requested()
    params = _placed_params(cfg, lambda t: pb.place(t)[0], gen_device,
                            staged)
    torch.cuda.synchronize()
    out = {"param_bytes_requested": _requested() - asked,
           "param_bytes_computed": _spec_share_bytes(params, pb.in_specs[0],
                                                     mesh),
           "card_used_bytes_placed": card_used_bytes("cuda")}
    extra = () if embeds is None else (sharding.distribute(
        torch.as_tensor(embeds, device="cuda"), mesh, pb.in_specs[2]),)
    state = {}
    flash_attention.launches = decode_attention.launches = 0

    def prefill(t):
        tok = sharding.distribute(torch.as_tensor(t, device="cuda"), mesh,
                                  pb.in_specs[1])
        logits, state["caches"] = pb.fn(params, tok, *extra)
        return logits.full_tensor().float().cpu()

    def decode(t, pos):
        tok, p_ = (sharding.distribute(
            torch.as_tensor(x, dtype=torch.int32, device="cuda"), mesh, spec)
            for x, spec in ((t, db.in_specs[2]),
                            (np.full(B, F_ + pos), db.in_specs[3])))
        logits, state["caches"] = db.fn(params, state["caches"], tok, p_)
        return logits.full_tensor().float().cpu()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = _teacher_forced(prefill, decode, toks, P, ms.serve_steps)
    torch.cuda.synchronize()
    out.update({"serve_s": time.perf_counter() - t0,
                "flash": flash_attention.launches,
                "decode": decode_attention.launches,
                "card_used_bytes_served": card_used_bytes("cuda"),
                "cache_placed": all(
                    tuple(t.placements) == sharding.placements(mesh, sp)
                    for t, sp in zip(_leaves_of(state["caches"]),
                                     sharding.spec_leaves(db.out_specs[1])))})
    if rank == 0:
        out["logits"] = torch.stack(logits)
    return out


def _count_first_step(loop, mesh) -> Dict[str, object]:
    """Wraps ``loop.train_step`` so that its next call runs under the dry
    run's ``StepCounter`` with the peak reset before it; the returned
    dict fills in then: the collective bytes by kind and by mesh axis
    and the step's ``max_memory_allocated``. The counter decomposes
    nothing, so the step runs the ops it runs unwatched."""
    from repro_torch.launch.dryrun import StepCounter
    step, out = loop.train_step, {}

    def first(*args):
        loop.train_step = step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with StepCounter(mesh, decompose=False) as c:
            res = step(*args)
        torch.cuda.synchronize()
        out.update(peak_bytes=torch.cuda.max_memory_allocated(),
                   collectives=dict(c.collectives), by_axis=c.by_axis)
        return res

    loop.train_step = first
    return out


def _first_world(a: dict, ms: MeshSizes, mesh, rank: int,
                 res: Dict[str, object], same_point: List[str]) -> None:
    """A rank's ``mesh``, ``mesh_moe`` and ``mesh_families`` work, its
    results into ``res``."""
    from repro_torch.configs.base import reduced
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.launch.train import TrainLoop
    # training, f32: the TrainLoop places its state by the rules
    cfg = _mesh_cfg(ms, "float32")
    batch, toks = _mesh_inputs(ms, cfg.vocab_size)
    torch.cuda.synchronize()
    before, asked = torch.cuda.memory_allocated(), _requested()
    loop = TrainLoop(cfg, opt_cfg=_mesh_opt(ms), mesh=mesh, seed=3)
    torch.cuda.synchronize()
    res["state_bytes_measured"] = torch.cuda.memory_allocated() - before
    res["state_bytes_requested"] = _requested() - asked
    res["batch_share"] = sum(v.nbytes for v in batch.values()
                             ) // ms.shape[0]
    res["first_step"] = _count_first_step(loop, mesh)
    res["state_bytes_computed"] = (
        _spec_share_bytes(loop.params, sharding.param_specs(
            loop.params, mesh), mesh)
        + _spec_share_bytes(loop.opt_state, sharding.opt_specs(
            loop.opt_state, mesh), mesh))
    res["unsharded_bytes"] = sum(
        t.numel() * t.element_size()
        for t in _leaves_of(loop.params) + _leaves_of(loop.opt_state))
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    times: List[float] = []
    ran = loop.run(iter([batch] * ms.train_steps),
                   steps=ms.train_steps, log_every=0,
                   on_metrics=_step_timer(times))
    res["train_flash"] = flash_attention.launches - f0
    res["train_flash_bwd"] = flash_attention_bwd.launches - b0
    res["losses"] = [h["loss"] for h in ran["history"]]
    res["grad_norms"] = [h["grad_norm"] for h in ran["history"]]
    # the first step ran under the counter: its time kept apart
    res["counted_step_ms"], res["step_ms"] = times[0], times[1:]
    ref = (torch.load(a["ref"]) if rank == 0 else None)
    num = den = 0.0
    for i, t in enumerate(_leaves_of(loop.params)):
        full = t.full_tensor()                  # every rank
        if rank == 0:
            want = ref[i].to("cuda").double()
            num += float(((full.double() - want) ** 2).sum())
            den += float((want ** 2).sum())
    res["param_rel_l2"] = (num / den) ** 0.5 if rank == 0 else None
    del loop, ref
    torch.cuda.empty_cache()

    # serving, f32 then bf16: the prefill and decode bundles
    for dtype in MESH_SERVE:
        res[dtype] = _mesh_serve(ms, _mesh_cfg(ms, dtype), mesh, toks,
                                 rank)
        torch.cuda.empty_cache()

    # the streaming layout: context-parallel training and prefill
    res["cp"] = _cp_rank(ms, mesh, rank)
    torch.cuda.empty_cache()

    # a reduced checkpoint saved on the world
    rcfg = reduced(_mesh_cfg(ms, "float32"))
    rloop = TrainLoop(rcfg, opt_cfg=_mesh_opt(ms), mesh=mesh, seed=4,
                      ckpt_dir=a["ckpt"])
    rb = {k: v[:, :16] for k, v in batch.items()}
    rb = {k: np.clip(v, 0, rcfg.vocab_size - 1) for k, v in rb.items()}
    rloop.run(iter([rb] * ms.ckpt_steps), steps=ms.ckpt_steps,
              log_every=0)
    rloop.save(block=True)
    full = [t.full_tensor().cpu() for t in _leaves_of(rloop.params)]
    if rank == 0:
        res["ckpt_params"] = full
    del rloop, full
    torch.cuda.empty_cache()

    # the MoE families on the same world (the mesh_moe phase)
    res["moe"] = moe_rank(MoeMeshSizes(**a["moe"]), mesh, rank,
                          a["moe_ref"])
    _freed()
    # the SSD and the vision frontend (the mesh_families phase)
    res["families"] = families_rank(FamilyMeshSizes(**a["families"]),
                                    mesh, rank, a["tmp"],
                                    tuple(same_point))
    _freed()


def _cp_cfg(ms: MeshSizes):
    """The ``mesh`` phase's f32 config in the JAX package's streaming
    layout (its dry run's ``--attn-block``): q, k and v batch-sharded over
    ``data`` with every head, q's rows over ``model``."""
    return dataclasses.replace(_mesh_cfg(ms, "float32"),
                               attn_block_k=ms.cp_block, act_dp=("data",),
                               act_sp="model")


def _cp_rank(ms: MeshSizes, mesh, rank: int) -> Dict[str, object]:
    """A rank's context-parallel work: ``TrainLoop(mesh=)`` for
    ``cp_steps`` steps from the ``mesh`` phase's seed and batch, then the
    f32 prefill bundle on its prompts (parameters from seed 5): the
    losses and gradient norms, the prefill logits (rank 0), the caches'
    placements against the decode bundle's specs, the flash launches of
    each (the count reset just before) and every flash call's query rows,
    key rows and ``q_offset``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import TrainLoop
    t0 = time.perf_counter()
    cfg = _cp_cfg(ms)
    batch, toks = _mesh_inputs(ms, cfg.vocab_size)
    seen: List[tuple] = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw.get("q_offset")))
        return flash(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        loop = TrainLoop(cfg, opt_cfg=_mesh_opt(ms), mesh=mesh, seed=3)
        flash_attention.launches = flash_attention_bwd.launches = 0
        ran = loop.run(iter([batch] * ms.cp_steps), steps=ms.cp_steps,
                       log_every=0)
        torch.cuda.synchronize()
        out = {"train_flash": flash_attention.launches,
               "train_flash_bwd": flash_attention_bwd.launches,
               "train_seen": sorted(set(seen)),
               "losses": [h["loss"] for h in ran["history"]],
               "grad_norms": [h["grad_norm"] for h in ran["history"]]}
        del loop
        torch.cuda.empty_cache()
        B, P = ms.serve_batch, ms.prompt_len
        C = P + ms.serve_steps
        pb = steps.build_step_bundle(cfg, ShapeSpec("prompt", P, B,
                                                    "prefill"),
                                     mesh, cache_len=C)
        db = steps.build_step_bundle(cfg, ShapeSpec("serve", C, B,
                                                    "decode"), mesh)
        params = _placed_params(cfg, lambda t: pb.place(t)[0], "cpu",
                                False)
        tok = sharding.distribute(torch.as_tensor(toks[:, :P],
                                                  device="cuda"),
                                  mesh, pb.in_specs[1])
        seen.clear()
        flash_attention.launches = 0
        logits, caches = pb.fn(params, tok)
        logits = logits.full_tensor().float().cpu()
        torch.cuda.synchronize()
        out.update(prefill_flash=flash_attention.launches,
                   prefill_seen=sorted(set(seen)),
                   cache_placed=all(
                       tuple(t.placements) == sharding.placements(mesh, sp)
                       for t, sp in zip(_leaves_of(caches),
                                        sharding.spec_leaves(
                                            db.in_specs[1]))))
        if rank == 0:
            out["logits"] = logits
        del params, caches
    finally:
        ops.flash_attention = flash
    out["model_rank"] = mesh.get_local_rank("model")
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_cp_check(ms: MeshSizes, ref: Dict[str, object],
                  ranks: List[Dict[str, object]]) -> Dict[str, object]:
    """The context-parallel work against the ``mesh`` phase's meshless
    references: losses and gradient norms of the first ``cp_steps``
    steps within 1e-5 relative, the f32 prefill logits within 1e-4
    relative L2 with every greedy token equal; on every rank, the
    flash kernel launched on its ``model`` coordinate's rows (training
    ``train_seq/2`` of ``train_seq``, the prefill ``prompt_len/2`` of
    ``prompt_len``) at ``q_offset`` = that coordinate times the rows,
    once a layer in the prefill and twice a layer a step in training
    (the forward and the remat recompute), and the caches in the decode
    bundle's placements."""
    cps = [r["cp"] for r in ranks]
    r0 = cps[0]
    n = ms.cp_steps
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(r0["losses"], ref["losses"][:n]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in
                    zip(r0["grad_norms"], ref["grad_norms"][:n]))
    prefill = _mesh_logits(r0["logits"][None], ref["float32"][:1])
    for c in cps:
        m = c["model_rank"]
        tr, pr = ms.train_seq // 2, ms.prompt_len // 2
        want = {"train_seen": [(tr, ms.train_seq, m * tr)],
                "prefill_seen": [(pr, ms.prompt_len, m * pr)],
                "train_flash": 2 * ms.layers * n,
                "train_flash_bwd": ms.layers * n,
                "prefill_flash": ms.layers, "cache_placed": True}
        got = {k: c[k] for k in want}
        if got != want:
            raise AssertionError(f"mesh cp (model rank {m}): {got}, "
                                 f"expected {want}")
        if (c["losses"], c["grad_norms"]) != (r0["losses"],
                                               r0["grad_norms"]):
            raise AssertionError("mesh cp: ranks disagree on the losses")
    if (loss_rel > 1e-5 or gnorm_rel > 1e-5 or prefill["rel_l2"] > 1e-4
            or prefill["mismatches"]):
        raise AssertionError(f"mesh cp vs meshless: losses "
                             f"{r0['losses']} vs {ref['losses'][:n]}, "
                             f"gradient norms {r0['grad_norms']} vs "
                             f"{ref['grad_norms'][:n]}, prefill {prefill}")
    return {"losses": r0["losses"], "losses_meshless": ref["losses"][:n],
            "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
            "prefill": prefill,
            "launches": {"flash_attention": sum(
                c["train_flash"] + c["prefill_flash"] for c in cps),
                         "flash_attention_bwd": sum(c["train_flash_bwd"]
                                                    for c in cps)},
            "rows": [(c["model_rank"], c["train_seen"], c["prefill_seen"])
                     for c in cps],
            "seconds": max(c["seconds"] for c in cps)}


def mesh_rank(arg: str) -> None:
    """One rank of a world (``chip_smoke.py --mesh-rank <json>``): on the
    card, gloo between the processes that share it. The first world runs
    the ``mesh``, ``mesh_moe`` and ``mesh_families`` work
    (``_first_world``), a second one of as many processes beside it
    (``encdec_world`` in the argument) the ``mesh_encdec`` work."""
    import pickle
    from datetime import timedelta
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import gloo_cuda
    from repro_torch.launch.mesh import make_mesh
    a = json.loads(arg)
    ms = MeshSizes(**{k: tuple(v) if k == "shape" else v
                      for k, v in a["sizes"].items()})
    rank, n = a["rank"], a["world"]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", store=dist.FileStore(
        a["store"], n), rank=rank, world_size=n,
        timeout=timedelta(seconds=ms.join_s))
    gloo_cuda.install()
    res: Dict[str, object] = {"rank": rank}
    try:
        # started beside the references: run once they are written
        deadline = time.monotonic() + ms.join_s
        while not os.path.exists(a["ready"]):
            if time.monotonic() > deadline:
                raise TimeoutError("the references were not written")
            time.sleep(0.1)
        same_point = json.loads(Path(a["ready"]).read_text())["same_point"]
        mesh = make_mesh(ms.shape, ("data", "model"))
        res["coords"] = [mesh.get_local_rank(d) for d in ("data", "model")]
        if a["encdec_world"]:
            res["encdec"] = encdec_rank(EncDecMeshSizes(**a["encdec"]),
                                        mesh, rank, a["tmp"])
        else:
            _first_world(a, ms, mesh, rank, res, same_point)
    finally:
        dist.destroy_process_group()
    with open(a["out"], "wb") as f:
        pickle.dump(res, f)


def _mesh_logits(got: torch.Tensor, want: torch.Tensor
                 ) -> Dict[str, object]:
    """Teacher-forced logits (steps, B, V) of the world against the
    meshless server's: relative L2, largest difference, the greedy tokens
    that differ, and of those the ones where the reference's logits of
    the two tokens lie further apart than twice the largest difference
    (a near-tie is within it)."""
    got, want = got.double(), want.double()
    max_abs = float((got - want).abs().max())
    g_tok, w_tok = got.argmax(-1), want.argmax(-1)
    differ = g_tok != w_tok
    gap = (want.gather(-1, w_tok[..., None])
           - want.gather(-1, g_tok[..., None]))[..., 0]
    return {"rel_l2": float((got - want).norm() / want.norm()),
            "max_abs": max_abs, "tokens": int(differ.numel()),
            "mismatches": int(differ.sum()),
            "mismatches_not_near_ties": int((differ
                                             & (gap > 2 * max_abs)).sum())}


@dataclasses.dataclass(frozen=True)
class MoeMeshSizes:
    """The ``mesh_moe`` phase on the mesh phase's world: granite at full
    width trains and serves, mixtral at full width serves."""
    granite: str = "granite-moe-3b-a800m"
    granite_layers: int = 2        # of 32, cut for the smoke's time
    mixtral: str = "mixtral-8x22b"
    mixtral_layers: int = 1        # of 56
    train_batch: int = 4
    train_seq: int = 128
    train_steps: int = 2           # cut for the smoke's time
    train_groups: int = 2          # moe_groups: one group a data rank
    lr: float = 1e-3
    serve_batch: int = 4
    prompt_len: int = 64
    serve_steps: int = 4          # cut for the smoke's time


def _moe_cfg(mz: MoeMeshSizes, arch: str, dtype: str, groups: int = 0):
    from repro_torch.configs.registry import get_config
    layers = (mz.granite_layers if arch == mz.granite
              else mz.mixtral_layers)
    return dataclasses.replace(get_config(arch), n_layers=layers,
                               dtype=dtype, param_dtype=dtype,
                               moe_groups=groups)


def _moe_inputs(mz: MoeMeshSizes, vocab: int):
    rng = np.random.default_rng(37)
    batch = {k: rng.integers(0, vocab, (mz.train_batch, mz.train_seq))
             .astype(np.int32) for k in ("tokens", "targets")}
    toks = rng.integers(0, vocab, (mz.serve_batch,
                                   mz.prompt_len + mz.serve_steps)
                        ).astype(np.int32)
    return batch, toks


# (arch field, dtype) of each served case
MOE_SERVE = (("granite", "float32"), ("granite", "bfloat16"),
             ("mixtral", "bfloat16"))


def _routes_kept(routes: List[torch.Tensor]) -> Callable[[], None]:
    """Wraps ``moe.route`` so that each call's expert indices ``(t, K)``
    are appended to ``routes``; returns the function that unwraps it."""
    from repro_torch.models import moe
    route = moe.route

    def keep(*a, **k):
        out = route(*a, **k)
        routes.append(out[3])
        return out

    moe.route = keep

    def undo() -> None:
        moe.route = route
    return undo


def _route_flips(got: List[torch.Tensor], want: List[torch.Tensor]
                 ) -> Dict[str, object]:
    """Of the routings (one per token and MoE layer call) of two served
    runs, those whose set of experts differs."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routing calls against "
                             f"{len(want)}")
    differ = total = 0
    for a, b in zip(got, want):
        a, b = a.cpu().sort(-1).values, b.cpu().sort(-1).values
        if a.shape != b.shape:
            raise AssertionError(f"routings {tuple(a.shape)} against "
                                 f"{tuple(b.shape)}")
        differ += int((a != b).any(-1).sum())
        total += a.shape[0]
    return {"routings": total, "differ": differ, "share": differ / total}


def _routes_replayed(routes: List[torch.Tensor]) -> Callable[[], int]:
    """Wraps ``moe.route`` so that its calls take their expert indices
    ``(t, K)`` from ``routes`` in order (another run's choices for the
    same tokens), each gate that expert's probability renormalised as
    ``route`` does; returns the function that unwraps it and gives the
    number of routings used."""
    from repro_torch.models import moe
    route = moe.route
    used = [0]

    def replay(router, xf, top_k):
        logits, probs, _, _ = route(router, xf, top_k)
        if used[0] == len(routes):
            raise AssertionError(f"more than the {len(routes)} routings "
                                 f"recorded")
        eidx = routes[used[0]].to(probs.device)
        used[0] += 1
        if tuple(eidx.shape) != (xf.shape[0], top_k):
            raise AssertionError(f"a recorded routing {tuple(eidx.shape)} "
                                 f"for {xf.shape[0]} tokens, top {top_k}")
        gates = probs.gather(-1, eidx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, gates, eidx

    moe.route = replay

    def undo() -> int:
        moe.route = route
        return used[0]
    return undo


def moe_reference(mz: MoeMeshSizes, tmp: str) -> Dict[str, object]:
    """The meshless runs the ``mesh_moe`` world is held to, on the card:
    granite's TrainLoop in f32 at the world's ``moe_groups`` (losses,
    gradient norms, step ms; the final parameters saved to ``tmp``) and
    ModelServer (teacher-forced logits, each MoE layer call's expert
    choices) for each served case, the parameters drawn on the card from
    the seeds the ranks use."""
    from repro_torch.launch.steps import init_params
    from repro_torch.launch.train import TrainLoop
    from repro_torch.serving.server import ModelServer
    t0 = time.perf_counter()
    cfg = _moe_cfg(mz, mz.granite, "float32", mz.train_groups)
    batch, _ = _moe_inputs(mz, cfg.vocab_size)
    loop = TrainLoop(cfg, opt_cfg=_mesh_opt(mz), device="cuda", seed=3)
    times: List[float] = []
    ran = loop.run(iter([batch] * mz.train_steps), steps=mz.train_steps,
                   log_every=0, on_metrics=_step_timer(times))
    torch.save([t.cpu() for t in _leaves_of(loop.params)],
               os.path.join(tmp, "moe_ref_params.pt"))
    del loop
    out: Dict[str, object] = {
        "losses": [h["loss"] for h in ran["history"]],
        "grad_norms": [h["grad_norm"] for h in ran["history"]],
        "step_ms": times}
    for field, dtype in MOE_SERVE:
        scfg = _moe_cfg(mz, getattr(mz, field), dtype)
        _, toks = _moe_inputs(mz, scfg.vocab_size)
        params = init_params(torch.Generator(device="cuda").manual_seed(5),
                             scfg)
        srv = ModelServer(scfg, params, batch=mz.serve_batch,
                          cache_len=mz.prompt_len + mz.serve_steps)

        def prefill(t):
            srv.prefill(t)
            return srv.logits.float().cpu()

        def decode(t, _pos):
            srv.tokens = torch.as_tensor(t, device="cuda")
            srv.decode(1)
            return srv.logits.float().cpu()

        routes: List[torch.Tensor] = []
        undo = _routes_kept(routes)
        try:
            out[f"{field}_{dtype}"] = torch.stack(_teacher_forced(
                prefill, decode, toks, mz.prompt_len, mz.serve_steps))
        finally:
            undo()
        out[f"{field}_{dtype}_routes"] = [r.cpu() for r in routes]
        del srv, params
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def moe_rank(mz: MoeMeshSizes, mesh, rank: int, ref_path: str
             ) -> Dict[str, object]:
    """One rank's ``mesh_moe`` work: granite's TrainLoop on the mesh
    (f32, ``moe_groups`` one group a data rank, so EP's all-to-all), its
    state bytes (allocated, requested of the allocator, each leaf's local
    piece) beside the specs' share, the parameters against the meshless
    loop's; then the prefill and decode bundles of each served case
    (``moe_groups`` 0: the gathered token stream), rank 0 keeping each
    MoE layer call's expert choices. The attention launches are counted
    from 0 for this work alone; the bytes the MoE layers exchange are
    read off the tensors the exchanges are given."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     flash_attention_bwd)
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import moe
    t0 = time.perf_counter()
    res: Dict[str, object] = {}
    moved = {"all_to_all": 0, "all_to_all_calls": 0, "gathered_slab": 0,
             "gathered_calls": 0}
    exchange, gathered = collectives._exchange, moe._ep_gathered

    def count_exchange(x, *a):
        moved["all_to_all"] += x.numel() * x.element_size()
        moved["all_to_all_calls"] += 1
        return exchange(x, *a)

    def count_gathered(ex, disp, *a):
        moved["gathered_slab"] += disp.numel() * disp.element_size()
        moved["gathered_calls"] += 1
        return gathered(ex, disp, *a)

    def requested() -> int:
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    collectives._exchange, moe._ep_gathered = count_exchange, count_gathered
    flash_attention.launches = decode_attention.launches = 0
    flash_attention_bwd.launches = 0
    try:
        cfg = _moe_cfg(mz, mz.granite, "float32", mz.train_groups)
        batch, _ = _moe_inputs(mz, cfg.vocab_size)
        torch.cuda.synchronize()
        before, asked = torch.cuda.memory_allocated(), requested()
        loop = TrainLoop(cfg, opt_cfg=_mesh_opt(mz), mesh=mesh, seed=3)
        torch.cuda.synchronize()
        res["state_bytes_measured"] = torch.cuda.memory_allocated() - before
        res["state_bytes_requested"] = requested() - asked
        leaves = _leaves_of(loop.params) + _leaves_of(loop.opt_state)
        shares = (_spec_shares(loop.params, sharding.param_specs(
            loop.params, mesh), mesh) + _spec_shares(
                loop.opt_state, sharding.opt_specs(loop.opt_state, mesh),
                mesh))
        res["state_bytes_computed"] = sum(shares)
        held = [(t.to_local() if isinstance(t, DTensor) else t)
                for t in leaves]
        # (leaf index, bytes held, the spec's share) of every leaf whose
        # local piece is not its share
        res["leaves_off"] = [
            (i, h.numel() * h.element_size(), w)
            for i, (h, w) in enumerate(zip(held, shares))
            if h.numel() * h.element_size() != w]
        res["unsharded_bytes"] = sum(t.numel() * t.element_size()
                                     for t in leaves)
        del leaves, held
        times: List[float] = []
        ran = loop.run(iter([batch] * mz.train_steps), steps=mz.train_steps,
                       log_every=0, on_metrics=_step_timer(times))
        res["train_flash"] = flash_attention.launches
        res["train_flash_bwd"] = flash_attention_bwd.launches
        res["train_moved"] = dict(moved)
        res["losses"] = [h["loss"] for h in ran["history"]]
        res["grad_norms"] = [h["grad_norm"] for h in ran["history"]]
        res["step_ms"] = times
        ref = torch.load(ref_path) if rank == 0 else None
        num = den = 0.0
        for i, t in enumerate(_leaves_of(loop.params)):
            full = t.full_tensor()                  # every rank
            if rank == 0:
                want = ref[i].to("cuda").double()
                num += float(((full.double() - want) ** 2).sum())
                den += float((want ** 2).sum())
        res["param_rel_l2"] = (num / den) ** 0.5 if rank == 0 else None
        del loop, ref
        torch.cuda.empty_cache()
        for field, dtype in MOE_SERVE:
            scfg = _moe_cfg(mz, getattr(mz, field), dtype)
            _, toks = _moe_inputs(mz, scfg.vocab_size)
            for k in moved:
                moved[k] = 0
            flash_attention.launches = decode_attention.launches = 0
            routes: List[torch.Tensor] = []
            undo = _routes_kept(routes)
            try:
                res[f"{field}_{dtype}"] = dict(
                    _mesh_serve(mz, scfg, mesh, toks, rank,
                                gen_device="cuda"), moved=dict(moved))
            finally:
                undo()
            if rank == 0:
                res[f"{field}_{dtype}"]["routes"] = [r.cpu() for r in routes]
            del routes
            torch.cuda.empty_cache()
    finally:
        collectives._exchange, moe._ep_gathered = exchange, gathered
    res["seconds"] = time.perf_counter() - t0
    return res


# bytes the state asked of the allocator may differ from the specs' share
# by: less than the smallest leaf held twice (a norm's local piece, 6 KiB
# at granite's width), so no copy of a leaf hides in it
STATE_SLACK = 4096


def mesh_moe_check(mz: MoeMeshSizes, ref: Dict[str, object],
                   ranks: List[Dict[str, object]]) -> Dict[str, object]:
    """Holds the ``mesh_moe`` world to the meshless runs: granite's
    training (losses and gradient norms within 1e-5 relative, parameters
    within 1e-4 relative L2, the same losses on every rank; the state:
    each leaf's local piece exactly its spec's share, the bytes asked of
    the allocator within ``STATE_SLACK`` of the specs' share, the bytes
    it allocated within 1 % + 1 MiB, its blocks being rounded up), each
    served case's teacher-forced logits (f32: within 1e-4 relative L2,
    every greedy token equal; bf16: within 2e-2, a greedy token
    differing only at a near-tie) and the share of its routings that
    chose other experts than the meshless server's, the attention
    launches of every rank and the caches' placements."""
    r0 = ranks[0]["moe"]
    cfg = _moe_cfg(mz, mz.granite, "float32", mz.train_groups)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                       ref["losses"]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["grad_norms"],
                                                        ref["grad_norms"]))
    serve = {f"{f}_{dt}": _mesh_logits(r0[f"{f}_{dt}"]["logits"],
                                       ref[f"{f}_{dt}"])
             for f, dt in MOE_SERVE}
    flips = {f"{f}_{dt}": _route_flips(r0[f"{f}_{dt}"]["routes"],
                                       ref[f"{f}_{dt}_routes"])
             for f, dt in MOE_SERVE}
    remat = 1 if cfg.remat == "none" else 2
    for r in ranks:
        m = r["moe"]
        if (m["losses"], m["grad_norms"]) != (r0["losses"],
                                               r0["grad_norms"]):
            raise AssertionError(f"mesh_moe: ranks disagree on the losses "
                                 f"or gradient norms: {m['losses']} vs "
                                 f"{r0['losses']}")
        got, want = m["state_bytes_measured"], m["state_bytes_computed"]
        asked = m["state_bytes_requested"]
        if (m["leaves_off"] or abs(asked - want) > STATE_SLACK
                or abs(got - want) > 0.01 * want + (1 << 20)):
            raise AssertionError(f"mesh_moe rank {r['rank']}: {got} bytes "
                                 f"of state allocated, {asked} requested, "
                                 f"the specs give {want}; leaves (index, "
                                 f"held, share) off: {m['leaves_off']}")
        bad = (m["train_flash"] != remat * cfg.n_layers * mz.train_steps
               or m["train_flash_bwd"] != cfg.n_layers * mz.train_steps)
        for f, dt in MOE_SERVE:
            layers = _moe_cfg(mz, getattr(mz, f), dt).n_layers
            sv = m[f"{f}_{dt}"]
            bad |= (sv["flash"] != layers
                    or sv["decode"] != layers * mz.serve_steps
                    or not sv["cache_placed"])
        if bad:
            raise AssertionError(f"mesh_moe rank {r['rank']}: launches or "
                                 f"cache placements: {m}")
    if loss_rel > 1e-5 or gnorm_rel > 1e-5 or r0["param_rel_l2"] > 1e-4:
        raise AssertionError(f"mesh_moe training vs meshless: losses "
                             f"{r0['losses']} vs {ref['losses']}, gradient "
                             f"norms {r0['grad_norms']} vs "
                             f"{ref['grad_norms']}, parameters "
                             f"{r0['param_rel_l2']}")
    for key, v in serve.items():
        if (v["rel_l2"] > 1e-4 or v["mismatches"]) if key.endswith(
                "float32") else (v["rel_l2"] > 2e-2
                                 or v["mismatches_not_near_ties"]):
            raise AssertionError(f"mesh_moe serving vs ModelServer: {key} "
                                 f"{v}")
    steps_ = cfg.n_layers * mz.train_steps
    return {
        "archs": {mz.granite: mz.granite_layers,
                  mz.mixtral: mz.mixtral_layers},
        "losses_mesh": r0["losses"], "losses_meshless": ref["losses"],
        "loss_rel": loss_rel, "grad_norms_mesh": r0["grad_norms"],
        "grad_norms_meshless": ref["grad_norms"], "grad_norm_rel": gnorm_rel,
        "param_rel_l2": r0["param_rel_l2"], "step_ms": r0["step_ms"],
        "step_ms_meshless": ref["step_ms"],
        "unsharded_state_bytes": r0["unsharded_bytes"],
        # what each rank hands the all-to-alls per MoE layer and train
        # step (two exchanges forward, two backward), and the slab each
        # served MoE layer call hands the gathered exchange
        "train_all_to_all_bytes_per_layer_step":
            r0["train_moved"]["all_to_all"] / steps_,
        "train_all_to_all_calls": r0["train_moved"]["all_to_all_calls"],
        "serve_moved": {f"{f}_{dt}": r0[f"{f}_{dt}"]["moved"]
                        for f, dt in MOE_SERVE},
        "serve": serve, "route_flips": flips,
        "ranks": [{"coords": r["coords"],
                   "state_bytes_measured": r["moe"]["state_bytes_measured"],
                   "state_bytes_requested":
                       r["moe"]["state_bytes_requested"],
                   "state_bytes_computed": r["moe"]["state_bytes_computed"],
                   "train_flash": r["moe"]["train_flash"],
                   "train_flash_bwd": r["moe"]["train_flash_bwd"],
                   **{f"{f}_{dt}_{k}": r["moe"][f"{f}_{dt}"][k]
                      for f, dt in MOE_SERVE
                      for k in ("flash", "decode", "serve_s")},
                   "seconds": r["moe"]["seconds"]} for r in ranks],
        "launches": {
            "flash_attention": sum(
                r["moe"]["train_flash"] + sum(r["moe"][f"{f}_{dt}"]["flash"]
                                              for f, dt in MOE_SERVE)
                for r in ranks),
            "flash_attention_bwd": sum(r["moe"]["train_flash_bwd"]
                                       for r in ranks),
            "decode_attention": sum(r["moe"][f"{f}_{dt}"]["decode"]
                                    for r in ranks for f, dt in MOE_SERVE)}}


@dataclasses.dataclass(frozen=True)
class FamilyMeshSizes:
    """The ``mesh_families`` phase on the mesh phase's world, at full
    width: mamba2-780m trains and serves, jamba-v0.1-52b serves,
    qwen2-vl-7b trains and serves with its patch embeddings ahead of the
    tokens."""
    mamba: str = "mamba2-780m"
    mamba_layers: int = 2          # of 48, cut for the smoke's time
    mamba_seq: int = 320           # past the 256-row chunk: a padded tail
    jamba: str = "jamba-v0.1-52b"
    jamba_layers: int = 8          # one period of 8, of 32
    vl: str = "qwen2-vl-7b"
    vl_layers: int = 1             # of 28, cut for the smoke's time
    vl_patches: int = 256
    vl_tokens: int = 64
    train_batch: int = 4
    train_steps: int = 2           # cut for the smoke's time
    # at 1e-4 qwen2-vl learns the batch by heart in one step (its loss
    # 12.35 then 0.0012), where the f32 softmax's 1 - p decides the
    # later digits; at 1e-3 mamba2's three steps amplify rounding past
    # the limits (the meshless loop's own spread, ``families_reference``)
    lr: float = 1e-5
    serve_batch: int = 4
    prompt_len: int = 320          # mamba2 and jamba; qwen2-vl: vl_tokens
    serve_steps: int = 4          # cut for the smoke's time

    def layers(self, arch: str) -> int:
        return {self.mamba: self.mamba_layers, self.jamba: self.jamba_layers,
                self.vl: self.vl_layers}[arch]

    def serving(self, arch: str):
        """The ``_mesh_serve`` sizes of ``arch``'s served case."""
        import types
        return types.SimpleNamespace(
            serve_batch=self.serve_batch, serve_steps=self.serve_steps,
            prompt_len=self.vl_tokens if arch == self.vl
            else self.prompt_len)


def _fam_cfg(fz: FamilyMeshSizes, arch: str, dtype: str):
    """``arch`` at full width, cut in depth; qwen2-vl's frontend gives
    ``vl_patches`` embeddings (the shape cells' length counts them)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, n_layers=fz.layers(arch), dtype=dtype, param_dtype=dtype,
        frontend_len=fz.vl_patches if cfg.frontend else cfg.frontend_len)


def _fam_inputs(fz: FamilyMeshSizes, arch: str, vocab: int):
    """(the train batch, the served prompts and their next tokens, the
    served embeddings or None) of ``arch``, from seeds every rank uses:
    qwen2-vl's patch embeddings from the frontend's stub on a seeded CPU
    generator (f32 numpy)."""
    from repro_torch.models import frontend
    rng = np.random.default_rng(41)
    seq = fz.vl_tokens if arch == fz.vl else fz.mamba_seq
    batch = {k: rng.integers(0, vocab, (fz.train_batch, seq))
             .astype(np.int32) for k in ("tokens", "targets")}
    sv = fz.serving(arch)
    toks = rng.integers(0, vocab, (fz.serve_batch,
                                   sv.prompt_len + fz.serve_steps)
                        ).astype(np.int32)
    if arch != fz.vl:
        return batch, toks, None
    cfg = _fam_cfg(fz, arch, "float32")

    def patches(seed: int, b: int) -> np.ndarray:
        return frontend.stub_vision_embeddings(
            torch.Generator().manual_seed(seed), cfg, b,
            fz.vl_patches).float().numpy()
    batch["embeds"] = patches(1, fz.train_batch)
    return batch, toks, patches(2, fz.serve_batch)


# (arch field, dtype) of each served case; the trained archs, f32
FAMILY_SERVE = (("mamba", "float32"), ("mamba", "bfloat16"),
                ("vl", "bfloat16"), ("jamba", "bfloat16"))
FAMILY_TRAIN = ("mamba", "vl")
# served fields whose bf16 runs, meshless and on the mesh, replay the
# meshless f32 run's expert choices: bf16 alone flips some of jamba's
# routings (which moves the logits by far more than the mesh's
# arithmetic), so the check compares the arithmetic at one routing
FAMILY_REPLAY = ("jamba",)
# jamba's bf16 logits on the mesh against meshless, both at one routing:
# the meshless bf16 run's own distance from f32 at that routing (what
# bf16 rounding alone moves them by), as ``scripts/jamba_bf16_limit.py``
# read it on an H100 at 700 W: 5.973e-2, where the mesh read 2.433e-2
# and a gated norm over each rank's local heads (planted) 0.4626
REPLAYED_BF16_LIMIT = 6e-2
SPREAD_FLOOR = 1e-6    # a tenth of the gradient norms' 1e-5 limit


def families_reference(fz: FamilyMeshSizes, tmp: str) -> Dict[str, object]:
    """The meshless runs the ``mesh_families`` world is held to, on the
    card, from the seeds the ranks use: mamba2's and qwen2-vl's
    TrainLoops in f32 (losses, gradient norms, step ms; the final
    parameters saved to ``tmp``), and each served case teacher-forced:
    mamba2 and jamba through ``ModelServer``, qwen2-vl (whose prompts
    carry patch embeddings) through ``make_prefill_step`` and
    ``make_serve_step``. Each bf16 case also runs as its f32 twin, first:
    for a field of ``FAMILY_REPLAY`` the twin's expert choices are kept
    (and saved to ``tmp`` for the ranks) and the bf16 run replays them.
    jamba's f32 twin (about 53 GB at its period of 8) is the largest
    holding; each model is freed before the next and the last before the
    ranks start; the card's bytes in use with each held are kept."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import init_params
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.tree import tree_map
    from repro_torch.serving.server import ModelServer
    t0 = time.perf_counter()
    out: Dict[str, object] = {}
    opt = _mesh_opt(fz)
    for field in FAMILY_TRAIN:
        arch = getattr(fz, field)
        cfg = _fam_cfg(fz, arch, "float32")
        batch, _, _ = _fam_inputs(fz, arch, cfg.vocab_size)
        loop = TrainLoop(cfg, opt_cfg=opt, device="cuda", seed=3)
        times: List[float] = []
        ran = loop.run(iter([batch] * fz.train_steps), steps=fz.train_steps,
                       log_every=0, on_metrics=_step_timer(times))
        final = [t.cpu() for t in _leaves_of(loop.params)]
        torch.save(final, os.path.join(tmp, f"fam_{field}_params.pt"))
        del loop
        _freed()
        # the meshless loop's own spread: the same steps from parameters
        # moved by a seeded relative 1e-7, what rounding alone can do
        moved = TrainLoop(cfg, opt_cfg=opt, device="cuda", seed=3)
        g = torch.Generator(device="cuda").manual_seed(11)
        moved.params = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=g, device="cuda")), moved.params)
        ran2 = moved.run(iter([batch] * fz.train_steps),
                         steps=fz.train_steps, log_every=0)
        num = den = 0.0
        for a, b in zip(_leaves_of(moved.params), final):
            n_, d_ = _sq_diff(a, b, "cuda")
            num, den = num + n_, den + d_
        del moved, final
        _freed()
        h1, h2 = ran["history"], ran2["history"]
        out[field] = {"losses": [h["loss"] for h in h1],
                      "grad_norms": [h["grad_norm"] for h in h1],
                      "step_ms": times,
                      "spread": {
                          "loss_rel": [abs(a["loss"] - b["loss"])
                                       / abs(a["loss"]) for a, b in
                                       zip(h1, h2)],
                          "grad_norm_rel": [
                              abs(a["grad_norm"] - b["grad_norm"])
                              / abs(a["grad_norm"]) for a, b in zip(h1, h2)],
                          "param_rel_l2": (num / den) ** 0.5}}
    # each bf16 case's f32 twin, before it: how far bf16 itself moves the
    # logits, at the twin's expert choices where they are replayed
    twins = [(f, "float32") for f, dt in FAMILY_SERVE
             if dt != "float32" and (f, "float32") not in FAMILY_SERVE]
    for field, dtype in twins + list(FAMILY_SERVE):
        arch = getattr(fz, field)
        cfg = _fam_cfg(fz, arch, dtype)
        sv = fz.serving(arch)
        _, toks, embeds = _fam_inputs(fz, arch, cfg.vocab_size)
        key = f"{field}_{dtype}"
        params = init_params(torch.Generator(device="cuda").manual_seed(5),
                             cfg)
        torch.cuda.synchronize()
        out[f"{key}_card_used_bytes"] = card_used_bytes("cuda")
        F_ = 0 if embeds is None else embeds.shape[1]
        C = F_ + sv.prompt_len + fz.serve_steps
        if embeds is None:
            srv = ModelServer(cfg, params, batch=fz.serve_batch, cache_len=C)

            def prefill(t):
                srv.prefill(t)
                return srv.logits.float().cpu()

            def decode(t, _pos):
                srv.tokens = torch.as_tensor(t, device="cuda")
                srv.decode(1)
                return srv.logits.float().cpu()
        else:
            pf = steps.make_prefill_step(cfg, C)
            step = steps.make_serve_step(cfg)
            emb = torch.as_tensor(embeds, device="cuda")
            state = {}

            def prefill(t):
                logits, state["caches"] = pf(
                    params, torch.as_tensor(t, device="cuda"), emb)
                return logits.float().cpu()

            def decode(t, pos):
                logits, state["caches"] = step(
                    params, state["caches"],
                    torch.as_tensor(t, dtype=torch.int32, device="cuda"),
                    torch.full((fz.serve_batch,), F_ + pos,
                               dtype=torch.int32, device="cuda"))
                return logits.float().cpu()
        routes_at = os.path.join(tmp, f"fam_{field}_routes.pt")
        kept: List[torch.Tensor] = []
        if field not in FAMILY_REPLAY:
            undo = lambda: 0                            # noqa: E731
        elif dtype == "float32":
            undo = _routes_kept(kept)
        else:
            kept = torch.load(routes_at)
            undo = _routes_replayed(kept)
        try:
            out[key] = torch.stack(_teacher_forced(
                prefill, decode, toks, sv.prompt_len, fz.serve_steps))
        finally:
            used = undo()
        if field in FAMILY_REPLAY:
            if dtype == "float32":
                torch.save([r.cpu() for r in kept], routes_at)
            elif used != len(kept):
                raise AssertionError(f"{arch} {dtype}: {used} routings of "
                                     f"{len(kept)} replayed")
            out[f"{key}_routings"] = len(kept)
        del params, prefill, decode, kept
        if embeds is None:
            del srv
        else:
            del state
        _freed()
    torch.cuda.synchronize()
    out["card_used_bytes_after"] = card_used_bytes("cuda")
    out["seconds"] = time.perf_counter() - t0
    return out


def _meshless_point(cfg, skeleton, leaves: List[torch.Tensor], batch
                    ) -> Tuple[float, float]:
    """The meshless loss and global gradient norm (f64 sum of squares) at
    the parameters ``leaves`` (``skeleton``'s leaf order), on the card: a
    mesh step's gradient held at the point the mesh reached."""
    from repro_torch.models import lm
    from repro_torch.models.tree import tree_unflatten
    held = [t.to("cuda").requires_grad_() for t in leaves]
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    with torch.enable_grad():
        loss, _ = lm.loss_fn(tree_unflatten(skeleton, held), cfg, b)
        grads = torch.autograd.grad(loss, held)
    return float(loss.detach()), float(torch.sqrt(sum(
        (g.double() ** 2).sum() for g in grads)))


def families_rank(fz: FamilyMeshSizes, mesh, rank: int, tmp: str,
                  same_point: Tuple[str, ...]) -> Dict[str, object]:
    """One rank's ``mesh_families`` work: mamba2's and qwen2-vl's
    TrainLoops on the mesh (f32; the state bytes, allocated and
    requested of the allocator and each leaf's local piece, beside the
    specs' share; the parameters against the meshless loop's), then the
    prefill and decode bundles of each served case (jamba's shards drawn
    by one rank after the other, ``_placed_params``). For the trained
    fields in ``same_point`` rank 0 also computes the meshless loss and
    gradient norm at the parameters each later step starts from. A
    field of ``FAMILY_REPLAY`` replays the meshless f32 run's expert
    choices (``tmp``) on every rank. The attention launches are counted
    from 0 for each run alone."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     flash_attention_bwd)
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.tree import tree_map
    t0 = time.perf_counter()
    res: Dict[str, object] = {}
    for field in FAMILY_TRAIN:
        arch = getattr(fz, field)
        cfg = _fam_cfg(fz, arch, "float32")
        batch, _, _ = _fam_inputs(fz, arch, cfg.vocab_size)
        torch.cuda.synchronize()
        before, asked = torch.cuda.memory_allocated(), _requested()
        loop = TrainLoop(cfg, opt_cfg=_mesh_opt(fz), mesh=mesh, seed=3)
        torch.cuda.synchronize()
        r: Dict[str, object] = {
            "state_bytes_measured": torch.cuda.memory_allocated() - before,
            "state_bytes_requested": _requested() - asked}
        leaves = _leaves_of(loop.params) + _leaves_of(loop.opt_state)
        shares = (_spec_shares(loop.params, sharding.param_specs(
            loop.params, mesh), mesh) + _spec_shares(
                loop.opt_state, sharding.opt_specs(loop.opt_state, mesh),
                mesh))
        r["state_bytes_computed"] = sum(shares)
        held = [(t.to_local() if isinstance(t, DTensor) else t)
                for t in leaves]
        r["leaves_off"] = [
            (i, h.numel() * h.element_size(), w)
            for i, (h, w) in enumerate(zip(held, shares))
            if h.numel() * h.element_size() != w]
        r["unsharded_bytes"] = sum(t.numel() * t.element_size()
                                   for t in leaves)
        del leaves, held
        times: List[float] = []
        history: List[dict] = []
        points: List[List[torch.Tensor]] = []   # rank 0, on the host
        flash_attention.launches = decode_attention.launches = 0
        flash_attention_bwd.launches = 0
        for i in range(fz.train_steps):
            if i and field in same_point:
                # the parameters this step starts from: every rank gathers
                # each leaf, rank 0 keeps it on the host
                point = []
                for t in _leaves_of(loop.params):
                    full = t.full_tensor()
                    if rank == 0:
                        point.append(full.cpu())
                    del full
                if rank == 0:
                    points.append(point)
            history += loop.run(iter([batch]), steps=i + 1, log_every=0,
                                on_metrics=_step_timer(times))["history"]
            _freed()
        r["flash"] = flash_attention.launches
        r["flash_bwd"] = flash_attention_bwd.launches
        r["losses"] = [h["loss"] for h in history]
        r["grad_norms"] = [h["grad_norm"] for h in history]
        r["step_ms"] = times
        ref = (torch.load(os.path.join(tmp, f"fam_{field}_params.pt"))
               if rank == 0 else None)
        _freed()
        num = den = 0.0
        for i, t in enumerate(_leaves_of(loop.params)):
            full = t.full_tensor()                  # every rank
            if rank == 0:                           # compared on the card
                n_, d_ = _sq_diff(full, ref[i], "cuda")
                num, den = num + n_, den + d_
            del full
        r["param_rel_l2"] = (num / den) ** 0.5 if rank == 0 else None
        skeleton = tree_map(lambda _: 0, loop.params)
        del loop, ref
        _freed()
        if rank == 0 and field in same_point:
            r["same_point"] = [_meshless_point(cfg, skeleton, pt, batch)
                               for pt in points]
        del points
        _freed()
        res[f"{field}_train"] = r
    for field, dtype in FAMILY_SERVE:
        arch = getattr(fz, field)
        cfg = _fam_cfg(fz, arch, dtype)
        _, toks, embeds = _fam_inputs(fz, arch, cfg.vocab_size)
        key = f"{field}_{dtype}"
        routes: List[torch.Tensor] = []
        undo = lambda: 0                                # noqa: E731
        if field in FAMILY_REPLAY:
            routes = torch.load(os.path.join(tmp, f"fam_{field}_routes.pt"))
            undo = _routes_replayed(routes)
        try:
            res[key] = _mesh_serve(fz.serving(arch), cfg, mesh, toks, rank,
                                   gen_device="cuda", embeds=embeds,
                                   staged=field == "jamba")
        finally:
            used = undo()
        if used != len(routes):
            raise AssertionError(f"{arch} {dtype} rank {rank}: {used} "
                                 f"routings of {len(routes)} replayed")
        del routes
        _freed()
    res["seconds"] = time.perf_counter() - t0
    return res


def _n_attention(cfg) -> int:
    from repro_torch.models.blocks import normalize_pattern
    pattern = normalize_pattern(cfg)
    return sum(t[0] == "a" for t in pattern) * (cfg.n_layers // len(pattern))


def mesh_families_check(fz: FamilyMeshSizes, ref: Dict[str, object],
                        ranks: List[Dict[str, object]]) -> Dict[str, object]:
    """Holds the ``mesh_families`` world to the meshless runs, with the
    ``mesh`` phase's limits: mamba2's and qwen2-vl's training (losses
    within 1e-5 relative of the meshless loop's, parameters within 1e-4
    relative L2, gradient norms within 1e-5 of the meshless loop's; where
    that loop's own spread from a 1e-7 start moves a later norm by more
    than ``SPREAD_FLOOR`` (a trajectory that amplifies rounding), each
    later step's loss and norm within 1e-5 of the meshless ones at the
    parameters the mesh reached instead; the same losses on every rank; each leaf's local piece exactly
    its spec's share, the state's bytes asked of the allocator within
    ``STATE_SLACK`` of the specs' share), each served case's
    teacher-forced logits (f32: within 1e-4 relative L2, every greedy
    token equal; bf16: within 2e-2, a greedy token differing only at a
    near-tie; jamba, at the meshless f32 run's expert choices on both
    sides, within ``REPLAYED_BF16_LIMIT``) and its
    parameters' bytes asked of the allocator within
    ``STATE_SLACK`` of the specs' share, the attention launches of every
    rank (its attention layers times the calls, twice in training under
    ``remat='dots'``) and the caches' placements."""
    r0 = ranks[0]["families"]
    out: Dict[str, object] = {"train": {}, "serve": {}}
    for field in FAMILY_TRAIN:
        arch = getattr(fz, field)
        cfg = _fam_cfg(fz, arch, "float32")
        want, got = ref[field], r0[f"{field}_train"]
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], want["losses"]))
        # the first step's gradient norm against the meshless loop's (the
        # same parameters); each later one, where the meshless loop's own
        # spread says its trajectory amplifies rounding, against the
        # meshless gradient at the parameters the mesh reached
        points = got.get("same_point")
        at = list(zip(got["grad_norms"], want["grad_norms"]))
        if points is not None:
            at = at[:1] + [(g, p[1]) for g, p in zip(got["grad_norms"][1:],
                                                     points)]
        gnorm_rel = max(abs(a - b) / abs(b) for a, b in at)
        point_loss_rel = max([abs(a - p[0]) / abs(p[0]) for a, p in
                              zip(got["losses"][1:], points or [])],
                             default=0.0)
        flash = (_n_attention(cfg) * fz.train_steps
                 * (1 if cfg.remat == "none" else 2))
        for rk in ranks:
            m = rk["families"][f"{field}_train"]
            if (m["losses"], m["grad_norms"]) != (got["losses"],
                                                   got["grad_norms"]):
                raise AssertionError(f"mesh_families {arch}: ranks disagree "
                                     f"on the losses or gradient norms")
            asked = m["state_bytes_requested"]
            share = m["state_bytes_computed"]
            if m["leaves_off"] or abs(asked - share) > STATE_SLACK:
                raise AssertionError(
                    f"mesh_families {arch} rank {rk['rank']}: {asked} bytes "
                    f"of state requested, the specs give {share}; leaves "
                    f"(index, held, share) off: {m['leaves_off']}")
            if (m["flash"] != flash
                    or m["flash_bwd"] != _n_attention(cfg) * fz.train_steps):
                raise AssertionError(f"mesh_families {arch} rank "
                                     f"{rk['rank']}: {m['flash']} flash and "
                                     f"{m['flash_bwd']} backward launches "
                                     f"in training, not {flash} and one a "
                                     f"layer a step")
        if (loss_rel > 1e-5 or gnorm_rel > 1e-5 or point_loss_rel > 1e-5
                or got["param_rel_l2"] > 1e-4):
            raise AssertionError(
                f"mesh_families {arch} training vs meshless: losses "
                f"{got['losses']} vs {want['losses']}, gradient norms "
                f"{got['grad_norms']} vs {want['grad_norms']} (at the "
                f"mesh's parameters {points}), parameters "
                f"{got['param_rel_l2']}; the meshless loop's own spread "
                f"{want['spread']}")
        out["train"][arch] = {
            "losses_mesh": got["losses"], "losses_meshless": want["losses"],
            "loss_rel": loss_rel, "grad_norms_mesh": got["grad_norms"],
            "grad_norms_meshless": want["grad_norms"],
            "same_point_meshless": points,
            "grad_norm_rel": gnorm_rel, "same_point_loss_rel": point_loss_rel,
            "meshless_spread": want["spread"],
            "param_rel_l2": got["param_rel_l2"],
            "step_ms": got["step_ms"], "step_ms_meshless": want["step_ms"],
            "unsharded_state_bytes": got["unsharded_bytes"],
            "state_bytes_by_rank": [
                (rk["families"][f"{field}_train"]["state_bytes_measured"],
                 rk["families"][f"{field}_train"]["state_bytes_requested"],
                 rk["families"][f"{field}_train"]["state_bytes_computed"])
                for rk in ranks],
            "flash_by_rank": [rk["families"][f"{field}_train"]["flash"]
                              for rk in ranks],
            "flash_bwd_by_rank": [
                rk["families"][f"{field}_train"]["flash_bwd"]
                for rk in ranks]}
    for field, dtype in FAMILY_SERVE:
        arch = getattr(fz, field)
        key = f"{field}_{dtype}"
        v = _mesh_logits(r0[key]["logits"], ref[key])
        limit = REPLAYED_BF16_LIMIT if field in FAMILY_REPLAY else 2e-2
        if dtype != "float32":
            # the meshless bf16 run against its f32 twin (at the twin's
            # expert choices where replayed): bf16's own move
            v["meshless_bf16_vs_f32"] = _mesh_logits(
                ref[key], ref[f"{field}_float32"])["rel_l2"]
            v["limit"] = limit
        if field in FAMILY_REPLAY:
            v["routings_replayed"] = ref[f"{key}_routings"]
        if ((v["rel_l2"] > 1e-4 or v["mismatches"]) if dtype == "float32"
                else (v["rel_l2"] > limit or v["mismatches_not_near_ties"])):
            raise AssertionError(f"mesh_families serving {arch} {dtype} vs "
                                 f"meshless: {v}")
        n_att = _n_attention(_fam_cfg(fz, arch, dtype))
        for rk in ranks:
            sv = rk["families"][key]
            asked, share = (sv["param_bytes_requested"],
                            sv["param_bytes_computed"])
            if (sv["flash"] != n_att or sv["decode"] != n_att * fz.serve_steps
                    or not sv["cache_placed"]
                    or abs(asked - share) > STATE_SLACK):
                seen = {k: x for k, x in sv.items()
                        if k not in ("logits", "routes")}
                raise AssertionError(
                    f"mesh_families {arch} {dtype} rank {rk['rank']}: "
                    f"launches, cache placements or parameter bytes "
                    f"({asked} requested, the specs give {share}): {seen}")
        out["serve"][key] = dict(v, **{
            "by_rank": [{k: rk["families"][key][k] for k in (
                "flash", "decode", "serve_s", "param_bytes_requested",
                "param_bytes_computed", "card_used_bytes_placed",
                "card_used_bytes_served")} for rk in ranks]})
    out["launches"] = {
        "flash_attention": sum(
            rk["families"][f"{f}_train"]["flash"] for rk in ranks
            for f in FAMILY_TRAIN) + sum(
            rk["families"][f"{f}_{dt}"]["flash"] for rk in ranks
            for f, dt in FAMILY_SERVE),
        "flash_attention_bwd": sum(
            rk["families"][f"{f}_train"]["flash_bwd"] for rk in ranks
            for f in FAMILY_TRAIN),
        "decode_attention": sum(rk["families"][f"{f}_{dt}"]["decode"]
                                for rk in ranks for f, dt in FAMILY_SERVE)}
    out["reference_card_used_bytes"] = {
        k[:-len("_card_used_bytes")]: x for k, x in ref.items()
        if k.endswith("_card_used_bytes")}
    return out


@dataclasses.dataclass(frozen=True)
class EncDecMeshSizes:
    """The ``mesh_encdec`` phase on the mesh phase's world:
    seamless-m4t-medium at full width, its depth cut, trains and serves.
    Budget: about 100 s, its meshless reference included."""
    arch: str = ENCDEC
    layers: int = 2                # encoder and decoder each, of 12 + 12
    train_batch: int = 4
    train_seq: int = 128           # tokens a row
    train_frames: int = 256        # frames a row
    train_steps: int = 2           # cut for the smoke's time
    # the cross-attention's K bias has a gradient that is zero in exact
    # arithmetic: AdamW moves each of its 2,048 elements by up to lr,
    # whichever way its rounding points, so at 1e-3 the bias alone could
    # move the parameters 1.8e-4 relative L2 apart on two correct runs
    lr: float = 1e-5
    serve_batch: int = 4
    prompt_len: int = 64
    enc_len: int = 1024            # frames a prompt
    serve_steps: int = 4          # cut for the smoke's time


def _encdec_mesh_cfg(ez: EncDecMeshSizes, dtype: str):
    return _encdec_config(ez.layers, dtype)


def _encdec_mesh_inputs(ez: EncDecMeshSizes, vocab: int):
    """(the train batch, the served prompts and their next tokens, the
    served frames), from seeds every rank uses; the frames are the stub
    frontend's on a seeded CPU generator (f32 numpy)."""
    from repro_torch.models.frontend import stub_audio_frames
    cfg = _encdec_mesh_cfg(ez, "float32")
    rng = np.random.default_rng(43)
    batch = {k: rng.integers(0, vocab, (ez.train_batch, ez.train_seq))
             .astype(np.int32) for k in ("tokens", "targets")}
    batch["enc_embeds"] = stub_audio_frames(
        torch.Generator().manual_seed(1), cfg, ez.train_batch,
        ez.train_frames).float().numpy()
    toks = rng.integers(0, vocab, (ez.serve_batch,
                                   ez.prompt_len + ez.serve_steps)
                        ).astype(np.int32)
    frames = stub_audio_frames(torch.Generator().manual_seed(2), cfg,
                               ez.serve_batch, ez.enc_len).float().numpy()
    return batch, toks, frames


def encdec_mesh_reference(ez: EncDecMeshSizes, tmp: str
                          ) -> Dict[str, object]:
    """The meshless runs the ``mesh_encdec`` world is held to, on the
    card, from the seeds the ranks use: the TrainLoop in f32 (losses,
    gradient norms, step ms; the final parameters saved to ``tmp``), and
    ModelServer teacher-forced in f32 and bf16 (the parameters drawn on
    the card from seed 5, each prompt's frames admitted with it)."""
    from repro_torch.launch.steps import init_params
    from repro_torch.launch.train import TrainLoop
    from repro_torch.serving.server import ModelServer
    t0 = time.perf_counter()
    cfg = _encdec_mesh_cfg(ez, "float32")
    batch, _, _ = _encdec_mesh_inputs(ez, cfg.vocab_size)
    loop = TrainLoop(cfg, opt_cfg=_mesh_opt(ez), device="cuda", seed=3)
    times: List[float] = []
    ran = loop.run(iter([batch] * ez.train_steps), steps=ez.train_steps,
                   log_every=0, on_metrics=_step_timer(times))
    torch.save([t.cpu() for t in _leaves_of(loop.params)],
               os.path.join(tmp, "encdec_ref_params.pt"))
    del loop
    _freed()
    out: Dict[str, object] = {
        "losses": [h["loss"] for h in ran["history"]],
        "grad_norms": [h["grad_norm"] for h in ran["history"]],
        "step_ms": times}
    for dtype in MESH_SERVE:
        scfg = _encdec_mesh_cfg(ez, dtype)
        _, toks, frames = _encdec_mesh_inputs(ez, scfg.vocab_size)
        params = init_params(torch.Generator(device="cuda").manual_seed(5),
                             scfg)
        srv = ModelServer(scfg, params, batch=ez.serve_batch,
                          cache_len=ez.prompt_len + ez.serve_steps,
                          enc_len=ez.enc_len)

        def prefill(t):
            srv.prefill(t, frames)
            return srv.logits.float().cpu()

        def decode(t, _pos):
            srv.tokens = torch.as_tensor(t, device="cuda")
            srv.decode(1)
            return srv.logits.float().cpu()

        out[dtype] = torch.stack(_teacher_forced(
            prefill, decode, toks, ez.prompt_len, ez.serve_steps))
        del srv, params, prefill, decode
        _freed()
    out["seconds"] = time.perf_counter() - t0
    return out


def _encdec_mesh_serve(ez: EncDecMeshSizes, cfg, mesh, toks, frames,
                       rank: int) -> Dict[str, object]:
    """The prefill and decode bundles on the mesh, teacher-forced, with
    the encoder output a server keeps obtained from
    ``make_prefill_step(with_enc_out=True)`` on the placed arguments and
    placed by the decode bundle's ``enc_out`` spec: launches (that step's
    prefill included), the caches' placements, the serving seconds, the
    parameters' requested bytes beside the specs' share; rank 0 also
    keeps the logits."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch import steps
    B, P = ez.serve_batch, ez.prompt_len
    C = P + ez.serve_steps
    pb = steps.build_step_bundle(cfg, ShapeSpec("prompt", P, B, "prefill"),
                                 mesh, cache_len=C)
    db = steps.build_step_bundle(cfg, ShapeSpec("serve", C, B, "decode"),
                                 mesh)
    with_enc = steps.make_prefill_step(cfg, C, with_enc_out=True)
    torch.cuda.synchronize()
    asked = _requested()
    params = _placed_params(cfg, lambda t: pb.place(t)[0], "cuda", False)
    torch.cuda.synchronize()
    out = {"param_bytes_requested": _requested() - asked,
           "param_bytes_computed": _spec_share_bytes(params, pb.in_specs[0],
                                                     mesh)}
    emb = sharding.distribute(torch.as_tensor(frames, device="cuda"), mesh,
                              pb.in_specs[1])
    state = {}
    flash_attention.launches = decode_attention.launches = 0

    def prefill(t):
        tok = sharding.distribute(torch.as_tensor(t, device="cuda"), mesh,
                                  pb.in_specs[2])
        logits, state["caches"] = pb.fn(params, emb, tok)
        again, _, enc_out = with_enc(params, emb, tok)
        state["same_prefill"] = bool(torch.equal(again.full_tensor(),
                                                 logits.full_tensor()))
        state["enc"] = sharding.distribute(enc_out, mesh, db.in_specs[4])
        state["placed"] = [_placed_as(state["caches"], db.in_specs[1],
                                      mesh)]
        return logits.full_tensor().float().cpu()

    def decode(t, pos):
        tok, p_ = (sharding.distribute(
            torch.as_tensor(x, dtype=torch.int32, device="cuda"), mesh, spec)
            for x, spec in ((t, db.in_specs[2]),
                            (np.full(B, pos), db.in_specs[3])))
        logits, state["caches"] = db.fn(params, state["caches"], tok, p_,
                                        state["enc"])
        state["placed"].append(_placed_as(state["caches"], db.out_specs[1],
                                          mesh))
        return logits.full_tensor().float().cpu()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = _teacher_forced(prefill, decode, toks, P, ez.serve_steps)
    torch.cuda.synchronize()
    out.update({"serve_s": time.perf_counter() - t0,
                "flash": flash_attention.launches,
                "decode": decode_attention.launches,
                "same_prefill": state["same_prefill"],
                "enc_out_placements": [str(p) for p in
                                       state["enc"].placements],
                "cache_placed": all(state["placed"])})
    if rank == 0:
        out["logits"] = torch.stack(logits)
    return out


def _placed_as(tree, specs, mesh) -> bool:
    """Whether every leaf of ``tree`` is in the placements of its spec."""
    from repro_torch.distributed import sharding
    return all(tuple(t.placements) == sharding.placements(mesh, sp)
               for t, sp in zip(_leaves_of(tree), sharding.spec_leaves(specs)))


def encdec_rank(ez: EncDecMeshSizes, mesh, rank: int, tmp: str
                ) -> Dict[str, object]:
    """One rank's ``mesh_encdec`` work: the TrainLoop on the mesh (f32;
    the state bytes, requested of the allocator and each leaf's local
    piece, beside the specs' share; the parameters against the meshless
    loop's), then the prefill and decode bundles in f32 and bf16
    (``_encdec_mesh_serve``). The attention launches are counted from 0
    for each run alone."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.launch.train import TrainLoop
    t0 = time.perf_counter()
    res: Dict[str, object] = {}
    cfg = _encdec_mesh_cfg(ez, "float32")
    batch, _, _ = _encdec_mesh_inputs(ez, cfg.vocab_size)
    torch.cuda.synchronize()
    asked = _requested()
    loop = TrainLoop(cfg, opt_cfg=_mesh_opt(ez), mesh=mesh, seed=3)
    torch.cuda.synchronize()
    res["state_bytes_requested"] = _requested() - asked
    leaves = _leaves_of(loop.params) + _leaves_of(loop.opt_state)
    shares = (_spec_shares(loop.params, sharding.param_specs(
        loop.params, mesh), mesh) + _spec_shares(
            loop.opt_state, sharding.opt_specs(loop.opt_state, mesh), mesh))
    res["state_bytes_computed"] = sum(shares)
    held = [(t.to_local() if isinstance(t, DTensor) else t) for t in leaves]
    res["leaves_off"] = [(i, h.numel() * h.element_size(), w)
                         for i, (h, w) in enumerate(zip(held, shares))
                         if h.numel() * h.element_size() != w]
    res["unsharded_bytes"] = sum(t.numel() * t.element_size()
                                 for t in leaves)
    del leaves, held
    times: List[float] = []
    flash_attention.launches = flash_attention_bwd.launches = 0
    ran = loop.run(iter([batch] * ez.train_steps), steps=ez.train_steps,
                   log_every=0, on_metrics=_step_timer(times))
    res["train_flash"] = flash_attention.launches
    res["train_flash_bwd"] = flash_attention_bwd.launches
    res["losses"] = [h["loss"] for h in ran["history"]]
    res["grad_norms"] = [h["grad_norm"] for h in ran["history"]]
    res["step_ms"] = times
    ref = (torch.load(os.path.join(tmp, "encdec_ref_params.pt"))
           if rank == 0 else None)
    num = den = 0.0
    for i, t in enumerate(_leaves_of(loop.params)):
        full = t.full_tensor()                      # every rank
        if rank == 0:                               # compared on the card
            n_, d_ = _sq_diff(full, ref[i], "cuda")
            num, den = num + n_, den + d_
        del full
    res["param_rel_l2"] = (num / den) ** 0.5 if rank == 0 else None
    del loop, ref
    _freed()
    for dtype in MESH_SERVE:
        scfg = _encdec_mesh_cfg(ez, dtype)
        _, toks, frames = _encdec_mesh_inputs(ez, scfg.vocab_size)
        res[dtype] = _encdec_mesh_serve(ez, scfg, mesh, toks, frames, rank)
        _freed()
    res["seconds"] = time.perf_counter() - t0
    return res


def mesh_encdec_check(ez: EncDecMeshSizes, ref: Dict[str, object],
                      ranks: List[Dict[str, object]]) -> Dict[str, object]:
    """Holds the ``mesh_encdec`` world to the meshless runs: training
    (losses and gradient norms within 1e-5 relative of the meshless
    loop's, parameters within 1e-4 relative L2, the same losses on every
    rank; each leaf's local piece exactly its spec's share and the state's
    requested bytes within ``STATE_SLACK`` of the specs' share), serving
    (teacher-forced logits against ModelServer's: f32 within 1e-4
    relative L2 and every greedy token equal, bf16 within 2e-2 and a
    greedy token differing only at a near-tie; the bundle's prefill logits
    bit for bit those of ``make_prefill_step(with_enc_out=True)``; the
    parameters' requested bytes within ``STATE_SLACK`` of their share),
    the launches of every rank (flash: the encoder's layers, the decoder's
    self and cross calls, per train step and per prefill, twice a
    prefill for the step that also returns the encoder output; decode:
    the decoder's self and cross calls a step) and the caches'
    placements."""
    r0 = ranks[0]["encdec"]
    cfg = _encdec_mesh_cfg(ez, "float32")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(r0["losses"], ref["losses"]))
    gnorm_rel = max(abs(a - b) / abs(b)
                    for a, b in zip(r0["grad_norms"], ref["grad_norms"]))
    serve = {dt: _mesh_logits(r0[dt]["logits"], ref[dt])
             for dt in MESH_SERVE}
    per_pass = cfg.encoder_layers + 2 * cfg.n_layers
    for r in ranks:
        m = r["encdec"]
        if (m["losses"], m["grad_norms"]) != (r0["losses"],
                                               r0["grad_norms"]):
            raise AssertionError(f"mesh_encdec: ranks disagree on the "
                                 f"losses or gradient norms: {m['losses']} "
                                 f"vs {r0['losses']}")
        asked, share = m["state_bytes_requested"], m["state_bytes_computed"]
        if m["leaves_off"] or abs(asked - share) > STATE_SLACK:
            raise AssertionError(
                f"mesh_encdec rank {r['rank']}: {asked} bytes of state "
                f"requested, the specs give {share}; leaves (index, held, "
                f"share) off: {m['leaves_off']}")
        bad = (m["train_flash"] != per_pass * ez.train_steps
               or m["train_flash_bwd"] != per_pass * ez.train_steps)
        for dt in MESH_SERVE:
            sv = m[dt]
            bad |= (sv["flash"] != 2 * per_pass
                    or sv["decode"] != 2 * cfg.n_layers * ez.serve_steps
                    or not sv["cache_placed"] or not sv["same_prefill"]
                    or abs(sv["param_bytes_requested"]
                           - sv["param_bytes_computed"]) > STATE_SLACK)
        if bad:
            seen = {k: ({x: y for x, y in v.items() if x != "logits"}
                        if isinstance(v, dict) else v)
                    for k, v in m.items()}
            raise AssertionError(f"mesh_encdec rank {r['rank']}: launches, "
                                 f"cache placements, the prefill or "
                                 f"parameter bytes: {seen}")
    if loss_rel > 1e-5 or gnorm_rel > 1e-5 or r0["param_rel_l2"] > 1e-4:
        raise AssertionError(f"mesh_encdec training vs meshless: losses "
                             f"{r0['losses']} vs {ref['losses']}, gradient "
                             f"norms {r0['grad_norms']} vs "
                             f"{ref['grad_norms']}, parameters "
                             f"{r0['param_rel_l2']}")
    f32, bf16 = serve["float32"], serve["bfloat16"]
    if (f32["rel_l2"] > 1e-4 or f32["mismatches"]
            or bf16["rel_l2"] > 2e-2 or bf16["mismatches_not_near_ties"]):
        raise AssertionError(f"mesh_encdec serving vs ModelServer: {serve}")
    return {
        "arch": ez.arch, "layers": [cfg.encoder_layers, cfg.n_layers],
        "losses_mesh": r0["losses"], "losses_meshless": ref["losses"],
        "loss_rel": loss_rel, "grad_norms_mesh": r0["grad_norms"],
        "grad_norms_meshless": ref["grad_norms"], "grad_norm_rel": gnorm_rel,
        "param_rel_l2": r0["param_rel_l2"], "step_ms": r0["step_ms"],
        "step_ms_meshless": ref["step_ms"],
        "unsharded_state_bytes": r0["unsharded_bytes"], "serve": serve,
        "enc_out_placements": r0["float32"]["enc_out_placements"],
        "ranks": [{"coords": r["coords"],
                   "state_bytes_requested":
                       r["encdec"]["state_bytes_requested"],
                   "state_bytes_computed": r["encdec"]["state_bytes_computed"],
                   "train_flash": r["encdec"]["train_flash"],
                   "train_flash_bwd": r["encdec"]["train_flash_bwd"],
                   **{f"{dt}_{k}": r["encdec"][dt][k] for dt in MESH_SERVE
                      for k in ("flash", "decode", "serve_s",
                                "param_bytes_requested")},
                   "seconds": r["encdec"]["seconds"]} for r in ranks],
        "launches": {
            "flash_attention": sum(
                r["encdec"]["train_flash"] + sum(r["encdec"][dt]["flash"]
                                                 for dt in MESH_SERVE)
                for r in ranks),
            "flash_attention_bwd": sum(r["encdec"]["train_flash_bwd"]
                                       for r in ranks),
            "decode_attention": sum(r["encdec"][dt]["decode"]
                                    for r in ranks for dt in MESH_SERVE)}}


def mesh_phase(device, ms: MeshSizes = MeshSizes(),
               mz: MoeMeshSizes = MoeMeshSizes(),
               fz: FamilyMeshSizes = FamilyMeshSizes(),
               ez: EncDecMeshSizes = EncDecMeshSizes()
               ) -> Tuple[Dict[str, object], Dict[str, object],
                          Dict[str, object], Dict[str, object]]:
    """The sharded path on the card: ``data`` x ``model`` processes share
    it (gloo; DTensor's collectives through
    ``repro_torch.distributed.gloo_cuda``), qwen2-1.5b at full width, cut
    to ``layers`` layers. Per rank: ``TrainLoop(mesh=)`` against the
    meshless loop on the card (f32, losses and gradient norms within
    1e-5 relative, the parameters within 1e-4 relative L2), the
    parameter and optimizer
    bytes ``memory_allocated`` measures beside the specs' share (within
    1 % + 1 MiB), the prefill and decode bundles against ModelServer,
    teacher-forced (f32: logits within 1e-4 relative L2 and every greedy
    token equal; bf16: relative L2 within 2e-2, a greedy token differing
    only at a near-tie, ``_mesh_logits``), the attention kernels'
    launches on local heads, the caches in their specs' placements; then
    a reduced
    checkpoint saved on the world restores onto the meshless loop bit for
    bit. Budget: about 150 s. The same ranks then run the ``mesh_moe``
    phase (``moe_rank``, held by ``mesh_moe_check``; budget 240 s, its
    meshless reference included), returned second, and the
    ``mesh_families`` phase (``families_rank``, held by
    ``mesh_families_check``; budget 300 s, its meshless reference
    included), returned third. The ``mesh_encdec`` phase
    (``encdec_rank``, held by ``mesh_encdec_check``; budget 100 s, its
    meshless reference included), returned fourth, runs on a second
    world of as many processes beside the first. The ranks of both start
    first and wait while the references run, one after the other, each
    freed before the next: jamba's, the largest (about 26.5 GB), before
    seamless's; then the ranks hold their shards, jamba's drawn by one
    rank at a time."""
    import pickle
    import shutil
    import tempfile
    from repro_torch.configs.base import reduced
    from repro_torch.kernels import _build
    from repro_torch.launch.train import TrainLoop
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke-mesh-")
    n = ms.shape[0] * ms.shape[1]
    ready = os.path.join(tmp, "ready.json")
    procs = []
    try:
        # the ranks start first and wait for ``ready`` (written once the
        # references are), so their start overlaps the references; the
        # encoder-decoder's ranks are a second world beside the first
        sizes = dataclasses.asdict(ms)
        for world in ("rank", "enc"):
            for r in range(n):
                arg = json.dumps({
                    "rank": r, "world": n, "sizes": sizes,
                    "encdec_world": world == "enc",
                    "store": os.path.join(tmp, f"{world}_store"),
                    "ready": ready,
                    "ref": os.path.join(tmp, "ref_params.pt"),
                    "ckpt": os.path.join(tmp, "ckpt"),
                    "out": os.path.join(tmp, f"{world}{r}.pkl"),
                    "moe": dataclasses.asdict(mz),
                    "moe_ref": os.path.join(tmp, "moe_ref_params.pt"),
                    "families": dataclasses.asdict(fz),
                    "encdec": dataclasses.asdict(ez), "tmp": tmp})
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--mesh-rank", arg], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        ref = mesh_reference(ms, tmp)
        moe_ref = moe_reference(mz, tmp)
        fam_ref = families_reference(fz, tmp)
        _freed()
        enc_ref = encdec_mesh_reference(ez, tmp)
        # the trained fields whose meshless loop moved a later gradient
        # norm by more than a tenth of the limit from a 1e-7 start
        same_point = [f for f in FAMILY_TRAIN if max(
            fam_ref[f]["spread"]["grad_norm_rel"][1:]) > SPREAD_FLOOR]
        _freed()
        _build.library()               # built here; the ranks load it
        log(f"mesh phases: the card's bytes in use {card_used_bytes(device)}"
            f" before the ranks run")
        Path(ready + ".tmp").write_text(json.dumps(
            {"same_point": same_point}))
        os.replace(ready + ".tmp", ready)
        t_world = time.perf_counter()
        with CardPeak(device) as world_peak:
            # every rank's end before judging: the first rank to fail is
            # not always the lowest (the others then lose a peer)
            failed = []
            for i, p in enumerate(procs):
                out, _ = p.communicate(timeout=ms.join_s)
                if p.returncode != 0:
                    failed.append(f"mesh rank {i % n} of world {i // n} "
                                  f"failed (exit {p.returncode}):\n"
                                  f"{out[-3000:]}")
            if failed:
                raise AssertionError("\n".join(failed))
        ranks = [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes())
                 for r in range(n)]
        for r, rk in enumerate(ranks):
            rk["encdec"] = pickle.loads(
                Path(tmp, f"enc{r}.pkl").read_bytes())["encdec"]
        world_s = (time.perf_counter() - t_world
                   - max(r["moe"]["seconds"] for r in ranks)
                   - max(r["families"]["seconds"] for r in ranks))
        rcfg = reduced(_mesh_cfg(ms, "float32"))
        meshless = TrainLoop(rcfg, opt_cfg=_mesh_opt(ms), device="cuda",
                             ckpt_dir=os.path.join(tmp, "ckpt"))
        if not meshless.restore() or meshless.step != ms.ckpt_steps:
            raise AssertionError("the world's checkpoint did not restore")
        restored = [t.cpu() for t in _leaves_of(meshless.params)]
        del meshless
    finally:
        for p in procs:                # a failure before the join
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                       ref["losses"]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["grad_norms"],
                                                        ref["grad_norms"]))
    serve = {dt: _mesh_logits(r0[dt]["logits"], ref[dt]) for dt in MESH_SERVE}
    ckpt_equal = all(torch.equal(a, b) for a, b in
                     zip(r0["ckpt_params"], restored))
    per_rank = [{"coords": r["coords"],
                 "state_bytes_measured": r["state_bytes_measured"],
                 "state_bytes_computed": r["state_bytes_computed"],
                 "state_bytes_requested": r["state_bytes_requested"],
                 "batch_share": r["batch_share"],
                 "first_step": r["first_step"],
                 "train_flash": r["train_flash"],
                 "train_flash_bwd": r["train_flash_bwd"],
                 "step_ms": r["step_ms"],
                 "counted_step_ms": r["counted_step_ms"],
                 **{f"{dt}_{k}": r[dt][k] for dt in MESH_SERVE
                    for k in ("flash", "decode", "serve_s")}}
                for r in ranks]
    out = {"world": list(ms.shape), "processes": n, "backend": "gloo",
           "arch": ms.arch, "layers": ms.layers,
           "losses_mesh": r0["losses"], "losses_meshless": ref["losses"],
           "loss_rel": loss_rel, "param_rel_l2": r0["param_rel_l2"],
           "grad_norms_mesh": r0["grad_norms"],
           "grad_norms_meshless": ref["grad_norms"],
           "grad_norm_rel": gnorm_rel,
           "step_ms_meshless": ref["step_ms"],
           "unsharded_state_bytes": r0["unsharded_bytes"],
           "serve": serve, "ckpt_bit_for_bit": ckpt_equal,
           "ranks": per_rank, "world_s": world_s}
    for r in ranks:
        if (r["losses"], r["grad_norms"]) != (r0["losses"],
                                               r0["grad_norms"]):
            raise AssertionError(f"mesh: ranks disagree on the losses or "
                                 f"gradient norms: {r['losses']} "
                                 f"{r['grad_norms']} vs {r0['losses']} "
                                 f"{r0['grad_norms']}")
        m_, c_ = r["state_bytes_measured"], r["state_bytes_computed"]
        if abs(m_ - c_) > 0.01 * c_ + (1 << 20):
            raise AssertionError(f"mesh rank {r['rank']}: {m_} bytes of "
                                 f"state measured, the specs give {c_}")
        want_flash = 2 * ms.layers * ms.train_steps    # forward + remat
        if (r["train_flash"] != want_flash
                or r["train_flash_bwd"] != ms.layers * ms.train_steps) or any(
                r[dt]["flash"] != ms.layers
                or r[dt]["decode"] != ms.layers * ms.serve_steps
                or not r[dt]["cache_placed"] for dt in MESH_SERVE):
            raise AssertionError(f"mesh rank {r['rank']}: launches or "
                                 f"cache placements: {per_rank}")
    if loss_rel > 1e-5 or gnorm_rel > 1e-5 or r0["param_rel_l2"] > 1e-4:
        raise AssertionError(f"mesh training vs meshless: losses "
                             f"{r0['losses']} vs {ref['losses']}, "
                             f"gradient norms {r0['grad_norms']} vs "
                             f"{ref['grad_norms']}, "
                             f"parameters {r0['param_rel_l2']}")
    f32, bf16 = serve["float32"], serve["bfloat16"]
    if (f32["rel_l2"] > 1e-4 or f32["mismatches"]
            or bf16["rel_l2"] > 2e-2 or bf16["mismatches_not_near_ties"]):
        raise AssertionError(f"mesh serving vs ModelServer: {serve}")
    if not ckpt_equal:
        raise AssertionError("mesh checkpoint: the meshless restore is not "
                             "bit for bit the world's parameters")
    out["launches"] = {
        "flash_attention": sum(r["train_flash"] + sum(
            r[dt]["flash"] for dt in MESH_SERVE) for r in ranks),
        "flash_attention_bwd": sum(r["train_flash_bwd"] for r in ranks),
        "decode_attention": sum(r[dt]["decode"] for r in ranks
                                for dt in MESH_SERVE)}
    cp_out = mesh_cp_check(ms, ref, ranks)
    out["cp"] = cp_out
    log(f"mesh cp ({ms.shape} over (data, model); {ms.arch} full width, "
        f"{ms.layers} layers, f32, act_dp ('data',), act_sp 'model': each "
        f"rank's flash on its model coordinate's rows at their offset): "
        f"{json.dumps(cp_out)}; {cp_out['seconds']:.3f} s; {card_line()}")
    moe_out = mesh_moe_check(mz, moe_ref, ranks)
    # the reference on the card, then the slowest rank's MoE work
    moe_out["seconds"] = moe_ref["seconds"] + max(
        r["moe"]["seconds"] for r in ranks)
    log(f"mesh_moe phase ({ms.shape} over (data, model), {n} processes "
        f"on the card, gloo; {mz.granite} full width, "
        f"{mz.granite_layers} layers, trains f32 {mz.train_steps} steps "
        f"of {mz.train_batch} x {mz.train_seq} at moe_groups "
        f"{mz.train_groups}; it and {mz.mixtral} full width, "
        f"{mz.mixtral_layers} layer, serve {mz.serve_batch} prompts of "
        f"{mz.prompt_len} and {mz.serve_steps} teacher-forced steps at "
        f"moe_groups 0): {json.dumps(moe_out)}; phase "
        f"{moe_out['seconds']:.3f} s; {card_line()}")
    fam_out = mesh_families_check(fz, fam_ref, ranks)
    fam_out["seconds"] = fam_ref["seconds"] + max(
        r["families"]["seconds"] for r in ranks)
    fam_out["reference_seconds"] = fam_ref["seconds"]
    # the card's bytes in use at their peak while the world ran (all
    # three phases' ranks; jamba's staged draw is the largest holding)
    fam_out["world_card_peak_bytes"] = world_peak.peak
    log(f"mesh_families phase ({ms.shape} over (data, model), {n} "
        f"processes on the card, gloo; full width: {fz.mamba} "
        f"{fz.mamba_layers} layers trains f32 {fz.train_steps} steps of "
        f"{fz.train_batch} x {fz.mamba_seq} and serves f32 and bf16 "
        f"{fz.serve_batch} prompts of {fz.prompt_len} and "
        f"{fz.serve_steps} teacher-forced steps; {fz.vl} {fz.vl_layers} "
        f"layers trains f32 on {fz.train_batch} x ({fz.vl_patches} patch "
        f"embeddings + {fz.vl_tokens} tokens) and serves bf16 the same; "
        f"{fz.jamba} {fz.jamba_layers} layers serves bf16 "
        f"{fz.serve_batch} prompts of {fz.prompt_len}): "
        f"{json.dumps(fam_out)}; phase {fam_out['seconds']:.3f} s; "
        f"{card_line()}")
    enc_out = mesh_encdec_check(ez, enc_ref, ranks)
    enc_out["seconds"] = enc_ref["seconds"] + max(
        r["encdec"]["seconds"] for r in ranks)
    enc_out["reference_seconds"] = enc_ref["seconds"]
    log(f"mesh_encdec phase ({ms.shape} over (data, model), {n} processes "
        f"on the card, gloo; {ez.arch} full width, {ez.layers} + "
        f"{ez.layers} layers, trains f32 {ez.train_steps} steps of "
        f"{ez.train_batch} x {ez.train_seq} tokens over {ez.train_frames} "
        f"frames and serves f32 and bf16 {ez.serve_batch} prompts of "
        f"{ez.prompt_len} over {ez.enc_len} frames, {ez.serve_steps} "
        f"teacher-forced steps): {json.dumps(enc_out)}; phase "
        f"{enc_out['seconds']:.3f} s; {card_line()}")
    # the encoder-decoder's world ran beside the first: its reference
    # alone was serial
    out["seconds"] = (time.perf_counter() - t_phase - moe_out["seconds"]
                      - fam_out["seconds"] - enc_ref["seconds"])
    log(f"mesh phase ({ms.shape} over (data, model), {n} processes on the "
        f"card, gloo; {ms.arch} full width, {ms.layers} layers): training "
        f"f32 {ms.train_steps} steps of {ms.train_batch} x "
        f"{ms.train_seq}, losses {r0['losses']} vs meshless "
        f"{ref['losses']} (largest relative difference {loss_rel:.3e}), "
        f"gradient norms {r0['grad_norms']} vs meshless "
        f"{ref['grad_norms']} ({gnorm_rel:.3e}), "
        f"parameters {r0['param_rel_l2']:.3e} relative L2, step ms "
        f"{r0['step_ms']} after the counted first "
        f"{r0['counted_step_ms']:.3f} (meshless {ref['step_ms']}); "
        f"per-rank state bytes measured/computed "
        f"{[(r['state_bytes_measured'], r['state_bytes_computed']) for r in ranks]}"
        f" of {r0['unsharded_bytes']} unsharded; serving "
        f"{ms.serve_batch} prompts of {ms.prompt_len}, {ms.serve_steps} "
        f"teacher-forced steps against ModelServer: {serve}; launches by "
        f"rank (train flash; f32, bf16 serve flash/decode) "
        f"{[(r['train_flash'],) + tuple((r[dt]['flash'], r[dt]['decode']) for dt in MESH_SERVE) for r in ranks]};"
        f" reshard restore bit for bit {ckpt_equal}; world {world_s:.3f} s,"
        f" phase {out['seconds']:.3f} s; {card_line()}")
    return out, moe_out, fam_out, enc_out


# ---------------------------------------------------------------------------
# the dry run: the port's steps on fake tensors, held to the card
# ---------------------------------------------------------------------------

DRYRUN_BUDGET_S = 90.0    # the four cells, one host core
DRYRUN_ARG_SLACK = 4096   # argument bytes against the allocator's
DRYRUN_PEAK_GAP = 0.15    # a predicted peak against the measured one


def dryrun_cells(ts_: TrainSizes = TrainSizes(),
                 ms: MeshSizes = MeshSizes()) -> Dict[str, Dict[str, object]]:
    """name -> ``repro_torch.launch.dryrun.run_cell`` arguments (the
    CLI's flags): hold_train the ``train`` phase's main path (no mesh),
    hold_mesh the ``mesh`` phase's training on a fake world of its
    shape, then two production cells on the fake (16, 16) pod; all on
    fake CUDA tensors."""
    from repro_torch.configs.registry import get_config
    d, m = ms.shape
    return {
        "hold_train": dict(arch=ts_.arch, shape=f"train:{ts_.batch}x"
                           f"{ts_.seq}", mesh_kind="none",
                           remat=get_config(ts_.arch).remat, accum=1),
        "hold_mesh": dict(arch=ms.arch, periods=ms.layers, dtype="float32",
                          shape=f"train:{ms.train_batch}x{ms.train_seq}",
                          mesh_kind=f"{d}x{m}",
                          remat=get_config(ms.arch).remat, accum=1),
        "qwen2_train_4k_pod": dict(arch="qwen2-1.5b", shape="train_4k",
                                   mesh_kind="pod"),
        "mixtral_decode_32k_pod": dict(arch="mixtral-8x22b",
                                       shape="decode_32k", mesh_kind="pod")}


# the dry run's subprocess: ``run_cell`` on each cell of argv[1] (a JSON
# object, name -> arguments), one after another, into argv[2]
DRYRUN_CHILD = """
import json, sys, torch
from repro_torch.launch import dryrun
torch.set_num_threads(1)
cells = {name: dryrun.run_cell(device="cuda", **kw)
         for name, kw in json.loads(sys.argv[1]).items()}
with open(sys.argv[2], "w") as f:
    json.dump(cells, f)
"""


class DryRun:
    """The dry run beside the single-process phases: a thread of this
    process runs ``DRYRUN_CHILD`` over ``dryrun_cells``, one cell after
    another in one subprocess pinned to one host core and at the lowest
    priority (``os.sched_setaffinity``, ``os.nice`` in the child, so the
    phases' own threads on that core keep it) with one torch thread, its
    fake tensors on CUDA (the kernels' ops); each cell sets up its fake
    world and takes it down. ``start`` as the ``model`` phase starts,
    ``join`` before ``mesh``: it adds no wall time while it fits beside
    them."""

    def __init__(self) -> None:
        import tempfile
        import threading
        self.tmp = tempfile.mkdtemp(prefix="smoke-dryrun-")
        self.cells: Dict[str, dict] = {}
        self.seconds = 0.0
        self.error = ""
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.core = max(os.sched_getaffinity(0))
        # built here: an import in the thread could meet one of the
        # main thread's on a module lock
        self.todo = dryrun_cells()

    def _child(self) -> None:
        os.sched_setaffinity(0, {self.core})
        os.nice(19)

    def _run(self) -> None:
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        out = os.path.join(self.tmp, "cells.json")
        t0 = time.perf_counter()
        try:
            p = subprocess.run(
                [sys.executable, "-c", DRYRUN_CHILD,
                 json.dumps(self.todo), out], capture_output=True,
                text=True, env=env, timeout=600, cwd=str(SRC.parent),
                preexec_fn=self._child)
            self.seconds = time.perf_counter() - t0
            if p.returncode != 0:
                raise AssertionError(f"dry run failed ({p.returncode}):\n"
                                     f"{p.stdout[-2000:]}"
                                     f"{p.stderr[-3000:]}")
            self.cells = json.loads(Path(out).read_text())
            bad = {k: c["status"] for k, c in self.cells.items()
                   if c["status"] != "ok"}
            if bad:
                raise AssertionError(f"dry run cells not ok: {bad}")
        except Exception as e:        # reported by join
            self.error = f"{type(e).__name__}: {e}"

    def start(self) -> "DryRun":
        self.thread.start()
        return self

    def join(self) -> Dict[str, object]:
        import shutil
        self.thread.join()
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.error:
            raise AssertionError(self.error)
        return {"cells": self.cells, "seconds": self.seconds,
                "cell_seconds": {k: c["lower_s"] + c["compile_s"]
                                 for k, c in self.cells.items()},
                "core": self.core}


def _predicted_peak(cell: dict) -> int:
    mem = cell["memory"]
    return mem["argument_bytes"] + mem["temp_bytes"]


def dryrun_check(dry: Dict[str, object], mesh: Dict[str, object],
                 trained: Dict[str, object]) -> Dict[str, object]:
    """The dry run's cells against what the card measured: hold_mesh's
    argument bytes within ``DRYRUN_ARG_SLACK`` of each mesh rank's state
    bytes asked of the allocator plus its share of the batch, its
    collective bytes equal to rank 0's first step's kind by kind, its
    predicted peak (arguments + temporaries) within ``DRYRUN_PEAK_GAP``
    of each rank's first-step peak, nothing live at that peak with the
    whole vocab (the loss works on vocab shards); hold_train's predicted
    peak within ``DRYRUN_PEAK_GAP`` of the ``train`` phase's. Prints
    hold_train's
    counted FLOPs over the phase's model FLOPs and the production cells'
    terms (computed from datasheet figures, not measured)."""
    cells = dry["cells"]
    hm, ht = cells["hold_mesh"], cells["hold_train"]
    args, pred = hm["memory"]["argument_bytes"], _predicted_peak(hm)
    r0 = mesh["ranks"][0]["first_step"]
    coll = {k: int(v) for k, v in hm["collectives"].items()}
    out: Dict[str, object] = {"hold_mesh": {
        "argument_bytes": args, "predicted_peak": pred,
        "collectives": coll, "collectives_by_axis":
            hm["collectives_by_axis"], "ranks": []}}
    for i, r in enumerate(mesh["ranks"]):
        held = r["state_bytes_requested"] + r["batch_share"]
        peak = r["first_step"]["peak_bytes"]
        out["hold_mesh"]["ranks"].append({
            "state_and_batch": held, "argument_gap": args - held,
            "peak_bytes": peak, "peak_gap": (pred - peak) / peak,
            "collectives": r["first_step"]["collectives"]})
        if abs(args - held) > DRYRUN_ARG_SLACK:
            raise AssertionError(f"dry run hold_mesh: {args} argument "
                                 f"bytes, rank {i} holds {held}")
        if abs(pred - peak) > DRYRUN_PEAK_GAP * peak:
            raise AssertionError(f"dry run hold_mesh: predicted peak "
                                 f"{pred}, rank {i} measured {peak}")
    if coll != {k: int(v) for k, v in r0["collectives"].items()}:
        raise AssertionError(f"dry run hold_mesh collectives {coll} vs "
                             f"rank 0's {r0['collectives']}")
    # the vocab-parallel loss: nothing at the peak holds the whole vocab
    from repro_torch.configs.registry import get_config
    vocab = get_config(hm["arch"]).vocab_size
    out["hold_mesh"]["peak_live"] = hm["peak_live"]
    whole = [k for k in hm["peak_live"] if vocab in k["shape"]]
    if whole:
        raise AssertionError(f"dry run hold_mesh: the peak holds tensors "
                             f"of the whole vocab {vocab}: {whole}")
    main_ = trained["main"]
    pred_t, peak_t = _predicted_peak(ht), main_["peak_bytes"]
    out["hold_train"] = {
        "argument_bytes": ht["memory"]["argument_bytes"],
        "temp_bytes": ht["memory"]["temp_bytes"], "predicted_peak": pred_t,
        "peak_bytes": peak_t, "peak_gap": (pred_t - peak_t) / peak_t,
        "flops_per_step": ht["flops_per_device"],
        "flops_over_model_flops": (ht["flops_per_device"]
                                   / main_["model_flops_per_step"])}
    if abs(pred_t - peak_t) > DRYRUN_PEAK_GAP * peak_t:
        raise AssertionError(f"dry run hold_train: predicted peak {pred_t}"
                             f", the train phase measured {peak_t}")
    for name in ("qwen2_train_4k_pod", "mixtral_decode_32k_pod"):
        c = cells[name]
        out[name] = {k: c[k] for k in (
            "fits", "dominant", "compute_s", "memory_s", "collective_s",
            "collective_links", "memory", "useful_flop_ratio")}
        log(f"dry run {c['arch']} {c['shape']} on {c['mesh']} (fake "
            f"{c['n_chips']}-rank world; datasheet figures, computed, not "
            f"measured): fits {c['fits']} (arguments "
            f"{c['memory']['argument_bytes']} + temporaries "
            f"{c['memory']['temp_bytes']} bytes), dominant {c['dominant']}"
            f"; compute {c['compute_s']:.6g} s, memory {c['memory_s']:.6g} "
            f"s, collectives {c['collective_s']:.6g} s "
            f"{c['collective_links']}")
    out["seconds"] = dry["seconds"]
    out["cell_seconds"] = dry["cell_seconds"]
    log(f"dryrun phase (one host core, fake CUDA tensors): hold_mesh "
        f"{json.dumps(out['hold_mesh'])}; hold_train "
        f"{json.dumps(out['hold_train'])}; {dry['seconds']:.3f} s (budget "
        f"{DRYRUN_BUDGET_S} s), each cell's build and trace seconds "
        f"{dry['cell_seconds']}; {card_line()}")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 3:
        mesh_rank(sys.argv[2])
        return 0
    calls_only = sys.argv[1:] == ["--calls"]
    train_only = sys.argv[1:] == ["--train"]
    decode_only = sys.argv[1:] == ["--decode"]
    if sys.argv[1:] and not (calls_only or train_only or decode_only):
        print(f"usage: {sys.argv[0]} [--calls | --train | --decode]",
              file=sys.stderr)
        return 2
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
    if calls_only:
        eng, (keys, ts, rows), _ = setup("cuda", Sizes())
        calls = main_path_calls(eng, keys, ts, rows, Sizes(), "cuda")
        report = serve(eng, keys, ts, rows, Sizes(), "cuda")
        log(card)
        log(json.dumps({"calls": calls, "serve": report}))
        return 0
    if train_only:
        main_ = train_main_path(TrainSizes(), "cuda")
        log(card)
        log(json.dumps({"train": {k: main_[k] for k in (
            "step_ms_p50", "first_step_ms", "peak_bytes", "busy",
            "flash_backward", "flash_backward_d64", "flash_bwd_routes")}}))
        return 0
    if decode_only:
        rep = model_main_path(ModelSizes(), "cuda")["report"]
        log(card)
        log(json.dumps({"decode": {k: rep[k] for k in (
            "decode_step_p50_ms", "decode_step_p99_ms", "decode_steps",
            "busy")}}))
        return 0
    wall: Dict[str, float] = {}       # each step's seconds, host clock
    t_main = time.perf_counter()

    def timed(name: str, fn: Callable, *args):
        # each step's start and end on stderr too: where a run that is cut
        # at its time limit stood shows at the end of its errors
        t0 = time.perf_counter()
        print(f"chip_smoke: {name} starts at {t0 - t_main:.1f} s",
              file=sys.stderr, flush=True)
        out = fn(*args)
        torch.cuda.empty_cache()
        wall[name] = time.perf_counter() - t0
        print(f"chip_smoke: {name} took {wall[name]:.1f} s",
              file=sys.stderr, flush=True)
        return out

    res = timed("run", run, "cuda", Sizes())
    shard_ref = res.pop("shard_ref")
    shard = timed("sharded_node", sharded_node, shard_ref, res["serve"],
                  Sizes(), "cuda")
    proc = timed("process_node", process_node, shard_ref, res["serve"],
                 shard, Sizes(), "cuda")
    base = timed("baselines", baselines_phase, Sizes(), "cuda")
    trained = timed("train", train_phase, "cuda")
    dry = DryRun().start()          # beside model, families and encdec
    mres = timed("model", run_model, "cuda", ModelSizes())
    fam = timed("families", families_phase, "cuda")
    enc = timed("encdec", encdec_phase, "cuda")
    dry_out = timed("dryrun_join", dry.join)
    wall["dryrun"] = dry_out["seconds"]
    mesh, mesh_moe, mesh_fam, mesh_enc = timed("mesh_phases", mesh_phase,
                                               "cuda")
    dried = dryrun_check(dry_out, mesh, trained)
    log(json.dumps({"phase_seconds": wall}))
    log(json.dumps({k: res[k] for k in ("serve", "ingest_s", "peak_bytes",
                                        "engine_stats", "busy", "calls")}))
    log(json.dumps({k: res[k] for k in ("live", "modes", "swap", "stream",
                                        "server")}))
    log(json.dumps({"observe": res["observe"]}))
    log(json.dumps({"sharded": shard}))
    log(json.dumps({"process": proc}))
    log(json.dumps({"baselines": base}))
    log(json.dumps({"train": trained}))
    log(json.dumps({k: mres[k] for k in ("model", "model_cuda_vs_cpu",
                                         "serve_cli")}))
    log(json.dumps({"families": fam}))
    log(json.dumps({"encdec": enc}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"mesh_moe": mesh_moe}))
    log(json.dumps({"mesh_families": mesh_fam}))
    log(json.dumps({"mesh_encdec": mesh_enc}))
    log(json.dumps({"dryrun": dried}))
    phase = {"baselines": {k: sum(v.get(k, 0)
                                  for v in base["launches"].values())
                           for k in KERNELS},
             "train": {"flash_attention": trained["main"]["flash_launches"],
                       "flash_attention_bwd":
                           trained["main"]["flash_bwd_launches"]},
             "families": fam["launches"],
             "encdec": enc["launches"],
             "mesh": mesh["launches"],
             "mesh_cp": mesh["cp"]["launches"],
             "mesh_moe": mesh_moe["launches"],
             "mesh_families": mesh_fam["launches"],
             "mesh_encdec": mesh_enc["launches"]}
    fb = trained["main"]["flash_backward"]
    fb64 = trained["main"]["flash_backward_d64"]
    kernels = res["kernels"] + mres["kernels"] + [{
        "name": name, "route": "cuda", "source": src, "replaces": what,
        "launches": trained["main"]["flash_bwd_launches"],
        "max_abs_err": max(fb["max_abs_err"], fb64["max_abs_err"],
                           mres["bwd_err"]),
        **{k: fb[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library_backend", "shape",
                              "bound_with_scratch_ms")},
        "launches_by_route": trained["main"]["flash_bwd_routes"],
        "d64": {k: fb64[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "library_backend", "shape",
                                     "bound_with_scratch_ms")}}
        for name, (src, what) in BWD_KERNEL.items()]
    for k in kernels:
        k["phase_launches"] = {p: v[k["name"]] for p, v in phase.items()
                               if k["name"] in v}
    log(f"flash_attention_bwd before its redesign for Hopper: "
        f"{BWD_REDESIGNED_FROM_MS} ms at the training call, an earlier "
        f"run's reading (PERF.md), not measured in this run; this run: "
        f"{fb['ms']:.6f} ms")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
