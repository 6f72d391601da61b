"""What the train step's non-finite guard costs on one card.

The guard keeps the old parameters and optimizer state where the
gradient norm is not finite. It selects on the device, a ``torch.where``
per leaf of the parameters and of both moments
(``repro_torch.launch.steps._select``), as JAX's ``jnp.where`` does. The
other way, the one the port took before, decides on the host: it reads
the norm back (a device sync) and keeps one tree or the other. This
script runs both in one process on one ``TrainLoop``: qwen2-1.5b at
full width and depth, bf16, remat ``dots``, 4 x 512 tokens (the smoke's
``train`` main path). Steps alternate A B B A, each timed between device
syncs on the host clock, so host drift falls on both alike. It also
reads each guard's device time for one step under ``torch.profiler``
(the kernels' summed time, as the smoke's ``train_busy`` reads it).

Run from the repo root: ``python3 scripts/train_guard_ab.py [pairs]``
(about 2 minutes on an H100 at the default 16 pairs). It prints one
JSON line: each guard's step p50 and the median of the paired relative
differences with its quartiles, and the two device times, beside the
card's name and power limit.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import TrainLoop  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

ARCH, BATCH, SEQ, WARM = "qwen2-1.5b", 4, 512, 3


def host_guard(ok, new, old):
    """The guard decided on the host: a device sync, then one tree."""
    return new if bool(ok) else old


GUARDS = {"device_select": steps._select, "host_decision": host_guard}


def main() -> None:
    pairs = int(sys.argv[1]) if sys.argv[1:] else 16
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    loop = TrainLoop(cfg, opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=2,
                                              total_steps=1000),
                     seed=0, device="cuda")
    rng = np.random.default_rng(17)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1].astype(np.int32),
                                       device="cuda"),
             "targets": torch.as_tensor(toks[:, 1:].astype(np.int32),
                                        device="cuda")}

    def step(guard: str) -> float:
        steps._select = GUARDS[guard]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.params, loop.opt_state, m = loop.train_step(
            loop.params, loop.opt_state, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if float(m["skipped"]) != 0.0 or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"{guard}: a skipped or non-finite step")
        return dt

    for i in range(WARM):
        step(list(GUARDS)[i % 2])
    ms = {g: [] for g in GUARDS}
    rel = []
    for i in range(pairs):
        order = list(GUARDS) if i % 2 == 0 else list(GUARDS)[::-1]
        got = {g: step(g) for g in order}
        for g, v in got.items():
            ms[g].append(v)
        rel.append(got["device_select"] / got["host_decision"] - 1.0)

    from torch.profiler import ProfilerActivity, profile
    device_ms = {}
    for g in GUARDS:
        steps._select = GUARDS[g]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop.params, loop.opt_state, _ = loop.train_step(
                loop.params, loop.opt_state, batch)
            torch.cuda.synchronize()
        device_ms[g] = sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    steps._select = GUARDS["device_select"]
    q1, q2, q3 = np.percentile(rel, [25, 50, 75])
    print(card)
    print(json.dumps({
        "arch": ARCH, "batch": BATCH, "seq": SEQ, "pairs": pairs,
        "step_p50_ms": {g: float(np.percentile(v, 50))
                        for g, v in ms.items()},
        "select_over_host_rel": {"q1": q1, "median": q2, "q3": q3},
        "device_ms": device_ms,
        "step_ms": ms}))


if __name__ == "__main__":
    main()
