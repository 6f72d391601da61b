"""Time the flash attention backward kernel on the card, pass by pass.

Usage (on a machine with an NVIDIA H100; builds the kernel library first)::

    PYTHONPATH=src python3 scripts/flash_bwd_bench.py

1. Prints the compiler's register and spill lines of the backward's
   ``wgmma`` kernels (``ptxas -v``).
2. At the training calls (qwen2-1.5b: 4 x 512, 12/2 heads of 128;
   granite-moe-3b-a800m: 4 x 512, 24/8 heads of 64; bf16, causal) runs
   ``chip_smoke.flash_backward``: the kernel held to its plain versions,
   its device ms per call, each of its kernels' (torch.profiler), the
   plain recompute's, the library's and the bound.

The checks of every route, head dim, mask and offset are the ``cuda``
tests of ``tests/test_torch_cuda.py``. Prints one JSON line per timed
shape and, last, ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

TIMED = [("qwen2-1.5b train", (4, 512, 512, 12, 2, 128)),
         ("granite-moe-3b-a800m train", (4, 512, 512, 24, 8, 64))]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def ptxas_lines() -> list:
    """The wgmma route's kernels' lines: entry, spills, registers."""
    keep, out = False, []
    for line in _build.build_log().splitlines():
        if line.startswith("== "):
            keep = False
        elif "Compiling entry" in line:
            keep = "_wg_kernel" in line or "dkdv_sum" in line
        if keep and ("Used" in line or "spill" in line
                     or "Compiling entry" in line):
            out.append(line.strip())
    return out


def timed(name, shape) -> dict:
    B, Sq, Sk, Hq, Hkv, D = shape
    a = (cs._randn((B, Sq, Hq, D), torch.bfloat16, "cuda", 7),
         cs._randn((B, Sk, Hkv, D), torch.bfloat16, "cuda", 8),
         cs._randn((B, Sk, Hkv, D), torch.bfloat16, "cuda", 9))
    res = cs.flash_backward(a, {}, "cuda")
    res.update(name=name, card=card())
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(json.dumps({"build_s": _build.build_seconds()}), flush=True)
    for line in ptxas_lines():
        print(line, flush=True)
    for name, shape in TIMED:
        print(json.dumps(timed(name, shape), default=str), flush=True)
    print(card())
    print(json.dumps({"ok": True, "seconds": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
