"""End-to-end trainer on one device (CPU-runnable with
``--reduced --device cpu``; the card by default).

The port of the JAX package's ``repro.launch.train``: config -> model ->
``train_step`` -> host data pipeline -> checkpoint manager -> supervisor.
Without a mesh one device holds the whole model. ``TrainLoop(mesh=...)``
on a mesh whose ``data`` or ``model`` axis has several ranks places the
parameters and the optimizer state by the sharding rules
(``distributed/sharding.py``: DTensors, each rank holding its shards)
and its restore reshards them onto its own mesh; on a mesh whose only
wide axis is ``pod`` it is data parallel over it (one rank per pod, an
f32 gradient mean, or with ``compress=True`` the int8-compressed one).
``--compress-grads`` without a mesh is the plain step, as in the JAX
package. Every registered config trains on one device and on a wide
mesh, the encoder-decoder (seamless-m4t-medium) included.

Fault tolerance in the loop:

* async atomic checkpoints every ``--ckpt-every`` steps, retention-K;
* NaN/divergence supervisor: non-finite steps are skipped in-step (no
  update); after ``--max-bad-steps`` consecutive bad steps the loop
  rolls back to the last checkpoint;
* resume: ``--resume`` restarts from the latest checkpoint.

Example:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 30 --batch 8 --seq 64 --ckpt-dir ck/
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.reshard import restore_resharded
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.pipeline import HostPipeline, PipelineConfig
from repro_torch.data.synthetic import token_batch_stream
from repro_torch.distributed.sharding import (distribute, is_wide,
                                              opt_specs, param_specs)
from repro_torch.featurestore.table import resolve_device
from repro_torch.launch.steps import init_params, make_train_step
from repro_torch.models import frontend
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["TrainLoop", "make_batches", "main"]


class TrainLoop:
    """Owns params/opt/step + checkpointing + the supervisor. ``device``
    defaults to the card and raises where there is none; on a mesh the
    mesh's device type is the device. On a wide mesh every rank draws the
    same seeded parameters and keeps its shards of them."""

    def __init__(self, cfg: ModelConfig, *, opt_cfg: AdamWConfig,
                 accum: int = 1, mesh=None, compress: bool = False,
                 ckpt_dir: Optional[str] = None, retain: int = 3,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
        self.step = 0
        self.bad_streak = 0
        # the rules place the state only where a data/model axis shards
        self.mesh = mesh if mesh is not None and is_wide(mesh) else None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(gen, cfg)
        if self.mesh is not None:
            self.params = distribute(self.params, self.mesh,
                                     param_specs(self.params, self.mesh))
        self.opt_state = adamw_init(self.params, opt_cfg)
        self.train_step = make_train_step(cfg, opt_cfg, accum=accum,
                                          mesh=mesh,
                                          compress_crosspod=compress)
        self.ckpt = (CheckpointManager(ckpt_dir, retain=retain)
                     if ckpt_dir else None)

    # ----------------------------------------------------------- checkpoint
    def save(self, block: bool = False) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       extra={"step": self.step}, block=block)

    def restore(self, step: Optional[int] = None) -> bool:
        """Restore ``step`` (the newest by default). In a world of
        several processes rank 0 chooses the step and every rank restores
        that one, or every rank returns False."""
        if self.ckpt is None:
            return False
        self.ckpt.wait()                 # a pending save is published
        if step is None:
            step = self.ckpt.latest_step()
        if dist.is_initialized() and dist.get_world_size() > 1:
            chosen = [step]
            dist.broadcast_object_list(chosen, src=0)
            step = chosen[0]
        if step is None:
            return False
        like = {"params": self.params, "opt": self.opt_state}
        specs = None
        if self.mesh is not None:
            specs = {"params": param_specs(self.params, self.mesh),
                     "opt": opt_specs(self.opt_state, self.mesh)}
        tree, meta = restore_resharded(self.ckpt, step, like, self.mesh,
                                       specs)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = int(meta.extra.get("step", meta.step))
        return True

    # ------------------------------------------------------------------ run
    def run(self, batches, *, steps: int, ckpt_every: int = 0,
            max_bad_steps: int = 3, log_every: int = 10,
            on_metrics=None) -> Dict[str, Any]:
        history = []
        it = iter(batches)
        t0 = time.perf_counter()
        while self.step < steps:
            batch = next(it)
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in batch.items()}
            self.params, self.opt_state, m = self.train_step(
                self.params, self.opt_state, batch)
            m = {k: float(v) for k, v in m.items()}
            self.step += 1

            # --- supervisor ---------------------------------------------
            if m.get("skipped", 0.0) > 0 or not np.isfinite(m["loss"]):
                self.bad_streak += 1
                if self.bad_streak >= max_bad_steps and self.ckpt:
                    rolled = self.restore()
                    m["rolled_back"] = float(rolled)
                    self.bad_streak = 0
            else:
                self.bad_streak = 0

            if ckpt_every and self.step % ckpt_every == 0:
                self.save()
            if on_metrics:
                on_metrics(self.step, m)
            if log_every and self.step % log_every == 0:
                dt = time.perf_counter() - t0
                print(f"step {self.step:5d} loss {m['loss']:.4f} "
                      f"gnorm {m.get('grad_norm', float('nan')):.3f} "
                      f"lr {m.get('lr', 0):.2e} {dt / log_every:.3f}s/step",
                      flush=True)
                t0 = time.perf_counter()
            history.append(m)
        if self.ckpt:
            self.ckpt.wait()
        return {"history": history, "final_loss": history[-1]["loss"]
                if history else float("nan")}


def make_batches(cfg: ModelConfig, *, batch: int, seq: int, seed: int,
                 pipeline: bool = True):
    """Token batches from a cycled pool of 8 (deterministic). A model with
    a frontend also gets ``embeds`` (f32 numpy, the stub's embeddings drawn
    from a CPU generator seeded by the batch index, as the JAX package
    seeds them by ``PRNGKey(i)``); an encoder-decoder also gets
    ``enc_embeds`` (f32 numpy, ``(batch, seq, d_model)`` audio frames
    drawn the same way)."""
    gen = token_batch_stream(vocab=cfg.vocab_size, batch=batch, seq=seq,
                             seed=seed)
    raw = list(next(gen) for _ in range(8))     # cycled pool

    def producer(i):
        b = dict(raw[i % len(raw)])
        if cfg.frontend:
            b["embeds"] = frontend.stub_frontend(
                torch.Generator().manual_seed(i), cfg, batch
            ).float().numpy()
        if cfg.is_encdec:
            b["enc_embeds"] = frontend.stub_audio_frames(
                torch.Generator().manual_seed(i), cfg, batch, n_frames=seq
            ).float().numpy()
        return b

    if pipeline:
        return HostPipeline(producer, n_batches=None,
                            cfg=PipelineConfig(prefetch=2, n_workers=2))
    return (producer(i) for i in range(10 ** 9))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-runnable reduced config of the same family")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8-compressed cross-pod gradient reduce; "
                         "without a mesh (this CLI's single device) the "
                         "plain step, as in the JAX trainer")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 3),
                          total_steps=args.steps)
    loop = TrainLoop(cfg, opt_cfg=opt_cfg, accum=args.accum,
                     compress=args.compress_grads, ckpt_dir=args.ckpt_dir,
                     seed=args.seed, device=args.device)
    if args.resume and loop.restore():
        print(f"resumed from step {loop.step}")
    batches = make_batches(cfg, batch=args.batch, seq=args.seq,
                           seed=args.seed)
    try:
        out = loop.run(batches, steps=args.steps,
                       ckpt_every=args.ckpt_every)
    finally:
        if isinstance(batches, HostPipeline):
            batches.close()
    print(f"final loss {out['final_loss']:.4f} on {loop.device}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
