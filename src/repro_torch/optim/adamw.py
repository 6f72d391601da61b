"""AdamW with schedules and global-norm clipping (the JAX package's
``repro.optim.adamw``).

Functions over parameter trees (``repro_torch.models.tree``): the update
returns new trees and changes none it was given, as the JAX package's
pure functions do.

Mixed precision contract: params may be bf16; ``m``/``v`` are always f32;
the update is computed in f32 and cast back to the param dtype. A separate
f32 master copy can be kept with ``master_weights=True``. Leaves are
visited in JAX's order (sorted dict keys), so the global norm sums them in
the same order, and the weight-decay mask reads the same paths.
DTensor parameters (a wide mesh) get DTensor state placed as they are,
the step counter replicated; the update is elementwise on each shard,
the global norm a full reduction every rank reads alike.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten

Params = Any
__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "make_schedule"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"         # constant | linear | cosine
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_weights: bool = False


@dataclass
class OptState:
    m: Params
    v: Params
    count: torch.Tensor               # () int32
    master: Optional[Params] = None   # f32 copy when enabled


def make_schedule(cfg: AdamWConfig
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int or float tensor) -> lr (f32 tensor of the same shape)."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "constant":
            decay = torch.ones_like(t)
        elif cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_frac) * t
        elif cfg.schedule == "cosine":
            decay = (cfg.min_lr_frac + (1.0 - cfg.min_lr_frac)
                     * 0.5 * (1.0 + torch.cos(math.pi * t)))
        else:
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        return cfg.lr * warm * decay

    return sched


def _leaves(tree: Params):
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def _zeros_f32_like(params: Params) -> Params:
    """f32 zeros shaped (and, for DTensor parameters, placed) like each
    leaf."""
    return tree_unflatten(params, [
        torch.zeros_like(p, dtype=torch.float32) for p in _leaves(params)])


def adamw_init(params: Params, cfg: AdamWConfig = AdamWConfig()
               ) -> OptState:
    master = None
    if cfg.master_weights:
        master = tree_unflatten(params, [p.detach().to(torch.float32)
                                         for p in _leaves(params)])
    first = _leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):      # replicated over the mesh
        mesh = first.device_mesh
        count = distribute_tensor(count, mesh, [Replicate()] * mesh.ndim,
                                  src_data_rank=None)
    return OptState(m=_zeros_f32_like(params), v=_zeros_f32_like(params),
                    count=count, master=master)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    leaves = _leaves(grads)
    sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return (tree_unflatten(grads, [
        (g.to(torch.float32) * scale).to(g.dtype) for g in leaves]), gnorm)


def _decay_mask(path) -> bool:
    """Decay matmul weights; skip norms/biases/scalars (standard recipe).
    ``path`` names a leaf as JAX's tree paths do: a sequence index has no
    name there, so it joins as an empty segment."""
    names = [k if isinstance(k, str) else "" for k in path]
    joined = "/".join(names)
    for skip in ("norm", "bias", "scale", "dt_bias", "A_log", "D", "b"):
        if joined.endswith(skip) or f"/{skip}/" in joined:
            return False
    return True


def adamw_update(grads: Params, state: OptState, params: Params,
                 cfg: AdamWConfig
                 ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    metrics: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        if cfg.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
            metrics["grad_norm"] = gnorm
        count = state.count + 1
        cf = count.to(torch.float32)
        lr = make_schedule(cfg)(count)
        metrics["lr"] = lr
        bc1 = 1.0 - cfg.b1 ** cf
        bc2 = 1.0 - cfg.b2 ** cf

        src = state.master if state.master is not None else params

        def upd(path, g, m, v, p):
            gf = g.to(torch.float32)
            m2 = cfg.b1 * m + (1.0 - cfg.b1) * gf
            v2 = cfg.b2 * v + (1.0 - cfg.b2) * gf * gf
            step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
            pf = p.to(torch.float32)
            if cfg.weight_decay and _decay_mask(path):
                step = step + cfg.weight_decay * pf
            return pf - lr * step, m2, v2

        flat = tree_flatten_with_path(grads)
        new = [upd(path, g, m, v, p) for (path, g), m, v, p in zip(
            flat, _leaves(state.m), _leaves(state.v), _leaves(src))]
        new_params = tree_unflatten(params, [
            n[0].to(p.dtype) for n, p in zip(new, _leaves(params))])
        new_master = (tree_unflatten(params, [n[0] for n in new])
                      if state.master is not None else None)
        new_state = OptState(m=tree_unflatten(params, [n[1] for n in new]),
                             v=tree_unflatten(params, [n[2] for n in new]),
                             count=count, master=new_master)
    return new_params, new_state, metrics
