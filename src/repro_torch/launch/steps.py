"""Model-agnostic step factories: one place that turns a ``ModelConfig``
into the ``train_step`` / ``prefill_step`` / ``serve_step`` functions the
trainer and the serving runtime call (the JAX package's
``repro.launch.steps``, less its mesh and sharding specs).

* ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
  with optional gradient accumulation (``accum`` microbatches).
* ``prefill_step(params, tokens[, embeds]) -> (last_logits, caches)``.
* ``serve_step(params, caches, token, position) -> (logits, caches)`` —
  one decode token against the KV/SSM cache, which it writes in place.
* Non-finite-gradient guard: a step whose global grad norm is non-finite
  applies no update (params and optimizer state come back unchanged) and
  reports ``skipped = 1``.

PyTorch runs eagerly, so the steps are plain functions (no jit, no
sharding specs). The int8-compressed cross-pod gradient reduce needs the
mesh and its collectives, which are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update

__all__ = ["init_params", "make_train_step", "make_prefill_step",
           "make_serve_step"]


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    return lm.init_lm(gen, cfg)


def _value_and_grad(params: Any, cfg: ModelConfig,
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, f32 grads shaped like ``params``). The parameters
    are taken as fresh leaves sharing their storage, so the caller's
    tensors gain no ``grad`` and no graph."""
    flat = tree_flatten_with_path(params)
    leaves = [p.detach().requires_grad_() for _, p in flat]
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(tree_unflatten(params, leaves), cfg,
                                   batch)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, [g.to(torch.float32) for g in grads]))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    accum: int = 1,
                    compress_crosspod: bool = False) -> Callable:
    """Builds ``train_step(params, opt_state, batch)``.

    ``accum > 1`` splits the leading batch dim into microbatches, run one
    after the other, accumulating f32 gradients — activation memory drops
    ~accum-fold while FLOPs stay."""
    if compress_crosspod:
        raise NotImplementedError(
            "compress_crosspod: the int8 cross-pod gradient reduce "
            "(distributed/collectives.py, optim/compression.py) is not "
            "ported yet")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")

    def grads_of(params, batch):
        if accum == 1:
            loss, metrics, grads = _value_and_grad(params, cfg, batch)
            return grads, loss, metrics
        b = next(iter(batch.values())).shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum {accum}")
        g_sum = l_sum = None
        m_all = []
        for i in range(accum):
            mb = {k: v.reshape((accum, b // accum) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss, metrics, g = _value_and_grad(params, cfg, mb)
            if g_sum is None:
                g_sum, l_sum = g, loss
            else:
                g_sum = tree_unflatten(g_sum, [
                    a + b_ for (_, a), (_, b_) in zip(
                        tree_flatten_with_path(g_sum),
                        tree_flatten_with_path(g))])
                l_sum = l_sum + loss
            m_all.append(metrics)
        grads = tree_unflatten(g_sum, [
            g / accum for _, g in tree_flatten_with_path(g_sum)])
        metrics = {k: torch.stack([m[k] for m in m_all]).mean()
                   for k in m_all[0]}
        return grads, l_sum / accum, metrics

    def train_step(params, opt_state: OptState, batch):
        grads, loss, metrics = grads_of(params, batch)
        new_p, new_s, om = adamw_update(grads, opt_state, params, opt_cfg)
        # non-finite guard: no update, the old state kept
        gnorm = om.get("grad_norm")
        ok = gnorm is None or bool(torch.isfinite(gnorm))
        if not ok:
            new_p, new_s = params, opt_state
        om["skipped"] = torch.tensor(0.0 if ok else 1.0)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return new_p, new_s, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    def prefill_step(params, tokens, embeds=None):
        return lm.prefill(params, cfg, tokens, cache_len, embeds)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, caches, token, position):
        return lm.decode_step(params, cfg, caches, token, position)
    return serve_step
