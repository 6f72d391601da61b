"""Model-agnostic step factories: one place that turns a ``ModelConfig``
into the ``train_step`` / ``prefill_step`` / ``serve_step`` functions the
trainer and the serving runtime call (the JAX package's
``repro.launch.steps``, less its sharding specs).

* ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
  with optional gradient accumulation (``accum`` microbatches); on a
  mesh's ``pod`` axis, data parallel with an f32 or (``compress_crosspod``)
  int8-compressed cross-pod gradient mean.
* ``prefill_step(params, tokens[, embeds]) -> (last_logits, caches)``;
  for an encoder-decoder ``prefill_step(params, enc_embeds, tokens)``.
* ``serve_step(params, caches, token, position[, enc_out])
  -> (logits, caches)`` — one decode token against the KV/SSM cache,
  which it writes in place.
* Non-finite-gradient guard: a step whose global grad norm is non-finite
  applies no update (params and optimizer state come back unchanged) and
  reports ``skipped = 1``.

PyTorch runs eagerly, so the steps are plain functions (no jit, no
sharding specs). A mesh whose ``data`` or ``model`` axis has more than
one rank needs the sharding rules (``distributed/sharding.py``), which
are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (axis_size,
                                                 crosspod_grad_mean)
from repro_torch.models import encdec, lm
from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update

__all__ = ["init_params", "make_train_step", "make_prefill_step",
           "make_serve_step"]


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    if cfg.is_encdec:
        return encdec.init_encdec(gen, cfg)
    return lm.init_lm(gen, cfg)


def _value_and_grad(params: Any, cfg: ModelConfig,
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, f32 grads shaped like ``params``). The parameters
    are taken as fresh leaves sharing their storage, so the caller's
    tensors gain no ``grad`` and no graph."""
    loss_fn = encdec.loss_fn if cfg.is_encdec else lm.loss_fn
    flat = tree_flatten_with_path(params)
    leaves = [p.detach().requires_grad_() for _, p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, [g.to(torch.float32) for g in grads]))


def _pod_of(mesh) -> Optional[Tuple[Any, int, int]]:
    """(the ``pod`` axis's process group, its ranks, this rank's pod
    coordinate), or None for a mesh without a ``pod`` axis. Raises for a
    mesh that shards over ``data`` or ``model``."""
    wide = {a: axis_size(mesh, a) for a in ("data", "model")
            if axis_size(mesh, a) > 1}
    if wide:
        raise NotImplementedError(
            f"a mesh with {wide}: sharding parameters and activations "
            f"over the data and model axes needs distributed/sharding.py, "
            f"which is not ported yet")
    if "pod" not in (mesh.mesh_dim_names or ()):
        return None
    return (mesh.get_group("pod"), axis_size(mesh, "pod"),
            mesh.get_local_rank("pod"))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    accum: int = 1, mesh=None,
                    compress_crosspod: bool = False) -> Callable:
    """Builds ``train_step(params, opt_state, batch)``.

    ``accum > 1`` splits the leading batch dim into microbatches, run one
    after the other, accumulating f32 gradients — activation memory drops
    ~accum-fold while FLOPs stay.

    On a ``DeviceMesh`` with a ``pod`` axis of n ranks the step is data
    parallel over it: every rank is given the global batch and takes its
    pod's rows ``[r·B/n, (r+1)·B/n)``, computes f32 gradients on them,
    averages them over the pod group (``crosspod_grad_mean``: an f32
    all-reduce, or with ``compress_crosspod`` the int8 one, ``psum_int8 /
    n``), averages the loss and the metrics over the group, and applies
    the same AdamW update, so every rank ends the step with the same
    parameters. The loss is the mean of the pods' means, which is the
    global batch's when every pod's rows hold as many unmasked targets.
    Without a mesh or a ``pod`` axis the step is the plain one, whatever
    ``compress_crosspod`` says, as in the JAX package."""
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    pod = _pod_of(mesh) if mesh is not None else None

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

    def apply_update(params, opt_state: OptState, grads, loss, metrics):
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

    if pod is None:
        def train_step(params, opt_state: OptState, batch):
            grads, loss, metrics = grads_of(params, batch)
            return apply_update(params, opt_state, grads, loss, metrics)

        return train_step

    # ---- data parallel over the pod axis ----------------------------------
    group, npods, r = pod

    def train_step(params, opt_state: OptState, batch):
        b = next(iter(batch.values())).shape[0]
        if b % npods:
            raise ValueError(f"batch {b} not divisible by {npods} pods")
        lo, hi = r * b // npods, (r + 1) * b // npods
        grads, loss, metrics = grads_of(
            params, {k: v[lo:hi] for k, v in batch.items()})
        grads = crosspod_grad_mean(grads, mesh, compress=compress_crosspod)
        # the loss and the metrics: one f32 all-reduce, then / npods
        names = sorted(metrics)
        vals = torch.stack([loss.float()]
                           + [metrics[k].float() for k in names])
        dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
        vals = vals / npods
        metrics = {k: vals[i + 1] for i, k in enumerate(names)}
        return apply_update(params, opt_state, grads, vals[0], metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, *,
                      with_enc_out: bool = False) -> Callable:
    """The prefill step; for an encoder-decoder with ``with_enc_out`` it
    also returns the encoder output, which a server keeps for the serve
    step (``(last_logits, caches, enc_out)``)."""
    if cfg.is_encdec:
        def prefill_step(params, enc_embeds, tokens):
            enc_out = encdec.encode(params, cfg, enc_embeds)
            logits, caches = encdec.dec_prefill(params, cfg, enc_out,
                                                tokens, cache_len)
            return ((logits, caches, enc_out) if with_enc_out
                    else (logits, caches))
        return prefill_step

    def prefill_step(params, tokens, embeds=None):
        return lm.prefill(params, cfg, tokens, cache_len, embeds)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    if cfg.is_encdec:
        def serve_step(params, caches, token, position, enc_out):
            return encdec.dec_decode_step(params, cfg, enc_out, caches,
                                          token, position)
        return serve_step

    def serve_step(params, caches, token, position):
        return lm.decode_step(params, cfg, caches, token, position)
    return serve_step
