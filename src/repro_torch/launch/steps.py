"""Model-agnostic step factories: one place that turns a ``ModelConfig``
into the ``prefill_step`` / ``serve_step`` functions the serving runtime
calls (the serving part of the JAX package's ``repro.launch.steps``).

* ``prefill_step(params, tokens[, embeds]) -> (last_logits, caches)``.
* ``serve_step(params, caches, token, position) -> (logits, caches)`` —
  one decode token against the KV cache, which it writes in place.

PyTorch runs eagerly, so the steps are plain functions (no jit, no
sharding specs); the training step comes with the training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

__all__ = ["init_params", "make_prefill_step", "make_serve_step"]


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    return lm.init_lm(gen, cfg)


def make_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    def prefill_step(params, tokens, embeds=None):
        return lm.prefill(params, cfg, tokens, cache_len, embeds)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, caches, token, position):
        return lm.decode_step(params, cfg, caches, token, position)
    return serve_step
