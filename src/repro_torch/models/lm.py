"""Decoder-only language model: embed → stacked blocks → norm → logits.

Entry points of the serving path (as in the JAX package's
``repro.models.lm``, same parameter and cache layouts):

    init_lm(gen, cfg)                         -> params
    prefill(params, cfg, tokens, cache_len)   -> (last_logits, caches)
    decode_step(params, cfg, caches, token, position) -> (logits, caches)
    init_cache(cfg, batch, cache_len, device) -> zero caches

``decode_step`` writes the caches in place (and returns them). Logits are
f32, from the f32 product of the final hidden state with the head; a caller
that runs many steps passes ``with_f32_head(params, cfg)``, which converts
the head to f32 once instead of on every call. The training entry points,
the encoder-decoder models and the frontends come with their own slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers import (apply_norm, init_embedding, init_norm,
                                       mrope_positions_text)
from repro_torch.models.tree import tree_map

Params = Dict[str, Any]

__all__ = ["init_lm", "prefill", "decode_step", "init_cache",
           "with_f32_head", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model the port does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models (ROADMAP Queue 1 item 10: "
            f"models/encdec.py) are not ported yet")
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.frontend} frontend embeddings (ROADMAP "
            f"Queue 1 item 10: models/frontend.py) are not ported yet")
    for token in B.normalize_pattern(cfg):
        B.check_supported(token)


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    dtype = cfg.torch_param_dtype
    p: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "blocks": B.init_stacked_blocks(gen, cfg),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      dtype)
    return p


def with_f32_head(params: Params, cfg: ModelConfig) -> Params:
    """``params`` plus ``head_f32``, the output head converted to f32 once
    (the same tensor when it is f32 already)."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return dict(params, head_f32=head.float())


def _positions(cfg: ModelConfig, B_: int, S: int, device: torch.device,
               offset: int = 0) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(B_, S)
    if cfg.mrope_sections is not None:
        return mrope_positions_text(pos)
    return pos


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    # gather first, then convert: the same values as converting the table
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if embeds is not None:
        x = torch.cat([embeds.to(cfg.compute_dtype), x], dim=1)
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params.get("head_f32")
    if head is None:
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ head.float().T


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Tuple]:
    """tokens (B, S) -> (logits of the last position (B, V) f32, caches
    padded to ``cache_len``)."""
    x = _embed_inputs(params, cfg, tokens, embeds)
    B_, S = x.shape[:2]
    pos = _positions(cfg, B_, S, x.device)
    x, caches = B.run_blocks_prefill(params["blocks"], x, cfg, pos,
                                     cache_len)
    return _logits(params, cfg, x[:, -1:, :])[:, 0, :], caches


def decode_step(params: Params, cfg: ModelConfig, caches: Tuple,
                token: torch.Tensor, position: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple]:
    """token (B,) int; position (B,) int32 -> (logits (B, V) f32, caches
    written in place)."""
    x = params["embed"][token.long()].to(cfg.compute_dtype)   # (B, d)
    x, caches = B.run_blocks_decode(params["blocks"], x, cfg, caches,
                                    position)
    return _logits(params, cfg, x[:, None, :])[:, 0, :], caches


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: torch.device) -> Tuple:
    """Zero caches, stacked per pattern position on a leading reps axis."""
    check_supported(cfg)
    pattern = B.normalize_pattern(cfg)
    reps = cfg.n_layers // len(pattern)
    out = []
    for token in pattern:
        one = B.init_block_cache(cfg, token, batch, cache_len,
                                 cfg.compute_dtype, device)
        out.append(tree_map(
            lambda a: a.new_zeros((reps,) + tuple(a.shape)), one))
    return tuple(out)
