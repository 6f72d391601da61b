"""Encoder-decoder backbone (the Seamless-M4T medium class).

As in the JAX package's ``repro.models.encdec``: the modality frontend is
a stub, so the encoder takes precomputed audio-frame embeddings
``(B, S_enc, d_model)`` (``models/frontend.py``) directly. Encoder:
bidirectional self-attention + MLP. Decoder: causal self-attention (KV
cached for serving) + cross-attention over the encoder's output + MLP.

Both stacks keep the JAX layout, each leaf stacked on a leading layer
axis (``enc_blocks``, ``dec_blocks``), so parameters carry across leaf for
leaf (``repro_torch.convert``); the port loops over the layers in Python
and hands each block views of its slice. The decoder cache is
``{"k", "v"}`` of shape ``(n_layers, B, cache_len, Hkv, D)``;
``dec_decode_step`` writes one slot of each layer in place.

Logits are the f32 product of the final hidden state with the tied
``embed``. A caller that runs many steps passes
``lm.with_f32_head(params, cfg)``, which converts it to f32 once; training
passes the parameters as they are, so the gradient reaches the bf16
``embed``.

On a wide mesh (DTensor parameters placed by ``distributed/sharding.py``,
the inputs by ``batch_specs``) both stacks run as the decoder-only models
do (``models/blocks.py``, ``models/lm.py``): each layer's weights have
their ``data`` shards gathered at their use, the residual stream is
pinned batch-sharded over the data axes after every half of a block
(self-attention, cross-attention, MLP), attention runs on each rank's
local heads (cross-attention's K/V from the encoder's output, which is
batch-sharded as the decoder's stream), the token lookup goes through
``lm._vocab_lookup`` and the tied head through ``lm._logits``. The
decoder caches come back stacked over the layers, and the bundles of
``launch/steps.py`` place them by ``cache_specs_tree``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.blocks import _layer, _pinned
from repro_torch.models.layers import (apply_mlp, apply_norm, init_embedding,
                                       init_mlp, init_norm)
from repro_torch.models.tree import layer_slice, stacked_init, tree_map

Params = Dict[str, Any]

__all__ = ["init_encdec", "encode", "forward_train", "loss_fn",
           "dec_prefill", "dec_decode_step", "init_dec_cache"]


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = cfg.torch_param_dtype
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "attn": attn.init_attention(gen, cfg),
        "norm2": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = cfg.torch_param_dtype
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "self_attn": attn.init_attention(gen, cfg),
        "norm_x": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "cross_attn": attn.init_cross_attention(gen, cfg),
        "norm2": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters from ``gen``, on ``gen``'s device."""
    dtype = cfg.torch_param_dtype
    return {
        "enc_blocks": stacked_init(lambda: _init_enc_block(gen, cfg),
                                   cfg.encoder_layers),
        "enc_norm": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "dec_blocks": stacked_init(lambda: _init_dec_block(gen, cfg),
                                   cfg.n_layers),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
    }


def _n_layers(stacked: Params) -> int:
    return next(iter(stacked["norm1"].values())).shape[0]


def encode(params: Params, cfg: ModelConfig,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """enc_embeds (B, Se, d) -> the encoder's output (B, Se, d) in
    ``cfg.compute_dtype``."""
    x = _pinned(enc_embeds.to(cfg.compute_dtype))
    pos = lm._positions(cfg, x)
    stacked = params["enc_blocks"]
    for i in range(_n_layers(stacked)):
        p = _layer(stacked, i, x)
        h = apply_norm(p["norm1"], x, cfg.norm)
        x = _pinned(x + attn.attend_train(p["attn"], h, cfg, pos,
                                          causal=False))
        h = apply_norm(p["norm2"], x, cfg.norm)
        x = _pinned(x + apply_mlp(p["mlp"], h, cfg.act))
    return apply_norm(lm._top(params, x, ("enc_norm",))["enc_norm"], x,
                      cfg.norm)


def _dec_rest(p: Params, cfg: ModelConfig, x: torch.Tensor,
              enc_out: torch.Tensor, decode: bool) -> torch.Tensor:
    """A decoder block's cross-attention and MLP halves, after its
    self-attention half has been added to ``x``."""
    x = _pinned(x)
    h = apply_norm(p["norm_x"], x, cfg.norm)
    cross = attn.cross_attend_decode if decode else attn.cross_attend
    x = _pinned(x + cross(p["cross_attn"], h, enc_out, cfg))
    h = apply_norm(p["norm2"], x, cfg.norm)
    return _pinned(x + apply_mlp(p["mlp"], h, cfg.act))


def forward_train(params: Params, cfg: ModelConfig,
                  enc_embeds: torch.Tensor, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """enc_embeds (B, Se, d), tokens (B, S) -> logits (B, S, V) f32 (on
    a mesh vocab-sharded as ``lm.forward_train``'s, for the loss)."""
    enc_out = encode(params, cfg, enc_embeds)
    x = lm._embed_inputs(params, cfg, tokens, None)
    pos = lm._positions(cfg, x)
    stacked = params["dec_blocks"]
    for i in range(_n_layers(stacked)):
        p = _layer(stacked, i, x)
        h = apply_norm(p["norm1"], x, cfg.norm)
        x = x + attn.attend_train(p["self_attn"], h, cfg, pos, causal=True)
        x = _dec_rest(p, cfg, x, enc_out, decode=False)
    return lm._logits(params, cfg, x, pin=False)


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked mean next-token NLL (f32). batch: enc_embeds (B, Se, d),
    tokens (B, S), targets (B, S) with a negative target masked."""
    logits = forward_train(params, cfg, batch["enc_embeds"],
                           batch["tokens"])
    loss = lm.masked_nll(logits, batch["targets"])
    return loss, {"loss": loss, "nll": loss}


# ---------------------------------------------------------------------------
# Serving: the decoder runs incrementally over a fixed encoder output
# ---------------------------------------------------------------------------

def init_dec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   device: torch.device) -> Params:
    """Zero decoder caches ``{"k", "v"}`` (n_layers, batch, cache_len,
    Hkv, D) in ``cfg.compute_dtype``."""
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def dec_prefill(params: Params, cfg: ModelConfig, enc_out: torch.Tensor,
                tokens: torch.Tensor, cache_len: int
                ) -> Tuple[torch.Tensor, Params]:
    """tokens (B, S) over enc_out (B, Se, d) -> (logits of the last
    position (B, V) f32, decoder caches padded to ``cache_len``)."""
    x = lm._embed_inputs(params, cfg, tokens, None)
    pos = lm._positions(cfg, x)
    stacked = params["dec_blocks"]
    caches = []
    for i in range(_n_layers(stacked)):
        p = _layer(stacked, i, x)
        h = apply_norm(p["norm1"], x, cfg.norm)
        o, cache = attn.attend_prefill(p["self_attn"], h, cfg, pos,
                                       cache_len)
        caches.append(cache)
        x = _dec_rest(p, cfg, x + o, enc_out, decode=False)
    stacked_caches = tree_map(lambda *xs: torch.stack(xs), *caches)
    return lm._logits(params, cfg, x[:, -1:, :])[:, 0, :], stacked_caches


def dec_decode_step(params: Params, cfg: ModelConfig, enc_out: torch.Tensor,
                    caches: Params, token: torch.Tensor,
                    position: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token (B,) int, position (B,) int32 -> (logits (B, V) f32, caches
    written in place)."""
    x = lm._embed_inputs(params, cfg, token, None)           # (B, d)
    stacked = params["dec_blocks"]
    for i in range(_n_layers(stacked)):
        p = _layer(stacked, i, x)
        h = apply_norm(p["norm1"], x, cfg.norm)
        o, _ = attn.attend_decode(p["self_attn"], h, cfg,
                                  layer_slice(caches, i), position)
        x = _dec_rest(p, cfg, x + o, enc_out, decode=True)
    return lm._logits(params, cfg, x[:, None, :])[:, 0, :], caches
