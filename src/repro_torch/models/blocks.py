"""Decoder blocks and their per-pattern-position stacking.

Block kinds are two-character tokens ``<mixer><ffn>`` (as in the JAX
package's ``repro.models.blocks``):

    mixer:  'a' = GQA attention, 'm' = Mamba-2 SSD
    ffn:    'd' = dense MLP, 'e' = MoE, '-' = none (pure mixer block)

e.g. qwen2 = ('ad',), mamba2 = ('m-',), mixtral = ('ae',), jamba's period-8
pattern = ('md','me','md','me','ad','me','md','me').

Layers are stacked as in the JAX package: for a pattern of period R over L
layers, the params (and caches) of pattern position r are stacked along a
leading ``L/R`` axis, so parameters and caches carry across one to one.
Where the JAX package runs one ``lax.scan`` over the stack, the port loops
over layers in Python and hands each block views of its slice.

Training (``run_blocks_train``) rematerialises each super-block as
``cfg.remat`` says, as the JAX package's ``jax.checkpoint`` does: ``full``
keeps only the block's input and recomputes the rest in the backward pass;
``dots`` also keeps the outputs of the matrix products
(``checkpoint_dots``), through a selective checkpoint. The recompute
routes every token to the experts the forward pass chose: the routing is
a function of the block's input alone.

On a wide mesh (DTensor activations and parameters placed by
``distributed/sharding.py``; every block kind) each layer's weights have
their ``data`` shards gathered at their use (``sharding.fsdp_gather``;
an EP expert leaf keeps its expert shard), and the residual stream is
pinned batch-sharded over the data axes (``sharding.pin_dp``) after the
mixer and after the feed-forward half, so that no half starts from a
partial sum over ``model``. The mixers run on local tensors (attention
on local heads, the SSD on local heads and channel chunks), their
collectives DTensor redistributions that the selective checkpoint of
``dots`` recomputes in the backward pass like any op that is not a
matrix product.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import fsdp_gather, pin_dp
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm)
from repro_torch.models.tree import (layer_slice, stacked_init,
                                     tree_map)

Params = Dict[str, Any]

__all__ = ["init_block", "init_stacked_blocks", "block_train",
           "block_prefill", "block_decode", "run_blocks_train",
           "run_blocks_prefill", "run_blocks_decode", "init_block_cache",
           "normalize_pattern"]


def normalize_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    """Expand legacy one-char tokens to <mixer><ffn> form."""
    out = []
    for t in cfg.pattern:
        if len(t) == 1:
            if t == "a":
                out.append("ae" if cfg.moe else "ad")
            elif t == "m":
                out.append("m-")
            else:
                raise ValueError(f"bad pattern token {t!r}")
        else:
            out.append(t)
    return tuple(out)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, token: str) -> Params:
    mixer, ffn = token[0], token[1]
    dtype = cfg.torch_param_dtype
    p: Params = {"norm1": init_norm(cfg.d_model, cfg.norm, dtype, gen.device)}
    if mixer == "a":
        p["attn"] = attn.init_attention(gen, cfg)
    else:
        p["mamba"] = ssm.init_mamba(gen, cfg)
    if ffn == "d":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    elif ffn == "e":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        p["moe"] = moe_mod.init_moe(gen, cfg)
    return p


def _ffn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, token: str
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The block's feed-forward half: (x, MoE metrics — none for 'd' and
    '-')."""
    ffn = token[1]
    if ffn == "-":
        return x, {}
    h = apply_norm(p["norm2"], x, cfg.norm)
    if ffn == "d":
        return x + apply_mlp(p["mlp"], h, cfg.act), {}
    y, metrics = moe_mod.apply_moe(p["moe"], h, cfg)
    return x + y, metrics


def block_train(p: Params, x: torch.Tensor, cfg: ModelConfig, token: str,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block's training forward: (x, MoE metrics)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if token[0] == "a":
        x = x + attn.attend_train(p["attn"], h, cfg, positions)
    else:
        x = x + ssm.mamba_train(p["mamba"], h, cfg)
    x, metrics = _ffn_apply(p, _pinned(x), cfg, token)
    return _pinned(x), metrics


def block_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, token: str,
                  positions: torch.Tensor, cache_len: int
                  ) -> Tuple[torch.Tensor, Params]:
    """A prompt through one block: (x, its cache — the KV cache of
    ``attention.ring_len(cfg, cache_len)`` slots, or the Mamba block's
    conv tail and final SSD state)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if token[0] == "a":
        o, cache = attn.attend_prefill(p["attn"], h, cfg, positions,
                                       cache_len)
    else:
        o, cache = ssm.mamba_prefill(p["mamba"], h, cfg)
    x, _ = _ffn_apply(p, _pinned(x + o), cfg, token)
    return _pinned(x), cache


def block_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, token: str,
                 cache: Params, position: torch.Tensor
                 ) -> Tuple[torch.Tensor, Params]:
    """x (B, d) single token; ``cache`` is updated in place. The MoE takes
    the whole batch as one (B, 1, d) call, so every slot's token, an idle
    slot's too, takes expert capacity, as in the JAX package."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if token[0] == "a":
        o, cache = attn.attend_decode(p["attn"], h, cfg, cache, position)
    else:
        o, cache = ssm.mamba_decode(p["mamba"], h, cfg, cache)
    x2, _ = _ffn_apply(p, _pinned(x + o)[:, None, :], cfg, token)
    return _pinned(x2[:, 0, :]), cache


def _zero(x: torch.Tensor) -> torch.Tensor:
    """An f32 zero, replicated on ``x``'s mesh when ``x`` is a DTensor."""
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    if isinstance(x, DTensor):
        return DTensor.from_local(z, x.device_mesh,
                                  [Replicate()] * x.device_mesh.ndim,
                                  run_check=False)
    return z


def _pinned(x: torch.Tensor) -> torch.Tensor:
    return pin_dp(x) if isinstance(x, DTensor) else x


def _layer(stacked: Any, i: int, x: torch.Tensor) -> Any:
    """Layer ``i`` of stacked parameters (one tree, or a tuple of them,
    one per pattern position); on a wide mesh with their ``data`` shards
    gathered."""
    layer = layer_slice(stacked, i)
    return fsdp_gather(layer) if isinstance(x, DTensor) else layer


def init_block_cache(cfg: ModelConfig, token: str, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    if token[0] != "a":
        return ssm.init_mamba_cache(cfg, batch, dtype, device)
    shape = (batch, attn.ring_len(cfg, cache_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------

def init_stacked_blocks(gen: torch.Generator, cfg: ModelConfig
                        ) -> Tuple[Params, ...]:
    """Per-pattern-position stacked params: a tuple of length R, each a
    tree with leading axis reps = n_layers / R. Layers are drawn in order
    into a preallocated stack (no second copy of the weights)."""
    pattern = normalize_pattern(cfg)
    reps = cfg.n_layers // len(pattern)
    return tuple(stacked_init(lambda: init_block(gen, cfg, token), reps)
                 for token in pattern)


def _reps(stacked: Tuple[Params, ...]) -> int:
    return next(iter(stacked[0]["norm1"].values())).shape[0]


# matrix products at the dispatcher level: what ``checkpoint_dots`` keeps
_DOTS = frozenset(op for op in (
    getattr(torch.ops.aten, n, None) for n in (
        "mm", "bmm", "addmm", "baddbmm", "matmul", "linear", "dot"))
    if op is not None)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    del ctx, args, kwargs
    packet = getattr(op, "overloadpacket", op)
    return (CheckpointPolicy.MUST_SAVE if packet in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``cfg.remat``: ``none`` as it is, ``full`` under a
    checkpoint that keeps its inputs only, ``dots`` under a selective
    checkpoint that also keeps every matrix product's output."""
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    if cfg.remat != "none":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn


def run_blocks_train(stacked: Tuple[Params, ...], x: torch.Tensor,
                     cfg: ModelConfig, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every layer's training forward: (x, the MoE load-balance and
    router z losses summed over the layers — zero without MoE blocks)."""
    pattern = normalize_pattern(cfg)

    def superblock(x, layer_params):
        aux = zl = _zero(x)
        for r, token in enumerate(pattern):
            x, m = block_train(layer_params[r], x, cfg, token, positions)
            if "moe_aux" in m:
                aux = aux + m["moe_aux"]
                zl = zl + m["moe_zloss"]
        return x, aux, zl

    body = _maybe_remat(superblock, cfg)
    auxs, zls = [], []
    for i in range(_reps(stacked)):
        x, aux, zl = body(x, _layer(stacked, i, x))
        auxs.append(aux)
        zls.append(zl)
    return x, {"moe_aux": torch.stack(auxs).sum(),
               "moe_zloss": torch.stack(zls).sum()}


def run_blocks_prefill(stacked: Tuple[Params, ...], x: torch.Tensor,
                       cfg: ModelConfig, positions: torch.Tensor,
                       cache_len: int) -> Tuple[torch.Tensor, Tuple]:
    """Returns (x, caches): a tuple of per-position caches stacked on the
    reps axis."""
    pattern = normalize_pattern(cfg)
    per_layer = []
    for i in range(_reps(stacked)):
        caches = []
        layer = _layer(stacked, i, x)
        for r, token in enumerate(pattern):
            x, c = block_prefill(layer[r], x, cfg, token, positions,
                                 cache_len)
            caches.append(c)
        per_layer.append(caches)
    caches = tuple(
        tree_map(lambda *xs: torch.stack(xs), *(cs[r] for cs in per_layer))
        for r in range(len(pattern)))
    return x, caches


def run_blocks_decode(stacked: Tuple[Params, ...], x: torch.Tensor,
                      cfg: ModelConfig, caches: Tuple, position: torch.Tensor
                      ) -> Tuple[torch.Tensor, Tuple]:
    """One token through every layer; ``caches`` are written in place and
    returned."""
    pattern = normalize_pattern(cfg)
    for i in range(_reps(stacked)):
        layer = _layer(stacked, i, x)
        for r, token in enumerate(pattern):
            x, _ = block_decode(layer[r], x, cfg, token,
                                layer_slice(caches[r], i), position)
    return x, caches
