"""Decoder-only language model: embed → stacked blocks → norm → logits.

Entry points (as in the JAX package's ``repro.models.lm``, same parameter
and cache layouts):

    init_lm(gen, cfg)                         -> params
    forward_train(params, cfg, tokens, ...)   -> (logits, aux)
    loss_fn(params, cfg, batch)               -> (loss, metrics)
    prefill(params, cfg, tokens, cache_len)   -> (last_logits, caches)
    decode_step(params, cfg, caches, token, position) -> (logits, caches)
    init_cache(cfg, batch, cache_len, device) -> zero caches

``decode_step`` writes the caches in place (and returns them). Logits are
f32, from the f32 product of the final hidden state with the head; a caller
that runs many steps passes ``with_f32_head(params, cfg)``, which converts
the head to f32 once instead of on every call. Training passes the
parameters as they are: the head is converted inside the graph, so its
gradient reaches the bf16 ``embed``/``lm_head``.

Every decoder-only block kind runs: attention or Mamba-2 mixers with a
dense, MoE or no feed-forward half (``models/blocks.py``); the caches are
``{k, v}`` for attention layers and ``{conv, ssm}`` for Mamba layers. The
[vlm]/[audio] archs prepend stub frontend embeddings (``models/frontend.py``:
precomputed patch / frame vectors) to the token embeddings; the loss is
masked to the token positions. The encoder-decoder models run in
``models/encdec.py``; this module's entry points refuse them
(``check_supported``).

With DTensor parameters and inputs on a wide mesh (every decoder-only
family, ``launch/steps.py``) the embedding and the head (the tied
embedding, or its own) have their ``data`` shards gathered at their use,
a frontend's embeddings are batch-sharded as the tokens and put ahead of
them, the positions (text positions over the whole sequence, M-RoPE's
three streams expanded on each rank's local rows) are placed as the
batch. Serving gathers the logits' vocab dim (sharded over ``model``)
before the caller reads them. Training does not: ``forward_train``
returns the logits as the head's product leaves them (rows over the data
axes, vocab columns over ``model``) and ``masked_nll`` runs a
vocab-parallel cross entropy on each rank's own piece (``_VocabNLL``), as
GSPMD partitions the JAX package's loss.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import blocks as B
from repro_torch.models.layers import (apply_norm, init_embedding, init_norm,
                                       matmul, mrope_positions_text)
from repro_torch.models.tree import tree_map

Params = Dict[str, Any]

__all__ = ["init_lm", "forward_train", "loss_fn", "prefill", "decode_step",
           "init_cache", "cache_specs", "with_f32_head", "check_supported",
           "masked_nll"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an encoder-decoder config: this module's functions would
    build the wrong model for it."""
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: models.encdec runs it "
            f"(launch.steps.init_params dispatches on cfg.is_encdec), not "
            f"the decoder-only models.lm")


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


def _positions(cfg: ModelConfig, x: torch.Tensor, offset: int = 0
               ) -> torch.Tensor:
    """Text positions (B, S) of the activations ``x`` (B, S, d), placed as
    ``x`` is when it is a DTensor."""
    B_, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    pos = (pos + offset).expand(B_, S)
    if isinstance(x, DTensor):
        return sharding.like(pos.contiguous(), x)
    if cfg.mrope_sections is not None:
        return mrope_positions_text(pos)
    return pos


def _top(params: Params, x: torch.Tensor, names: Tuple[str, ...]
         ) -> Params:
    """The top-level leaves ``names`` (the embedding, final norm or
    head), with their ``data`` shards gathered when ``x`` is a DTensor:
    only those a use needs, since a vocab table is the largest gather."""
    top = {k: params[k] for k in names}
    return sharding.fsdp_gather(top) if isinstance(x, DTensor) else top


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    # gather first, then convert: the same values as converting the table.
    # F.embedding's backward sums each row's gradient in a fixed order on
    # the card (an indexed gather's would use atomics)
    table = _top(params, tokens, ("embed",))["embed"]
    if isinstance(tokens, DTensor):
        x = sharding.pin_dp(_vocab_lookup(tokens, table)
                            .to(cfg.compute_dtype))
        if embeds is None:
            return x
        # the frontend's embeddings batch-sharded as the tokens are
        embeds = (sharding.pin_dp(embeds) if isinstance(embeds, DTensor)
                  else sharding.like(embeds, x))
        return torch.cat([embeds.to(cfg.compute_dtype), x], dim=1)
    x = F.embedding(tokens.long(), table).to(cfg.compute_dtype)
    if embeds is not None:
        x = torch.cat([embeds.to(cfg.compute_dtype), x], dim=1)
    return x


def _vocab_lookup(tokens: DTensor, table: DTensor) -> DTensor:
    """``F.embedding`` of a DTensor table whose vocab rows may be
    ``Shard`` over ``model``: each rank looks up the tokens its rows hold
    and zeros the rest, a partial sum over ``model`` (the exact row, plus
    zeros). Its backward scatters into the rank's own rows only."""
    mesh = table.device_mesh
    d = sharding.mesh_dim(mesh, "model")
    pl = list(tokens.placements)
    tl = tokens.to_local().long()
    if d is None or not isinstance(table.placements[d], Shard):
        table = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    # the rows' gradient: partial over the mesh dims the batch is split on
    grad_pl = [Partial() if isinstance(b, Shard) else t
               for b, t in zip(tokens.placements, table.placements)]
    rows = table.to_local(grad_placements=grad_pl)
    if d is None or not isinstance(table.placements[d], Shard):
        return DTensor.from_local(F.embedding(tl, rows), mesh, pl,
                                  run_check=False)
    lo = sharding.model_rank(mesh) * rows.shape[0]
    inside = (tl >= lo) & (tl < lo + rows.shape[0])
    y = F.embedding((tl - lo).clamp(0, rows.shape[0] - 1), rows)
    y = y * inside[..., None].to(y.dtype)
    pl[d] = Partial()
    return DTensor.from_local(y, mesh, pl, run_check=False)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            pin: bool = True) -> torch.Tensor:
    """f32 logits of the final hidden state ``x``; on a mesh pinned to
    ``pin_dp``'s layout (the vocab whole on every rank) unless ``pin`` is
    False, which keeps the vocab ``Shard`` over ``model`` for the loss."""
    head = ("head_f32" if "head_f32" in params
            else "embed" if cfg.tie_embeddings else "lm_head")
    top = _top(params, x, ("final_norm", head))
    x = apply_norm(top["final_norm"], x, cfg.norm)
    w = top[head]
    if not pin and isinstance(w, DTensor):
        w = _vocab_split(w)
    logits = matmul(x.float(), w.float().T)
    if pin and isinstance(logits, DTensor):
        return sharding.pin_dp(logits)
    return logits


def _vocab_split(w: DTensor) -> DTensor:
    """The head ``w`` (V, d) with its vocab rows ``Shard`` over ``model``
    where the rule tables replicate them because ``model`` does not
    divide V (granite, mamba2, seamless at 16): each rank takes its
    ``torch.chunk`` of the rows, with no communication, so that the
    loss's logits are a vocab piece there too; the rows' gradient is
    gathered back over ``model``. Where a chunk would be empty the head
    stays replicated."""
    mesh = w.device_mesh
    d = sharding.mesh_dim(mesh, "model")
    if d is None or not isinstance(w.placements[d], Replicate):
        return w
    m, V = mesh.size(d), w.shape[0]
    if m == 1 or -(-V // m) * (m - 1) >= V:
        return w
    pl = list(w.placements)
    pl[d] = Shard(0)
    return w.redistribute(mesh, pl)


def forward_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, S_txt) [+ embeds (B, F, d)] -> logits (B, S, V) f32
    (on a mesh with the vocab dim ``Shard`` over ``model`` where the rule
    tables shard the head: ``full_tensor()`` gives the whole)."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, tokens, embeds)
    x, aux = B.run_blocks_train(params["blocks"], x, cfg, _positions(cfg, x))
    return _logits(params, cfg, x, pin=False), aux


def masked_nll(logits: torch.Tensor, targets: torch.Tensor
               ) -> torch.Tensor:
    """Mean next-token NLL of f32 ``logits`` (B, S, V) over the targets
    (B, S) that are not negative. DTensor logits take the vocab-parallel
    path (``_vocab_nll``): nothing is gathered."""
    if isinstance(logits, DTensor):
        return _vocab_nll(logits, targets)
    mask = (targets >= 0).to(torch.float32)
    tgt = targets.clamp(min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _reduced(t: torch.Tensor, mesh, pl: list, dims: list, op: str
             ) -> torch.Tensor:
    """Every rank's ``t`` (local, placed as ``pl`` elsewhere) reduced by
    ``op`` over the mesh dims ``dims``: a DTensor ``Partial(op)`` brought
    to ``Replicate``, so that the collective is DTensor's own (carried by
    ``gloo_cuda`` on the card, counted by the dry run)."""
    if not dims:
        return t
    src = [Partial(op) if i in dims else p for i, p in enumerate(pl)]
    dst = [Replicate() if i in dims else p for i, p in enumerate(pl)]
    return DTensor.from_local(t, mesh, src, run_check=False).redistribute(
        mesh, dst).to_local()


class _VocabNLL(torch.autograd.Function):
    """``masked_nll`` on one rank's piece ``x`` (b, S, v) of the logits:
    its rows (a share of the batch over the mesh dims ``rows``) and its
    vocab columns ``[lo, lo + v)`` (all of them where ``vocab`` is None).
    The row max, the sum of ``exp(x - max)`` and the gold logit are
    reduced over ``vocab`` (b·S f32 each), the masked sum and the mask
    count over ``rows``. The backward is local: ``(softmax - onehot) ·
    mask · g / count`` on the rank's columns, from ``lse``, the mask and
    the targets it saves beside ``x``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, targets: torch.Tensor, mesh,
                pl: list, rows: list, vocab: Optional[int], lo: int
                ) -> torch.Tensor:
        col = targets.clamp(min=0).long() - lo
        inside = (col >= 0) & (col < x.shape[-1])
        col = col.clamp(0, x.shape[-1] - 1)
        over = [vocab] if vocab is not None else []
        m = _reduced(x.amax(-1), mesh, pl, over, "max")
        e = x - m[..., None]
        s = _reduced(e.exp_().sum(-1), mesh, pl, over, "sum")
        del e
        lse = m + s.log()
        gold = torch.gather(x, -1, col[..., None])[..., 0]
        gold = _reduced(gold * inside.to(x.dtype), mesh, pl, over, "sum")
        mask = (targets >= 0).to(x.dtype)
        tot = torch.stack([((lse - gold) * mask).sum(), mask.sum()])
        tot = _reduced(tot, mesh, [Replicate()] * mesh.ndim, rows, "sum")
        count = torch.clamp(tot[1], min=1.0)
        ctx.save_for_backward(x, lse, mask, targets, count)
        ctx.lo = lo
        return tot[0] / count

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, lse, mask, targets, count = ctx.saved_tensors
        col = targets.clamp(min=0).long() - ctx.lo
        inside = (col >= 0) & (col < x.shape[-1])
        grad = x - lse[..., None]
        grad.exp_()
        grad.scatter_add_(-1, col.clamp(0, x.shape[-1] - 1)[..., None],
                          -inside[..., None].to(grad.dtype))
        grad.mul_((mask * (g / count))[..., None])
        return grad, None, None, None, None, None, None


def _vocab_nll(logits: DTensor, targets: DTensor) -> DTensor:
    """``masked_nll`` of DTensor logits as the head's product leaves
    them (see ``_VocabNLL``): on each mesh dim the batch's rows
    ``Shard``, the vocab ``Shard`` over ``model``, or replicated. The
    targets are placed as the rows. The loss comes back replicated."""
    mesh, last = logits.device_mesh, logits.dim() - 1
    md = sharding.mesh_dim(mesh, "model")
    pl = list(logits.placements)
    for i, p in enumerate(pl):
        if not (isinstance(p, Replicate) or p == Shard(0)
                or (i == md and p == Shard(last))):
            raise ValueError(f"masked_nll of logits placed as {tuple(pl)}")
    tpl = [p if p == Shard(0) else Replicate() for p in pl]
    targets = targets.redistribute(mesh, tpl).to_local()
    wide = [i for i in range(mesh.ndim) if mesh.size(i) > 1]
    rows = [i for i in wide if tpl[i] == Shard(0)]
    vocab = md if md in wide and pl[md] != tpl[md] else None
    lo = 0
    if vocab is not None:
        lo = mesh.get_local_rank(vocab) * -(-logits.shape[-1]
                                            // mesh.size(vocab))
    loss = _VocabNLL.apply(logits.to_local(), targets, mesh, tpl, rows,
                           vocab, lo)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (f32), the MoE aux losses folded in.

    batch: tokens (B, S_txt), targets (B, S_txt) with -100 = masked,
    optional embeds (B, F, d_model)."""
    tokens = batch["tokens"]
    targets = batch["targets"]
    embeds = batch.get("embeds")
    logits, aux = forward_train(params, cfg, tokens, embeds)
    if embeds is not None:
        logits = logits[:, embeds.shape[1]:, :]   # loss on text positions
    loss = masked_nll(logits, targets)
    metrics = {"nll": loss}
    if cfg.moe is not None:
        loss = (loss + cfg.moe.aux_coef * aux["moe_aux"] / cfg.n_layers
                + cfg.moe.router_z_coef * aux["moe_zloss"] / cfg.n_layers)
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Tuple]:
    """tokens (B, S) -> (logits of the last position (B, V) f32, caches
    padded to ``cache_len``)."""
    x = _embed_inputs(params, cfg, tokens, embeds)
    x, caches = B.run_blocks_prefill(params["blocks"], x, cfg,
                                     _positions(cfg, x), cache_len)
    return _logits(params, cfg, x[:, -1:, :])[:, 0, :], caches


def decode_step(params: Params, cfg: ModelConfig, caches: Tuple,
                token: torch.Tensor, position: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple]:
    """token (B,) int; position (B,) int32 -> (logits (B, V) f32, caches
    written in place)."""
    x = _embed_inputs(params, cfg, token, None)             # (B, d)
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


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Tuple:
    """``init_cache``'s tree on the ``meta`` device (no allocation)."""
    return init_cache(cfg, batch, cache_len, torch.device("meta"))
