"""Mixture-of-Experts: top-k router + sort-based capacity dispatch.

The port of the JAX package's ``repro.models.moe``, same parameter layout
(``router (d, E)``; ``experts``/``shared`` MLPs stacked on a leading expert
axis). Token→expert assignments are sorted by expert (a stable sort, so
each expert takes its tokens in token order), each expert processes a
fixed-capacity ``(E, cap, d)`` slab through three batched products, and
the outputs are combined with the (renormalised) router gates. Compute is
``E·cap·d·ff ≈ top_k·T·cf·d·ff``, the active parameters' FLOPs. Overflowing
assignments are dropped; a dropped token passes through the residual
stream (and the shared experts, if configured).

Where the JAX package scatters tokens into the slab (dropped ones to an
out-of-bounds row that XLA discards) and scatter-adds the expert outputs
back, the port gathers: each slab row reads the token sorted into it, and
each token reads its ``K`` expert outputs back and sums them in ascending
expert order, the order of JAX's sorted scatter-add. No index is out of
bounds, nothing adds with atomics, so the forward pass is the same on the
card in every run, and no step waits on the host.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import apply_mlp, init_linear, init_mlp

Params = Dict[str, torch.Tensor]

__all__ = ["init_moe", "apply_moe", "expert_capacity", "route"]


def expert_capacity(n_tokens: int, moe: MoEConfig) -> int:
    cap = int(math.ceil(n_tokens * moe.top_k * moe.capacity_factor
                        / moe.num_experts))
    return max(8, ((cap + 7) // 8) * 8)   # pad to a multiple of 8


def _stack_mlps(gen: torch.Generator, cfg: ModelConfig, n: int,
                dff: int) -> Params:
    """``n`` MLPs drawn one after the other into stacked tensors (no
    second copy of the weights)."""
    dtype = cfg.torch_param_dtype
    out: Params = {}
    for i in range(n):
        one = init_mlp(gen, cfg.d_model, dff, cfg.act, dtype)
        for name, w in one.items():
            if name not in out:
                out[name] = torch.empty((n,) + tuple(w.shape), dtype=dtype,
                                        device=w.device)
            out[name][i].copy_(w)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    moe = cfg.moe
    p: Params = {
        "router": init_linear(gen, cfg.d_model, moe.num_experts,
                              cfg.torch_param_dtype)["w"],
        "experts": _stack_mlps(gen, cfg, moe.num_experts, moe.d_ff_expert)}
    if moe.num_shared:
        p["shared"] = _stack_mlps(gen, cfg, moe.num_shared, moe.d_ff_expert)
    return p


def _expert_ffn(experts: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x (E, cap, d) through per-expert MLPs (E, d, ff)/(E, ff, d)."""
    h = torch.bmm(x, experts["wi"].to(x.dtype))
    if act in ("swiglu", "geglu"):
        g = torch.bmm(x, experts["wg"].to(x.dtype))
        h = (F.silu(g) if act == "swiglu"
             else F.gelu(g, approximate="tanh")) * h
    else:
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    return torch.bmm(h, experts["wo"].to(x.dtype))


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits (t, E) f32, probs, renormalised gates (t, K), expert
    indices (t, K)) of the tokens ``xf (t, d)``; the logits are the f32
    product of the activations with the router."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, eidx


def _dispatch_group(p: Params, xf: torch.Tensor, cfg: ModelConfig, cap: int
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Capacity dispatch of one token group ``xf (t, d)``: (y (t, d),
    (load-balance aux, router z loss, dropped share))."""
    moe = cfg.moe
    t, d = xf.shape
    E, K = moe.num_experts, moe.top_k
    dev = xf.device
    logits, probs, gates, eidx = route(p["router"], xf, K)

    # ---- sort assignments by expert -----------------------------------
    expert_flat = eidx.reshape(-1)                        # (t*K,)
    token_flat = torch.arange(t, device=dev).repeat_interleave(K)
    order = torch.argsort(expert_flat, stable=True)
    st = token_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, expert_flat, torch.ones_like(expert_flat))
    starts = torch.cumsum(counts, 0) - counts
    # each assignment's place in its expert's queue (the stable sort's
    # rank), put back in assignment order through ``order``
    pos_sorted = (torch.arange(t * K, device=dev)
                  - starts[expert_flat[order]])
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap

    # slab row (e, c) holds expert e's c-th assignment while c < count
    c_idx = torch.arange(cap, device=dev)
    filled = c_idx[None, :] < counts[:, None]                 # (E, cap)
    src = torch.clamp(starts[:, None] + c_idx[None, :], max=t * K - 1)
    disp = torch.where(filled[..., None], xf[st[src]],
                       xf.new_zeros(()))                       # (E, cap, d)

    out_e = _expert_ffn(p["experts"], disp, cfg.act)          # (E, cap, d)

    gathered = out_e[expert_flat, torch.clamp(pos, max=cap - 1)]
    weighted = gathered * (gates.reshape(-1) * keep.to(gates.dtype)
                           )[:, None].to(gathered.dtype)
    # a token's K contributions, summed in ascending expert order
    by_expert = torch.argsort(eidx, dim=1)
    w = torch.gather(weighted.view(t, K, d), 1,
                     by_expert[..., None].expand(t, K, d))
    y = w[:, 0]
    for k in range(1, K):
        y = y + w[:, k]

    # ---- aux losses (Switch-style load balance + router z-loss) --------
    f = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx[:, 0], torch.ones(t, dtype=torch.float32, device=dev)) / t
    pmean = probs.mean(0)
    aux = E * torch.sum(f * pmean)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = torch.sum(1.0 - keep.float()) / (t * K)
    return y, (aux, z, dropped)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y (B, S, d), aux metrics incl. load-balance loss).

    ``cfg.moe_groups > 1`` splits the token stream into that many groups
    with per-group capacity (the JAX package's data-shard-aligned groups),
    dispatched one after the other; a group count that does not divide the
    batch falls back to one group, as there.
    """
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    G = max(cfg.moe_groups, 1)
    if T % G or (B % G and G > 1):
        G = 1
    xf = x.reshape(T, d)

    if G == 1:
        y, (aux, z, dropped) = _dispatch_group(
            p, xf, cfg, expert_capacity(T, moe))
    else:
        cap = expert_capacity(T // G, moe)
        outs = [_dispatch_group(p, xg, cfg, cap)
                for xg in xf.reshape(G, T // G, d)]
        y = torch.cat([o[0] for o in outs])
        aux, z, dropped = (torch.stack([o[1][i] for o in outs]).mean()
                           for i in range(3))

    if moe.num_shared:
        for i in range(moe.num_shared):
            one = {k: v[i] for k, v in p["shared"].items()}
            y = y + apply_mlp(one, xf, cfg.act)

    metrics = {"moe_aux": aux, "moe_zloss": z, "moe_drop_frac": dropped}
    return y.reshape(B, S, d), metrics
