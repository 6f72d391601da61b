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

On a mesh whose ``data`` or ``model`` axis has several ranks (``x`` a
DTensor, the parameters placed by ``distributed/sharding.py`` and
gathered by ``blocks._layer``) the layer computes what the meshless one
computes at the same ``cfg.moe_groups``, on local tensors:

* local groups (as many groups as the batch has data shards): each rank
  dispatches its own rows with the group's capacity, no tokens move;
* otherwise (one group, or groups that do not match the shards) the
  token stream is all-gathered over the data axes and every rank runs
  the meshless dispatch of every group, then keeps its own rows.

The experts follow ``sharding.ExpertLayout``. With EP a rank runs only
its own experts: with local groups each slab's rows go to their experts'
owner by one all-to-all over ``data`` and come back by another
(``collectives.all_to_all``); with the gathered stream each rank takes
its experts' rows of the slab, which every rank holds, and the outputs
are all-gathered. Without EP every rank runs every expert. The experts'
``ff`` dim is sharded over ``model``: their outputs are partial sums,
reduced over ``model`` in f32 where they come out of the last product and
then rounded once to the activations' dtype, as the meshless product
rounds; the slab's tokens enter through an identity whose backward sums
their gradient over ``model``. The combine then runs as the meshless
one on whole expert outputs.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import all_to_all
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


def _expert_ffn(experts: Params, x: torch.Tensor, act: str,
                f32_out: bool = False) -> torch.Tensor:
    """x (E, cap, d) through per-expert MLPs (E, d, ff)/(E, ff, d); the
    last product in x's dtype, or with ``f32_out`` its f32 sums
    unrounded (``sharding.mm_f32``)."""
    h = torch.bmm(x, experts["wi"].to(x.dtype))
    if act in ("swiglu", "geglu"):
        g = torch.bmm(x, experts["wg"].to(x.dtype))
        h = (F.silu(g) if act == "swiglu"
             else F.gelu(g, approximate="tanh")) * h
    else:
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    wo = experts["wo"].to(x.dtype)
    return sharding.mm_f32(h, wo) if f32_out else torch.bmm(h, wo)


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


Fn = Callable[[torch.Tensor], torch.Tensor]


def _dispatch_group(p: Params, xf: torch.Tensor, cfg: ModelConfig, cap: int,
                    ffn: Optional[Fn] = None, tp: Optional[Fn] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Capacity dispatch of one token group ``xf (t, d)``: (y (t, d),
    (load-balance aux, router z loss, dropped share)). ``ffn`` runs the
    ``(E, cap, d)`` slab through the experts (``p["experts"]`` by
    default); ``tp``, where given, is applied to the slab's source
    tokens."""
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
    xs = xf if tp is None else tp(xf)
    disp = torch.where(filled[..., None], xs[st[src]],
                       xs.new_zeros(()))                       # (E, cap, d)

    out_e = (_expert_ffn(p["experts"], disp, cfg.act) if ffn is None
             else ffn(disp))                                   # (E, cap, d)

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


def _groups(cfg: ModelConfig, B: int, T: int) -> int:
    """The dispatch groups of ``B`` rows, ``T`` tokens: ``cfg.moe_groups``,
    or one where it does not divide them."""
    G = max(cfg.moe_groups, 1)
    if T % G or (B % G and G > 1):
        G = 1
    return G


def _dispatch(p: Params, xf: torch.Tensor, cfg: ModelConfig, G: int,
              ffn: Optional[Fn] = None, tp: Optional[Fn] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``G`` groups of ``xf (T, d)`` dispatched one after the other, each
    with its own capacity; the metrics averaged over the groups."""
    T, d = xf.shape
    if G == 1:
        return _dispatch_group(p, xf, cfg, expert_capacity(T, cfg.moe),
                               ffn, tp)
    cap = expert_capacity(T // G, cfg.moe)
    outs = [_dispatch_group(p, xg, cfg, cap, ffn, tp)
            for xg in xf.reshape(G, T // G, d)]
    y = torch.cat([o[0] for o in outs])
    return y, tuple(torch.stack([o[1][i] for o in outs]).mean()
                    for i in range(3))


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y (B, S, d), aux metrics incl. load-balance loss).

    ``cfg.moe_groups > 1`` splits the token stream into that many groups
    with per-group capacity (the JAX package's data-shard-aligned groups),
    dispatched one after the other; a group count that does not divide the
    batch falls back to one group, as there. A DTensor ``x`` runs on the
    mesh (see the module's docstring).
    """
    if isinstance(x, DTensor):
        return _apply_moe_sharded(p, x, cfg)
    moe = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    y, (aux, z, dropped) = _dispatch(p, xf, cfg, _groups(cfg, B, B * S))

    if moe.num_shared:
        for i in range(moe.num_shared):
            one = {k: v[i] for k, v in p["shared"].items()}
            y = y + apply_mlp(one, xf, cfg.act)

    metrics = {"moe_aux": aux, "moe_zloss": z, "moe_drop_frac": dropped}
    return y.reshape(B, S, d), metrics


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _local_ffn(ex: Params, x: torch.Tensor, act: str, mesh,
               md: Optional[int]) -> torch.Tensor:
    """The rank's experts on ``x (E_local, rows, d)``; where their ``ff``
    dim is sharded over mesh dim ``md`` the f32 partial sums are reduced
    over it, then rounded to ``x``'s dtype."""
    if md is None:
        return _expert_ffn(ex, x, act)
    rep = [Replicate()] * mesh.ndim
    part = list(rep)
    part[md] = Partial()
    out = _expert_ffn(ex, x, act, f32_out=True)
    return DTensor.from_local(out, mesh, part, run_check=False).redistribute(
        mesh, rep).to_local().to(x.dtype)


def _ep_exchange(ffn: Fn, disp: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """EP with local groups: the slab ``(E, cap, d)`` of this rank's group
    to the experts' owners (chunk ``j`` of ``E/n`` experts to data rank
    ``j``), this rank's experts (``ffn``) over every group's rows, the
    outputs back."""
    E, cap, d = disp.shape
    el = E // n
    got = all_to_all(disp, mesh, "data").view(n, el, cap, d)
    out = ffn(got.transpose(0, 1).reshape(el, n * cap, d))
    out = out.view(el, n, cap, d).transpose(0, 1).reshape(E, cap, d)
    return all_to_all(out, mesh, "data")


def _ep_gathered(ffn: Fn, disp: torch.Tensor, mesh, dim: int
                 ) -> torch.Tensor:
    """EP on the gathered stream: every rank holds the whole slab
    ``(E, cap, d)``; it runs its experts (``ffn``) on their rows (a
    slice, whose backward all-gathers the slab's gradient) and
    all-gathers the outputs over mesh dim ``dim`` (whose backward keeps
    the rank's own experts')."""
    rep = [Replicate()] * mesh.ndim
    sh = list(rep)
    sh[dim] = Shard(0)
    mine = DTensor.from_local(disp, mesh, rep, run_check=False).redistribute(
        mesh, sh).to_local()
    out = ffn(mine)
    return sharding.from_local(out, mesh, sh, tuple(disp.shape)).redistribute(
        mesh, rep).to_local()


def _group_means(vals: torch.Tensor, mesh, dp: Sequence[int], G: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Each rank's group metrics ``vals (3,)`` gathered over the data axes
    (group order, pod-major), then averaged over the groups as the
    meshless path averages them."""
    sh = [Shard(0) if i in dp else Replicate() for i in range(mesh.ndim)]
    every = sharding.from_local(vals[None], mesh, sh, (G, 3)).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()
    return tuple(every[:, i].contiguous().mean() for i in range(3))


def _apply_moe_sharded(p: Params, x: DTensor, cfg: ModelConfig
                       ) -> Tuple[DTensor, Dict[str, DTensor]]:
    """``apply_moe`` of a DTensor ``x`` (B, S, d): batch-sharded over the
    data axes or replicated there, replicated over ``model``."""
    moe = cfg.moe
    mesh = x.device_mesh
    B, S, d = x.shape
    G = _groups(cfg, B, B * S)
    names = mesh.mesh_dim_names
    dp = [names.index(a) for a in sharding.dp_axes(mesh)]
    sharded = sharding.batch_dims(x)
    local = bool(sharded) and G == math.prod(mesh.shape[i] for i in sharded)
    ed = sharding.mesh_dim(mesh, "data")
    md = sharding.mesh_dim(mesh, "model")
    experts = p["experts"]
    lay = sharding.expert_layout(mesh, moe.num_experts)
    if md is None or not isinstance(experts["wi"].placements[md], Shard):
        md = None
    tp = sharding.grad_summed_over(mesh, md) if md is not None else None

    # with local groups every rank routes and runs its own tokens, so the
    # weights' gradients are partial sums over the data axes (an EP
    # leaf's data shard holds every group's rows of its experts)
    partial = dp if local else []
    ex = {k: sharding.local(v, [i for i in partial
                                if not (lay.ep and i == ed)])
          for k, v in experts.items()}
    q = {"router": sharding.local(p["router"], partial), "experts": ex}

    def ffn(rows: torch.Tensor) -> torch.Tensor:
        return _local_ffn(ex, rows, cfg.act, mesh, md)

    if lay.ep and local:
        slab = lambda disp: _ep_exchange(ffn, disp, mesh, lay.d)
    elif lay.ep:
        slab = lambda disp: _ep_gathered(ffn, disp, mesh, ed)
    else:
        slab = ffn

    pl = list(x.placements)
    if local:
        xl = x.to_local()
        y, m = _dispatch_group(q, xl.reshape(-1, d), cfg,
                               expert_capacity(B * S // G, moe), slab, tp)
        aux, z, dropped = _group_means(torch.stack(m), mesh, dp, G)
    else:
        for i in sharded:
            pl[i] = Replicate()
        xl = x.redistribute(mesh, pl).to_local() if sharded else x.to_local()
        y, (aux, z, dropped) = _dispatch(q, xl.reshape(B * S, d), cfg, G,
                                         slab, tp)
    out = sharding.from_local(y.view(xl.shape), mesh, pl, (B, S, d))
    if sharded and not local:
        # every rank combined every row: keep its own (a local slice)
        for i in sharded:
            pl[i] = x.placements[i]
        out = out.redistribute(mesh, pl)

    if moe.num_shared:
        for i in range(moe.num_shared):
            one = {k: v[i] for k, v in p["shared"].items()}
            out = out + apply_mlp(one, x, cfg.act)

    rep = [Replicate()] * mesh.ndim
    metrics = {k: DTensor.from_local(v, mesh, rep, run_check=False)
               for k, v in (("moe_aux", aux), ("moe_zloss", z),
                            ("moe_drop_frac", dropped))}
    return out, metrics
