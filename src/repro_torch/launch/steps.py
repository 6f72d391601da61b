"""Model-agnostic step factories: one place that turns a ``ModelConfig``
into the ``train_step`` / ``prefill_step`` / ``serve_step`` functions the
trainer and the serving runtime call, plus their input, parameter,
optimizer and cache sharding specs (the JAX package's
``repro.launch.steps``).

* ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
  with optional gradient accumulation (``accum`` microbatches) and
  optional int8-compressed cross-pod gradient reduce.
* ``prefill_step(params, tokens[, embeds]) -> (last_logits, caches)``;
  for an encoder-decoder ``prefill_step(params, enc_embeds, tokens)``.
* ``serve_step(params, caches, token, position[, enc_out])
  -> (logits, caches)`` — one decode token against the KV/SSM cache,
  which it writes in place.
* Non-finite-gradient guard: a step whose global grad norm is non-finite
  applies no update (params and optimizer state come back unchanged) and
  reports ``skipped = 1``.

PyTorch runs eagerly, so the steps are plain functions. On a
``DeviceMesh`` whose ``data`` or ``model`` axis has several ranks the
parameters and optimizer state are DTensors placed by
``distributed/sharding.py``'s rules (``TrainLoop`` places them), and the
step computes the unsharded step's maths on them, as GSPMD does in JAX:
the batch sharded over ``("pod", "data")``, each weight's ``data`` shards
gathered at its use (FSDP), heads, FFN hidden and vocab over ``model``
(TP), the experts over ``data`` where it divides them (EP,
``models/moe.py``), every gradient brought back to its parameter's
placements before AdamW, the Mamba-2 blocks on local heads and channel
chunks (``models/ssm.py``). Every registered config runs there: each
decoder-only family, a vision frontend's embeddings with it, and the
encoder-decoder (``models/encdec.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (ModelConfig, ShapeSpec, input_specs,
                                      shape_spec)
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import (axis_size,
                                                 crosspod_grad_mean,
                                                 psum_int8)
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              batch_specs, cache_specs_tree,
                                              opt_specs, param_specs)
from repro_torch.models import encdec, lm
from repro_torch.models.tree import (tree_flatten_with_path, tree_map,
                                     tree_unflatten)
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update)

__all__ = ["init_params", "params_struct", "opt_struct", "cache_struct",
           "make_train_step", "make_prefill_step",
           "make_serve_step", "StepBundle", "build_step_bundle"]


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    if cfg.is_encdec:
        return encdec.init_encdec(gen, cfg)
    return lm.init_lm(gen, cfg)


def _meta(tree: Any) -> Any:
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def params_struct(cfg: ModelConfig) -> Any:
    """The parameter tree on the ``meta`` device (no allocation): shapes
    and dtypes from ``init_params`` run under a fake-tensor mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return _meta(init_params(torch.Generator(), cfg))


def opt_struct(cfg: ModelConfig, opt_cfg: AdamWConfig) -> OptState:
    """``adamw_init``'s state of ``params_struct`` on ``meta``."""
    return adamw_init(params_struct(cfg), opt_cfg)


def cache_struct(cfg: ModelConfig, batch: int, cache_len: int) -> Any:
    """The serving cache tree on ``meta``."""
    if cfg.is_encdec:
        return encdec.init_dec_cache(cfg, batch, cache_len,
                                     torch.device("meta"))
    return lm.cache_specs(cfg, batch, cache_len)


def _value_and_grad(params: Any, cfg: ModelConfig,
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, f32 grads shaped like ``params``). The parameters
    are taken as fresh leaves sharing their storage, so the caller's
    tensors gain no ``grad`` and no graph. A DTensor parameter's gradient
    comes back in the parameter's placements (autograd may leave it
    partial or replicated)."""
    loss_fn = encdec.loss_fn if cfg.is_encdec else lm.loss_fn
    flat = tree_flatten_with_path(params)
    leaves = [p.detach().requires_grad_() for _, p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(p, DTensor) else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, [g.to(torch.float32) for g in grads]))


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor as the full tensor every rank reads alike."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _select(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """Each leaf of ``new`` where ``ok`` (a boolean scalar on the
    device), else ``old``'s, leaf by leaf; a DTensor pair (AdamW keeps
    each leaf's placements) selects on its local pieces."""

    def pick(n: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        if not isinstance(o, DTensor):
            return torch.where(ok, n, o)
        return DTensor.from_local(torch.where(ok, n.to_local(),
                                              o.to_local()),
                                  o.device_mesh, o.placements,
                                  run_check=False, shape=o.shape,
                                  stride=o.stride())

    return tree_unflatten(old, [
        pick(n, o) for (_, n), (_, o) in zip(tree_flatten_with_path(new),
                                             tree_flatten_with_path(old))])


def _pod_of(mesh) -> Optional[Tuple[Any, int, int]]:
    """(the ``pod`` axis's process group, its ranks, this rank's pod
    coordinate), or None for a mesh without a ``pod`` axis."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return None
    return (mesh.get_group("pod"), axis_size(mesh, "pod"),
            mesh.get_local_rank("pod"))


def _pod_rows(batch: Dict[str, torch.Tensor], npods: int, r: int
              ) -> Dict[str, torch.Tensor]:
    """Pod ``r``'s rows ``[r·B/n, (r+1)·B/n)`` of the global batch."""
    b = next(iter(batch.values())).shape[0]
    if b % npods:
        raise ValueError(f"batch {b} not divisible by {npods} pods")
    lo, hi = r * b // npods, (r + 1) * b // npods
    return {k: v[lo:hi] for k, v in batch.items()}


def _pod_mean(loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
              group, npods: int):
    """The loss and the metrics averaged over the pod group: one f32
    all-reduce, then / npods."""
    names = sorted(metrics)
    vals = torch.stack([loss.float()] + [metrics[k].float() for k in names])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    vals = vals / npods
    return vals[0], {k: vals[i + 1] for i, k in enumerate(names)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    accum: int = 1, mesh=None,
                    compress_crosspod: bool = False,
                    rules: ShardingRules = DEFAULT_RULES) -> Callable:
    """Builds ``train_step(params, opt_state, batch)``.

    ``accum > 1`` splits the leading batch dim into microbatches, run one
    after the other, accumulating f32 gradients — activation memory drops
    ~accum-fold while FLOPs stay. Every rank is given the global batch.

    On a ``DeviceMesh`` whose ``data`` or ``model`` axis has several
    ranks, ``params`` and ``opt_state`` are DTensors placed by
    ``param_specs`` / ``opt_specs`` (``sharding.distribute``); each
    microbatch is sharded by ``batch_specs`` (each rank keeping its own
    rows, no communication), and the step returns parameters and state in
    the same placements, with metrics every rank reads alike. A ``pod``
    axis composes with ``data`` for the batch; with
    ``compress_crosspod`` each pod computes its gradients on its
    ``(data, model)`` submesh and the pods reduce them with the int8
    collective (one scale per tensor, its amax over the whole tensor on
    every pod, as JAX's ``psum_int8`` under ``shard_map`` takes it).

    On a mesh whose only wide axis is ``pod`` (one rank per pod) the step
    is data parallel over it: each rank takes its pod's rows, averages
    its f32 gradients over the pod group (``crosspod_grad_mean``: an f32
    all-reduce, or with ``compress_crosspod`` the int8 one) and the loss
    and the metrics, and applies the same AdamW update. Without a mesh or
    a ``pod`` axis ``compress_crosspod`` is the plain step, as in the JAX
    package."""
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    wide = mesh is not None and sharding.is_wide(mesh, rules)
    pod = _pod_of(mesh) if mesh is not None else None

    def grads_of(params, batch, place=lambda mb: mb, step_cfg=cfg):
        """Gradients of ``place(microbatch)`` for each microbatch of the
        global ``batch``, the model run under ``step_cfg``."""
        if accum == 1:
            loss, metrics, grads = _value_and_grad(params, step_cfg,
                                                   place(batch))
            return grads, loss, metrics
        b = next(iter(batch.values())).shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum {accum}")
        g_sum = l_sum = None
        m_all = []
        for i in range(accum):
            mb = {k: v.reshape((accum, b // accum) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss, metrics, g = _value_and_grad(params, step_cfg, place(mb))
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
        # non-finite guard: no update, the old state kept, selected on
        # the device as JAX's jnp.where does (no host sync); on a mesh
        # the norm is a full reduction, so every rank selects alike
        gnorm = om.get("grad_norm")
        if gnorm is None:
            om["skipped"] = torch.zeros((), device=loss.device)
        else:
            ok = torch.isfinite(_plain(gnorm))
            new_p = _select(ok, new_p, params)
            new_s = _select(ok, new_s, opt_state)
            om["skipped"] = (~ok).float()
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return new_p, new_s, {k: _plain(v) for k, v in metrics.items()}

    if wide:
        return _sharded_train_step(cfg, mesh, rules, pod, compress_crosspod,
                                   grads_of, apply_update)

    if pod is None:
        def train_step(params, opt_state: OptState, batch):
            grads, loss, metrics = grads_of(params, batch)
            return apply_update(params, opt_state, grads, loss, metrics)

        return train_step

    # ---- data parallel over the pod axis ----------------------------------
    group, npods, r = pod

    def train_step(params, opt_state: OptState, batch):
        grads, loss, metrics = grads_of(params, _pod_rows(batch, npods, r))
        grads = crosspod_grad_mean(grads, mesh, compress=compress_crosspod)
        loss, metrics = _pod_mean(loss, metrics, group, npods)
        return apply_update(params, opt_state, grads, loss, metrics)

    return train_step


def _sharded_train_step(cfg: ModelConfig, mesh, rules: ShardingRules, pod,
                        compress: bool, grads_of, apply_update) -> Callable:
    """``make_train_step`` on a mesh whose ``data`` or ``model`` axis has
    several ranks (see there)."""

    def placer(m):
        def place(mb):
            b = next(iter(mb.values())).shape[0]
            specs = batch_specs(cfg, m, "train", b, rules)
            return sharding.distribute(mb, m, {k: specs[k] for k in mb})
        return place

    def global_batch(batch):
        return {k: _plain(v) for k, v in batch.items()}

    if pod is None or not compress:
        place = placer(mesh)

        def train_step(params, opt_state: OptState, batch):
            grads, loss, metrics = grads_of(params, global_batch(batch),
                                            place)
            return apply_update(params, opt_state, grads, loss, metrics)

        return train_step

    # ---- per-pod gradients on the (data, model) submesh, int8 pod reduce
    group, npods, r = pod
    names = mesh.mesh_dim_names
    ipod = names.index("pod")
    sub = mesh[tuple(n for n in names if n != "pod")]
    place = placer(sub)
    # each pod's step runs on the submesh, which has no pod axis: the
    # activation pins name the axes it has (JAX's cfg_local)
    cfg_local = dataclasses.replace(
        cfg, act_dp=tuple(a for a in cfg.act_dp if a != "pod"))

    def to_sub(t: DTensor) -> DTensor:
        pl = tuple(p for i, p in enumerate(t.placements) if i != ipod)
        return DTensor.from_local(t.to_local(), sub, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def train_step(params, opt_state: OptState, batch):
        batch = _pod_rows(global_batch(batch), npods, r)
        grads, loss, metrics = grads_of(tree_map(to_sub, params), batch,
                                        place, cfg_local)

        def reduce(g: DTensor, p: DTensor) -> DTensor:
            total = psum_int8(g.to_local(), group,
                              scale_group=dist.group.WORLD) / npods
            return DTensor.from_local(total, mesh, p.placements,
                                      run_check=False, shape=p.shape,
                                      stride=p.stride())

        grads = tree_map(reduce, grads, params)
        loss, metrics = _pod_mean(_plain(loss),
                                  {k: _plain(v) for k, v in metrics.items()},
                                  group, npods)
        return apply_update(params, opt_state, grads, loss, metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, *,
                      with_enc_out: bool = False) -> Callable:
    """The prefill step; for an encoder-decoder with ``with_enc_out`` it
    also returns the encoder output, which a server keeps for the serve
    step (``(last_logits, caches, enc_out)``). The encoder-decoder's
    prefill bundle returns ``(logits, caches)`` only, as JAX's does: a
    caller on a mesh calls this step with ``with_enc_out`` on the placed
    parameters, frames and tokens, and places the encoder output by
    ``batch_specs``' ``enc_out`` spec (``sharding.distribute``) for the
    decode bundle."""
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


# ---------------------------------------------------------------------------
# Bundle: one shape cell's step, its argument structs and placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepBundle:
    """One shape cell's step function, its argument structs on ``meta``
    and the specs of its inputs and outputs. Carried state (parameters,
    optimizer state, caches) keeps its input placement: on a
    ``DeviceMesh`` ``fn`` brings every output that has a spec back to it.
    ``place(*args)`` puts arguments every rank holds alike onto the mesh
    by ``in_specs``."""

    fn: Callable
    arg_structs: Tuple
    in_specs: Tuple
    donate: Tuple[int, ...]
    kind: str                        # train | prefill | decode
    out_specs: Optional[Tuple] = None
    mesh: Any = None

    def place(self, *args):
        return tuple(
            a if s is None else sharding.distribute(a, self.mesh, s)
            for a, s in zip(args, self.in_specs))


def _keep_placements(fn: Callable, mesh, out_specs: Tuple) -> Callable:
    """``fn`` with each output that has a spec redistributed to it."""
    if not isinstance(mesh, DeviceMesh):
        return fn

    def step(*args):
        out = fn(*args)
        return tuple(o if s is None else sharding.distribute(o, mesh, s)
                     for o, s in zip(out, out_specs))

    return step


def build_step_bundle(cfg: ModelConfig, shape: Union[str, ShapeSpec], mesh,
                      *, opt_cfg: AdamWConfig = AdamWConfig(),
                      accum: int = 1, compress_crosspod: bool = False,
                      cache_len: Optional[int] = None,
                      rules: ShardingRules = DEFAULT_RULES) -> StepBundle:
    """Assemble (fn, arg structs, specs) for one (arch × shape) cell.
    ``shape`` names a ``SHAPES`` cell or is a ``ShapeSpec``; ``mesh`` is
    a ``DeviceMesh`` (``fn`` runs on it) or a ``sharding.AbstractMesh``
    (structs and specs only); every arch builds on both. A prefill cell's
    cache holds ``cache_len`` positions, its ``seq_len`` by default as in
    JAX; a server passes its decode cell's, so the prefill's caches are
    the decode step's."""
    ss = shape_spec(shape)
    pstruct = params_struct(cfg)
    pspecs = param_specs(pstruct, mesh, rules)
    ins = input_specs(cfg, ss)
    bspecs_all = batch_specs(cfg, mesh, ss.kind, ss.global_batch, rules)
    bspecs = {k: bspecs_all[k] for k in ins}

    def bundle(fn, args, specs, donate, out_specs):
        return StepBundle(fn=_keep_placements(fn, mesh, out_specs),
                          arg_structs=args, in_specs=specs, donate=donate,
                          kind=ss.kind, out_specs=out_specs, mesh=mesh)

    if ss.kind == "train":
        ostruct = adamw_init(pstruct, opt_cfg)          # opt_struct's
        ospecs = opt_specs(ostruct, mesh, rules)
        fn = make_train_step(cfg, opt_cfg, accum=accum,
                             mesh=(mesh if isinstance(mesh, DeviceMesh)
                                   else None),
                             compress_crosspod=compress_crosspod,
                             rules=rules)
        return bundle(fn, (pstruct, ostruct, ins), (pspecs, ospecs, bspecs),
                      (0, 1), (pspecs, ospecs, None))

    if ss.kind == "prefill":
        clen = ss.seq_len if cache_len is None else cache_len
        cstruct = cache_struct(cfg, ss.global_batch, clen)
        cspecs = cache_specs_tree(cstruct, cfg, mesh, ss.global_batch,
                                  rules)
        fn = make_prefill_step(cfg, clen)
        names = (("enc_embeds", "tokens") if cfg.is_encdec else
                 ("tokens", "embeds") if cfg.frontend else ("tokens",))
        return bundle(fn, (pstruct,) + tuple(ins[n] for n in names),
                      (pspecs,) + tuple(bspecs[n] for n in names), (),
                      (None, cspecs))

    # decode
    cstruct = cache_struct(cfg, ss.global_batch, ss.seq_len)
    cspecs = cache_specs_tree(cstruct, cfg, mesh, ss.global_batch, rules)
    fn = make_serve_step(cfg)
    names = ("token", "position") + (("enc_out",) if cfg.is_encdec else ())
    return bundle(fn, (pstruct, cstruct) + tuple(ins[n] for n in names),
                  (pspecs, cspecs) + tuple(bspecs[n] for n in names), (1,),
                  (None, cspecs))
