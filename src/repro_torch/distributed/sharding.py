"""Per-architecture sharding rules (DP/FSDP/TP/EP/SP) as declarative
tables, and their DTensor placements over a ``DeviceMesh`` (the JAX
package's ``repro.distributed.sharding``).

Strategy (as in the JAX package):

* ``data`` axis: FSDP — every weight's ``d_model``-role dim is sharded
  over it; activations' batch dim is sharded over ``("pod", "data")``.
* ``model`` axis: TP — attention head projections, FFN hidden, expert
  hidden, and the vocab dim of embedding/lm_head.
* ``pod`` axis (multi-pod only): pure data parallelism (composes with
  ``data`` for the batch), so cross-pod traffic is the gradient reduce
  only (``distributed/collectives.py``).
* EP: the expert dim shards over ``data`` when divisible; otherwise
  experts keep FSDP+TP on their (d, ff) dims.
* SP: long-context decode (B=1) shards the KV-cache sequence dim over
  ``data`` instead of the unshardable batch.

Every rule is divisibility-checked against the actual dim size: a mesh
axis that does not divide the dim is dropped (replicated), and no axis is
used twice in one spec. So one table serves all 10 architectures.

A spec is a ``Spec``: a tuple of per-dimension entries, each ``None``,
an axis name or a tuple of names, trailing ``None``s trimmed where JAX's
``_mk`` trims them; ``tuple(spec)`` equals ``tuple(PartitionSpec)`` of
the JAX package's rule. The tables take a real ``DeviceMesh`` or an
``AbstractMesh`` (axis names and sizes, no ranks), on which they run at
the production shapes on any host. ``placements(mesh, spec)`` turns a
spec into DTensor placements in mesh-dimension order; ``distribute``
places a tree by its specs, the counterpart of ``device_put`` with
``NamedSharding``. The mesh's device type sets the device.

The DTensor execution helpers the dense model path uses on a wide mesh
sit at the end: ``fsdp_gather`` (each weight's ``data`` shards gathered
at its use, its ``model`` placement kept), ``pin_dp`` (activations
batch-sharded over ``dp_axes``, JAX's ``_pin_dp``), ``head_layout``
(which q and kv heads each ``model`` rank takes to the attention
kernels) and ``act_specs`` (attention's layout under ``cfg.act_dp`` and
``cfg.act_sp``: every head, q's rows over ``act_sp``).
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)

from repro_torch.configs.base import ModelConfig
from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten

__all__ = ["ShardingRules", "DEFAULT_RULES", "Spec", "AbstractMesh",
           "dp_axes", "spec_for_leaf", "param_specs", "opt_specs",
           "batch_specs", "cache_specs_tree", "placements", "named",
           "tree_named", "spec_leaves", "map_spec_tree", "distribute",
           "is_wide", "mesh_dim", "fsdp_gather", "pin_dp", "pin_heads",
           "like", "model_rank", "HeadLayout", "head_layout", "matmul",
           "from_local", "mm_f32", "ExpertLayout", "expert_layout",
           "local", "grad_summed_over", "batch_dims", "act_specs",
           "SEQ_QUANTUM"]

Axis = Union[None, str, Tuple[str, ...]]


@dataclass(frozen=True)
class ShardingRules:
    """Logical-role -> mesh-axis mapping (MaxText-style logical axis
    rules)."""

    fsdp: Axis = "data"          # weight d_model-role dims
    tensor: Axis = "model"       # heads / ffn-hidden / vocab dims
    expert: Axis = "data"        # MoE expert dim (EP), when divisible
    dp_extra: Axis = "pod"       # extra pure-DP axis when present in mesh
    seq: Axis = "data"           # SP for unshardable-batch caches
    # when True, expert dim takes priority over fsdp on expert weights
    prefer_ep: bool = True


DEFAULT_RULES = ShardingRules()


class Spec(tuple):
    """A partition spec: one entry per tensor dim (trailing dims not
    named are replicated). As ``PartitionSpec`` does, a one-name tuple
    is stored as the name and an empty tuple as ``None``."""

    def __new__(cls, *entries: Axis) -> "Spec":
        def norm(e: Axis) -> Axis:
            if isinstance(e, tuple):
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no ranks behind them."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")


Mesh = Union[DeviceMesh, AbstractMesh]


def _axes(mesh: Mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh-dimension order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def dp_axes(mesh: Mesh, rules: ShardingRules = DEFAULT_RULES) -> Axis:
    """Batch-dim axes: ("pod", "data") on multi-pod, ("data",) otherwise."""
    names = _axes(mesh)
    out = []
    if isinstance(rules.dp_extra, str) and rules.dp_extra in names:
        out.append(rules.dp_extra)
    for a in (rules.fsdp if isinstance(rules.fsdp, tuple)
              else (rules.fsdp,)):
        if a in names:
            out.append(a)
    return tuple(out)


def _axis_size(mesh: Mesh, axis: Axis) -> int:
    sizes = _axes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, str):
        return sizes.get(axis, 0)
    n = 1
    for a in axis:
        s = sizes.get(a, 0)
        if s == 0:
            return 0
        n *= s
    return n


def _fit(mesh: Mesh, axis: Axis, dim: int) -> Axis:
    """Return ``axis`` if it exists in the mesh and divides ``dim``."""
    sz = _axis_size(mesh, axis)
    if sz <= 1 or dim % sz != 0:
        return None
    return axis


def _mk(mesh: Mesh, shape: Tuple[int, ...], wanted: Sequence[Axis]
        ) -> Spec:
    """Divisibility-checked spec; drops duplicate axis uses."""
    used: set = set()
    out = []
    for dim, ax in zip(shape, wanted):
        ax = _fit(mesh, ax, dim)
        flat = (ax,) if isinstance(ax, str) else (ax or ())
        if ax is not None and not any(a in used for a in flat):
            out.append(ax)
            used.update(flat)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return Spec(*out)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

def _path_str(path: Tuple) -> str:
    return "/".join(str(k) for k in path)


def spec_for_leaf(path: str, shape: Tuple[int, ...], mesh: Mesh,
                  rules: ShardingRules = DEFAULT_RULES) -> Spec:
    """Sharding rule for one parameter leaf, by name + shape.

    ``path`` is the '/'-joined tree key path; stacked-layer params carry a
    leading ``reps`` dim that is never sharded.
    """
    fs, tp, ep = rules.fsdp, rules.tensor, rules.expert
    nd = len(shape)

    def tail(*axes: Axis) -> Spec:
        """Apply ``axes`` to the trailing dims, replicate leading dims."""
        lead = nd - len(axes)
        return _mk(mesh, shape, [None] * lead + list(axes))

    # --- embeddings / lm head: (V, d) -> vocab TP + d FSDP
    if re.search(r"(^|/)(embed|lm_head)$", path):
        return tail(tp, fs)

    # --- MoE ----------------------------------------------------------------
    if "/router" in path:
        return tail(fs, None)                       # (d, E)
    if "/experts/" in path or "/shared/" in path:
        # (reps, E, d, ff) for wi/wg; (reps, E, ff, d) for wo
        is_wo = path.endswith("wo")
        e_dim = shape[-3]
        ep_ok = _fit(mesh, ep, e_dim) is not None and rules.prefer_ep
        if is_wo:
            return (tail(ep, tp, None) if ep_ok else tail(None, tp, fs))
        return (tail(ep, None, tp) if ep_ok else tail(None, fs, tp))

    # --- Mamba ---------------------------------------------------------------
    if path.endswith("in_proj"):
        return tail(fs, tp)                         # (d, d_proj)
    if path.endswith("out_proj"):
        return tail(tp, fs)                         # (d_in, d)
    if path.endswith("conv_w"):
        return tail(None, tp)                       # (k, conv_ch)
    if re.search(r"(A_log|dt_bias|/D|conv_b)$", path):
        return tail(None)

    # --- attention / MLP matmul weights --------------------------------------
    if re.search(r"/(wq|wk|wv|wi|wg)(/w)?$", path):
        return tail(fs, tp)                         # column-parallel
    if re.search(r"/(wo)(/w)?$", path):
        return tail(tp, fs)                         # row-parallel

    # --- norms, biases, scalars ----------------------------------------------
    return _mk(mesh, shape, [None] * nd)


def param_specs(params_shape: Any, mesh: Mesh,
                rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Tree of ``Spec`` matching a params (shape-)tree."""
    flat = tree_flatten_with_path(params_shape)
    return tree_unflatten(params_shape, [
        spec_for_leaf(_path_str(p), tuple(leaf.shape), mesh, rules)
        for p, leaf in flat])


def opt_specs(opt_shape: Any, mesh: Mesh,
              rules: ShardingRules = DEFAULT_RULES) -> Any:
    """OptState specs: m/v/master shard like params; count replicated."""

    def one(path, leaf):
        ps = _path_str(path)
        if ps.endswith("count") or leaf.dim() == 0:
            return Spec()
        # strip the leading "m/"|"v/"|"master/" component
        sub = ps.split("/", 1)[1] if "/" in ps else ps
        return spec_for_leaf(sub, tuple(leaf.shape), mesh, rules)

    return tree_unflatten(opt_shape, [
        one(p, leaf) for p, leaf in tree_flatten_with_path(opt_shape)])


# ---------------------------------------------------------------------------
# Activation / input / cache rules
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, mesh: Mesh, kind: str,
                global_batch: int, rules: ShardingRules = DEFAULT_RULES
                ) -> Dict[str, Spec]:
    """Input specs for one shape cell. Batch over ("pod", "data")."""
    b = _fit(mesh, dp_axes(mesh, rules), global_batch)
    specs: Dict[str, Spec] = {}
    if kind in ("train", "prefill"):
        specs["tokens"] = Spec(b, None)
        if kind == "train":
            specs["targets"] = Spec(b, None)
        if cfg.frontend:
            specs["embeds"] = Spec(b, None, None)
        if cfg.is_encdec:
            specs["enc_embeds"] = Spec(b, None, None)
    else:  # decode
        specs["token"] = Spec(b)
        specs["position"] = Spec(b)
        if cfg.is_encdec:
            specs["enc_out"] = Spec(b, None, None)
    return specs


def cache_specs_tree(cache_shape: Any, cfg: ModelConfig, mesh: Mesh,
                     global_batch: int,
                     rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Specs for a stacked KV/SSM cache tree.

    Leaves are (reps, B, S, Hkv, D) [attn k/v], (reps, B, k-1, conv_ch)
    [mamba conv], (reps, B, nh, N, P) [mamba ssm]. Batch shards over
    ("pod", "data") when divisible; otherwise the sequence dim (attn) or
    the heads dim (ssm) shards over ``data`` — sequence parallelism for
    the long_500k cells. A KV cache's heads shard over ``model`` where
    they divide it, else its sequence dim, else its head dim.
    """
    dp = _fit(mesh, dp_axes(mesh, rules), global_batch)

    def kv_axes(S: int, hkv: int, hd: int):
        if _fit(mesh, rules.tensor, hkv) is not None:
            return None, rules.tensor, None
        if _fit(mesh, rules.tensor, S) is not None:
            return rules.tensor, None, None
        if _fit(mesh, rules.tensor, hd) is not None:
            return None, None, rules.tensor
        return None, None, None

    def seq_axes(s_ax: Axis) -> Axis:
        """B unshardable: the sequence takes both axes when possible."""
        if s_ax is None:
            return rules.seq
        return (rules.seq, s_ax) if isinstance(s_ax, str) else rules.seq

    def one(path, leaf):
        ps = _path_str(path)
        sh = tuple(leaf.shape)
        nd = len(sh)
        if nd == 5:            # attn kv (reps,B,S,H,D) or ssm (reps,B,nh,N,P)
            if ps.endswith("ssm"):
                return _mk(mesh, sh, [None, dp, rules.tensor, None, None])
            s_ax, h_ax, d_ax = kv_axes(sh[2], sh[3], sh[4])
            if dp is not None:
                return _mk(mesh, sh, [None, dp, s_ax, h_ax, d_ax])
            return _mk(mesh, sh, [None, None, seq_axes(s_ax), h_ax, d_ax])
        if nd == 4:            # unstacked kv (B,S,H,D) / conv (reps,B,k,ch)
            if ps.endswith("conv"):
                return _mk(mesh, sh, [None, dp, None, rules.tensor])
            s_ax, h_ax, d_ax = kv_axes(sh[1], sh[2], sh[3])
            if dp is not None:
                return _mk(mesh, sh, [dp, s_ax, h_ax, d_ax])
            return _mk(mesh, sh, [seq_axes(s_ax), h_ax, d_ax])
        if nd == 3 and ps.endswith("conv"):
            return _mk(mesh, sh, [dp, None, rules.tensor])
        return _mk(mesh, sh, [dp] + [None] * (nd - 1))

    return tree_unflatten(cache_shape, [
        one(p, leaf) for p, leaf in tree_flatten_with_path(cache_shape)])


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh: Mesh, spec: Sequence[Axis]) -> Tuple[Placement, ...]:
    """``spec`` as DTensor placements, one per mesh dimension in mesh
    order: ``Shard(d)`` where tensor dim ``d`` takes that mesh axis,
    ``Replicate()`` elsewhere. A dim over ``("pod", "data")`` is
    ``Shard(d)`` on both mesh dims (pod-major, as JAX lays it out)."""
    names = list(_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, "
                                 f"not in the mesh's {tuple(names)}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedPlacement:
    """A mesh and one tensor's placements on it (``NamedSharding``)."""

    mesh: DeviceMesh
    spec: Spec
    placements: Tuple[Placement, ...]


def named(mesh: DeviceMesh, spec: Sequence[Axis]) -> NamedPlacement:
    return NamedPlacement(mesh, Spec(*spec), placements(mesh, spec))


def _map_specs(fn: Callable[[Spec], Any], specs: Any) -> Any:
    """``fn`` over the ``Spec`` leaves of a spec tree (a ``Spec`` is a
    tuple, so the tree helpers would walk into it)."""
    if isinstance(specs, Spec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (tuple, list)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return dataclasses.replace(specs, **{
            f.name: _map_specs(fn, getattr(specs, f.name))
            for f in dataclasses.fields(specs)})
    return specs


def spec_leaves(specs: Any) -> List[Spec]:
    """The ``Spec`` leaves in ``tree_flatten_with_path``'s order."""
    boxed = _map_specs(_Box, specs)
    return [b.spec for _, b in tree_flatten_with_path(boxed)]


class _Box:
    """A spec as one tree leaf."""

    __slots__ = ("spec",)

    def __init__(self, spec: Spec):
        self.spec = spec


def tree_named(mesh: DeviceMesh, specs: Any) -> Any:
    """A tree of ``Spec`` as the same tree of ``NamedPlacement``."""
    return _map_specs(lambda s: named(mesh, s), specs)


def map_spec_tree(fn: Callable[[Any, Spec], Any], tree: Any, specs: Any
                  ) -> Any:
    """``fn(leaf, spec)`` over the leaves of ``tree`` and the specs of
    ``specs`` (a spec tree of the same structure), rebuilding ``tree``."""
    leaves = [t for _, t in tree_flatten_with_path(tree)]
    specs_ = spec_leaves(specs)
    if len(leaves) != len(specs_):
        raise ValueError(f"{len(leaves)} leaves against {len(specs_)} specs")
    return tree_unflatten(tree, [fn(t, s) for t, s in zip(leaves, specs_)])


def distribute(tree: Any, mesh: DeviceMesh, specs: Any) -> Any:
    """Every leaf of ``tree`` placed on ``mesh`` by its spec in ``specs``
    (a tree of the same structure), as a DTensor on the mesh's device.

    Each rank keeps its own slice of the values it was given, with no
    communication: the tree is one that every rank holds alike (the
    global batch every rank is given, a seeded initialisation, a
    checkpoint read back). A leaf that is a DTensor already is
    redistributed to its spec's placements."""
    dev = torch.device(mesh.device_type)

    def one(t, s):
        pl = placements(mesh, s)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else t.redistribute(
                mesh, pl)
        t = torch.as_tensor(t)
        if t.device.type != dev.type:
            t = t.to(dev)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return map_spec_tree(one, tree, specs)


# ---------------------------------------------------------------------------
# DTensor execution helpers (the dense model path on a wide mesh)
# ---------------------------------------------------------------------------

def is_wide(mesh: Mesh, rules: ShardingRules = DEFAULT_RULES) -> bool:
    """Whether the mesh's ``data`` (fsdp) or ``model`` (tensor) axis has
    more than one rank: where the rules shard parameters."""
    return any(_axis_size(mesh, a) > 1 for a in (rules.fsdp, rules.tensor))


def mesh_dim(mesh: DeviceMesh, axis: str) -> Optional[int]:
    """The mesh dimension named ``axis`` (None where there is none)."""
    names = mesh.mesh_dim_names or ()
    return names.index(axis) if axis in names else None


def fsdp_gather(tree: Any, rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Each DTensor leaf with its ``fsdp`` (``data``) shards gathered:
    ``Replicate()`` on that mesh dim, every other placement kept. Done
    at a weight's use, so the product runs against the batch-sharded
    activations as FSDP does; its backward reduce-scatters the gradient
    back to the weight's shards. An expert leaf (under ``experts``)
    sharded on its expert dim (the third from last) over
    ``rules.expert`` keeps that shard: that is EP, each data rank runs
    its own experts (``ExpertLayout``). Plain tensors pass through."""
    def one(path, t):
        if not isinstance(t, DTensor):
            return t
        d = mesh_dim(t.device_mesh, rules.fsdp)
        if d is None or isinstance(t.placements[d], Replicate):
            return t
        if _is_ep_leaf(path, t, rules):
            return t
        pl = list(t.placements)
        pl[d] = Replicate()
        return t.redistribute(t.device_mesh, pl)
    flat = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [one(p, t) for p, t in flat])


def _is_ep_leaf(path: Tuple, t: DTensor,
                rules: ShardingRules = DEFAULT_RULES) -> bool:
    """Whether the leaf at ``path`` is an expert weight sharded on its
    expert dim over ``rules.expert`` (EP)."""
    d = mesh_dim(t.device_mesh, rules.expert)
    return ("experts" in path and d is not None and t.dim() >= 3
            and t.placements[d] == Shard(t.dim() - 3))


def pin_dp(x: DTensor, rules: ShardingRules = DEFAULT_RULES) -> DTensor:
    """``x`` (batch first) batch-sharded over ``dp_axes`` where they
    divide the batch, replicated over every other mesh dim (JAX's
    ``_pin_dp``): the layout every block's activations keep."""
    mesh = x.device_mesh
    b = _fit(mesh, dp_axes(mesh, rules), x.shape[0])
    want = placements(mesh, Spec(b))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


SEQ_QUANTUM = 16    # JAX's _pin_dp shards a sequence only where 16 divides it


def act_specs(mesh: Mesh, act_dp: Sequence[str], act_sp: Optional[str],
              batch: int, seq: int) -> Tuple[Spec, Spec]:
    """The specs of attention's q and of its k/v (batch, sequence first)
    in JAX's pinned layout (``_pin_dp`` under ``cfg.act_dp``): the batch
    over the ``act_dp`` axes where they divide it (as ``pin_dp``), every
    head on every rank; q's sequence also over ``act_sp`` (context
    parallelism) where ``SEQ_QUANTUM`` and that axis divide it, K/V's
    replicated over it. An ``act_dp`` axis the mesh lacks is refused, as
    JAX refuses it."""
    names = _axes(mesh)
    missing = [a for a in act_dp if a not in names]
    if missing:
        raise ValueError(f"act_dp {tuple(act_dp)} names {missing}, not "
                         f"in the mesh's {tuple(names)}")
    b = _fit(mesh, tuple(act_dp), batch)
    sp = None
    if (act_sp is not None and seq % SEQ_QUANTUM == 0
            and _fit(mesh, act_sp, seq) is not None):
        sp = act_sp
    return Spec(b, sp), Spec(b)


def from_local(t: torch.Tensor, mesh: DeviceMesh,
               pl: Sequence[Placement], shape: Sequence[int]) -> DTensor:
    """``DTensor.from_local`` of a contiguous local piece with the global
    ``shape`` given, so that a dim some axis shards unevenly keeps its
    size."""
    stride, n = [], 1
    for s in reversed(tuple(shape)):
        stride.append(n)
        n *= s
    return DTensor.from_local(t, mesh, tuple(pl), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def batch_dims(x: DTensor, rules: ShardingRules = DEFAULT_RULES
               ) -> List[int]:
    """The mesh dims of the data axes over which ``x`` (batch first) is
    ``Shard``: where each rank runs its own rows."""
    names = list(x.device_mesh.mesh_dim_names or ())
    return [names.index(a) for a in dp_axes(x.device_mesh, rules)
            if isinstance(x.placements[names.index(a)], Shard)]


def local(t: DTensor, partial: Sequence[int]) -> torch.Tensor:
    """``t``'s local piece, its gradient a partial sum over the mesh dims
    ``partial`` (each rank used it on its own rows, or for its own share
    of the output) and in ``t``'s placements elsewhere."""
    return t.to_local(grad_placements=[
        Partial() if i in partial else q for i, q in enumerate(t.placements)])


def grad_summed_over(mesh: DeviceMesh, dim: int
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Identity forward; the backward sums the gradient over mesh dim
    ``dim``: for a local tensor every rank of that dim holds alike and
    uses for its own share of the output (each rank's gradient of it is
    a partial sum). Behind an all-reduce this is needed: DTensor carries
    a partial gradient back through ``Partial -> Replicate`` unreduced."""
    rep = [Replicate()] * mesh.ndim
    part = list(rep)
    part[dim] = Partial()

    def f(t: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(t, mesh, rep, run_check=False).to_local(
            grad_placements=part)
    return f


def matmul(x: DTensor, w: DTensor) -> DTensor:
    """``x (..., k) @ w (k, n)`` on each rank's local pieces, the result's
    placements fixed by the operands'. DTensor's own propagation may put
    the flattened token dim of a batch that ``data`` does not divide on
    ``data``, which it then cannot view back to ``(B, S, n)``. Per mesh
    dim, with ``x`` first brought from ``Partial`` to ``Replicate``:

    * ``x`` ``Shard`` on a leading dim, ``w`` replicated: the result so
      sharded (``w``'s gradient a partial sum);
    * ``x`` replicated, ``w`` ``Shard(1)`` (column-parallel): the result
      ``Shard`` on its last dim (``x``'s gradient a partial sum);
    * ``x`` ``Shard`` on its last dim, ``w`` ``Shard(0)`` (row-parallel):
      a partial sum; ``x`` replicated against such a ``w`` takes its own
      slice first, ``w`` replicated against such an ``x`` likewise;
    * both replicated: replicated.

    A partial sum in a low-precision dtype comes out of the GEMM in f32
    (``mm_f32``), is reduced here, then rounded once to ``x``'s dtype:
    the meshless product accumulates in f32 and rounds once, where
    summing rounded partials would round twice.
    """
    mesh, last = x.device_mesh, x.dim() - 1
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                  else p for p in x.placements])
    xp, wp = list(x.placements), list(w.placements)
    for i, (a, b) in enumerate(zip(xp, wp)):
        if isinstance(a, Replicate) and b == Shard(0):
            xp[i] = Shard(last)
        elif a == Shard(last) and isinstance(b, Replicate):
            wp[i] = Shard(0)
    if xp != list(x.placements):
        x = x.redistribute(mesh, xp)
    if wp != list(w.placements):
        w = w.redistribute(mesh, wp)
    out, xg, wg = [], [], []
    for a, b in zip(xp, wp):
        if isinstance(a, Shard) and a.dim < last and isinstance(b, Replicate):
            out.append(a), xg.append(a), wg.append(Partial())
        elif isinstance(a, Replicate) and b == Shard(1):
            out.append(Shard(last)), xg.append(Partial()), wg.append(b)
        elif a == Shard(last) and b == Shard(0):
            out.append(Partial()), xg.append(a), wg.append(b)
        elif isinstance(a, Replicate) and isinstance(b, Replicate):
            out.append(a), xg.append(a), wg.append(b)
        else:
            raise ValueError(f"matmul of placements {tuple(x.placements)} "
                             f"and {tuple(w.placements)}")
    xl, wl = x.to_local(grad_placements=xg), w.to_local(grad_placements=wg)
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    if x.dtype == torch.float32 or not any(isinstance(p, Partial)
                                           for p in out):
        return from_local(xl @ wl, mesh, out, shape)
    yl = mm_f32(xl.reshape(-1, xl.shape[-1]), wl)
    y = from_local(yl.view(tuple(xl.shape[:-1]) + (wl.shape[1],)), mesh,
                   out, shape)
    return y.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                 else p for p in out]).to(x.dtype)


class _MmF32(torch.autograd.Function):
    """``x @ w`` (``mm`` of 2-D, ``bmm`` of 3-D operands) of one
    low-precision dtype, accumulated in f32 and returned in f32 without
    rounding: on the card one tensor-core GEMM with an f32 output
    (``out_dtype``); the CPU backend has no such overload, so there the
    operands are widened first, which computes the same sums. The
    backward runs in the operands' dtype, as the plain product's does
    (its incoming gradient holds values of that dtype)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        op = torch.mm if x.dim() == 2 else torch.bmm
        if x.is_cuda:
            return op(x, w, out_dtype=torch.float32)
        return op(x.float(), w.float())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w.mT if ctx.needs_input_grad[0] else None,
                x.mT @ g if ctx.needs_input_grad[1] else None)


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32, unrounded: the plain product for f32 operands,
    ``_MmF32`` for low-precision ones (a partial sum that is reduced
    before it is rounded once)."""
    if x.dtype == torch.float32:
        return x @ w
    return _MmF32.apply(x, w)


def pin_heads(x: DTensor, sharded: bool,
              rules: ShardingRules = DEFAULT_RULES) -> DTensor:
    """``pin_dp(x)``'s layout with the last dim (a projection's flat
    heads) ``Shard`` over ``model`` when ``sharded``: head-aligned, since
    the caller shards only a head count the axis divides."""
    x = pin_dp(x, rules)
    d = mesh_dim(x.device_mesh, rules.tensor) if sharded else None
    if d is None:
        return x
    pl = list(x.placements)
    pl[d] = Shard(x.dim() - 1)
    return x.redistribute(x.device_mesh, pl)


def like(t: torch.Tensor, x: DTensor) -> DTensor:
    """``t``, which every rank holds alike (positions), placed as ``x``
    is, each rank keeping its own slice: no communication."""
    return distribute_tensor(t.to(x.device), x.device_mesh, x.placements,
                             src_data_rank=None)


def model_rank(mesh: DeviceMesh, rules: ShardingRules = DEFAULT_RULES
               ) -> int:
    """This rank's coordinate on the ``model`` axis (0 without one)."""
    return (mesh.get_local_rank(rules.tensor)
            if mesh_dim(mesh, rules.tensor) is not None else 0)


@dataclass(frozen=True)
class HeadLayout:
    """Which heads each ``model`` rank takes to an attention kernel.

    ``q_sharded``: the q heads are ``Shard`` over ``model`` (``Hq % m ==
    0``, and the local heads form a valid GQA group), else every rank
    takes all heads. ``kv_sharded``: the kv heads are ``Shard`` too
    (``Hkv % m == 0``); otherwise a rank with sharded q heads takes, of a
    replicated K/V, the slice ``[kv_lo(r), kv_lo(r) + kv_local)`` its q
    heads use."""

    m: int
    hq: int
    hkv: int
    q_sharded: bool
    kv_sharded: bool

    @property
    def hq_local(self) -> int:
        return self.hq // self.m if self.q_sharded else self.hq

    @property
    def kv_local(self) -> int:
        if self.kv_sharded:
            return self.hkv // self.m
        if not self.q_sharded:
            return self.hkv
        return 1         # the local q heads sit inside one kv group

    def kv_lo(self, r: int) -> int:
        """The first kv head model rank ``r`` uses (of the replicated
        K/V; 0 where the kv heads are sharded or all taken)."""
        if self.kv_sharded or not self.q_sharded:
            return 0
        return (r * self.hq_local) // (self.hq // self.hkv)


def head_layout(mesh: DeviceMesh, hq: int, hkv: int,
                rules: ShardingRules = DEFAULT_RULES) -> HeadLayout:
    """The local-heads rule for ``hq`` query and ``hkv`` kv heads over
    the mesh's ``model`` axis (see ``HeadLayout``)."""
    m = max(1, _axis_size(mesh, rules.tensor))
    if m == 1 or hq % m:
        return HeadLayout(m, hq, hkv, False, False)
    if hkv % m == 0:
        return HeadLayout(m, hq, hkv, True, True)
    rep, local = hq // hkv, hq // m
    # the local q heads must sit inside one kv group (whole groups would
    # mean hkv % m == 0)
    if rep % local == 0:
        return HeadLayout(m, hq, hkv, True, False)
    return HeadLayout(m, hq, hkv, False, False)


@dataclass(frozen=True)
class ExpertLayout:
    """Which experts each ``data`` rank runs. ``ep``: the expert dim is
    ``Shard`` over ``data`` (``d`` divides ``e``, the rule of
    ``spec_for_leaf``), so data rank ``r`` owns experts ``[lo(r), lo(r) +
    local)``; otherwise every rank holds every expert, their ``d_model``
    dim gathered at use (FSDP) and their ``ff`` dim over ``model``."""

    d: int
    e: int
    ep: bool

    @property
    def local(self) -> int:
        return self.e // self.d if self.ep else self.e

    def lo(self, r: int) -> int:
        return r * self.local if self.ep else 0


def expert_layout(mesh: Mesh, num_experts: int,
                  rules: ShardingRules = DEFAULT_RULES) -> ExpertLayout:
    """The EP rule for ``num_experts`` experts over the mesh's ``expert``
    axis (see ``ExpertLayout``)."""
    d = max(1, _axis_size(mesh, rules.expert))
    ep = _fit(mesh, rules.expert, num_experts) is not None and rules.prefer_ep
    return ExpertLayout(d, num_experts, ep)
