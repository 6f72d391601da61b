"""Multi-pod dry run: run every (architecture × input shape) step on the
production meshes on fake tensors, and extract the roofline terms (the
JAX package's ``repro.launch.dryrun``).

Each cell sets up and takes down its own world: a fake process group of
the mesh's size (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``: one rank of a world whose collectives move nothing), the
production mesh over it (``launch/mesh.py``), the bundle's arguments
materialised as fake tensors on the mesh's device and placed by
``StepBundle.place``, then the real step run once at full depth under
a ``FakeTensorMode`` (no memory, no arithmetic). PyTorch runs eagerly,
so every layer of every microbatch is counted as it runs: no
extrapolation over depth. The traced rank is rank 0, or, where the cell
shards attention's query rows over ``model`` (``--attn-block``: JAX's
``act_sp``), the rank at the last ``model`` coordinate and the first of
every other axis: under a causal mask its rows keep the most (query, key)
pairs, so the compute term is the heaviest rank's, and every spec divides
its dim, so its shapes and bytes are rank 0's (``flops_model_rank`` in
the cell). Per cell it reports, for the traced rank:

* memory: argument bytes (the traced rank's local shards; DTensor's
  chunking gives rank 0 the largest, as GSPMD's padding does), output
  and alias bytes (outputs that share an argument's storage: the caches
  the decode step writes in place), temporary bytes (the peak of the
  bytes the step allocates and holds beyond its arguments) and the
  largest kinds of tensor live at that peak, and whether arguments plus
  temporaries fit the card;
* FLOPs from ``torch.utils.flop_counter``'s formulas (the attention
  kernels' ops register theirs), counted on the local tensors;
* bytes accessed: every dispatched op's operand and result bytes (eager
  PyTorch fuses nothing, so nothing is discounted; views and a
  collective's wait move nothing);
* collective bytes: the operand bytes of every collective the step
  issues, by JAX's five kinds and by mesh axis, and by the link its
  group runs on (one node of 8 cards: NVLink, else InfiniBand);
* the three roofline terms against the H100 SXM's datasheet figures,
  ``6·N_active·D`` model FLOPs and the useful-FLOP ratio, as JAX's.

Every time in a cell is computed from datasheet figures, not measured.
With ``--device cuda`` (the default) the tensors are fake CUDA tensors,
so the attention layers go through the kernels' torch ops (their fake
implementations and FLOP formulas), as on the card; ``--device cpu``
takes the plain versions, as the CPU does (the tests).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
        --mesh pod,multipod
    python -m repro_torch.launch.dryrun --attn-block 512  # JAX's streaming
        # layout; cells into experiments/dryrun_torch_attn512/
    python -m repro_torch.launch.dryrun --all      # every cell, both meshes
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --periods 2 \\
        --dtype float32 --shape train:4x128 --mesh 2x2 --device cpu
    python -m repro_torch.launch.dryrun --mesh pod --jobs 6  # 6 at once
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      param_count, scale_layers)
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.models.tree import tree_flatten_with_path, tree_unflatten

__all__ = ["run_cell", "trace_step", "place_arguments", "applicable",
           "StepCounter", "parse_shape", "flops_rank",
           "parse_mesh", "fake_world", "argument_bytes", "cell_path",
           "main", "PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "NVLINK_BW",
           "IB_BW", "NODE_CARDS", "KINDS"]

# ---------------------------------------------------------------------------
# Hardware figures (NVIDIA H100 SXM datasheet, per card)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12        # HBM3 bytes/s
HBM_BYTES = 80e9        # HBM3 capacity
NVLINK_BW = 450e9       # NVLink 4 bytes/s per direction, within one node
IB_BW = 50e9            # 400 Gb/s InfiniBand NDR per card, across nodes
NODE_CARDS = 8          # cards a node joins over NVLink (DGX H100)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def _collective_kinds() -> Dict[Any, str]:
    """Collective op packet -> JAX's kind name."""
    out: Dict[Any, str] = {}
    table = {
        "_c10d_functional": {
            "all_gather_into_tensor": "all-gather",
            "all_gather_into_tensor_coalesced": "all-gather",
            "reduce_scatter_tensor": "reduce-scatter",
            "reduce_scatter_tensor_coalesced": "reduce-scatter",
            "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
            "all_to_all_single": "all-to-all",
            "broadcast": "collective-permute"},
        "_dtensor": {"shard_dim_alltoall": "all-to-all"},
        "c10d": {"allreduce_": "all-reduce", "allgather_": "all-gather",
                 "_allgather_base_": "all-gather",
                 "reduce_scatter_": "reduce-scatter",
                 "_reduce_scatter_base_": "reduce-scatter",
                 "alltoall_base_": "all-to-all",
                 "broadcast_": "collective-permute"}}
    for ns, ops in table.items():
        space = getattr(torch.ops, ns)
        for name, kind in ops.items():
            if hasattr(space, name):
                out[getattr(space, name)] = kind
    return out


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------

def _bytes(t: Any) -> int:
    return (t.numel() * t.element_size()
            if isinstance(t, torch.Tensor) else 0)


def _group_of(arg: Any) -> Optional[dist.ProcessGroup]:
    from torch.distributed.distributed_c10d import _resolve_process_group
    if isinstance(arg, str):
        return _resolve_process_group(arg)
    if isinstance(arg, dist.ProcessGroup):
        return arg
    if isinstance(arg, torch.ScriptObject):   # c10d's eager ops
        return dist.ProcessGroup.unbox(arg)
    return None


_NO_DECOMPOSE = {torch.ops.prim.device.default}
_WAIT = torch.ops._c10d_functional.wait_tensor.default   # gives its input


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes accessed and collective bytes of the ops run under
    it, counted on local tensors: an op on DTensors is let through to
    DTensor's dispatch (``NotImplemented``, as ``CommDebugMode`` does),
    whose local ops and collectives then come back here. FLOPs come from
    ``FlopCounterMode``'s formula registry (``register_flop_formula``);
    collectives are counted by operand bytes, by JAX's five kinds, by the
    mesh axis of their group and by the link the group runs on. Works on
    real tensors as on fake ones, so a rank of a real world counts a step
    as the dry run does. An op with no formula runs as its decomposition
    (as ``FlopCounterMode`` runs it), so that its parts are counted;
    ``decompose=False`` runs every op as it comes, for a real step that
    must run the ops it runs unwatched (its FLOPs then miss those ops).

    The stock tools each see a part of this: ``FlopCounterMode`` counts
    FLOPs only (its formula registry is used here), ``CommDebugMode``
    counts collective calls, not their bytes, and neither counts bytes
    accessed; one mode counts all three in one pass."""

    def __init__(self, mesh=None, decompose: bool = True) -> None:
        super().__init__()
        self._decompose = decompose
        from torch.utils.flop_counter import FlopCounterMode
        self._formulas = FlopCounterMode(display=False).flop_registry
        self._kinds = _collective_kinds()
        self._axes: Dict[str, str] = {}
        if dist.is_initialized():
            self._axes[dist.group.WORLD.group_name] = "world"
        if mesh is not None:
            for a in mesh.mesh_dim_names or ():
                self._axes[mesh.get_group(a).group_name] = a
        self._links: Dict[str, str] = {}
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in KINDS}
        self.by_axis: Dict[str, Dict[str, int]] = {}
        self.by_link = {"nvlink": 0, "infiniband": 0}
        self.n_collectives = 0

    def _link(self, pg: dist.ProcessGroup) -> str:
        name = pg.group_name
        if name not in self._links:
            nodes = {r // NODE_CARDS
                     for r in dist.get_process_group_ranks(pg)}
            self._links[name] = "nvlink" if len(nodes) == 1 else "infiniband"
        return self._links[name]

    def _collective(self, func, kind: str, args: tuple, kwargs: dict
                    ) -> None:
        nbytes = sum(_bytes(t) for t in tree_leaves(args[:1]))
        pg = None
        for i, a in enumerate(func._schema.arguments):
            if a.name in ("group_name", "process_group"):
                pg = _group_of(args[i] if i < len(args)
                               else kwargs.get(a.name))
        axis = (self._axes.get(pg.group_name, f"group{pg.size()}")
                if pg is not None else "unknown")
        self.collectives[kind] += nbytes
        per = self.by_axis.setdefault(axis, {k: 0 for k in KINDS})
        per[kind] += nbytes
        if pg is not None:
            self.by_link[self._link(pg)] += nbytes
        self.n_collectives += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        if (self._decompose and packet not in self._formulas
                and func not in _NO_DECOMPOSE):
            with self:                       # as FlopCounterMode does
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self._formulas:
            fargs = args
            if func._overloadname == "dtype":  # mm/bmm/addmm's out_dtype
                fargs = tuple(a for a in args if isinstance(a, torch.Tensor))
            self.flops += int(self._formulas[packet](*fargs, **kwargs,
                                                     out_val=out))
        kind = self._kinds.get(packet)
        if kind is not None:
            self._collective(func, kind, args, kwargs)
        if not func.is_view and func is not _WAIT:
            self.bytes += sum(_bytes(t) for t in tree_leaves((args, kwargs,
                                                               out)))
        return out


PEAK_TOP = 5     # the largest kinds of allocation a cell lists at its peak


def _tracked_fake_mode(device_type: str):
    """A ``FakeTensorMode`` that follows the bytes of the storages made
    on ``device_type`` while ``tracking`` is on: ``live`` now and its
    ``peak``. It sees every allocation, those inside an op's fake
    implementation too (the decode kernel's scratch). ``peak_live`` lists
    what the live bytes were made of at the peak (taken again whenever
    the peak passes the last one taken by 1 %): the ``PEAK_TOP`` largest
    (op, shape, dtype) kinds with their tensors and bytes. Tensors made
    while the mode is entered again are not followed (DTensor's sharding
    propagation enters the current fake mode to run an op on global-shape
    stand-ins, which a real run makes in a fake mode of its own), except
    inside this package's ops, whose fake implementations run so. Views
    of the storages ``hold`` names (the arguments) are not new; nor is
    what ``wait_tensor`` returns, which a real run gives back as its
    input (a fake one copies it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Tracked(FakeTensorMode):
        def __init__(self) -> None:
            super().__init__()
            self.tracking = False
            self.live = self.peak = 0
            self.peak_live: List[Dict[str, Any]] = []
            self._taken = 0
            self._held: Dict[int, Tuple[int, tuple]] = {}
            self._kinds: Dict[tuple, List[int]] = {}   # kind -> [n, bytes]
            self._depth = 0
            self._own_ops = 0
            self._known: Dict[int, Any] = {}     # id -> a held storage

        def hold(self, tensors) -> None:
            for t in tensors:
                st = t.untyped_storage()
                self._known[id(st)] = st

        def __enter__(self):
            self._depth += 1
            return super().__enter__()

        def __exit__(self, *exc):
            self._depth -= 1
            return super().__exit__(*exc)

        def _freed(self, key: int) -> None:
            n, kind = self._held.pop(key, (0, None))
            if kind is not None:
                self.live -= n
                self._kinds[kind][0] -= 1
                self._kinds[kind][1] -= n

        def _alias(self, src: torch.Tensor, dst: torch.Tensor) -> None:
            """``dst`` stands for ``src``'s storage from now on."""
            a, b = src.untyped_storage(), dst.untyped_storage()
            if id(a) in self._known:
                self._known[id(b)] = b
            elif id(a) in self._held:
                self._held[id(b)] = self._held.pop(id(a))
                weakref.finalize(b, self._freed, id(b))

        def _take(self) -> None:
            top = sorted(self._kinds.items(), key=lambda kv: -kv[1][1])
            self.peak_live = [
                {"op": k[0], "shape": list(k[1]), "dtype": k[2],
                 "tensors": v[0], "bytes": v[1]}
                for k, v in top[:PEAK_TOP] if v[1] > 0]
            self._taken = self.peak

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            own = getattr(func, "namespace", "") == "repro_torch"
            self._own_ops += own
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self._own_ops -= own
            if (self.tracking and (self._depth == 1 or self._own_ops)
                    and out is not NotImplemented):
                if func is _WAIT:
                    self._alias(args[0], out)
                    return out
                for t in tree_leaves(out):
                    if (isinstance(t, torch.Tensor)
                            and t.device.type == device_type):
                        st = t.untyped_storage()
                        if id(st) not in self._held and id(st) not in \
                                self._known:
                            kind = (str(func), tuple(t.shape),
                                    str(t.dtype).replace("torch.", ""))
                            n = st.nbytes()
                            self._held[id(st)] = (n, kind)
                            c = self._kinds.setdefault(kind, [0, 0])
                            c[0] += 1
                            c[1] += n
                            self.live += n
                            weakref.finalize(st, self._freed, id(st))
                if self.live > self.peak:
                    self.peak = self.live
                    if self.peak > 1.01 * self._taken:
                        self._take()
            return out

    return Tracked()


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.long_context_ok:
        return False, ("pure full-attention arch: no sub-quadratic path "
                       "for 500k decode (DESIGN.md §Arch-applicability)")
    return True, ""


def parse_shape(shape: str) -> ShapeSpec:
    """A ``SHAPES`` name, or ``kind:BxS`` (``train:4x512``)."""
    if shape in SHAPES:
        return SHAPES[shape]
    kind, _, bs = shape.partition(":")
    b, _, s = bs.partition("x")
    if kind not in ("train", "prefill", "decode") or not (b + s).isdigit():
        raise ValueError(f"shape {shape!r}: a SHAPES name or kind:BxS")
    return ShapeSpec(shape, int(s), int(b), kind)


def parse_mesh(mesh_kind: str) -> Optional[Tuple[Tuple[int, ...],
                                                 Tuple[str, ...]]]:
    """``pod`` / ``multipod`` (the production meshes), ``none``, or
    ``DxM`` over (data, model)."""
    from repro_torch.launch.mesh import MULTIPOD_SHAPE, POD_SHAPE
    if mesh_kind == "none":
        return None
    if mesh_kind == "pod":
        return POD_SHAPE, ("data", "model")
    if mesh_kind == "multipod":
        return MULTIPOD_SHAPE, ("pod", "data", "model")
    dims = tuple(int(x) for x in mesh_kind.split("x") if x.isdigit())
    if len(dims) != 2 or "x".join(map(str, dims)) != mesh_kind:
        raise ValueError(f"mesh {mesh_kind!r}: pod, multipod, none or DxM")
    return dims, ("data", "model")


class fake_world:
    """``with fake_world(mesh_kind, device) as mesh``: a fake process
    group of the mesh's size (this process is its rank ``rank``, 0 by
    default) and the mesh over it, taken down on exit; ``mesh`` is None
    for ``none``."""

    def __init__(self, mesh_kind: str, device: str, rank: int = 0) -> None:
        self.layout = parse_mesh(mesh_kind)
        self.device = device
        self.rank = rank

    def __enter__(self):
        if self.layout is None:
            return None
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_mesh, make_production_mesh
        shape, axes = self.layout
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank,
                                world_size=math.prod(shape))
        try:
            if axes == ("data", "model") and shape == (16, 16):
                return make_production_mesh(device_type=self.device)
            if len(shape) == 3 and shape == (2, 16, 16):
                return make_production_mesh(multi_pod=True,
                                            device_type=self.device)
            return make_mesh(shape, axes, device_type=self.device)
        except BaseException:
            dist.destroy_process_group()
            raise

    def __exit__(self, *exc) -> None:
        if self.layout is not None:
            dist.destroy_process_group()
            # DTensor's sharding-propagation caches keep output specs on
            # this world's mesh; the next world's mesh of the same shape
            # and names is equal to it, so without this it would be served
            # this one's process groups (which name others on another rank)
            from torch.distributed.tensor.debug import (
                _clear_sharding_prop_cache)
            _clear_sharding_prop_cache()


def _derived(cfg: ModelConfig, ss: ShapeSpec, arch: str,
             layout, accum: Optional[int], remat: Optional[str],
             attn_block: int) -> Tuple[ModelConfig, int, str]:
    """JAX's per-cell settings: remat, the accum table, and the
    activation-pinning and MoE-group fields from the data axes."""
    if remat is None:
        remat = "full" if ss.kind == "train" else "none"
    if accum is None:
        # keep per-microbatch tokens <= 64k tokens/device-row to bound
        # activation memory on the big archs
        accum = 1
        if ss.kind == "train":
            accum = {"jamba-v0.1-52b": 8, "mixtral-8x22b": 8,
                     "starcoder2-7b": 4, "qwen2-vl-7b": 4,
                     "phi4-mini-3.8b": 4, "granite-moe-3b-a800m": 2,
                     }.get(arch, 2)
    sizes = dict(zip(layout[1], layout[0])) if layout else {}
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_n = math.prod(sizes[a] for a in dp) if dp else 1
    act_dp = dp if (attn_block and ss.global_batch % dp_n == 0) else ()
    act_sp = "model" if (act_dp and ss.kind in ("train", "prefill")
                         and ss.seq_len % sizes.get("model", 1) == 0
                         ) else None
    moe_groups = dp_n if (attn_block and cfg.moe is not None
                          and ss.global_batch % dp_n == 0) else 0
    cfg = dataclasses.replace(cfg, remat=remat, attn_block_k=attn_block,
                              act_dp=act_dp, act_sp=act_sp,
                              moe_groups=moe_groups)
    return cfg, accum, remat


def flops_rank(cfg: ModelConfig, layout) -> Tuple[int, int]:
    """``(rank, model coordinate)`` of the rank a cell is traced on: rank
    0, or where ``cfg.act_sp`` shards attention's query rows, the rank at
    the last coordinate of that axis and the first of every other (the
    mesh is row-major), whose rows keep the most pairs under a causal or
    window mask (a row's kept keys never fall as its position grows)."""
    if layout is None or cfg.act_sp is None:
        return 0, 0
    shape, axes = layout
    if cfg.act_sp not in axes:
        return 0, 0
    i = axes.index(cfg.act_sp)
    last = shape[i] - 1
    return last * math.prod(shape[i + 1:]), last


def _fake_args(structs: Any, device: str) -> Any:
    """Fake tensors shaped like the ``meta`` structs, on ``device``
    (called under the fake mode)."""
    return tree_unflatten(structs, [
        torch.empty(t.shape, dtype=t.dtype, device=device)
        for _, t in tree_flatten_with_path(structs)])


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def argument_bytes(placed: Any) -> int:
    """Rank 0's bytes of a placed argument tree: each leaf's local
    piece."""
    return sum(_bytes(_local(t)) for _, t in tree_flatten_with_path(placed))


def place_arguments(bundle, args: tuple) -> Tuple[tuple, tuple]:
    """``(placed, given)``: the bundle's arguments ``args`` (every rank's
    alike) placed by ``StepBundle.place`` (as they are without a mesh),
    and those the step is given. A train step is given the global batch,
    as every rank is (``TrainLoop``), and shards it itself; its local
    share is counted among the placed arguments, as JAX's ``in_specs``
    place it."""
    placed = (bundle.place(*args) if isinstance(bundle.mesh, DeviceMesh)
              else args)
    given = (placed[:2] + args[2:]) if bundle.kind == "train" else placed
    return placed, given


def trace_step(cfg: ModelConfig, ss: ShapeSpec, mesh, device: str, *,
               accum: int = 1, compress: bool = False) -> Dict[str, Any]:
    """One step of ``build_step_bundle(cfg, ss, mesh)`` run on fake
    tensors (``mesh`` a ``DeviceMesh`` over a world, or None for one
    device: the bundle of a ``(1, 1)`` abstract mesh): its
    ``StepCounter`` (``counter``), this rank's ``memory`` bytes (arguments,
    outputs, aliases, temporaries), what the temporaries' peak held
    (``peak_live``) and the seconds spent building and placing
    (``lower_s``) and stepping (``step_s``)."""
    from repro_torch.launch.steps import build_step_bundle
    from repro_torch.optim.adamw import AdamWConfig
    t0 = time.perf_counter()
    one = AbstractMesh((1, 1), ("data", "model"))
    bundle = build_step_bundle(cfg, ss, one if mesh is None else mesh,
                               opt_cfg=AdamWConfig(), accum=accum,
                               compress_crosspod=compress)
    fake = _tracked_fake_mode(device)
    with fake:
        placed, given = place_arguments(bundle, tuple(
            _fake_args(st, device) for st in bundle.arg_structs))
        arg_bytes = argument_bytes(placed)
        held = {id(_local(t).untyped_storage())
                for _, t in tree_flatten_with_path(given)}
        del placed
        fake.hold(_local(t) for _, t in tree_flatten_with_path(given))
        lower_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        counter = StepCounter(mesh)
        fake.tracking = True
        with counter:
            out = bundle.fn(*given)
        fake.tracking = False
        step_s = time.perf_counter() - t0
        outs = [_local(t) for _, t in tree_flatten_with_path(out)]
        memory = {"argument_bytes": arg_bytes,
                  "output_bytes": sum(_bytes(t) for t in outs),
                  "temp_bytes": fake.peak,
                  "alias_bytes": sum(_bytes(t) for t in outs
                                     if id(t.untyped_storage()) in held)}
        del out, outs, given
    return {"counter": counter, "memory": memory, "lower_s": lower_s,
            "step_s": step_s, "peak_live": fake.peak_live}


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             accum: Optional[int] = None,
             remat: Optional[str] = None,
             compress: bool = False,
             attn_block: int = 0,
             rules_name: str = "default",
             device: str = "cuda",
             periods: int = 0,
             dtype: str = "") -> Dict[str, Any]:
    """Run one cell's step on fake tensors in a fake world; return the
    report dict (JAX's keys, plus ``device``, ``fits``, ``peak_live``,
    ``collectives_by_axis``, ``collective_links`` and ``datasheet``).
    ``periods`` cuts the config to that many layer periods
    (``scale_layers``); ``dtype`` overrides both its dtypes."""
    cfg = get_config(arch)
    ok, why = applicable(cfg, shape)
    cell: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                            "rules": rules_name, "status": "skip",
                            "skip_reason": why}
    if not ok:
        return cell
    ss = parse_shape(shape)
    layout = parse_mesh(mesh_kind)
    cfg, accum, remat = _derived(cfg, ss, arch, layout, accum, remat,
                                 attn_block)
    traced, model_rank = flops_rank(cfg, layout)
    world = fake_world(mesh_kind, device, traced)
    if periods:
        cfg = scale_layers(cfg, periods)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    n_chips = math.prod(world.layout[0]) if world.layout else 1

    with world as mesh:
        tr = trace_step(cfg, ss, mesh, device, accum=accum,
                        compress=compress)
    counter, mem = tr["counter"], tr["memory"]

    flops_dev, bytes_dev = float(counter.flops), float(counter.bytes)
    coll = {k: float(v) for k, v in counter.collectives.items()}
    coll_total = sum(coll.values())
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = (counter.by_link["nvlink"] / NVLINK_BW
                    + counter.by_link["infiniband"] / IB_BW)

    n_params = param_count(cfg)
    n_active = param_count(cfg, active=True)
    if ss.kind == "train":
        model_flops = 6 * n_active * ss.global_batch * ss.seq_len
    elif ss.kind == "prefill":
        model_flops = 2 * n_active * ss.global_batch * ss.seq_len
    else:
        model_flops = 2 * n_active * ss.global_batch  # one token a row
    model_flops_dev = model_flops / n_chips
    step_s = max(compute_s, memory_s, collective_s)
    dom = max((("compute", compute_s), ("memory", memory_s),
               ("collective", collective_s)), key=lambda kv: kv[1])[0]

    cell.update({
        "status": "ok",
        "kind": ss.kind,
        "accum": accum,
        "remat": remat,
        "attn_block": attn_block,
        "flops_model_rank": model_rank,
        "n_chips": n_chips,
        "measure_mode": "eager-full-depth(every layer counted)",
        "raw_full_compile": {"flops": flops_dev, "bytes": bytes_dev,
                             "coll": coll},
        "lower_s": round(tr["lower_s"], 2),
        "compile_s": round(tr["step_s"], 2),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_total,
        "collectives": coll,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dom,
        "step_s_est": step_s,
        "params": n_params,
        "params_active": n_active,
        "model_flops_per_device": model_flops_dev,
        "useful_flop_ratio": (model_flops_dev / flops_dev
                              if flops_dev else 0.0),
        "roofline_frac": (model_flops_dev / PEAK_FLOPS / step_s
                          if step_s > 0 else 0.0),
        "memory": mem,
        "device": device,
        "fits": mem["argument_bytes"] + mem["temp_bytes"] <= HBM_BYTES,
        "peak_live": tr["peak_live"],
        "collectives_by_axis": counter.by_axis,
        "collective_links": dict(counter.by_link),
        "datasheet": {"source": "NVIDIA H100 SXM datasheet (computed, "
                                "not measured)",
                      "peak_flops_bf16": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "hbm_bytes": HBM_BYTES, "nvlink_bw": NVLINK_BW,
                      "ib_bw": IB_BW, "node_cards": NODE_CARDS},
    })
    return cell


def cell_path(outdir: str, arch: str, shape: str, mesh_kind: str) -> str:
    return os.path.join(outdir, f"{arch}__{shape}__{mesh_kind}.json")


def _one_cell(kw: Dict[str, Any]) -> Dict[str, Any]:
    """A child process's cell: fake tracing does no arithmetic, so one
    thread."""
    torch.set_num_threads(1)
    return run_cell(**kw)


def _require_device(device: str) -> None:
    if device == "cuda" and not torch.backends.cuda.is_built():
        raise SystemExit("dryrun: --device cuda traces fake CUDA tensors "
                         "and needs a CUDA build of torch; pass --device "
                         "cpu for the plain versions on the CPU")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="shape cell, or kind:BxS (default: all)")
    ap.add_argument("--mesh", default="pod,multipod",
                    help="pod, multipod, none or DxM, comma-joined")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="cell directory (default experiments/dryrun_torch, "
                         "or experiments/dryrun_torch_attn<N> with "
                         "--attn-block N)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod gradient all-reduce")
    ap.add_argument("--attn-block", type=int, default=0,
                    help="KV block for streaming attention (0=dense): JAX's "
                         "streaming layout (q/k/v pinned over the data "
                         "axes, q's rows over model; local MoE groups)")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--rules", default="default")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="fake tensors' device (cuda: the kernels' ops)")
    ap.add_argument("--periods", type=int, default=0,
                    help="cut the config to this many layer periods")
    ap.add_argument("--dtype", default="",
                    help="override the config's dtype and param_dtype")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own "
                         "(1: one after another in this process)")
    args = ap.parse_args(argv)
    _require_device(args.device)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = args.mesh.split(",")
    if args.out is None:
        args.out = "experiments/dryrun_torch" + (
            f"_attn{args.attn_block}" if args.attn_block else "")
    os.makedirs(args.out, exist_ok=True)

    todo = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                p = cell_path(args.out, arch, shape, mk)
                if (os.path.exists(p) and not args.force
                        and args.rules == "default"):
                    print(f"[cached] {arch} {shape} {mk}")
                    continue
                todo.append((p, dict(
                    arch=arch, shape=shape, mesh_kind=mk, accum=args.accum,
                    remat=args.remat, compress=args.compress,
                    attn_block=args.attn_block, rules_name=args.rules,
                    device=args.device, periods=args.periods,
                    dtype=args.dtype)))

    failures = 0
    # the default process group is one per process: each cell sets up its
    # fake world and takes it down, so cells run one after another here,
    # or at once in processes of their own
    pool = None
    if args.jobs > 1 and len(todo) > 1:
        pool = ProcessPoolExecutor(
            max_workers=max(args.jobs, 1), max_tasks_per_child=1,
            mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [(p, kw, pool.submit(_one_cell, kw) if pool else None)
                   for p, kw in todo]
        for p, kw, fut in futures:
            tag = f"{kw['arch']} × {kw['shape']} × {kw['mesh_kind']}"
            try:
                cell = fut.result() if fut else _one_cell(kw)
            except Exception as e:
                traceback.print_exception(e)
                cell = {"arch": kw["arch"], "shape": kw["shape"],
                        "mesh": kw["mesh_kind"], "status": "fail",
                        "error": f"{type(e).__name__}: {e}"}
                failures += 1
            if args.rules == "default":
                with open(p, "w") as f:
                    json.dump(cell, f, indent=1)
            st = cell["status"]
            extra = ""
            if st == "ok":
                mem = cell["memory"]
                extra = (f" fits={cell['fits']}"
                         f" args={mem['argument_bytes'] / 1e9:.2f}GB"
                         f" temp={mem['temp_bytes'] / 1e9:.2f}GB"
                         f" dom={cell['dominant']}"
                         f" comp={cell['compute_s']:.3e}s"
                         f" mem={cell['memory_s']:.3e}s"
                         f" coll={cell['collective_s']:.3e}s"
                         f" useful={cell['useful_flop_ratio']:.2f}"
                         f" trace={cell['compile_s']:.0f}s")
            elif st == "fail":
                extra = " " + cell.get("error", "")[:160]
            print(f"[{st}] {tag}{extra}", flush=True)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
