"""Compression-aware collectives over the ``pod`` axis of a
``DeviceMesh`` (the JAX package's ``repro.distributed.collectives``).

The hot cross-pod path is the gradient all-reduce over ``pod``.
``psum_int8`` runs it at a quarter of the f32 bytes on the wire's payload
(int8 codes, summed as int32, plus one f32 scale per tensor): the scale is
agreed by an f32 ``all_reduce(MAX)`` of ``|x|.max()``, each rank quantizes
against it, and the codes are summed by an ``all_reduce(SUM)``. Where the
JAX package enters ``shard_map`` over the pod axis, every rank here holds
its own per-pod values and calls the collective on the axis's process
group (``mesh.get_group("pod")``). A mesh without a ``pod`` axis leaves
the tree as it is.

``all_to_all`` is the exchange of expert parallelism (``models/moe.py``):
equal chunks of a tensor's leading dim go one to each rank of a mesh
axis, inside autograd, its backward the reverse exchange. It runs through
the functional ``all_to_all_single``, which ``gloo_cuda.install``
carries on CUDA tensors over gloo.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.tree import tree_map
from repro_torch.optim.compression import int8_codes

__all__ = ["psum_int8", "pod_allreduce_int8", "crosspod_grad_mean",
           "axis_size", "all_to_all"]


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis`` of ``mesh``; 1 where the mesh has no such
    axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(axis)] if axis in names else 1


def psum_int8(x: torch.Tensor, group, *, scale_group=None) -> torch.Tensor:
    """The int8-compressed sum of ``x`` over the ranks of ``group``, in
    f32. Bias is bounded by 0.5 · scale · ranks; pair with error feedback
    (``optim.compression.ErrorFeedback``) on the training path. The scale
    is agreed over ``scale_group`` (``group`` by default): where each rank
    holds a shard of the tensor, the group of every rank, so that one
    scale covers the whole tensor."""
    xf = x.float()
    amax = xf.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                    group=group if scale_group is None else scale_group)
    q, scale = int8_codes(xf, amax)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale


def pod_allreduce_int8(tree: Any, mesh: DeviceMesh, *, axis: str = "pod",
                       mean: bool = True) -> Any:
    """int8-compressed all-reduce of every leaf of ``tree`` over ``axis``
    (the per-pod values of each rank), averaged over the axis when
    ``mean``."""
    if axis not in (mesh.mesh_dim_names or ()):
        return tree
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    return tree_map(
        lambda g: psum_int8(g, group) / n if mean else psum_int8(g, group),
        tree)


def crosspod_grad_mean(grads: Any, mesh: DeviceMesh, *,
                       compress: bool = False) -> Any:
    """Average per-pod gradients across pods: an f32 all-reduce, or with
    ``compress`` the int8 one (a quarter of the payload)."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return grads
    if compress:
        return pod_allreduce_int8(grads, mesh, axis="pod", mean=True)
    group = mesh.get_group("pod")
    n = axis_size(mesh, "pod")

    def pmean(g: torch.Tensor) -> torch.Tensor:
        total = g.float().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total / n

    return tree_map(pmean, grads)


def _exchange(x: torch.Tensor, group_name: str, n: int) -> torch.Tensor:
    x = x.contiguous()
    splits = [x.shape[0] // n] * n
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_to_all_single(x, splits, splits, group_name))


class _AllToAll(torch.autograd.Function):
    """Chunk ``j`` of the leading dim to rank ``j``; the gradient of what
    rank ``i`` sent comes back from rank ``i`` the same way."""

    @staticmethod
    def forward(ctx, x, group_name, n):
        ctx.group_name, ctx.n = group_name, n
        return _exchange(x, group_name, n)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group_name, ctx.n), None, None


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``x``'s leading dim in ``n`` equal chunks (``n`` the ranks along
    ``axis``), chunk ``j`` sent to rank ``j`` of the axis; returns the
    chunks received, in rank order, as one tensor of ``x``'s shape.
    Differentiable: the backward is the reverse exchange."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all of {x.shape[0]} rows over {n} ranks")
    return _AllToAll.apply(x, mesh.get_group(axis).group_name, n)
