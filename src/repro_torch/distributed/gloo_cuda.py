"""DTensor's collectives on CUDA tensors over gloo, through the
synchronous c10d calls.

Several processes that share one card cannot join an NCCL group (NCCL
refuses two ranks on one device), so such a world talks over gloo. On
torch 2.11 gloo carries ``all_reduce``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` on CUDA tensors through ``torch.distributed``,
but DTensor's redistributions go through the functional collectives
(``torch.ops._c10d_functional``), and waiting on one of those over gloo
with CUDA tensors crashes the process. ``install()`` registers, for the
CUDA dispatch key only, implementations of the functional collectives
DTensor issues (and of its ``shard_dim_alltoall``, which gloo lacks)
that run the synchronous c10d call and return its result, so the
``wait`` that follows has nothing to wait on. Each call copies its
input to pageable host memory, runs gloo's CPU collective and copies
the result back to the input's device: gloo's own CUDA path stages
through pinned buffers that the caching host allocator keeps, one per
rounded size, for the life of the process. The CPU's kernels are
untouched. A process calls it
once, after ``init_process_group``, before any DTensor work; nothing
calls it implicitly.
"""
from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist
import torch.distributed.tensor  # noqa: F401  (defines the _dtensor ops)
from torch.distributed.distributed_c10d import _resolve_process_group

__all__ = ["install"]

_LIBS: dict = {}          # dispatch key -> the torch.library handles

_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _group(group_name: Any) -> dist.ProcessGroup:
    if isinstance(group_name, dist.ProcessGroup):
        return group_name
    return _resolve_process_group(group_name)


def _op(reduce_op: str) -> dist.ReduceOp:
    if reduce_op.lower() not in _OPS:
        raise ValueError(f"reduce op {reduce_op!r} not supported")
    return _OPS[reduce_op.lower()]


def _host(x: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """``x`` contiguous in host memory (a copy where ``copy``, or where it
    lies on the card)."""
    return x.to("cpu", copy=copy, memory_format=torch.contiguous_format)


def _all_gather(input: torch.Tensor, group_size: int, group_name: Any
                ) -> torch.Tensor:
    x = _host(input)
    out = x.new_empty((x.shape[0] * group_size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=_group(group_name))
    return out.to(input.device)


def _reduce_scatter(input: torch.Tensor, reduce_op: str, group_size: int,
                    group_name: Any) -> torch.Tensor:
    x = _host(input)
    out = x.new_empty((x.shape[0] // group_size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=_op(reduce_op),
                               group=_group(group_name))
    out = out.to(input.device)
    return out / group_size if reduce_op.lower() == "avg" else out


def _all_reduce(input: torch.Tensor, reduce_op: str, group_name: Any
                ) -> torch.Tensor:
    out = _host(input, copy=True)
    pg = _group(group_name)
    dist.all_reduce(out, op=_op(reduce_op), group=pg)
    out = out.to(input.device)
    return out / pg.size() if reduce_op.lower() == "avg" else out


def _broadcast(input: torch.Tensor, src: int, group_name: Any
               ) -> torch.Tensor:
    out = _host(input, copy=True)
    pg = _group(group_name)
    dist.broadcast(out, src=dist.get_global_rank(pg, src), group=pg)
    return out.to(input.device)


def _gather_dim(x: torch.Tensor, dim: int, pg: dist.ProcessGroup
                ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in group order."""
    n = pg.size()
    stacked = _all_gather(x.unsqueeze(0), n, pg)
    return torch.cat(stacked.unbind(0), dim=dim)


def _all_to_all_single(input: torch.Tensor, output_split_sizes: List[int],
                       input_split_sizes: List[int], group_name: Any
                       ) -> torch.Tensor:
    pg = _group(group_name)
    n, r = pg.size(), pg.rank()
    rows = input.shape[0]
    even = [rows // n] * n
    if (list(input_split_sizes or even) != even
            or list(output_split_sizes or even) != even or rows % n):
        raise ValueError("all_to_all_single over gloo on CUDA takes even "
                         "splits only")
    everyone = _all_gather(input.contiguous(), n, pg).view(
        (n, n, rows // n) + tuple(input.shape[1:]))
    return everyone[:, r].reshape((rows,) + tuple(input.shape[1:]))


def _shard_dim_alltoall(input: torch.Tensor, gather_dim: int,
                        shard_dim: int, group_name: Any) -> torch.Tensor:
    pg = _group(group_name)
    full = _gather_dim(input.contiguous(), gather_dim, pg)
    return full.chunk(pg.size(), dim=shard_dim)[pg.rank()].contiguous()


def install(dispatch_key: str = "CUDA") -> None:
    """Register the implementations for ``dispatch_key`` (the card's
    ``CUDA``; the tests register ``CPU`` in a process of their own to run
    them where there is no card). Idempotent."""
    if dispatch_key in _LIBS:
        return
    funcol = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_gather_into_tensor", _all_gather),
                     ("reduce_scatter_tensor", _reduce_scatter),
                     ("all_reduce", _all_reduce),
                     ("broadcast", _broadcast),
                     ("all_to_all_single", _all_to_all_single)):
        funcol.impl(name, fn, dispatch_key)
    dtensor = torch.library.Library("_dtensor", "IMPL")
    dtensor.impl("shard_dim_alltoall", _shard_dim_alltoall, dispatch_key)
    _LIBS[dispatch_key] = (funcol, dtensor)
