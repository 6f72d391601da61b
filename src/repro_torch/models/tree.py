"""Nested dict/tuple/list trees of tensors: the port's parameter and cache
containers, in the JAX package's pytree layouts."""
from __future__ import annotations

from typing import Any, Callable, List

import torch

__all__ = ["tree_map", "tree_leaves", "layer_slice"]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), rebuilding the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def layer_slice(stacked: Any, i: int) -> Any:
    """Layer ``i`` of a tree stacked on a leading ``reps`` axis: views,
    so writes into a slice land in the stacked tree."""
    return tree_map(lambda a: a[i], stacked)
