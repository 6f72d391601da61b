"""Nested dict/tuple/list trees of tensors: the port's parameter and cache
containers, in the JAX package's pytree layouts.

``tree_flatten_with_path`` and ``tree_unflatten`` walk a tree as
``jax.tree_util`` does: dict keys in sorted order, dataclass fields in
declaration order, ``None`` as an empty subtree. A path is a tuple of dict
keys and field names (strings) and sequence indices (ints), so the
optimizer's weight-decay mask and the checkpoint's leaf names come out as
the JAX package's do."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import torch

__all__ = ["tree_map", "tree_leaves", "layer_slice", "stacked_init",
           "tree_flatten_with_path", "tree_unflatten"]


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


def stacked_init(init_one: Callable[[], Any], n: int) -> Any:
    """``n`` trees from ``init_one()``, drawn in order into a preallocated
    stack on a leading axis (no second copy of the weights)."""
    first = init_one()
    stacked = tree_map(lambda a: torch.empty(
        (n,) + tuple(a.shape), dtype=a.dtype, device=a.device), first)
    tree_map(lambda s, a: s[0].copy_(a), stacked, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, a: s[i].copy_(a), stacked, init_one())
    return stacked


def tree_flatten_with_path(tree: Any, path: Tuple = ()
                           ) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, path + (i,))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pl for f in dataclasses.fields(tree)
                for pl in tree_flatten_with_path(getattr(tree, f.name),
                                                 path + (f.name,))]
    return [(path, tree)]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in
    ``tree_flatten_with_path(like)``'s order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
