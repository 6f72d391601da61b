"""Elastic restore: load a checkpoint onto a *different* mesh (the JAX
package's ``repro.checkpoint.reshard``).

Checkpoints store full (unsharded) host arrays per leaf (manager.py), so
resharding is placement only: every leaf is placed on the new mesh by
its freshly derived spec (``sharding.distribute``, each rank keeping its
own slice of what it read), or left whole where there is no mesh. The
values are the saved ones bit for bit, whatever mesh wrote them. This
supports scaling the data axis up or down, and changing the rule table
between a training and a serving restore.

For 1000+-node restores a rank would stream its shards instead of full
arrays: the manifest records per-leaf shapes, so a sharded reader can
seek exactly its slice of each ``.npy`` (header + C-contiguous payload);
``leaf_slice_bytes`` computes those offsets.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, CheckpointMeta
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              distribute, param_specs)
from repro_torch.models.tree import tree_flatten_with_path

__all__ = ["restore_resharded", "save_unsharded_spec", "leaf_slice_bytes"]


def restore_resharded(mgr: CheckpointManager, step: Optional[int],
                      like: Any, mesh=None, specs: Optional[Any] = None,
                      rules: ShardingRules = DEFAULT_RULES
                      ) -> Tuple[Any, CheckpointMeta]:
    """Restore a ``like``-shaped tree and place it on ``mesh`` (a
    ``DeviceMesh``), or whole on ``like``'s devices where ``mesh`` is
    None. ``specs`` defaults to the parameter rules — pass explicit specs
    for optimizer state or caches."""
    tree, meta = mgr.restore(step, like)
    if mesh is None:
        return tree, meta
    if specs is None:
        specs = param_specs(tree, mesh, rules)
    return distribute(tree, mesh, specs), meta


def save_unsharded_spec(tree: Any) -> Dict[str, Any]:
    """Manifest fragment describing each leaf for sharded readers."""
    out = {}
    for path, leaf in tree_flatten_with_path(tree):
        name = "__".join(str(k) for k in path)
        dtype = (str(leaf.dtype).replace("torch.", "")
                 if isinstance(leaf, torch.Tensor)
                 else str(np.asarray(leaf).dtype))
        out[name] = {"shape": list(np.shape(leaf)), "dtype": dtype}
    return out


def leaf_slice_bytes(shape, dtype, axis: int, shard: int, n_shards: int
                     ) -> Tuple[int, int]:
    """(offset, length) in bytes of one contiguous shard of a C-contiguous
    array sharded on ``axis`` — only meaningful when axis == 0 (leading-dim
    sharding reads are contiguous; others need strided reads). ``dtype``
    is a numpy or a torch dtype."""
    if axis != 0:
        raise ValueError("contiguous partial reads need leading-axis shards")
    itemsize = (torch.empty((), dtype=dtype).element_size()
                if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize)
    row = int(np.prod(shape[1:])) * itemsize if len(shape) > 1 else itemsize
    per = shape[0] // n_shards
    return shard * per * row, per * row
