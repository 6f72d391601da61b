"""State carried across from the JAX package.

The JAX engine keeps a table as ``values (K, C, V)``, ``ts (K, C)``,
``total (K,)``, the pre-aggregate tiers and a host ``key_to_idx`` dict.
Given those as numpy arrays (``np.asarray`` of each JAX array), these
helpers rebuild the same table in the port on a given device, and turn
PREDICT parameters given as numpy into tensors — so both packages can
compute on identical state.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.featurestore.table import (PreAggState, Table,
                                            TableSnapshot, TableState)

__all__ = ["table_state", "preagg_state", "load_table", "to_tensors"]

_PREAGG_FIELDS = ("sum", "sumsq", "min", "max", "count")


def table_state(values: np.ndarray, ts: np.ndarray, total: np.ndarray,
                device) -> TableState:
    """Ring arrays as a :class:`TableState` on ``device``."""
    return TableState(
        values=torch.tensor(np.asarray(values, np.float32), device=device),
        ts=torch.tensor(np.asarray(ts, np.float32), device=device),
        total=torch.tensor(np.asarray(total, np.int32), device=device))


def preagg_state(tiers: Mapping[str, np.ndarray], device) -> PreAggState:
    """``{"sum", "sumsq", "min", "max", "count"}`` arrays as a
    :class:`PreAggState` on ``device``."""
    missing = [f for f in _PREAGG_FIELDS if f not in tiers]
    if missing:
        raise ValueError(f"pre-aggregate tiers missing {missing}")
    return PreAggState(**{
        f: torch.tensor(np.asarray(tiers[f], np.float32), device=device)
        for f in _PREAGG_FIELDS})


def load_table(table: Table, *, values: np.ndarray, ts: np.ndarray,
               total: np.ndarray, key_to_idx: Mapping[Any, int],
               preagg: Optional[Mapping[str, np.ndarray]] = None
               ) -> TableSnapshot:
    """Replace ``table``'s contents with the given state and publish it.

    ``table`` must have the same shape (max_keys, capacity, columns,
    bucket size) as the state's source and hold no keys yet. The key
    directory, the per-key ingest frontier and the watermark are rebuilt
    from the state, so later inserts and requests behave as they would on
    the source table.
    """
    K, C = table.max_keys, table.capacity
    V = len(table.schema.value_cols)
    if np.shape(values) != (K, C, V) or np.shape(ts) != (K, C) \
            or np.shape(total) != (K,):
        raise ValueError(
            f"state shapes {np.shape(values)}, {np.shape(ts)}, "
            f"{np.shape(total)} do not fit table {table.schema.name!r} "
            f"({K}, {C}, {V})")
    if table.n_keys:
        raise ValueError(f"table {table.schema.name!r} already holds keys")
    if (preagg is None) != (table.preagg is None):
        raise ValueError("pre-aggregate tiers must be given exactly when "
                         "the table keeps them")
    state = table_state(values, ts, total, table.device)
    pa = preagg_state(preagg, table.device) if preagg is not None else None
    if pa is not None and tuple(pa.count.shape) != tuple(
            table.preagg.count.shape):
        raise ValueError(f"pre-aggregate tiers {tuple(pa.count.shape)} do "
                         f"not fit {tuple(table.preagg.count.shape)}")
    for key, idx in sorted(key_to_idx.items(), key=lambda kv: kv[1]):
        table.key_to_idx[key] = int(idx)
        table.keydir.insert(key, int(idx))
    total = np.asarray(total, np.int64)
    ts = np.asarray(ts, np.float32)
    last: Dict[int, float] = {
        int(k): float(ts[k, (total[k] - 1) % C])
        for k in np.nonzero(total > 0)[0]}
    table._last_ts = last
    table._watermark = max(last.values(), default=float("-inf"))
    return table.publish(state, pa)


def to_tensors(tree: Any, device) -> Any:
    """Numpy arrays and numbers in a tuple/list/dict tree as float32
    tensors on ``device`` (PREDICT parameters)."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_tensors(v, device) for v in tree)
    if tree is None:
        return None
    return torch.tensor(np.asarray(tree, np.float32), device=device)
