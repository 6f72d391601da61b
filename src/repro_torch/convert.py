"""State carried across from the JAX package.

The JAX engine keeps a table as ``values (K, C, V)``, ``ts (K, C)``,
``total (K,)``, the pre-aggregate tiers and a host ``key_to_idx`` dict.
Given those as numpy arrays (``np.asarray`` of each JAX array), these
helpers rebuild the same table in the port on a given device, and turn
PREDICT parameters given as numpy into tensors — so both packages can
compute on identical state.

The model tier's parameters and caches (KV and SSM) are pytrees of
arrays; the port keeps the JAX layouts (linear weights
``(d_in, d_out)``, blocks and caches stacked per pattern position on a
leading ``reps`` axis), so ``lm_params`` and ``lm_cache`` map a tree of
numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``) leaf for
leaf onto tensors, keeping each dtype (bf16 included); an
encoder-decoder's trees (``encdec.init_encdec``, the decoder cache) go
through the same two functions.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.models import blocks
from repro_torch.models.tree import tree_map
from repro_torch.optim.adamw import OptState
from repro_torch.featurestore.table import (PreAggState, Table,
                                            TableSnapshot, TableState)

__all__ = ["table_state", "preagg_state", "load_table", "to_tensors",
           "lm_params", "lm_cache", "opt_state"]

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


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array as a tensor of the same dtype on ``device``; JAX's
    bfloat16 arrays (an ml_dtypes type numpy cannot hand to torch) go
    across bit for bit."""
    a = np.array(a)       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree_tensors(tree: Any, device) -> Any:
    return tree_map(lambda a: _tensor(a, device), tree)


def lm_params(tree: Mapping[str, Any], cfg, device) -> Dict[str, Any]:
    """The JAX package's ``lm.init_lm`` parameters (as numpy) as the
    port's parameters on ``device``: every block kind's leaves (``attn``,
    ``mlp``, ``mamba``, ``moe`` with its ``experts``/``shared`` stacked on
    the expert axis) keep their layouts and dtypes. For an encoder-decoder
    config, ``encdec.init_encdec``'s tree (``enc_blocks``, ``enc_norm``,
    ``embed``, ``dec_blocks``, ``final_norm``), leaf for leaf."""
    if cfg.is_encdec:
        want = {"enc_blocks", "enc_norm", "embed", "dec_blocks",
                "final_norm"}
    else:
        want = {"embed", "blocks", "final_norm"} | (
            set() if cfg.tie_embeddings else {"lm_head"})
    if set(tree) != want:
        raise ValueError(f"parameter tree has {sorted(tree)}, expected "
                         f"{sorted(want)} for {cfg.name}")
    return _tree_tensors(dict(tree), device)


def lm_cache(tree: Any, cfg, device) -> Any:
    """A JAX cache tree (``lm.init_cache`` / ``lm.prefill`` layout: a
    tuple per pattern position of ``{"k", "v"}`` for attention layers or
    ``{"conv", "ssm"}`` for Mamba layers, stacked on ``reps``, as numpy)
    as the port's cache on ``device``. For an encoder-decoder config, the
    decoder's ``{"k", "v"}`` stacked on its layers
    (``encdec.init_dec_cache`` / ``encdec.dec_prefill``)."""
    if cfg.is_encdec:
        if not isinstance(tree, Mapping) or set(tree) != {"k", "v"}:
            raise ValueError(f"{cfg.name}: the decoder cache is a "
                             f"{{'k', 'v'}} dict, got {type(tree).__name__}")
        return _tree_tensors(dict(tree), device)
    pattern = blocks.normalize_pattern(cfg)
    if len(tree) != len(pattern):
        raise ValueError(f"cache has {len(tree)} pattern positions, "
                         f"{cfg.name} has {len(pattern)}")
    for token, c in zip(pattern, tree):
        want = {"k", "v"} if token[0] == "a" else {"conv", "ssm"}
        if set(c) != want:
            raise ValueError(f"cache of block kind {token!r} has "
                             f"{sorted(c)}, expected {sorted(want)}")
    return tuple(_tree_tensors(dict(c), device) for c in tree)


def opt_state(state: Any, cfg, device) -> OptState:
    """The JAX package's ``OptState`` (``m``, ``v``, ``count``,
    ``master``, as numpy: ``jax.tree_util.tree_map(np.asarray, state)``)
    as the port's on ``device``. ``m``, ``v`` and ``master`` are parameter
    trees (f32), ``count`` the int32 step counter."""
    return OptState(
        m=lm_params(state.m, cfg, device), v=lm_params(state.v, cfg, device),
        count=torch.tensor(np.asarray(state.count, np.int32), device=device),
        master=(None if state.master is None
                else lm_params(state.master, cfg, device)))
