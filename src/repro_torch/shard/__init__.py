"""Sharded serving runtime: hash-partitioned shard engines behind the
single-engine API (DESIGN.md §9, §11).

``ShardedEngine`` wraps N key-hash-partitioned shard engines — in this
process (default), each on its device (the engine's, or ``cuda:{s % D}``
with several cards), or one subprocess per shard (``backend="process"``
/ ``REPRO_SHARD_BACKEND=process``, see ``shard/proc/``); a
``ShardRouter`` scatters request batches to per-shard coalescing lanes
and gathers rows back in request order; a consistent-hash ring
(``shard/ring.py``) owns key -> shard placement so the shard count can
grow/shrink under live traffic; a ``ResourceManager`` bounds
per-deployment concurrency and sheds past-deadline (or dead-worker)
work whole-batch.
"""
from repro_torch.shard.engine import (ShardConfig, ShardedDeploymentHandle,
                                      ShardedEngine, ShardedPipeline,
                                      shard_device)
from repro_torch.shard.resource import AdmissionConfig, ResourceManager
from repro_torch.shard.ring import HashRing, ModuloRouting, RouteTable, \
    key_hash, key_hashes
from repro_torch.shard.router import ShardDownError, ShardRouter, \
    shard_ids, shard_of

__all__ = ["ShardConfig", "ShardedEngine", "ShardedDeploymentHandle",
           "ShardedPipeline", "AdmissionConfig", "ResourceManager",
           "ShardRouter", "ShardDownError", "shard_ids", "shard_of",
           "HashRing", "RouteTable", "ModuloRouting", "key_hash",
           "key_hashes", "shard_device"]
