"""Consistent-hash ring: elastic key -> shard ownership (DESIGN.md §11).

The modulo partitioner (``shard_of``) is pure in ``(key, n_shards)`` —
perfect while the shard count never changes, but growing N remaps
(N-1)/N of the key space at once. The ring maps keys to the **successor
virtual node** on a 32-bit hash circle instead: adding or removing one
shard only moves the key ranges adjacent to its virtual nodes (~1/N of
the space), so resharding is a bounded background migration instead of
a full rebuild.

Two layers:

* :class:`HashRing` — immutable ownership function. ``vnodes`` points
  per shard (crc32 of ``"shard:<s>:vnode:<v>"``), sorted once;
  ``owners_of`` is one vectorised ``np.searchsorted`` over the batch.
* :class:`RouteTable` — the *mutable* routing state the engine serves
  from **during** a migration. Built over the merged point set of the
  old and new rings, it starts extensionally equal to the old ring and
  is flipped interval-by-interval as each key range finishes copying —
  readers always see a consistent owner for any key, and a range's flip
  is a single int store.

Hashes intentionally reuse the router's Knuth/crc32 family so a ring
with the hash ranges of exactly one shard degenerates gracefully and
scalar/vectorised paths route identically.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = ["key_hash", "key_hashes", "HashRing", "RouteTable",
           "ModuloRouting"]

# same multiplicative constant as shard/router.py and featurestore.keydir
_MULT = 2654435761
_MASK32 = 0xFFFFFFFF


def key_hash(key) -> int:
    """32-bit routing hash of one key — pure, stable forever, identical
    to the hash family ``shard_of`` reduces modulo N."""
    if isinstance(key, np.generic):
        key = key.item()      # repr(np.str_) differs across numpy majors
    if isinstance(key, int) and not isinstance(key, bool):
        return (key & _MASK32) * _MULT & _MASK32
    return zlib.crc32(repr(key).encode()) & _MASK32


def key_hashes(keys: np.ndarray) -> np.ndarray:
    """Vectorised :func:`key_hash` -> (B,) uint64 (values < 2**32)."""
    keys = np.asarray(keys)
    if keys.dtype.kind in "iu":
        return ((keys.astype(np.uint64) & _MASK32) * _MULT) & _MASK32
    return np.asarray([key_hash(k) for k in keys.tolist()], np.uint64)


class HashRing:
    """Immutable consistent-hash ring over a set of shard slot ids."""

    def __init__(self, shards: Iterable[int], vnodes: int = 64):
        self.shard_set: Tuple[int, ...] = tuple(sorted(set(shards)))
        if not self.shard_set:
            raise ValueError("a hash ring needs at least one shard")
        self.vnodes = int(vnodes)
        pts: List[int] = []
        owner: List[int] = []
        for s in self.shard_set:
            for v in range(self.vnodes):
                pts.append(zlib.crc32(f"shard:{s}:vnode:{v}".encode())
                           & _MASK32)
                owner.append(s)
        p = np.asarray(pts, np.uint64)
        o = np.asarray(owner, np.int32)
        # stable order: by point, ties by owner id — both rings sharing a
        # collided point value resolve it the same way
        order = np.lexsort((o, p))
        self.points: np.ndarray = p[order]
        self.owners: np.ndarray = o[order]

    # ------------------------------------------------------------ ownership
    def owner_of_hash(self, h: int) -> int:
        i = int(np.searchsorted(self.points, np.uint64(h), side="left"))
        return int(self.owners[i % len(self.points)])

    def owner(self, key) -> int:
        return self.owner_of_hash(key_hash(key))

    def owners_of(self, keys: np.ndarray) -> np.ndarray:
        h = key_hashes(keys)
        idx = np.searchsorted(self.points, h, side="left")
        return self.owners[idx % len(self.points)].astype(np.int32)

    # ------------------------------------------------------------ evolution
    def with_shard(self, shard: int) -> "HashRing":
        return HashRing(self.shard_set + (shard,), self.vnodes)

    def without_shard(self, shard: int) -> "HashRing":
        rest = tuple(s for s in self.shard_set if s != shard)
        return HashRing(rest, self.vnodes)

    def __repr__(self) -> str:
        return (f"HashRing(shards={self.shard_set}, "
                f"vnodes={self.vnodes})")


class RouteTable:
    """Mutable interval -> owner map serving reads during a migration.

    Intervals are the elementary arcs of the merged point set of the old
    and the new ring: within one arc both rings are constant, so a
    migration step ("this arc now belongs to shard t") is one element
    store into ``cur``. ``owners_of`` stays a single ``searchsorted``.
    Arc ``i`` covers hashes ``(points[i-1], points[i]]`` with the usual
    wraparound for ``i == 0``.
    """

    def __init__(self, ring: HashRing):
        self.points = ring.points.copy()
        self.cur = ring.owners.astype(np.int32).copy()

    @classmethod
    def merged(cls, old: HashRing, new: HashRing) -> "RouteTable":
        """Route table over the union point set, initially routing
        exactly like ``old``."""
        rt = cls.__new__(cls)
        pts = np.union1d(old.points, new.points)
        rt.points = pts.astype(np.uint64)
        rt.cur = np.asarray([old.owner_of_hash(int(p)) for p in pts],
                            np.int32)
        return rt

    def plan_against(self, new: HashRing) -> List[int]:
        """Arc indices whose owner must change to make this table route
        like ``new`` — the migration work list."""
        tgt = np.asarray([new.owner_of_hash(int(p)) for p in self.points],
                         np.int32)
        return [int(i) for i in np.flatnonzero(tgt != self.cur)]

    # ------------------------------------------------------------ ownership
    def arc_of_hashes(self, h: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.points, h, side="left") \
            % len(self.points)

    def owner(self, key) -> int:
        i = int(np.searchsorted(self.points, np.uint64(key_hash(key)),
                                side="left"))
        return int(self.cur[i % len(self.points)])

    def owners_of(self, keys: np.ndarray) -> np.ndarray:
        return self.cur[self.arc_of_hashes(key_hashes(keys))]

    def set_owner(self, arcs: Sequence[int], owner: int) -> None:
        for i in arcs:
            self.cur[i] = owner

    def arc_owner(self, arc: int) -> int:
        return int(self.cur[arc])

    def shard_counts(self) -> Dict[int, int]:
        u, c = np.unique(self.cur, return_counts=True)
        return {int(s): int(n) for s, n in zip(u, c)}


class ModuloRouting:
    """The original ``hash % N`` partitioner behind the same owner API —
    kept as an explicit escape hatch (``ShardConfig(partitioner=
    "modulo")``); it cannot reshard."""

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)

    def owner(self, key) -> int:
        if self.n_shards <= 1:
            return 0
        return key_hash(key) % self.n_shards

    def owners_of(self, keys: np.ndarray) -> np.ndarray:
        if self.n_shards <= 1:
            return np.zeros(len(keys), np.int32)
        return (key_hashes(keys) % self.n_shards).astype(np.int32)
