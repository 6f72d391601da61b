"""Device-resident key→dense-index directory (open-addressing hash).

``Table.key_to_idx`` (a host dict) stays authoritative for arbitrary key
types; this directory mirrors integer keys into a device-side linear-
probing hash table so the serving hot path resolves a WHOLE request batch
with one vectorised probe (hash → gather → compare) instead of a per-key
Python dict loop (``engine.DeploymentHandle._serve``). Unknown keys come
back as ``found=False`` and index 0 — exactly the engine's masking
contract for ``STATUS_UNKNOWN_KEY``.

Scope: keys must fit int32 (user/account ids do; the sentinel INT32_MIN
is reserved). The first non-integer or out-of-range key permanently
deactivates the directory (``active = False``) and the engine falls back
to the dict loop — correctness never depends on this mirror.

Hashing: multiplicative (Knuth) on the low 32 bits, taken modulo the
power-of-two table size. The host insert computes
``((k & 0xFFFFFFFF) * MULT) & mask`` with Python integers; the device probe
computes the same low bits as ``((q & mask) * (MULT & mask)) & mask`` in
int64 — equal because a product's low n bits depend only on the factors'
low n bits, and free of overflow because both factors are below 2^31. So
host inserts and device probes agree bit for bit on slot sequences.

Concurrency: inserts (ingest path) and lookups (serving path) may race.
Values are written before keys, so a concurrent snapshot never maps a
key to an uninitialised index; a lookup racing an insert may simply not
see the brand-new key yet (one stale-miss, masked as unknown — the same
visibility a caller gets by requesting before ingesting).
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["KeyDirectory"]

_EMPTY = -(2 ** 31)                 # int32 sentinel; rejected as a user key
_MULT = 2654435761                  # Knuth multiplicative constant (odd)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _probe(tkeys: torch.Tensor, tvals: torch.Tensor, q: torch.Tensor, *,
           probe: int, mask: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (B,) i32, found (B,) bool) of int64 keys ``q``."""
    h = ((q & mask) * (_MULT & mask)) & mask
    offs = torch.arange(probe, dtype=torch.int64, device=q.device)[None, :]
    slots = (h[:, None] + offs) & mask                   # (B, P)
    match = tkeys[slots] == q[:, None]
    found = match.any(1)
    # keys are unique in the table: at most one slot matches
    vals = torch.where(match, tvals[slots], 0).sum(1)
    return vals.to(torch.int32), found


class KeyDirectory:
    def __init__(self, max_keys: int, device: torch.device):
        self.device = torch.device(device)
        self.slots = _next_pow2(max(2 * max_keys, 16))
        self._mask = self.slots - 1
        self._hkeys = np.full(self.slots, _EMPTY, np.int64)
        self._hvals = np.zeros(self.slots, np.int32)
        self.max_probe = 1
        self.n = 0
        self.active = True
        # device mirror is built once, then patched incrementally: inserts
        # queue their slot index and lookup applies them as one small
        # scatter — O(new keys), never an O(slots) re-upload per dirty.
        # _mu orders concurrent patch/build: without it a lookup could
        # observe an emptied queue but a not-yet-patched mirror and serve
        # stale misses for long-since-ingested keys
        self._pending: list = []
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._mu = threading.Lock()

    def insert(self, key, idx: int) -> None:
        """Mirror one (key, dense index) pair; deactivate on unsupported
        keys. Idempotent for re-inserts of the same (key, idx)."""
        if not self.active:
            return
        if isinstance(key, bool) or not isinstance(key, (int, np.integer)):
            self.active = False
            return
        k = int(key)
        if not (_EMPTY < k < 2 ** 31):
            self.active = False
            return
        h = ((k & 0xFFFFFFFF) * _MULT) & self._mask
        # whole commit under _mu: an append racing lookup's queue swap
        # would otherwise land on the orphaned list and never be patched
        # into the device mirror (a permanently invisible key)
        with self._mu:
            for i in range(self.slots):
                s = (h + i) & self._mask
                existing = self._hkeys[s]
                if existing != _EMPTY and existing != k:
                    continue
                if existing == k and self._hvals[s] == idx:
                    return                # true re-insert: nothing changed
                self._hvals[s] = idx      # value first: commit point is
                self._hkeys[s] = k        # the key becoming visible
                if existing == _EMPTY:
                    self.n += 1
                if i + 1 > self.max_probe:
                    self.max_probe = i + 1
                self._pending.append(s)
                return
            self.active = False           # table full (max_keys overflow)

    def covers(self, keys: np.ndarray) -> bool:
        """True if ``keys`` (an integer ndarray) can be probed exactly:
        every queried value fits the directory's int32 key domain."""
        if not self.active or keys.size == 0:
            return False
        lo, hi = int(keys.min()), int(keys.max())
        return _EMPTY < lo and hi < 2 ** 31

    def lookup(self, keys: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Resolve a batch: (idx (B,) i32, found (B,) bool), on the device.

        Caller must have checked :meth:`covers`."""
        with self._mu:
            if self._dev is None:
                self._pending = []        # full build supersedes patches
                self._dev = (torch.tensor(self._hkeys, device=self.device),
                             torch.tensor(self._hvals, device=self.device))
            elif self._pending:
                # swap the queue out under the lock: an insert racing this
                # patch lands in the fresh list for a later lookup
                pend, self._pending = self._pending, []
                s = np.asarray(pend, np.int64)
                tkeys, tvals = self._dev
                si = torch.from_numpy(s).to(self.device)
                tkeys[si] = torch.from_numpy(self._hkeys[s]).to(self.device)
                tvals[si] = torch.from_numpy(self._hvals[s]).to(self.device)
            tkeys, tvals = self._dev
            probe = self.max_probe
        q = torch.from_numpy(np.asarray(keys, np.int64)).to(self.device)
        return _probe(tkeys, tvals, q, probe=probe, mask=self._mask)
