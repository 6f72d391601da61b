"""Trace ids for the serving edge.

``FeatureServer`` stamps every request with a :func:`new_trace_id` when
the caller brings none, and hands it back on the response frame. The
spans and the bounded trace store that record a request's path come with
the observability slice of the port.
"""
from __future__ import annotations

import os
import time

__all__ = ["new_trace_id"]

# Crockford base32 (no I/L/O/U) — the ULID alphabet
_B32 = "0123456789ABCDEFGHJKMNPQRSTVWXYZ"


def _b32(value: int, n_chars: int) -> str:
    out = []
    for _ in range(n_chars):
        out.append(_B32[value & 31])
        value >>= 5
    return "".join(reversed(out))


def new_trace_id() -> str:
    """ULID-style id: 48-bit unix-ms timestamp + 80 random bits in 26
    Crockford-base32 chars — lexically sortable by creation time and
    collision-safe across processes (the random half comes from
    ``os.urandom``, so forked workers can't repeat a sequence)."""
    ms = int(time.time() * 1000) & ((1 << 48) - 1)
    rnd = int.from_bytes(os.urandom(10), "big")
    return _b32(ms, 10) + _b32(rnd, 16)

