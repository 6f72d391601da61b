"""Seeded, replayable fault injection for the process-shard transport.

A :class:`FaultPlan` is a frozen description of WHAT can go wrong —
per-frame drop / delay / duplicate / corrupt probabilities plus a
deterministic kill-on-nth-frame trigger. A :class:`FaultInjector` is the
plan armed with a seeded RNG and attached to a ``Channel`` (one injector
per channel end, derived from the plan seed xor a role string, so the
client→worker and worker→client directions draw independent but fully
reproducible streams).

The injector sits in ``Channel.send`` — the ONLY chaos hook in the
transport — and rewrites each outbound frame into zero or more wire
frames:

    drop       frame never hits the wire (receiver sees nothing; the
               sender's retry layer must re-send)
    delay      frame is held ``delay_s`` before sending (reorders
               against frames from other sender threads)
    duplicate  frame is sent twice (exercises worker-side request-id
               dedup — at-least-once delivery must stay exactly-once
               execution)
    corrupt    payload bytes are mutated under the ORIGINAL declared
               crc32; length is unchanged so the stream stays aligned
               and the receiver raises ``FrameCorrupt`` (retryable)
               rather than a pickle crash. This also covers the
               "truncate" failure mode: a short frame on a SOCK_STREAM
               socketpair is indistinguishable from a stall to the
               reader, so mid-frame damage is modeled as corruption
               at full length, which the CRC catches identically.
    kill       on the Nth frame (1-based, counted per injector) the
               kill callback fires — the parent-side injector SIGKILLs
               the worker mid-RPC, the sharpest crash the runtime can
               experience.

Plans parse from compact spec strings so CI can pin one in an env var::

    REPRO_FAULT_PLAN="seed=7,drop=0.05,delay=0.1,delay_s=0.02,dup=0.05"
    REPRO_FAULT_PLAN="seed=3,kill_after=40"

Everything here is stdlib-only, and the decisions are those of
``repro.shard.proc.faults`` draw for draw (the same ``random.Random``
seeded the same way): one plan and role make the same frame decisions in
either package. ``shard/engine.py`` imports FaultPlan for its config
surface without pulling the proc backend.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["FaultPlan", "FaultInjector"]

_ENV = "REPRO_FAULT_PLAN"


@dataclass(frozen=True)
class FaultPlan:
    """What the chaos layer is allowed to do, deterministically seeded.

    Probabilities are per outbound frame and evaluated independently in
    a fixed order (kill → drop → delay → corrupt → duplicate), so one
    seed always replays the identical fault sequence for a given frame
    stream."""

    seed: int = 0
    drop: float = 0.0          # P(frame never sent)
    delay: float = 0.0         # P(frame held delay_s before sending)
    delay_s: float = 0.01
    duplicate: float = 0.0     # P(frame sent twice)
    corrupt: float = 0.0       # P(payload mutated under original crc)
    kill_after: int = 0        # SIGKILL the peer on the Nth frame (0=off)

    @property
    def active(self) -> bool:
        return (self.drop > 0 or self.delay > 0 or self.duplicate > 0
                or self.corrupt > 0 or self.kill_after > 0)

    def disarmed(self) -> "FaultPlan":
        """The same plan without the kill trigger — respawned workers
        must not inherit a live kill counter or recovery becomes a
        crash loop."""
        return dataclasses.replace(self, kill_after=0)

    # ------------------------------------------------------------- parsing
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``"seed=7,drop=0.05,kill_after=40"`` (aliases:
        ``dup`` for duplicate). Unknown keys raise — a typo'd chaos run
        silently testing nothing is worse than a crash."""
        kw: Dict[str, object] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = {"dup": "duplicate"}.get(k.strip(), k.strip())
            if k not in cls.__dataclass_fields__:
                raise ValueError(f"unknown FaultPlan field {k!r} in "
                                 f"{spec!r}")
            kw[k] = int(v) if k in ("seed", "kill_after") else float(v)
        return cls(**kw)

    @classmethod
    def from_env(cls, env: str = _ENV) -> Optional["FaultPlan"]:
        spec = os.environ.get(env, "").strip()
        return cls.parse(spec) if spec else None


class FaultInjector:
    """A :class:`FaultPlan` armed with a per-role seeded RNG.

    ``role`` keeps the two directions of one channel (and the channels
    of different shards) on independent deterministic streams:
    ``seed ^ crc32(role)`` seeds a private ``random.Random``.

    ``kill_cb`` fires ON the kill frame *instead of sending it* —
    modeling a process that died mid-RPC, which is exactly when the
    caller is left holding an unanswered future.
    """

    def __init__(self, plan: FaultPlan, *, role: str = "",
                 kill_cb: Optional[Callable[[], None]] = None):
        self.plan = plan
        self.role = role
        self._rng = random.Random(plan.seed ^ zlib.crc32(role.encode()))
        self._kill_cb = kill_cb
        self._n = 0
        self._killed = False
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "frames": 0, "dropped": 0, "delayed": 0, "duplicated": 0,
            "corrupted": 0, "killed": 0}

    def _mutate(self, payload: bytes) -> bytes:
        """Flip a few bytes somewhere in the payload (length preserved)."""
        b = bytearray(payload)
        for _ in range(min(3, len(b))):
            i = self._rng.randrange(len(b))
            b[i] ^= 0xFF
        return bytes(b)

    def frames(self, payload: bytes) -> List[Tuple[bytes, int]]:
        """Map one logical outbound frame to the ``(payload, crc)`` wire
        frames that actually get sent (called under the channel's send
        lock — ordering across sender threads is already serialized)."""
        p = self.plan
        with self._lock:
            self._n += 1
            n = self._n
            self.stats["frames"] += 1
            r_kill = (p.kill_after > 0 and n >= p.kill_after
                      and not self._killed)
            if r_kill:
                self._killed = True        # fire once: a respawned peer
                                           # must not be re-killed
            r_drop = p.drop > 0 and self._rng.random() < p.drop
            r_delay = p.delay > 0 and self._rng.random() < p.delay
            r_corrupt = p.corrupt > 0 and self._rng.random() < p.corrupt
            r_dup = p.duplicate > 0 and self._rng.random() < p.duplicate
        if r_kill and self._kill_cb is not None:
            self.stats["killed"] += 1
            self._kill_cb()
            return []                      # the process died mid-send
        if r_drop:
            self.stats["dropped"] += 1
            return []
        if r_delay:
            self.stats["delayed"] += 1
            time.sleep(p.delay_s)
        crc = zlib.crc32(payload)
        if r_corrupt:
            self.stats["corrupted"] += 1
            # declared crc stays that of the ORIGINAL bytes: the
            # receiver sees a full-length frame that fails its check
            out = [(self._mutate(payload), crc)]
        else:
            out = [(payload, crc)]
        if r_dup:
            self.stats["duplicated"] += 1
            out = out + [out[0]]
        return out
