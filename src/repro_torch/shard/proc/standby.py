"""Warm-standby worker pool: pre-spawned, prewarmed, ready to adopt.

A shard worker's spawn cost is the interpreter and ``import torch``, the
engine's modules and, on the card, the CUDA context and the kernel
library load — dead weight on the recovery critical path, since the
replacement process runs the exact same bootstrap every time. The pool
keeps ``n`` workers parked PAST that bootstrap: each is spawned with
``REPRO_SHARD_PREWARM=1``, pays it (``worker.prewarm``), sends a
``("warm", {pid})`` frame, and then blocks on ``recv`` waiting for a
hello that may come much later.

Adoption (DESIGN.md §12): when a shard dies, ``_WorkerProc`` asks the
pool for a warmed entry and — instead of spawning — sends its normal
``hello`` (shard identity, device, flags, engine kwargs) down the
standby's existing channel. The standby wakes, constructs the Engine
(cheap: everything is resident), replies ``ready``, and IS the
replacement worker; kill→serving MTTR drops to the catalog replay. Every
``take`` triggers a background refill, so the pool self-heals back to
``n`` after absorbing a failure burst.

Standbys are shard-agnostic on purpose: one pool serves the whole fleet,
and everything shard-specific arrives in the hello. A standby sees every
card of the host (its env pins none), so on a host with several cards
the adopter names the shard's card in the hello's device.
"""
from __future__ import annotations

import socket
import subprocess
import sys
import threading
from types import SimpleNamespace
from typing import List, Optional, Tuple

from repro_torch.shard.proc.transport import Channel, FrameCorrupt

__all__ = ["StandbyPool"]

_WARM_TIMEOUT_S = 180.0


class StandbyPool:
    """``n`` pre-warmed shard workers awaiting adoption, for ``device``
    (``"cuda"``, the default, or ``"cpu"``: what the prewarm
    initialises)."""

    def __init__(self, n: int, device: str = "cuda"):
        self.n = int(n)
        self.device = device
        self._lock = threading.Lock()
        self._entries: List[SimpleNamespace] = []
        self._closing = False
        self._refills: List[threading.Thread] = []
        self.stats = {"spawned": 0, "adopted": 0, "misses": 0}
        for _ in range(self.n):
            self._spawn_one()

    # ------------------------------------------------------------- spawn
    def _spawn_one(self) -> None:
        # lazy import: backend.py owns worker_env and imports this module
        from repro_torch.shard.proc.backend import worker_env
        with self._lock:
            if self._closing:
                return
        parent_sock, child_sock = socket.socketpair()
        env = worker_env(-1, self.device)   # identity comes in the hello
        env["REPRO_SHARD_WORKER_FD"] = str(child_sock.fileno())
        env["REPRO_SHARD_PREWARM"] = "1"
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.shard.proc.worker"],
            env=env, pass_fds=[child_sock.fileno()])
        child_sock.close()
        entry = SimpleNamespace(proc=proc, sock=parent_sock,
                                ch=Channel(parent_sock),
                                warmed=threading.Event(), dead=False)
        with self._lock:
            if self._closing:
                self._kill(entry)
                return
            self._entries.append(entry)
            self.stats["spawned"] += 1
        threading.Thread(target=self._watch, args=(entry,), daemon=True,
                         name="standby-watch").start()

    def _watch(self, entry) -> None:
        """Consume the standby's single ``warm`` frame, then get out of
        the way — after ``warmed`` is set nothing reads this channel
        until an adopter runs its handshake on it."""
        try:
            entry.sock.settimeout(_WARM_TIMEOUT_S)
            tag, info = entry.ch.recv()
            entry.sock.settimeout(None)
            if tag == "warm":
                entry.pid = info["pid"]
                entry.warmed.set()
                return
        except (EOFError, OSError, FrameCorrupt):
            pass                     # died or timed out while warming
        entry.dead = True
        try:
            entry.ch.close()
        except OSError:
            pass

    # -------------------------------------------------------------- take
    def take(self) -> Optional[Tuple[subprocess.Popen, socket.socket,
                                     Channel]]:
        """Pop one warmed standby as ``(proc, sock, channel)`` — or
        ``None`` when nothing is warm yet (the caller cold-spawns).
        Always kicks off a background refill on a hit."""
        with self._lock:
            if self._closing:
                return None
            hit = None
            for i, e in enumerate(self._entries):
                if e.warmed.is_set() and not e.dead \
                        and e.proc.poll() is None:
                    hit = self._entries.pop(i)
                    break
            if hit is None:
                self.stats["misses"] += 1
                return None
            self.stats["adopted"] += 1
            refill = threading.Thread(target=self._spawn_one, daemon=True,
                                      name="standby-refill")
            self._refills.append(refill)
        refill.start()
        return hit.proc, hit.sock, hit.ch

    @property
    def n_warm(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries
                       if e.warmed.is_set() and not e.dead)

    @property
    def pids(self) -> List[int]:
        """The pool's processes (warm or still warming)."""
        with self._lock:
            return [e.proc.pid for e in self._entries]

    # --------------------------------------------------------- lifecycle
    @staticmethod
    def _kill(entry) -> None:
        try:
            entry.ch.close()               # EOF wakes the parked worker
        except OSError:
            pass
        try:
            entry.proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            entry.proc.kill()
            entry.proc.wait(timeout=5.0)

    def close(self) -> None:
        """Stop every standby, those a refill is still spawning included:
        no process of the pool outlives this call."""
        with self._lock:
            self._closing = True
            refills = list(self._refills)
        for t in refills:            # a refill mid-spawn kills its own
            t.join(timeout=30.0)
        with self._lock:
            entries = list(self._entries)
            self._entries.clear()
        for e in entries:
            self._kill(e)
