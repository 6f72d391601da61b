"""Per-deployment admission control + deadline-aware load shedding.

The control plane of the sharded serving runtime (DESIGN.md §9): before a
batch is scattered, the :class:`ResourceManager` decides whether it may
enter at all.

* **In-flight bound** — at most ``max_inflight`` batches of one
  deployment may be executing/queued at once; an admit blocks (up to the
  request's own deadline, capped by ``admit_timeout_s``) for a slot.
  A **deadlined** request that cannot get a slot in time is SHED at the
  door (whole-batch ``STATUS_SHED``, never an exception — the deadline
  IS its give-up bound); a deadline-less request REJECTS with
  backpressure, so overload surfaces as an explicit error at the door
  instead of unbounded queueing behind the shards.
* **Queue-depth bound** — if any target shard's worker queue is deeper
  than ``max_queue_depth`` sub-batches, the batch is rejected: one
  saturated shard must not keep absorbing work it cannot serve in time.
* **Deadline shedding** — a batch whose context deadline has already
  passed (on arrival, or while waiting for a slot) is SHED: the caller
  gets a whole-batch ``STATUS_SHED`` result immediately and the shards
  never see the work. Shedding is all-or-nothing per batch — the runtime
  never returns a mix of shed and computed rows.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = ["AdmissionConfig", "Admission", "ResourceManager"]


@dataclass(frozen=True)
class AdmissionConfig:
    max_inflight: int = 8          # concurrent batches per deployment
    max_queue_depth: int = 64      # pending sub-batches per shard worker
    admit_timeout_s: float = 1.0   # max wait for an in-flight slot
    # shed at the door when a deadlined request's remaining budget is
    # below this — it would only be shed later at lane dequeue anyway,
    # after wasting a slot and scatter work. 0 disables (admit anything
    # not yet expired); the control plane raises it when it observes
    # post-admission sheds (work admitted, then thrown away in a queue)
    min_service_budget_s: float = 0.0


class Admission:
    """Outcome of an admit: either a held slot (release it!) or a shed."""

    __slots__ = ("_mgr", "_name", "shed", "_released")

    def __init__(self, mgr: Optional["ResourceManager"], name: str,
                 shed: bool):
        self._mgr = mgr
        self._name = name
        self.shed = shed
        self._released = False

    def release(self) -> None:
        if self.shed or self._released or self._mgr is None:
            return
        self._released = True
        self._mgr._release(self._name)

    def __enter__(self) -> "Admission":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False


class ResourceManager:
    """Tracks per-deployment in-flight batches and shed/reject counters."""

    def __init__(self, cfg: AdmissionConfig = AdmissionConfig()):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._slot_freed = threading.Condition(self._lock)
        self._inflight: Dict[str, int] = {}
        self.stats = {"admitted": 0, "shed_deadline": 0,
                      "shed_worker_down": 0, "served_degraded": 0,
                      "rejected_inflight": 0, "rejected_queue_depth": 0}

    # ---------------------------------------------------------------- admit
    def admit(self, name: str, ctx=None,
              queue_depths: Optional[Callable[[], list]] = None
              ) -> Admission:
        """Admit one batch of deployment ``name``; returns an
        :class:`Admission` whose ``shed`` flag tells the caller to return
        a whole-batch shed status. Raises ``RuntimeError`` on capacity
        rejection (backpressure) — deadline-less requests only: a
        deadlined request that cannot be admitted in time is SHED, never
        errored, because its deadline is already the give-up bound."""
        cfg = self.cfg
        deadlined = ctx is not None and ctx.deadline is not None
        if ctx is not None and ctx.expired:
            with self._lock:
                self.stats["shed_deadline"] += 1
            return Admission(None, name, shed=True)
        deadline = time.monotonic() + cfg.admit_timeout_s
        if deadlined:
            deadline = min(deadline, ctx.deadline)
        with self._lock:
            while self._inflight.get(name, 0) >= self.cfg.max_inflight:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    if deadlined:
                        # could not get a slot within the request's
                        # budget (or the cap): shed NOW at the door —
                        # before the fix this raised backpressure (cap <
                        # deadline) or kept the caller blocked until the
                        # work would only be shed later at lane dequeue
                        self.stats["shed_deadline"] += 1
                        return Admission(None, name, shed=True)
                    self.stats["rejected_inflight"] += 1
                    raise RuntimeError(
                        f"admission control: deployment {name!r} has "
                        f"{self._inflight.get(name, 0)} batches in flight "
                        f"(max_inflight={self.cfg.max_inflight})")
                self._slot_freed.wait(wait)
            # a slot is free; shed rather than take it when the remaining
            # budget is gone (or too small to plausibly finish in)
            if ctx is not None and (ctx.expired or (
                    deadlined and self.cfg.min_service_budget_s > 0.0
                    and ctx.remaining() < self.cfg.min_service_budget_s)):
                self.stats["shed_deadline"] += 1
                return Admission(None, name, shed=True)
            if queue_depths is not None:
                depths = queue_depths()
                if depths and max(depths) >= cfg.max_queue_depth:
                    self.stats["rejected_queue_depth"] += 1
                    raise RuntimeError(
                        f"admission control: a shard queue is "
                        f"{max(depths)} sub-batches deep "
                        f"(max_queue_depth={cfg.max_queue_depth})")
            self._inflight[name] = self._inflight.get(name, 0) + 1
            self.stats["admitted"] += 1
            return Admission(self, name, shed=False)

    def record_shed(self, n: int = 1, kind: str = "deadline") -> None:
        """Count a post-admission shed: ``deadline`` (expired inside a
        shard queue) or ``worker_down`` (a subprocess shard died with the
        sub-batch queued/executing — shed, respawn in progress)."""
        with self._lock:
            self.stats["shed_worker_down" if kind == "worker_down"
                       else "shed_deadline"] += n

    def record_degraded(self, n: int = 1) -> None:
        """Count rows answered from the stale tier (STATUS_DEGRADED) —
        the step of the degradation ladder between OK and SHED."""
        with self._lock:
            self.stats["served_degraded"] += n

    def _release(self, name: str) -> None:
        with self._lock:
            n = self._inflight.get(name, 1)
            self._inflight[name] = max(0, n - 1)
            # notify_all: waiters for OTHER deployments share this
            # condition — waking a single (possibly wrong-name) waiter
            # could strand the freed slot until the next release
            self._slot_freed.notify_all()

    # ----------------------------------------------------------------- tune
    def reconfigure(self, **changes) -> AdmissionConfig:
        """Replace admission bounds live (control-plane knob surface).
        Blocked admits re-read ``self.cfg`` each loop, so a raised
        ``max_inflight`` takes effect on waiters immediately. Returns the
        previous config."""
        with self._lock:
            prev = self.cfg
            self.cfg = dataclasses.replace(prev, **changes)
            self._slot_freed.notify_all()   # bounds may have loosened
            return prev

    # ---------------------------------------------------------------- intro
    def inflight(self, name: str) -> int:
        with self._lock:
            return self._inflight.get(name, 0)

    def metrics(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)
