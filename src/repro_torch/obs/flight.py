"""Flight recorder: a bounded ring of recent per-batch serving records
dumped to JSONL on SLO breach (DESIGN.md §14).

Postmortems of a p99 regression or a shed storm need the HISTORY that
led into the event — which traces, which deployment versions, which
knob settings, how stale the snapshots were — but recording that
everywhere at full fidelity would be its own overhead problem. The
recorder keeps only the last ``capacity`` records in memory (a deque
append per served batch, no I/O) and writes them out ONLY when
something goes wrong: the control plane dumps on an SLO OK→ALERTING
transition. (The JAX package's process runtime also dumps when a
worker dies; the port's sharded runtime runs in one process.)

Record schema (one JSON object per line):
``{"seq": n, "t": unix_s, "kind": ...,  **fields}`` where ``kind`` is
``serve`` (trace id, deployment, version vector, rows, status mix,
freshness stamp), ``shed`` (shed kind), ``context`` (knob settings —
written only when a value CHANGES, not copied into every record),
``worker_down`` / ``alert`` markers, and a leading ``dump`` header with
the dump reason. ``dump()`` is rate-limited so an alert storm cannot
turn the recorder into a disk-filling hazard.
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import threading
import time
from typing import Any, Deque, Dict, List, Optional

__all__ = ["FlightRecorder"]

_REASON_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


def _json_default(v):
    if hasattr(v, "item"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return str(v)


class FlightRecorder:
    """Bounded in-memory ring of serving records + JSONL dump-on-breach."""

    def __init__(self, capacity: int = 2048,
                 out_dir: Optional[str] = None,
                 min_dump_interval_s: float = 2.0):
        self.capacity = int(capacity)
        self.out_dir = (out_dir
                        or os.environ.get("REPRO_FLIGHT_DIR")
                        or tempfile.gettempdir())
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.capacity)
        self._ctx: Dict[str, Any] = {}
        self._seq = 0
        self._last_dump = -float("inf")
        self.dumps: List[str] = []
        self._lock = threading.Lock()

    # -------------------------------------------------------------- record
    def record(self, kind: str, **fields) -> None:
        """Append one record (cheap: dict build + deque append)."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "t": time.time(), "kind": kind}
            rec.update(fields)
            self._ring.append(rec)

    def set_context(self, **kv) -> None:
        """Update ambient context (knob settings, live versions). Only
        CHANGED values produce a record — replaying the ring left to
        right reconstructs the context at any record without every
        record carrying a copy."""
        with self._lock:
            changed = {k: v for k, v in kv.items()
                       if self._ctx.get(k) != v}
            if not changed:
                return
            self._ctx.update(changed)
            self._seq += 1
            rec = {"seq": self._seq, "t": time.time(), "kind": "context"}
            rec.update(changed)
            self._ring.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ---------------------------------------------------------------- dump
    def dump(self, reason: str, *, force: bool = False) -> Optional[str]:
        """Write the ring to a timestamped JSONL file; returns the path,
        or ``None`` when rate-limited (pass ``force=True`` to override).
        The ring is NOT cleared — overlapping dumps around one incident
        each carry the full window."""
        now = time.time()
        with self._lock:
            if not force and (now - self._last_dump
                              < self.min_dump_interval_s):
                return None
            self._last_dump = now
            records = list(self._ring)
            ctx = dict(self._ctx)
        slug = _REASON_RE.sub("-", reason).strip("-") or "dump"
        path = os.path.join(
            self.out_dir,
            f"flight-{int(now * 1000)}-{os.getpid()}-{slug}.jsonl")
        header = {"kind": "dump", "t": now, "reason": reason,
                  "n_records": len(records), "context": ctx}
        with open(path, "w") as f:
            f.write(json.dumps(header, default=_json_default) + "\n")
            for rec in records:
                f.write(json.dumps(rec, default=_json_default) + "\n")
        with self._lock:
            self.dumps.append(path)
        return path

    # -------------------------------------------------------------- export
    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"records": float(len(self._ring)),
                    "seq": float(self._seq),
                    "dumps": float(len(self.dumps))}

    def __repr__(self) -> str:
        return (f"FlightRecorder(n={len(self)}/{self.capacity}, "
                f"dumps={len(self.dumps)})")
