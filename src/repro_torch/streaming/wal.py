"""Write-ahead ingest log: per-shard durability for streamed events.

The process-backed shard runtime (DESIGN.md §11) loses a shard's
partitioned table data when its worker dies; without a log, recovery
means waiting for some external actor to re-ingest. The WAL closes that
hole at the ingest boundary: every event the :class:`StreamBuffer`
ACCEPTS is appended here *under the buffer lock, before it becomes
flushable* — so no event can reach the table (and therefore a served
feature) without first being in the log, and replaying the log through
the same accept path reproduces the table bit-identically.

Log discipline (DESIGN.md §12):

* **Accepted events only.** Logging at arrival would replay events that
  the original run dropped as late (a fresh buffer has no frontier);
  logging post-acceptance makes replay = re-acceptance.
* **Segmented.** Records append to ``wal-<n>.seg``; at
  ``segment_bytes`` the segment is sealed (fsynced) and a new one
  opened. TTL compaction truncates whole sealed segments whose newest
  event-time fell behind the retention horizon.
* **Group commit.** Every record is written straight to the fd
  (unbuffered), so a SIGKILL'd worker loses nothing the OS already has;
  ``fsync`` is batched on ``fsync_interval_s`` for host-crash
  durability without one fsync per event (OpenMLDB's binlog does the
  same).
* **Torn tails tolerated.** Each record carries ``[u32 len][u32 crc]``;
  replay stops a segment at the first short read or CRC mismatch — a
  half-written tail record (killed mid-append) is dropped, never
  garbage-decoded.
* **2PC atomicity.** A prepared transaction is NOT logged at prepare
  time; ``commit`` appends the whole batch as ONE record. A crash
  between prepare and commit therefore replays as an abort —
  exactly the prepare-TTL semantics the live path has.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import pickle
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["WalConfig", "WriteAheadLog", "read_dir", "read_segment",
           "resolve_shard"]

_REC = struct.Struct(">II")          # record header: payload len, crc32
_PROTO = pickle.HIGHEST_PROTOCOL
_SEG_FMT = "wal-{:08d}.seg"


@dataclass(frozen=True)
class WalConfig:
    """``dir`` may contain a ``{shard}`` placeholder; the sharded engine
    (or :func:`resolve_shard`) substitutes the owning shard id before
    the log is opened, so one config template serves the whole fleet
    (and survives the DDL replay onto respawned / newly added shards)."""

    dir: str
    segment_bytes: int = 4 << 20      # rotate at ~4 MiB
    fsync_interval_s: float = 0.05    # group-commit window; 0 = every rec
    sync: bool = True                 # False: never fsync (bench/tests)


def resolve_shard(cfg, shard: int):
    """Substitute ``{shard}`` into a PipelineConfig-like ``cfg``'s WAL
    dir. Returns ``cfg`` unchanged when it has no WAL (or no
    placeholder)."""
    wal = getattr(cfg, "wal", None) if cfg is not None else None
    if wal is None or "{shard}" not in wal.dir:
        return cfg
    return dataclasses.replace(
        cfg, wal=dataclasses.replace(
            wal, dir=wal.dir.replace("{shard}", str(shard))))


def _read_records(path: str) -> Iterator[Tuple[list, np.ndarray,
                                               np.ndarray]]:
    """Yield ``(keys, ts, rows)`` records from one segment, stopping at
    the first torn/corrupt record (raises nothing — a damaged tail is
    expected after a kill)."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_REC.size)
            if len(hdr) < _REC.size:
                return
            length, crc = _REC.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return                        # torn tail / corruption
            try:
                keys, ts, rows = pickle.loads(payload)
            except Exception:
                return
            yield (list(keys), np.asarray(ts, np.float32),
                   np.asarray(rows, np.float32))


def read_segment(path: str) -> List[Tuple[list, np.ndarray, np.ndarray]]:
    return list(_read_records(path))


def read_dir(path: str) -> Iterator[Tuple[list, np.ndarray, np.ndarray]]:
    """Replay every record of every segment under ``path`` in append
    order. Missing dir yields nothing (a shard that never ingested)."""
    if not os.path.isdir(path):
        return
    for name in sorted(os.listdir(path)):
        if not (name.startswith("wal-") and name.endswith(".seg")):
            continue
        yield from _read_records(os.path.join(path, name))


class WriteAheadLog:
    """Segmented, CRC-framed, fsync-batched append log of event batches.

    Thread-safe: appends may come from any pusher thread (they already
    hold the stream-buffer lock, but ``truncate`` arrives from the
    flusher thread concurrently)."""

    def __init__(self, cfg: WalConfig):
        if "{" in cfg.dir:
            raise ValueError(
                f"WAL dir {cfg.dir!r} has an unresolved placeholder — "
                f"call resolve_shard() (the sharded engine does this "
                f"per shard) before opening the log")
        self.cfg = cfg
        self._lock = threading.Lock()
        os.makedirs(cfg.dir, exist_ok=True)
        # resume an existing dir (tests / in-place restart): every
        # pre-existing segment is sealed; pick up numbering after it
        self._sealed: List[Tuple[str, float]] = []   # (path, max_ts)
        seg_ids = []
        for name in sorted(os.listdir(cfg.dir)):
            if name.startswith("wal-") and name.endswith(".seg"):
                seg_ids.append(int(name[4:-4]))
                p = os.path.join(cfg.dir, name)
                mx = float("-inf")
                for _k, ts, _r in _read_records(p):
                    if len(ts):
                        mx = max(mx, float(np.max(ts)))
                self._sealed.append((p, mx))
        self._seg_id = (max(seg_ids) + 1) if seg_ids else 0
        self._f = self._open_segment()
        self._seg_bytes = 0
        self._seg_max_ts = float("-inf")
        self._last_sync = time.monotonic()
        self._closed = False
        self.stats: Dict[str, float] = {
            "records": 0, "events": 0, "bytes": 0, "rotations": 0,
            "fsyncs": 0, "truncated_segments": 0}

    # ------------------------------------------------------------ segments
    def _open_segment(self):
        path = os.path.join(self.cfg.dir, _SEG_FMT.format(self._seg_id))
        # buffering=0: every record write is a syscall, so data survives
        # SIGKILL the instant append() returns (page cache); fsync below
        # extends that to host-crash durability on its batched cadence
        return open(path, "ab", buffering=0)

    def _rotate_locked(self) -> None:
        self._sync_locked(force=True)
        self._f.close()
        self._sealed.append((self._f.name, self._seg_max_ts))
        self._seg_id += 1
        self._f = self._open_segment()
        self._seg_bytes = 0
        self._seg_max_ts = float("-inf")
        self.stats["rotations"] += 1

    def _sync_locked(self, *, force: bool = False) -> None:
        if not self.cfg.sync:
            return
        now = time.monotonic()
        if force or self.cfg.fsync_interval_s <= 0 \
                or now - self._last_sync >= self.cfg.fsync_interval_s:
            os.fsync(self._f.fileno())
            self._last_sync = now
            self.stats["fsyncs"] += 1

    # -------------------------------------------------------------- append
    def append(self, keys: Sequence, ts, rows) -> None:
        """Durably log one accepted batch as a single atomic record."""
        if not len(keys):
            return
        ts = np.asarray(ts, np.float32)
        rows = np.asarray(rows, np.float32)
        payload = pickle.dumps((list(keys), ts, rows), protocol=_PROTO)
        rec = _REC.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._closed:
                return
            self._f.write(rec)
            self._seg_bytes += len(rec)
            if len(ts):
                self._seg_max_ts = max(self._seg_max_ts,
                                       float(np.max(ts)))
            self.stats["records"] += 1
            self.stats["events"] += len(keys)
            self.stats["bytes"] += len(rec)
            if self._seg_bytes >= self.cfg.segment_bytes:
                self._rotate_locked()
            else:
                self._sync_locked()

    def sync(self) -> None:
        with self._lock:
            if not self._closed:
                self._sync_locked(force=True)

    # ------------------------------------------------------------ truncate
    def truncate(self, min_ts: float) -> int:
        """Delete sealed segments whose NEWEST event-time is below
        ``min_ts`` (the TTL horizon): everything in them has been
        compacted out of the table, so replay would only re-insert rows
        retention immediately drops again. Returns segments removed."""
        removed = 0
        with self._lock:
            keep: List[Tuple[str, float]] = []
            for path, mx in self._sealed:
                if np.isfinite(mx) and mx < min_ts:
                    try:
                        os.remove(path)
                        removed += 1
                    except OSError:
                        keep.append((path, mx))
                else:
                    keep.append((path, mx))
            self._sealed = keep
            self.stats["truncated_segments"] += removed
        return removed

    # ----------------------------------------------------------- lifecycle
    def replay(self) -> Iterator[Tuple[list, np.ndarray, np.ndarray]]:
        """Replay this log's own dir (sealed + active segments)."""
        self.sync()
        return read_dir(self.cfg.dir)

    @property
    def n_segments(self) -> int:
        with self._lock:
            return len(self._sealed) + 1

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.stats)
            out["segments"] = len(self._sealed) + 1
            out["active_segment_bytes"] = self._seg_bytes
        return out

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._sync_locked(force=True)
            except (OSError, ValueError):
                pass
            self._f.close()
