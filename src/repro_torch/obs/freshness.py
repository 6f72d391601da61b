"""Feature freshness tracking (DESIGN.md §14).

The paper's sub-millisecond-serving claim is only meaningful if the
features are FRESH — OpenMLDB's system paper makes ingest-to-visible
latency and online/offline consistency first-class correctness
properties. This module instruments the data plane end to end:

- **Feature age** — at serve, per ROW: request event-time minus the
  served snapshot's watermark (the max event-time the published state
  covers). Age is in event-time units; a negative age means the request
  asked about a time the table has already ingested past.
- **Ingest-to-visible latency** — wall seconds from an event arriving
  at the pipeline to the flush that PUBLISHED it (copy-on-write swap
  making it queryable). Matched FIFO per flush, so it is exact to
  within one flush interval.
- **Ingest-side distributions** — per-value-column sketches and a
  distinct-key KMV estimator maintained incrementally at
  ``Table.insert`` ride along in the same snapshot.

Everything is held as mergeable sketches/counters
(:mod:`repro_torch.obs.sketch`): each shard engine keeps its own
tracker, and :meth:`FreshnessTracker.merge` of their snapshots recovers
EXACTLY what one engine observing the union would hold (watermarks merge by ``min`` — the
slowest shard bounds global freshness).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.sketch import (CardinalityEstimator, QuantileSketch,
                                    DEFAULT_REL_ERR)

__all__ = ["FreshnessTracker"]


class FreshnessTracker:
    """Per-table freshness sketches + counters (one per engine; shard
    engines each own one and the sharded tier merges snapshots)."""

    MAX_PENDING = 256        # serve batches buffered before a forced fold

    def __init__(self, rel_err: float = DEFAULT_REL_ERR):
        self.rel_err = float(rel_err)
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[str, Any]] = {}
        # serve-path age batches are BUFFERED and folded lazily (on any
        # snapshot, or when MAX_PENDING batches pile up) so the hot path
        # pays one list append, not a sketch insert. Fold order cannot
        # change the result — sketch insertion is commutative.
        self._pending: List[Tuple[str, Any]] = []

    def _entry(self, table: str) -> Dict[str, Any]:
        ent = self._tables.get(table)
        if ent is None:
            ent = self._tables[table] = {
                "age": QuantileSketch(self.rel_err),
                "i2v": QuantileSketch(self.rel_err),
                "serve_rows": 0,
                "serve_batches": 0,
                "ingested": 0,
                "flushes": 0,
            }
        return ent

    # ------------------------------------------------------------- observe
    def _drain(self) -> None:
        """Fold every buffered age batch into the per-table sketches."""
        with self._lock:
            if not self._pending:
                return
            pending, self._pending = self._pending, []
        for table, ages in pending:
            with self._lock:
                ent = self._entry(table)
            n = ent["age"].observe_many(ages)
            with self._lock:
                ent["serve_rows"] += n
                ent["serve_batches"] += 1

    def observe_age(self, table: str, ages) -> int:
        """Per-row feature ages (event-time units) for one served batch.
        Call with the UNPADDED rows only — equal request multisets must
        produce equal sketches across backends. O(1) on the serve path:
        the batch is buffered and folded on the next snapshot (or after
        MAX_PENDING batches)."""
        a = np.asarray(ages, np.float64)
        with self._lock:
            self._pending.append((table, a))
            full = len(self._pending) >= self.MAX_PENDING
        if full:
            self._drain()
        return int(a.size)

    def observe_ingest_visibility(self, table: str, latency_s,
                                  count: int = 1) -> None:
        """One arrival cohort became visible: ``count`` events that
        waited ``latency_s`` wall seconds from pipeline arrival to the
        publishing flush."""
        with self._lock:
            ent = self._entry(table)
        ent["i2v"].observe_many(
            np.full(max(int(count), 1), float(latency_s), np.float64))
        with self._lock:
            ent["ingested"] += int(count)
            ent["flushes"] += 1

    # -------------------------------------------------------------- export
    def tables(self) -> List[str]:
        self._drain()
        with self._lock:
            return sorted(self._tables)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Picklable per-table snapshot (sketches as dicts). Watermark /
        publish stamps are NOT stored here — the engine reads them live
        from its table snapshots and folds them in
        (``Engine.freshness_snapshot``), so the tracker can never go
        stale relative to the tables it describes."""
        self._drain()
        with self._lock:
            items = list(self._tables.items())
        out: Dict[str, Dict[str, Any]] = {}
        for name, ent in items:
            out[name] = {
                "age_sketch": ent["age"].to_dict(),
                "i2v_sketch": ent["i2v"].to_dict(),
                "serve_rows": ent["serve_rows"],
                "serve_batches": ent["serve_batches"],
                "ingested": ent["ingested"],
                "flushes": ent["flushes"],
            }
        return out

    @staticmethod
    def blank_entry() -> Dict[str, Any]:
        return {"age_sketch": None, "i2v_sketch": None, "serve_rows": 0,
                "serve_batches": 0, "ingested": 0, "flushes": 0}

    @staticmethod
    def merge(snapshots: Sequence[Optional[Mapping[str, Any]]]
              ) -> Dict[str, Dict[str, Any]]:
        """Merge per-shard ``freshness_snapshot`` dicts: sketches merge
        exactly, counters add, watermark/published stamps take the MIN
        (conservative — the slowest shard bounds the data plane), table
        versions take the max."""
        out: Dict[str, Dict[str, Any]] = {}
        for snap in snapshots:
            if not snap:
                continue
            for table, ent in snap.items():
                acc = out.get(table)
                if acc is None:
                    acc = out[table] = dict(FreshnessTracker.blank_entry())
                for skey in ("age_sketch", "i2v_sketch"):
                    d = ent.get(skey)
                    if d:
                        if acc[skey] is None:
                            acc[skey] = QuantileSketch.from_dict(d) \
                                .to_dict()
                        else:
                            acc[skey] = QuantileSketch.from_dict(
                                acc[skey]).merge(dict(d)).to_dict()
                for ckey in ("serve_rows", "serve_batches", "ingested",
                             "flushes"):
                    acc[ckey] += int(ent.get(ckey, 0))
                for mkey in ("watermark", "published_at"):
                    if mkey in ent:
                        v = float(ent[mkey])
                        acc[mkey] = v if mkey not in acc \
                            else min(acc[mkey], v)
                if "table_version" in ent:
                    acc["table_version"] = max(
                        acc.get("table_version", -1),
                        int(ent["table_version"]))
                if ent.get("key_card"):
                    if acc.get("key_card") is None:
                        acc["key_card"] = CardinalityEstimator.from_dict(
                            ent["key_card"]).to_dict()
                    else:
                        acc["key_card"] = CardinalityEstimator.from_dict(
                            acc["key_card"]).merge(
                            dict(ent["key_card"])).to_dict()
                for col, d in (ent.get("columns") or {}).items():
                    cols = acc.setdefault("columns", {})
                    if col in cols:
                        cols[col] = QuantileSketch.from_dict(
                            cols[col]).merge(dict(d)).to_dict()
                    else:
                        cols[col] = QuantileSketch.from_dict(d).to_dict()
        return out

    @staticmethod
    def export(snapshot: Mapping[str, Mapping[str, Any]],
               now: Optional[float] = None) -> Dict[str, Any]:
        """Flatten a (possibly merged) snapshot into the registry's
        ``freshness`` group: ``"<table>/<metric>"`` keys. Sketch dicts
        are passed through under ``*_sketch`` keys — the Prometheus
        renderer exposes them as native histograms, the JSONL exporter
        keeps them verbatim."""
        now = time.time() if now is None else float(now)
        out: Dict[str, Any] = {}
        for table, ent in snapshot.items():
            age = ent.get("age_sketch")
            i2v = ent.get("i2v_sketch")
            agesk = (age if isinstance(age, QuantileSketch)
                     or age is None else QuantileSketch.from_dict(age))
            i2vsk = (i2v if isinstance(i2v, QuantileSketch)
                     or i2v is None else QuantileSketch.from_dict(i2v))
            out[f"{table}/age_p50"] = \
                agesk.percentile(50) if agesk else float("nan")
            out[f"{table}/age_p99"] = \
                agesk.percentile(99) if agesk else float("nan")
            out[f"{table}/age_max"] = \
                (agesk.vmax if agesk and agesk.count else float("nan"))
            out[f"{table}/age_samples"] = \
                int(agesk.count) if agesk else 0
            out[f"{table}/ingest_visible_p50_s"] = \
                i2vsk.percentile(50) if i2vsk else float("nan")
            out[f"{table}/ingest_visible_p99_s"] = \
                i2vsk.percentile(99) if i2vsk else float("nan")
            out[f"{table}/ingested"] = int(ent.get("ingested", 0))
            out[f"{table}/flushes"] = int(ent.get("flushes", 0))
            out[f"{table}/serve_rows"] = int(ent.get("serve_rows", 0))
            out[f"{table}/serve_batches"] = \
                int(ent.get("serve_batches", 0))
            wm = ent.get("watermark")
            if wm is not None:
                out[f"{table}/watermark"] = float(wm)
            pub = ent.get("published_at")
            if pub is not None:
                pub = float(pub)
                out[f"{table}/published_at"] = pub
                out[f"{table}/publish_age_s"] = (
                    now - pub if pub > 0 else float("nan"))
            if "table_version" in ent:
                out[f"{table}/table_version"] = \
                    int(ent["table_version"])
            kc = ent.get("key_card")
            if kc is not None:
                est = (kc.estimate() if isinstance(
                    kc, CardinalityEstimator)
                    else CardinalityEstimator.from_dict(kc).estimate())
                out[f"{table}/keys_est"] = est
            for col, d in (ent.get("columns") or {}).items():
                sk = QuantileSketch.from_dict(d)
                out[f"{table}/ingest_{col}_p50"] = sk.percentile(50)
                out[f"{table}/ingest_{col}_p99"] = sk.percentile(99)
            if age is not None:
                out[f"{table}/age_sketch"] = (
                    age.to_dict() if isinstance(age, QuantileSketch)
                    else dict(age))
            if i2v is not None:
                out[f"{table}/ingest_visible_sketch"] = (
                    i2v.to_dict() if isinstance(i2v, QuantileSketch)
                    else dict(i2v))
        return out

    @staticmethod
    def worst_age_p99(export_or_snapshot: Mapping[str, Any]) -> float:
        """Max per-table age p99 from an ``export()`` dict — the scalar a
        freshness SLO watches."""
        vals = [v for k, v in export_or_snapshot.items()
                if k.endswith("/age_p99") and isinstance(v, float)
                and math.isfinite(v)]
        return max(vals) if vals else float("nan")
