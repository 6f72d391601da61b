"""Stream replay over synthetic traces: one trace, three delivery modes.

* ``backfill(table)``     — offline path: sorted bulk insert, the batch
  half of the paper's "one definition, two execution modes";
* ``replay(pipeline)``    — online path: events pushed through the
  watermark buffer + background flusher, optionally paced (events/sec)
  and optionally with bounded arrival disorder (``with_disorder``) to
  exercise out-of-order repair;
* ``batches()``           — raw chunks for custom drivers.

``online_offline_consistency`` closes the loop: after a replayed stream
lands, ``Engine.query_offline`` over the stored events must equal online
point-in-time requests at the same ``(key, ts)`` — the training-serving
skew guarantee must survive streaming delivery, not just clean bulk loads.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import EventStreamConfig, generate_events

__all__ = ["StreamSource", "online_offline_consistency"]


@dataclass(frozen=True)
class StreamSource:
    """A finite keyed event trace in *arrival* order.

    ``ts`` is event time (what windows are computed over); the array order
    is arrival order — equal to ts order for a clean trace, deliberately
    not for a disordered one.
    """

    keys: np.ndarray   # (N,) arbitrary key dtype
    ts: np.ndarray     # (N,) f32 event time
    rows: np.ndarray   # (N, V) f32

    @classmethod
    def from_config(cls, cfg: EventStreamConfig) -> "StreamSource":
        keys, ts, rows = generate_events(cfg)
        return cls(keys=keys, ts=ts, rows=rows)

    def __len__(self) -> int:
        return len(self.keys)

    # ------------------------------------------------------------- variants
    def with_disorder(self, *, jitter: float, seed: int = 0
                      ) -> "StreamSource":
        """Bounded out-of-order delivery: arrival order becomes the sort
        of ``ts + U(0, jitter)`` while event times stay untouched. An
        event can thus arrive at most ``jitter`` event-time units late —
        repairable by a reorder window with ``lateness >= jitter``."""
        rng = np.random.default_rng(seed)
        arrival = self.ts + rng.uniform(0, jitter,
                                        len(self.ts)).astype(np.float32)
        order = np.argsort(arrival, kind="stable")
        return StreamSource(keys=self.keys[order], ts=self.ts[order],
                            rows=self.rows[order])

    def batches(self, batch_size: int = 256
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        for s in range(0, len(self.keys), batch_size):
            sl = slice(s, s + batch_size)
            yield self.keys[sl], self.ts[sl], self.rows[sl]

    # ------------------------------------------------------------- delivery
    def backfill(self, table) -> None:
        """Offline bulk load: sort by event time and insert directly (no
        buffer, no flusher) — the batch-mode ingest baseline."""
        order = np.argsort(self.ts, kind="stable")
        table.insert(self.keys[order].tolist(), self.ts[order].tolist(),
                     self.rows[order])

    def replay(self, pipeline, *, batch_size: int = 256,
               rate: Optional[float] = None,
               stop_event=None) -> int:
        """Push the trace through an ``IngestPipeline`` in arrival order.

        ``rate`` paces delivery in events per wall-clock second (None =
        as fast as possible — saturation mode). Returns events accepted.
        Respects ``stop_event`` (threading.Event) for bench teardown.
        """
        accepted = 0
        t0 = time.perf_counter()
        sent = 0
        for keys, ts, rows in self.batches(batch_size):
            if stop_event is not None and stop_event.is_set():
                break
            if rate is not None:
                target = sent / rate
                lag = target - (time.perf_counter() - t0)
                if lag > 0:
                    time.sleep(lag)
            accepted += pipeline.push_batch(keys.tolist(), ts, rows)
            sent += len(keys)
        return accepted


def online_offline_consistency(engine, deployment: str, *,
                               atol: float = 1e-4, rtol: float = 1e-5
                               ) -> Tuple[bool, Dict[str, float]]:
    """Verify point-in-time equality of the two execution modes.

    Materialises every stored event offline, then re-requests the same
    ``(key, ts)`` pairs online and compares feature-by-feature. Returns
    ``(ok, {feature: max_abs_err})``.
    """
    import dataclasses as _dc

    dep = engine.deployments[deployment]
    off = engine.query_offline(deployment)
    kidx = np.asarray(off["__key"])
    if kidx.size == 0:
        return True, {}
    rev = {v: k for k, v in dep.table.key_to_idx.items()}
    req_keys = [rev[int(k)] for k in kidx]

    saved = engine.flags
    if engine.flags.assume_latest:
        # online must replay historical ts, not assume "now"
        engine.flags = _dc.replace(engine.flags, assume_latest=False)
    try:
        on = engine.request(deployment, req_keys, off["__ts"].tolist())
    finally:
        engine.flags = saved

    errs: Dict[str, float] = {}
    ok = True
    for name, vals in on.items():
        e = float(np.max(np.abs(np.asarray(vals)
                                - np.asarray(off[name]))))
        errs[name] = e
        if e > atol + rtol * float(np.max(np.abs(off[name]))):
            ok = False
    return ok, errs
