"""Host-side input pipeline: prefetch, double-buffer, straggler hedging.

A copy of the JAX package's ``repro.data.pipeline`` (it has no JAX in
it). Training stalls whenever the host cannot hand the next batch to the
device in time. This pipeline runs producers on background threads with a
bounded queue (double buffering), and applies *hedged batch assembly* for
straggler mitigation: if a producer misses its deadline, the pipeline
re-issues the request to a spare producer and takes whichever finishes
first (the classic tail-at-scale trick, applied to input workers —
at 1000+ nodes a slow host must never stall the global step).

Producers are plain callables ``f(batch_index) -> pytree`` so the same
pipeline serves token streams, feature-engine offline scans, and the
serving replay benchmarks.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

__all__ = ["PipelineConfig", "HostPipeline"]


@dataclass(frozen=True)
class PipelineConfig:
    prefetch: int = 2                 # queue depth (double buffer = 2)
    n_workers: int = 2                # producer threads
    hedge_after_s: Optional[float] = None   # straggler deadline; None = off
    max_hedges: int = 1


class HostPipeline:
    """Pull-based prefetching iterator over ``producer(i)`` calls."""

    def __init__(self, producer: Callable[[int], Any],
                 n_batches: Optional[int] = None,
                 cfg: PipelineConfig = PipelineConfig()):
        self.producer = producer
        self.n_batches = n_batches
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._next_index = 0
        self._index_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(cfg.n_workers)]
        self.stats = {"produced": 0, "hedges": 0, "hedge_wins": 0}
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- producers
    def _claim(self) -> Optional[int]:
        with self._index_lock:
            i = self._next_index
            if self.n_batches is not None and i >= self.n_batches:
                return None
            self._next_index += 1
            return i

    def _produce_hedged(self, i: int) -> Any:
        cfg = self.cfg
        if cfg.hedge_after_s is None:
            return self.producer(i)
        result: Dict[str, Any] = {}
        done = threading.Event()

        def attempt(tag: str):
            try:
                r = self.producer(i)
            except Exception as e:                      # surfaced by get()
                r = e
            if tag not in result and not done.is_set():
                result[tag] = r
                done.set()

        t0 = threading.Thread(target=attempt, args=("primary",), daemon=True)
        t0.start()
        done.wait(cfg.hedge_after_s)
        hedges = 0
        while not done.is_set() and hedges < cfg.max_hedges:
            hedges += 1
            self.stats["hedges"] += 1
            th = threading.Thread(target=attempt, args=(f"hedge{hedges}",),
                                  daemon=True)
            th.start()
            done.wait(cfg.hedge_after_s)
        done.wait()                                      # someone finishes
        tag, val = next(iter(result.items()))
        if tag != "primary":
            self.stats["hedge_wins"] += 1
        if isinstance(val, Exception):
            raise val
        return val

    def _worker(self):
        while not self._stop.is_set():
            i = self._claim()
            if i is None:
                self._q.put((None, StopIteration()))
                return
            try:
                item = self._produce_hedged(i)
                self._q.put((i, item))
                self.stats["produced"] += 1
            except Exception as e:
                self._q.put((i, e))
                return

    # -------------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Any]:
        finished = 0
        served = 0
        pending: Dict[int, Any] = {}
        next_i = 0
        while True:
            if self.n_batches is not None and served >= self.n_batches:
                return
            if next_i in pending:                 # in-order delivery
                item = pending.pop(next_i)
                next_i += 1
                served += 1
                yield item
                continue
            i, item = self._q.get()
            if i is None:
                finished += 1
                if finished >= len(self._threads) and not pending:
                    return
                continue
            if isinstance(item, Exception):
                raise item
            pending[i] = item

    def close(self):
        self._stop.set()
