"""Synthetic feature-rich event streams (paper §Data Availability).

The paper evaluates on synthetic transaction-like data generated inside
Docker: keyed event streams with timestamps, numeric features, bursty
arrival patterns and heavy-tailed key popularity (some users transact far
more than others). We reproduce that generator with explicit knobs so
every benchmark is seeded + replayable:

* keys ~ Zipf(alpha) over ``n_keys`` users;
* inter-arrival ~ Exp(rate) with sinusoidal diurnal modulation;
* ``n_features`` value columns: amounts ~ LogNormal, coordinates ~ Normal,
  a categorical-ish column (small ints), and AR(1) per-key drift so window
  aggregates are informative;
* optional fraud labels from a planted rule (big amount + far from the
  key's home location + short window burst) for the end-to-end examples.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["EventStreamConfig", "generate_events", "request_stream",
           "make_labels", "token_batch_stream"]


@dataclass(frozen=True)
class EventStreamConfig:
    n_events: int = 10_000
    n_keys: int = 256
    n_features: int = 6
    zipf_alpha: float = 1.2
    rate_hz: float = 50.0
    diurnal_depth: float = 0.5
    ar_rho: float = 0.85
    seed: int = 0


def generate_events(cfg: EventStreamConfig
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (keys (N,) int64, ts (N,) f32 sorted, rows (N, F) f32)."""
    rng = np.random.default_rng(cfg.seed)
    N, F = cfg.n_events, cfg.n_features

    # heavy-tailed key popularity
    ranks = np.arange(1, cfg.n_keys + 1, dtype=np.float64)
    pk = ranks ** (-cfg.zipf_alpha)
    pk /= pk.sum()
    keys = rng.choice(cfg.n_keys, size=N, p=pk).astype(np.int64)

    # bursty arrivals: exponential gaps modulated by a diurnal sinusoid
    gaps = rng.exponential(1.0 / cfg.rate_hz, size=N)
    t = np.cumsum(gaps)
    mod = 1.0 + cfg.diurnal_depth * np.sin(2 * np.pi * t / (t[-1] + 1e-9))
    ts = np.cumsum(gaps * mod).astype(np.float32)

    rows = np.empty((N, F), np.float32)
    # col 0: amount ~ LogNormal
    rows[:, 0] = rng.lognormal(mean=3.0, sigma=1.0, size=N)
    # col 1-2: per-key home location + noise
    home = rng.normal(0, 10, size=(cfg.n_keys, 2))
    rows[:, 1:3] = home[keys] + rng.normal(0, 1.0, size=(N, 2))
    # col 3: small-int categorical-ish (merchant category)
    if F > 3:
        rows[:, 3] = rng.integers(0, 12, size=N).astype(np.float32)
    # col 4+: per-key AR(1) drift series
    for c in range(4, F):
        noise = rng.normal(0, 1, size=N).astype(np.float32)
        series = np.zeros(N, np.float32)
        last = np.zeros(cfg.n_keys, np.float32)
        for i in range(N):            # host-side gen; fine at bench sizes
            k = keys[i]
            last[k] = cfg.ar_rho * last[k] + noise[i]
            series[i] = last[k]
        rows[:, c] = series
    return keys, ts, rows


def make_labels(keys: np.ndarray, ts: np.ndarray, rows: np.ndarray,
                *, amount_thresh: float = 60.0, dist_thresh: float = 4.0,
                seed: int = 0) -> np.ndarray:
    """Planted fraud rule + label noise -> (N,) float32 in {0,1}."""
    rng = np.random.default_rng(seed)
    n_keys = int(keys.max()) + 1
    home = np.zeros((n_keys, 2), np.float32)
    cnt = np.zeros(n_keys, np.int64)
    for k, r in zip(keys, rows[:, 1:3]):          # running home estimate
        home[k] = (home[k] * cnt[k] + r) / (cnt[k] + 1)
        cnt[k] += 1
    dist = np.linalg.norm(rows[:, 1:3] - home[keys], axis=1)
    y = ((rows[:, 0] > amount_thresh) & (dist > dist_thresh))
    flip = rng.random(len(y)) < 0.02
    return (y ^ flip).astype(np.float32)


def request_stream(keys: np.ndarray, ts: np.ndarray, *,
                   batch: int, n_batches: int, seed: int = 0,
                   ts_offset: float = 1.0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Online serving workload: batches of (key, request-ts) pairs drawn
    from the observed key distribution, timestamps past the ingest
    horizon (fresh "now" queries, as in the paper's QPS runs)."""
    rng = np.random.default_rng(seed + 1)
    t_max = float(ts.max())
    uniq, freq = np.unique(keys, return_counts=True)
    p = freq / freq.sum()
    for i in range(n_batches):
        ks = rng.choice(uniq, size=batch, p=p)
        rts = np.full(batch, t_max + ts_offset * (i + 1), np.float32)
        yield ks, rts


def token_batch_stream(*, vocab: int, batch: int, seq: int, seed: int = 0,
                       n_batches: Optional[int] = None
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """LM training batches (synthetic Zipf tokens; deterministic)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    i = 0
    while n_batches is None or i < n_batches:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=p).astype(np.int32)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        i += 1
