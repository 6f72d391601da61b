"""Structured serving results + request context.

The hot path used to speak ``Dict[str, np.ndarray]`` and nothing else:
no way to tell which deployment *version* served a batch, whether a key
was unknown, or what the request actually cost. :class:`FeatureFrame`
carries that metadata while remaining a drop-in ``Mapping`` — every
pre-existing call site (``out["amt_sum_10"]``, ``res.items()``,
``for name in out``) keeps working unchanged.

:class:`RequestContext` flows from ``FeatureServer.request`` through the
``DynamicBatcher`` into the engine. Its ``version_pin`` is the batch
grouping key — the batcher never mixes differently-pinned requests in
one batch, which (together with the engine resolving ONE handle per
batch) is what keeps a batch on a single deployment version mid-swap.
"""
from __future__ import annotations

import time
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["FeatureFrame", "RequestContext", "DeadlineExceeded",
           "STATUS_OK", "STATUS_UNKNOWN_KEY", "STATUS_SHED",
           "STATUS_DEGRADED"]

STATUS_OK = 0
STATUS_UNKNOWN_KEY = 1
# the request was load-shed (deadline passed, or admission control dropped
# it) BEFORE any feature computation — the whole batch carries this status,
# never a mix of shed and computed rows (repro.shard.resource)
STATUS_SHED = 2
# the owning shard is down/recovering and this row was answered from the
# stale-tier cache (last feature row the shard published for this key)
# instead of being shed — possibly-stale values, still usable for models
# that prefer a slightly-old feature to none (DESIGN.md §12 degradation
# ladder OK→DEGRADED→SHED); unlike SHED this CAN mix with OK rows in one
# batch (only the dead shard's keys degrade)
STATUS_DEGRADED = 3


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed before (or while) it could be served."""


@dataclass(frozen=True)
class RequestContext:
    """Per-request serving context.

    ``deadline`` is an absolute ``time.monotonic()`` instant; expired
    requests are dropped by the batcher instead of wasting a batch slot.
    ``version_pin`` routes the request to one specific deployment version
    (e.g. replaying traffic against a retired version after a swap).
    ``trace_id``/``parent_span`` carry the distributed-tracing context
    (DESIGN.md §13): the id is generated ULID-style at the serving edge
    when absent, and each tier that opens a span re-parents the context
    it forwards (``dataclasses.replace(ctx, parent_span=span.span_id)``)
    so the reassembled trace is a tree, not a flat list.
    """

    deadline: Optional[float] = None
    trace_id: Optional[str] = None
    version_pin: Optional[int] = None
    parent_span: Optional[str] = None

    @classmethod
    def with_timeout(cls, timeout_s: float, **kw) -> "RequestContext":
        return cls(deadline=time.monotonic() + timeout_s, **kw)

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()


class FeatureFrame(Mapping):
    """Named feature columns + per-request status + serving metadata.

    Mapping protocol is over the feature columns, so a FeatureFrame is
    backwards-compatible with the raw dict the engine used to return.
    """

    __slots__ = ("columns", "status", "deployment", "version",
                 "table_version", "latency", "trace_id", "version_vector",
                 "watermark", "feature_age")

    def __init__(self, columns: Dict[str, np.ndarray], *,
                 status: Optional[np.ndarray] = None,
                 deployment: str = "", version: int = 0,
                 table_version: int = -1,
                 latency: Optional[Dict[str, float]] = None,
                 trace_id: Optional[str] = None,
                 version_vector: Optional[tuple] = None,
                 watermark: Optional[float] = None,
                 feature_age: Optional[float] = None):
        self.columns = dict(columns)
        if status is None:
            status = np.zeros((0,), np.int8)
        self.status = np.asarray(status, np.int8)
        self.deployment = deployment
        self.version = version
        self.table_version = table_version
        self.latency = dict(latency) if latency else {}
        self.trace_id = trace_id
        # sharded serving: per-shard table snapshot versions (shard order)
        # for the batch — the cross-shard analogue of ``table_version``
        self.version_vector = version_vector
        # freshness stamp (DESIGN.md §14): max event-time the served
        # snapshot covered, and this batch's worst feature age (request
        # event-time − watermark, event-time units; sharded serving
        # stamps the MIN watermark / MAX age across touched shards)
        self.watermark = watermark
        self.feature_age = feature_age

    # ---------------------------------------------------- Mapping protocol
    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self.columns)

    def __len__(self) -> int:
        return len(self.columns)

    # ------------------------------------------------------------- helpers
    def to_dict(self) -> Dict[str, np.ndarray]:
        """Plain dict of the feature columns (metadata dropped)."""
        return dict(self.columns)

    @property
    def all_ok(self) -> bool:
        return bool((self.status == STATUS_OK).all())

    @property
    def n_unknown(self) -> int:
        return int((self.status == STATUS_UNKNOWN_KEY).sum())

    @property
    def n_shed(self) -> int:
        return int((self.status == STATUS_SHED).sum())

    @property
    def n_degraded(self) -> int:
        return int((self.status == STATUS_DEGRADED).sum())

    def row(self, i: int) -> "FeatureFrame":
        """Single-request view (scalar columns), keeping the metadata —
        how the batcher splits one engine batch into per-caller results."""
        return FeatureFrame(
            {n: v[i] for n, v in self.columns.items()},
            status=self.status[i:i + 1] if self.status.size else None,
            deployment=self.deployment, version=self.version,
            table_version=self.table_version, latency=self.latency,
            trace_id=self.trace_id, version_vector=self.version_vector,
            watermark=self.watermark, feature_age=self.feature_age)

    def __repr__(self) -> str:
        return (f"FeatureFrame({sorted(self.columns)}, "
                f"deployment={self.deployment!r} v{self.version}, "
                f"n={self.status.size}, unknown={self.n_unknown})")
