"""Observability, the part of it the serving tier needs so far: trace
ids (``trace``) and the mergeable sketches (``sketch``) behind the
batcher's rolling latency window and the LAST JOIN staleness quantiles.
The tracer, profiler, metrics registry, freshness, drift, SLO and flight
recorder modules come with the observability slice of the port."""
from repro_torch.obs.sketch import QuantileSketch, RollingSketch
from repro_torch.obs.trace import new_trace_id

__all__ = ["QuantileSketch", "RollingSketch", "new_trace_id"]
