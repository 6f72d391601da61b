"""Observability: distributed tracing, the EXPLAIN ANALYZE operator
profiler, the unified metrics registry, and the data-plane freshness,
drift, SLO and flight-recorder modules, with the mergeable sketches
under them.

Attribute access is lazy (PEP 562): the sketch and freshness modules are
imported by the featurestore and streaming layers, so importing
``profile``/``export`` here (which pull ``repro_torch.core``) eagerly
would create an import cycle.
"""
_EXPORTS = {
    "MetricsRegistry": "repro_torch.obs.export",
    "registry_from_engine": "repro_torch.obs.export",
    "OperatorProfiler": "repro_torch.obs.profile",
    "attribute_exec": "repro_torch.obs.profile",
    "operator_rows": "repro_torch.obs.profile",
    "Span": "repro_torch.obs.trace",
    "Tracer": "repro_torch.obs.trace",
    "new_trace_id": "repro_torch.obs.trace",
    "QuantileSketch": "repro_torch.obs.sketch",
    "RollingSketch": "repro_torch.obs.sketch",
    "CardinalityEstimator": "repro_torch.obs.sketch",
    "DriftMonitor": "repro_torch.obs.sketch",
    "psi_distance": "repro_torch.obs.sketch",
    "FreshnessTracker": "repro_torch.obs.freshness",
    "SLOSpec": "repro_torch.obs.slo",
    "SLOEngine": "repro_torch.obs.slo",
    "FlightRecorder": "repro_torch.obs.flight",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
