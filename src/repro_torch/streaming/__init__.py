"""Streaming ingestion subsystem: watermarked reorder buffering, background
flushing into the copy-on-write ring-buffer ingest, TTL retention, and
trace replay — continuous ingest without serving interference (DESIGN.md §4)."""
from repro_torch.streaming.buffer import StreamBuffer, StreamBufferStats
from repro_torch.streaming.pipeline import IngestPipeline, PipelineConfig
from repro_torch.streaming.retention import (RetentionPolicy, apply_retention,
                                       compact_expired)
from repro_torch.streaming.source import StreamSource, online_offline_consistency

__all__ = ["StreamBuffer", "StreamBufferStats", "IngestPipeline",
           "PipelineConfig", "RetentionPolicy", "apply_retention",
           "compact_expired", "StreamSource", "online_offline_consistency"]
