from repro_torch.data.synthetic import (EventStreamConfig, generate_events,
                                        request_stream, make_labels,
                                        token_batch_stream)
from repro_torch.data.pipeline import HostPipeline, PipelineConfig

__all__ = ["EventStreamConfig", "generate_events", "request_stream",
           "make_labels", "token_batch_stream", "HostPipeline",
           "PipelineConfig"]
