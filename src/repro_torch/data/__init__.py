from repro_torch.data.synthetic import (EventStreamConfig, generate_events,
                                        request_stream, make_labels)

__all__ = ["EventStreamConfig", "generate_events", "request_stream",
           "make_labels"]
