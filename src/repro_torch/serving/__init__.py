from repro_torch.serving.batcher import BatcherConfig, DynamicBatcher, Request
from repro_torch.serving.server import (FeatureServer, ModelServer,
                                        ServerConfig, hedged)

__all__ = ["BatcherConfig", "DynamicBatcher", "Request", "FeatureServer",
           "ServerConfig", "ModelServer", "hedged"]
