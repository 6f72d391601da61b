from repro_torch.serving.server import ModelServer, hedged

__all__ = ["ModelServer", "hedged"]
