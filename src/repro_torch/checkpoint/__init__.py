from repro_torch.checkpoint.manager import CheckpointManager, CheckpointMeta

__all__ = ["CheckpointManager", "CheckpointMeta"]
