from repro_torch.checkpoint.manager import CheckpointManager, CheckpointMeta
from repro_torch.checkpoint.reshard import (leaf_slice_bytes,
                                            restore_resharded,
                                            save_unsharded_spec)

__all__ = ["CheckpointManager", "CheckpointMeta", "restore_resharded",
           "save_unsharded_spec", "leaf_slice_bytes"]
