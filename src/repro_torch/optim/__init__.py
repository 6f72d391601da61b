from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     make_schedule)
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           compress_topk, decompress_topk,
                                           ErrorFeedback)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "make_schedule", "compress_int8",
           "decompress_int8", "compress_topk", "decompress_topk",
           "ErrorFeedback"]
