from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     make_schedule)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "make_schedule"]
