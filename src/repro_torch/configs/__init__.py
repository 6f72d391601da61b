from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      reduced, param_count, scale_layers)
from repro_torch.configs.registry import get_config, list_archs

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "reduced",
           "param_count", "scale_layers", "get_config", "list_archs"]
