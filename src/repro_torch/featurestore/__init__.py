from repro_torch.featurestore.table import (Table, TableSchema, TableState,
                                            PreAggState)
from repro_torch.featurestore.registry import FeatureRegistry, FeatureSet

__all__ = ["Table", "TableSchema", "TableState", "PreAggState",
           "FeatureRegistry", "FeatureSet"]
