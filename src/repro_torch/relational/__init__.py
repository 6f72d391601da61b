"""Relational tier: multi-table catalog for point-in-time LAST JOIN."""
from repro_torch.relational.catalog import Catalog, CatalogEntry

__all__ = ["Catalog", "CatalogEntry"]
