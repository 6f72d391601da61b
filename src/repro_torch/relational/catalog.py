"""Relational catalog: the engine's multi-table tier.

OpenMLDB's headline scenarios (fraud detection, personalized
recommendation) are multi-table: a request over a transactions stream is
enriched with the latest account-profile / merchant rows *as of the
request timestamp* via ``LAST JOIN`` (the system paper's signature
operator). The :class:`Catalog` is the registry that makes that safe:
every table the engine creates is registered together with its **declared
join keys**, and the optimizer validates each ``LAST JOIN`` against those
declarations before any plan is compiled — an undeclared probe column is
a deploy-time error, never a silent full scan.

A join key must resolve through the right table's key directory (the
device-resident hash index ``featurestore.keydir`` builds over the
table's partition key), so today the only declarable join key is the
table's ``key_col``. Secondary join-key indexes are a ROADMAP open item
("multi-key indexes"); declaring one fails loudly here instead of
degrading to a scan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

from repro_torch.featurestore.table import Table, TableSchema

__all__ = ["Catalog", "CatalogEntry"]


@dataclass(frozen=True)
class CatalogEntry:
    """One joinable table: storage + the keys LAST JOIN may probe."""

    table: Table
    join_keys: Tuple[str, ...]

    @property
    def schema(self) -> TableSchema:
        return self.table.schema


class Catalog:
    """Name -> :class:`CatalogEntry` registry for the relational tier."""

    def __init__(self) -> None:
        self._entries: Dict[str, CatalogEntry] = {}

    def register(self, table: Table,
                 join_keys: Sequence[str] = ()) -> CatalogEntry:
        """Register ``table`` with its declared join keys.

        The table's partition key (``schema.key_col``) is always declared
        — it is the one column the key directory can probe. Additional
        join keys would need secondary indexes (ROADMAP: multi-key
        indexes) and are rejected until those exist.
        """
        name = table.schema.name
        if name in self._entries:
            raise ValueError(f"table {name!r} already in the catalog")
        extra = [k for k in join_keys if k != table.schema.key_col]
        if extra:
            raise ValueError(
                f"table {name!r}: secondary join key(s) {sorted(extra)} are "
                f"not supported yet — LAST JOIN probes resolve through the "
                f"table's key directory, which indexes only the partition "
                f"key {table.schema.key_col!r} (ROADMAP open item: "
                f"multi-key indexes)")
        entry = CatalogEntry(table=table,
                             join_keys=(table.schema.key_col,))
        self._entries[name] = entry
        return entry

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> CatalogEntry:
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(
                f"unknown table {name!r} in the relational catalog; "
                f"registered: {sorted(self._entries)} (create_table "
                f"registers tables automatically)")
        return entry

    def schema(self, name: str) -> TableSchema:
        return self.get(name).schema

    def join_keys(self, name: str) -> Tuple[str, ...]:
        return self.get(name).join_keys

    def tables(self) -> Tuple[str, ...]:
        return tuple(sorted(self._entries))
