"""Feature registry: one SQL definition, consistent offline + online use.

The registry is the paper's §3.3 "bridging online and offline pipelines":
a :class:`FeatureSet` couples a table schema with a feature query. The SAME
optimized plan is executed by the offline batch path (training data) and the
online request path (serving), which is what eliminates training–serving
skew. ``tests/test_consistency.py`` asserts bit-equality between the two.

Feature sets are **versioned**: every redeploy of a name registers the next
version, all versions stay addressable (``get(name, version=...)``), and the
``active`` pointer tracks which version the engine is currently serving —
it moves on hot-swap, promote, and rollback (DESIGN.md §6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Optional

from repro_torch.featurestore.table import TableSchema

if TYPE_CHECKING:  # avoid featurestore <-> core import cycle
    from repro_torch.core.logical import Query

__all__ = ["FeatureSet", "FeatureRegistry"]


@dataclass
class FeatureSet:
    name: str
    query: "Query"
    version: int = 1
    description: str = ""

    @property
    def table(self) -> str:
        return self.query.table


@dataclass
class FeatureRegistry:
    """Named feature sets + table schemas (the 'feature store' catalogue)."""

    schemas: Dict[str, TableSchema] = field(default_factory=dict)
    feature_sets: Dict[str, FeatureSet] = field(default_factory=dict)
    # name -> version -> FeatureSet (full history; feature_sets keeps the
    # latest registered for backwards compatibility)
    versions: Dict[str, Dict[int, FeatureSet]] = field(default_factory=dict)
    # name -> the version currently serving (set by the engine on swap)
    active: Dict[str, int] = field(default_factory=dict)

    def register_schema(self, schema: TableSchema) -> None:
        if schema.name in self.schemas:
            raise ValueError(f"schema {schema.name!r} already registered")
        self.schemas[schema.name] = schema

    def register(self, fs: FeatureSet) -> None:
        if fs.table not in self.schemas:
            raise ValueError(
                f"feature set {fs.name!r} references unknown table "
                f"{fs.table!r}; register its schema first")
        prev = self.feature_sets.get(fs.name)
        if prev is not None and prev.version >= fs.version:
            raise ValueError(
                f"feature set {fs.name!r} v{fs.version} does not supersede "
                f"registered v{prev.version}")
        self.feature_sets[fs.name] = fs
        self.versions.setdefault(fs.name, {})[fs.version] = fs

    def set_active(self, name: str, version: int) -> None:
        """Point ``name`` at the serving version (swap/promote/rollback)."""
        if version not in self.versions.get(name, {}):
            raise KeyError(f"feature set {name!r} has no version {version}; "
                           f"known: {sorted(self.versions.get(name, {}))}")
        self.active[name] = version

    def latest_version(self, name: str) -> int:
        vs = self.versions.get(name)
        if not vs:
            raise KeyError(f"unknown feature set {name!r}; registered: "
                           f"{sorted(self.feature_sets)}")
        return max(vs)

    def get(self, name: str, version: Optional[int] = None) -> FeatureSet:
        """The active version by default; any version by number."""
        if version is not None:
            try:
                return self.versions[name][version]
            except KeyError:
                raise KeyError(
                    f"feature set {name!r} has no version {version}; "
                    f"known: {sorted(self.versions.get(name, {}))}") from None
        if name in self.active:
            return self.versions[name][self.active[name]]
        try:
            return self.feature_sets[name]
        except KeyError:
            raise KeyError(f"unknown feature set {name!r}; registered: "
                           f"{sorted(self.feature_sets)}") from None
