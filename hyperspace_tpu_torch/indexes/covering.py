"""Covering index — the core index kind.

Reference: ``index/covering/CoveringIndex.scala:33-193``,
``CoveringIndexTrait.scala:32-135``, ``CoveringIndexConfig.scala:37-151``.

A covering index is a vertical slice of the source (indexed + included
columns), **hash-bucketed by the indexed columns and sorted within each
bucket**, so that at query time it can substitute (a) the scan in a filter
query with bucket pruning, and (b) the whole shuffle+sort in a sort-merge
join (both sides co-bucketed ⇒ no exchange).

Build pipeline (replaces ``indexData.repartition(numBuckets, cols) +
saveWithBuckets``, CoveringIndex.scala:56-71), single device:

    host scan (arrow) → columnar batch, key reps to the device
      → murmur3 bucket ids of the indexed cols   (kernel B1, ops/hash)
      → stable sort by (bucket, key)             (ops/sort, torch.sort)
      → host write: one parquet file per bucket under v__=N/

Optimize and refresh (CoveringIndexTrait.scala:57-134) run the same
pipeline over the rows they rewrite, into a new version directory.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.base import Index, IndexConfigTrait, UpdateMode
from hyperspace_tpu_torch.indexes.registry import register_index


@register_index
class CoveringIndex(Index):
    kind = "CoveringIndex"
    kind_abbr = "CI"

    def __init__(
        self,
        indexed_columns: List[str],
        included_columns: List[str],
        schema_json: str,
        num_buckets: int,
        properties: Optional[Dict[str, str]] = None,
    ):
        self._indexed_columns = list(indexed_columns)
        self._included_columns = list(included_columns)
        self.schema_json = schema_json
        self.num_buckets = int(num_buckets)
        self.properties: Dict[str, str] = dict(properties or {})

    # -- identity -----------------------------------------------------------
    def __eq__(self, other):
        return (
            isinstance(other, CoveringIndex)
            and self._indexed_columns == other._indexed_columns
            and self._included_columns == other._included_columns
            and self.num_buckets == other.num_buckets
            and self.schema_json == other.schema_json
        )

    def __hash__(self):
        return hash((tuple(self._indexed_columns), self.num_buckets))

    # -- schema -------------------------------------------------------------
    @property
    def indexed_columns(self) -> List[str]:
        return list(self._indexed_columns)

    @property
    def included_columns(self) -> List[str]:
        return list(self._included_columns)

    @property
    def can_handle_deleted_files(self) -> bool:
        # deletes are compensated through the lineage column
        # (CoveringIndexTrait)
        return self.lineage_enabled

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "type": self.kind,
            "kindAbbr": self.kind_abbr,
            "indexedColumns": self._indexed_columns,
            "includedColumns": self._included_columns,
            "schemaJson": self.schema_json,
            "numBuckets": self.num_buckets,
            "properties": dict(self.properties),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CoveringIndex":
        return cls(
            d["indexedColumns"],
            d.get("includedColumns", []),
            d.get("schemaJson", ""),
            d["numBuckets"],
            d.get("properties", {}),
        )

    # -- data plane ---------------------------------------------------------
    def write(self, ctx, index_data) -> None:
        """Bucketed + sorted write (CoveringIndex.write:56-71)."""
        from hyperspace_tpu_torch.indexes import covering_build

        covering_build.write_bucketed(
            ctx, index_data, self._indexed_columns, self.num_buckets
        )

    def optimize(self, ctx, files_to_optimize: List[str]) -> None:
        """Read the listed index files and rewrite them bucketed
        (CoveringIndexTrait.optimize:130-134)."""
        from hyperspace_tpu_torch.indexes import covering_build

        covering_build.rewrite_files(
            ctx, files_to_optimize, self._indexed_columns, self.num_buckets
        )

    def refresh_incremental(
        self, ctx, appended_df, deleted_source_file_ids, previous_content
    ) -> Tuple["CoveringIndex", UpdateMode]:
        """Index the appended source files' rows into the new version dir
        (MERGE, co-bucketed with the previous files), or, when source files
        were deleted, rewrite the previous index data minus their lineage
        ids together with them (OVERWRITE)
        (CoveringIndexTrait.refreshIncremental:57-106)."""
        from hyperspace_tpu_torch.indexes import covering_build

        return covering_build.refresh_incremental(
            ctx, self, appended_df, deleted_source_file_ids, previous_content
        )

    def refresh_full(self, ctx, df) -> "CoveringIndex":
        """Full rebuild from the current source state
        (CoveringIndexTrait.refreshFull:108-126)."""
        from hyperspace_tpu_torch.indexes import covering_build

        return covering_build.refresh_full(ctx, self, df)

    def statistics(self, extended: bool = False) -> Dict[str, str]:
        """The index's own columns of ``hs.indexes()`` / ``hs.index(name)``
        (CoveringIndex.statistics)."""
        return {
            "indexedColumns": ",".join(self._indexed_columns),
            "includedColumns": ",".join(self._included_columns),
            "numBuckets": str(self.num_buckets),
            "schema": self.schema_json if extended else "",
        }


class CoveringIndexConfig(IndexConfigTrait):
    """name + indexedColumns + includedColumns
    (CoveringIndexConfig.scala:37-151)."""

    def __init__(
        self,
        index_name: str,
        indexed_columns: List[str],
        included_columns: Optional[List[str]] = None,
    ):
        if not index_name:
            raise HyperspaceException("Index name cannot be empty")
        if not indexed_columns:
            raise HyperspaceException("indexed_columns cannot be empty")
        lowered = [c.lower() for c in indexed_columns]
        if len(set(lowered)) != len(lowered):
            raise HyperspaceException("Duplicate indexed column names")
        inc = list(included_columns or [])
        if set(c.lower() for c in inc) & set(lowered):
            raise HyperspaceException(
                "Duplicate column names in indexed/included columns"
            )
        self._name = index_name
        self._indexed = list(indexed_columns)
        self._included = inc

    def __repr__(self):
        return (
            f"CoveringIndexConfig(indexName={self._name!r}, "
            f"indexedColumns={self._indexed}, includedColumns={self._included})"
        )

    @property
    def index_name(self) -> str:
        return self._name

    @property
    def indexed_columns(self) -> List[str]:
        return list(self._indexed)

    @property
    def included_columns(self) -> List[str]:
        return list(self._included)

    @property
    def referenced_columns(self) -> List[str]:
        return self._indexed + self._included

    def create_index(self, ctx, source_data, properties: Dict[str, str]):
        """(CoveringIndex, index_data) — projection + optional lineage column
        (CoveringIndexConfig.createIndex:43-61 →
        CoveringIndex.createIndexData:140-192)."""
        from hyperspace_tpu_torch.indexes import covering_build

        return covering_build.create_covering_index(
            ctx, source_data, self, properties
        )

    def describe_index(self, ctx, source_data, properties: Dict[str, str]):
        """CoveringIndex object without scanning data (begin-phase entry)."""
        from hyperspace_tpu_torch.indexes import covering_build

        return covering_build.describe_covering_index(
            ctx, source_data, self, properties
        )
