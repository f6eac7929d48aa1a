"""Z-order covering index.

Counterpart of ``hyperspace_tpu/indexes/zorder.py`` (reference:
``zordercovering/ZOrderCoveringIndex.scala:32-189``): a covering index
whose rows are globally sorted by interleaved-bit **z-address** instead of
hash-bucketed, so range queries on any indexed column touch few files and
row groups. Build:

    host scan (arrow)  →  SoA batch
      →  per-column order encodings and scaled words   [host, numpy]
      →  z-address planes                              [kernel B6, ops/zorder]
      →  stable lexsort of the planes                  [ops/sort, torch.sort]
      →  permutation back to the host, the sorted rows split into
         ceil(bytes / targetSourceBytesPerPartition) files
         ``part-{i:05d}-zorder.parquet``

The files are byte-identical to the reference's. An incremental refresh
z-sorts only its new data (the appended files' rows, or, after a delete,
the previous index data minus the deleted files' lineage ids with them),
as the reference does; optimize rewrites the listed files, a full refresh
rebuilds. Its streamed two-pass build for sources past the memory budget
waits for the streaming build (ROADMAP A.8). Stage wall times (scan /
z_address / sort / write) land in ``session.build_stats``; z_address and
sort include the transfers to and from the device.
"""

from __future__ import annotations

import math
import os
import time as _time
from typing import Dict, List, Optional, Tuple

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.base import Index, IndexConfigTrait, UpdateMode
from hyperspace_tpu_torch.indexes.registry import register_index
from hyperspace_tpu_torch.io import parquet as pio

#: z-address bits a column, as the reference's build uses
Z_BITS = 16


@register_index
class ZOrderCoveringIndex(Index):
    kind = "ZOrderCoveringIndex"
    kind_abbr = "ZOCI"

    def __init__(
        self,
        indexed_columns: List[str],
        included_columns: List[str],
        schema_json: str,
        target_bytes_per_partition: int,
        properties: Optional[Dict[str, str]] = None,
    ):
        self._indexed_columns = list(indexed_columns)
        self._included_columns = list(included_columns)
        self.schema_json = schema_json
        self.target_bytes_per_partition = int(target_bytes_per_partition)
        self.properties: Dict[str, str] = dict(properties or {})

    def __eq__(self, other):
        return (
            isinstance(other, ZOrderCoveringIndex)
            and self._indexed_columns == other._indexed_columns
            and self._included_columns == other._included_columns
            and self.schema_json == other.schema_json
        )

    def __hash__(self):
        return hash(tuple(self._indexed_columns))

    @property
    def indexed_columns(self) -> List[str]:
        return list(self._indexed_columns)

    @property
    def included_columns(self) -> List[str]:
        return list(self._included_columns)

    @property
    def can_handle_deleted_files(self) -> bool:
        return self.lineage_enabled

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "type": self.kind,
            "kindAbbr": self.kind_abbr,
            "indexedColumns": self._indexed_columns,
            "includedColumns": self._included_columns,
            "schemaJson": self.schema_json,
            "targetBytesPerPartition": self.target_bytes_per_partition,
            "properties": dict(self.properties),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ZOrderCoveringIndex":
        return cls(
            d["indexedColumns"],
            d.get("includedColumns", []),
            d.get("schemaJson", ""),
            d.get("targetBytesPerPartition", 1 << 30),
            d.get("properties", {}),
        )

    # -- data plane ---------------------------------------------------------
    def write(self, ctx, index_data) -> None:
        """Z-sort + size-targeted split write
        (ZOrderCoveringIndex.write:97-154)."""
        write_zordered(
            ctx, index_data, self._indexed_columns, self.target_bytes_per_partition
        )

    def optimize(self, ctx, files_to_optimize: List[str]) -> None:
        from hyperspace_tpu_torch.indexes.covering_build import _stage_add
        from hyperspace_tpu_torch.io.columnar import ColumnarBatch

        ctx.session.build_stats.clear()
        t0 = _time.perf_counter()
        batch = ColumnarBatch.from_arrow(pio.read_table(files_to_optimize, None))
        _stage_add(ctx, "scan", t0)
        write_zordered(ctx, batch, self._indexed_columns, self.target_bytes_per_partition)

    def refresh_incremental(
        self, ctx, appended_df, deleted_source_file_ids, previous_content
    ) -> Tuple["ZOrderCoveringIndex", UpdateMode]:
        """Like the covering index, but the new data is z-sorted on its own
        (a merged global re-sort would be a full rebuild; the reference
        likewise z-sorts only the delta)."""
        from hyperspace_tpu_torch.indexes import covering_build

        ctx.session.build_stats.clear()
        config = covering_build._config_of(self, ZOrderCoveringIndexConfig)
        scans, mode = covering_build.refresh_scans(
            ctx, self, config, appended_df, deleted_source_file_ids, previous_content
        )
        if scans:
            write_zordered(
                ctx,
                covering_build.materialize(ctx, scans),
                self._indexed_columns,
                self.target_bytes_per_partition,
            )
        return self, mode

    def refresh_full(self, ctx, df) -> "ZOrderCoveringIndex":
        from hyperspace_tpu_torch.indexes import covering_build

        config = covering_build._config_of(self, ZOrderCoveringIndexConfig)
        covering, batch = covering_build.create_covering_index(
            ctx, df, config, dict(self.properties)
        )
        # create_covering_index builds a CoveringIndex; re-wrap with our kind
        rebuilt = ZOrderCoveringIndex(
            covering.indexed_columns,
            covering.included_columns,
            covering.schema_json,
            self.target_bytes_per_partition,
            dict(self.properties),
        )
        rebuilt.write(ctx, batch)
        return rebuilt

    def statistics(self, extended: bool = False) -> Dict[str, str]:
        return {
            "indexedColumns": ",".join(self._indexed_columns),
            "includedColumns": ",".join(self._included_columns),
            "targetBytesPerPartition": str(self.target_bytes_per_partition),
            "schema": self.schema_json if extended else "",
        }


def write_zordered(ctx, batch, indexed_cols: List[str], target_bytes: int) -> List[str]:
    """Global z-sort on the session's device, then the split into
    ceil(bytes / target_bytes) files of equal row counts
    (``_write_zordered`` of the reference, in-memory route)."""
    from hyperspace_tpu_torch.indexes.covering_build import _stage_add
    from hyperspace_tpu_torch.ops.sort import lexsort_permutation
    from hyperspace_tpu_torch.ops.zorder import ZOrderEncoder

    os.makedirs(ctx.index_data_path, exist_ok=True)
    if batch.num_rows == 0:
        return []
    conf = ctx.session.conf
    t0 = _time.perf_counter()
    encoder, encs = ZOrderEncoder.fit(
        [batch.column(c) for c in indexed_cols],
        Z_BITS,
        conf.zorder_quantile_enabled,
        conf.zorder_quantile_relative_error,
    )
    planes = encoder.planes_from_encodings(encs, ctx.device)
    if planes.is_cuda:
        torch.cuda.synchronize(planes.device)
    _stage_add(ctx, "z_address", t0)
    t0 = _time.perf_counter()
    perm = lexsort_permutation(planes).cpu().numpy()
    table = batch.take(perm).to_arrow()
    _stage_add(ctx, "sort", t0)
    t0 = _time.perf_counter()
    nbytes = max(table.nbytes, 1)
    num_parts = max(1, math.ceil(nbytes / target_bytes))
    rows_per_part = math.ceil(table.num_rows / num_parts)
    written = []
    for i in range(num_parts):
        chunk = table.slice(i * rows_per_part, rows_per_part)
        if chunk.num_rows == 0:
            continue
        path = os.path.join(ctx.index_data_path, f"part-{i:05d}-zorder.parquet")
        pio.write_table(path, chunk)
        written.append(path)
    _stage_add(ctx, "write", t0)
    return written


class ZOrderCoveringIndexConfig(IndexConfigTrait):
    """name + indexedColumns + includedColumns
    (ZOrderCoveringIndexConfig.scala)."""

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
        self._name = index_name
        self._indexed = list(indexed_columns)
        self._included = list(included_columns or [])

    def __repr__(self):
        return (
            f"ZOrderCoveringIndexConfig(indexName={self._name!r}, "
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

    def _index_from(self, ctx, covering, properties) -> ZOrderCoveringIndex:
        return ZOrderCoveringIndex(
            covering.indexed_columns,
            covering.included_columns,
            covering.schema_json,
            ctx.session.conf.zorder_target_source_bytes_per_partition,
            dict(properties),
        )

    def create_index(self, ctx, source_data, properties: Dict[str, str]):
        """(ZOrderCoveringIndex, index_data batch): the covering index's
        projection and lineage column under this kind."""
        from hyperspace_tpu_torch.indexes import covering_build

        covering, batch = covering_build.create_covering_index(
            ctx, source_data, self, properties
        )
        return self._index_from(ctx, covering, properties), batch

    def describe_index(self, ctx, source_data, properties: Dict[str, str]):
        from hyperspace_tpu_torch.indexes import covering_build

        covering = covering_build.describe_covering_index(
            ctx, source_data, self, properties
        )
        return self._index_from(ctx, covering, properties)
