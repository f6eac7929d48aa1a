"""Data-skipping index — a sketch table of one row a source file.

Counterpart of ``hyperspace_tpu/indexes/dataskipping.py`` (reference:
``dataskipping/DataSkippingIndex.scala:44-336``): the build
(``createIndexData:291-317``) sketches each source file; at query time
(``translateFilterCondition:143-185``) the filter predicate becomes a
keep-mask over the sketch table's rows, which prunes source files. Unlike
the covering kinds, the rewritten plan still scans the SOURCE, only fewer
files (``DataSkippingFileIndex.scala:32-74``).

The sketches run on the session's device (the Bloom filter sketch
through kernel B7). The sketch table is written as the reference writes
it, byte for byte. An incremental refresh sketches only the appended
files (a deleted file's row is dropped, no lineage needed), a full
refresh sketches every file again, optimize rewrites the listed tables
as one.
"""

from __future__ import annotations

import json
import os
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from hyperspace_tpu_torch.constants import DATA_FILE_NAME_ID
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.base import Index, IndexConfigTrait, UpdateMode
from hyperspace_tpu_torch.indexes.registry import register_index
from hyperspace_tpu_torch.indexes.sketches import Sketch, sketch_from_dict
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.io.columnar import ColumnarBatch
from hyperspace_tpu_torch.plan import expressions as E

#: the sketch table's one file in an index version directory
SKETCH_FILE_NAME = "part-00000-sketch.parquet"


@register_index
class DataSkippingIndex(Index):
    kind = "DataSkippingIndex"
    kind_abbr = "DS"

    def __init__(
        self,
        sketches: List[Sketch],
        schema_json: str = "",
        properties: Optional[Dict[str, str]] = None,
    ):
        self.sketches = list(sketches)
        self.schema_json = schema_json
        self.properties: Dict[str, str] = dict(properties or {})

    def __eq__(self, other):
        return isinstance(other, DataSkippingIndex) and [
            s.to_dict() for s in self.sketches
        ] == [s.to_dict() for s in other.sketches]

    def __hash__(self):
        return hash(tuple(s.kind + s.column for s in self.sketches))

    # -- schema surface -----------------------------------------------------
    @property
    def indexed_columns(self) -> List[str]:
        seen = []
        for s in self.sketches:
            for c in s.referenced_columns():
                if c not in seen:
                    seen.append(c)
        return seen

    @property
    def included_columns(self) -> List[str]:
        return []

    @property
    def can_handle_deleted_files(self) -> bool:
        # one sketch row a file: a deletion drops rows (no lineage needed)
        return True

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "type": self.kind,
            "kindAbbr": self.kind_abbr,
            "sketches": [s.to_dict() for s in self.sketches],
            "schemaJson": self.schema_json,
            "properties": dict(self.properties),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DataSkippingIndex":
        return cls(
            [sketch_from_dict(s) for s in d["sketches"]],
            d.get("schemaJson", ""),
            d.get("properties", {}),
        )

    # -- build --------------------------------------------------------------
    def build_sketch_rows(self, ctx, plan_relation) -> pa.Table:
        """One sketch row a source file (createIndexData:291-317), the
        files in sorted order. File ids are keyed by the provider's (path,
        size, mtime) view so they match the ids recorded in the log
        entry's source content. Stage seconds: ``sketch_read`` (the
        files' indexed columns) and ``sketch`` (the sketches, device work
        included) in ``session.build_stats``."""
        from hyperspace_tpu_torch.indexes.covering_build import (
            _stage_add,
            source_file_infos,
        )

        fmt = plan_relation.fmt
        cols = self.indexed_columns
        fields: List[Tuple[str, pa.DataType]] = [(DATA_FILE_NAME_ID, pa.int64())]
        rows: List[Dict] = []
        out_fields = None
        for f, size, mtime in sorted(source_file_infos(ctx.session, plan_relation)):
            fid = ctx.file_id_tracker.add_file(f, size, mtime)
            t0 = _time.perf_counter()
            batch = ColumnarBatch.from_arrow(pio.read_table([f], cols, fmt))
            _stage_add(ctx, "sketch_read", t0)
            t0 = _time.perf_counter()
            row = {DATA_FILE_NAME_ID: fid}
            if out_fields is None:
                out_fields = list(fields)
                for s in self.sketches:
                    src_t = batch.column(s.referenced_columns()[0]).arrow_type
                    out_fields.extend(s.output_fields(src_t))
            for s in self.sketches:
                row.update(s.aggregate(batch, ctx.device))
            rows.append(row)
            _stage_add(ctx, "sketch", t0)
        if out_fields is None:
            raise HyperspaceException("No source files to sketch")
        return pa.table(
            {name: pa.array([r.get(name) for r in rows], type=t) for name, t in out_fields}
        )

    def write(self, ctx, index_data: pa.Table) -> None:
        os.makedirs(ctx.index_data_path, exist_ok=True)
        pio.write_table(os.path.join(ctx.index_data_path, SKETCH_FILE_NAME), index_data)

    def optimize(self, ctx, files_to_optimize: List[str]) -> None:
        self.write(ctx, pio.read_table(files_to_optimize, None))

    def refresh_incremental(
        self, ctx, appended_df, deleted_source_file_ids, previous_content
    ) -> Tuple["DataSkippingIndex", UpdateMode]:
        """The appended files' sketch rows (MERGE), or, when source files
        were deleted, the previous sketch rows without theirs followed by
        the appended ones (OVERWRITE)."""
        ctx.session.build_stats.clear()
        parts = []
        if appended_df is not None:
            rel = appended_df.logical_plan.collect_leaves()[0].relation
            parts.append(self.build_sketch_rows(ctx, rel))
        if deleted_source_file_ids:
            old = pio.read_table(list(previous_content.files), None)
            ids = np.asarray(old.column(DATA_FILE_NAME_ID))
            keep = ~np.isin(ids, np.array(deleted_source_file_ids, dtype=np.int64))
            parts.append(old.filter(pa.array(keep)))
            mode = UpdateMode.OVERWRITE
        else:
            mode = UpdateMode.MERGE
        if parts:
            self.write(ctx, pa.concat_tables(parts, promote_options="permissive"))
        return self, mode

    def refresh_full(self, ctx, df) -> "DataSkippingIndex":
        ctx.session.build_stats.clear()
        rel = df.logical_plan.collect_leaves()[0].relation
        self.write(ctx, self.build_sketch_rows(ctx, rel))
        return self

    # -- query-time translation (translateFilterCondition:143-185) ----------
    def translate_filter(
        self, condition: E.Expr, sketch_table: pa.Table, device
    ) -> Optional[np.ndarray]:
        """Keep-mask over sketch rows, or None when nothing translates;
        the sketches' device work runs on ``device``."""

        def walk(expr) -> Optional[np.ndarray]:
            if isinstance(expr, E.And):
                l, r = walk(expr.left), walk(expr.right)
                if l is not None and r is not None:
                    return l & r
                return l if l is not None else r
            if isinstance(expr, E.Or):
                l, r = walk(expr.left), walk(expr.right)
                if l is not None and r is not None:
                    return l | r
                return None  # OR prunes only if BOTH sides translate
            for s in self.sketches:
                m = s.convert_predicate(expr, sketch_table, device)
                if m is not None:
                    return m
            return None

        return walk(condition)

    def statistics(self, extended: bool = False) -> Dict[str, str]:
        return {
            "sketches": ";".join(repr(s) for s in self.sketches),
            "indexedColumns": ",".join(self.indexed_columns),
            "schema": self.schema_json if extended else "",
        }


class DataSkippingIndexConfig(IndexConfigTrait):
    """name + sketches (DataSkippingIndexConfig.scala:39-95); a
    PartitionSketch is implicit in the build since constancy is detected
    per file (``:72-84`` auto-adds it for partitioned sources)."""

    def __init__(self, index_name: str, *sketches: Sketch):
        if not index_name:
            raise HyperspaceException("Index name cannot be empty")
        if not sketches:
            raise HyperspaceException("At least one sketch is required")
        cols = [s.referenced_columns()[0].lower() + s.kind for s in sketches]
        if len(set(cols)) != len(cols):
            raise HyperspaceException("Duplicate sketches")
        self._name = index_name
        self._sketches = list(sketches)

    @property
    def index_name(self) -> str:
        return self._name

    @property
    def referenced_columns(self) -> List[str]:
        out = []
        for s in self._sketches:
            for c in s.referenced_columns():
                if c not in out:
                    out.append(c)
        return out

    def _mk_index(self, source_data, properties) -> DataSkippingIndex:
        from hyperspace_tpu_torch.utils import resolver

        rel = source_data.logical_plan.collect_leaves()[0].relation
        schema = rel.schema
        resolved_sketches = []
        for s in self._sketches:
            rc = resolver.require_resolve(s.referenced_columns(), rel.column_names)[0]
            d = s.to_dict()
            d["column"] = rc.name
            d["sourceType"] = str(schema[rc.name])
            resolved_sketches.append(sketch_from_dict(d))
        schema_json = json.dumps([[c, str(schema[c])] for c in self.referenced_columns])
        return DataSkippingIndex(resolved_sketches, schema_json, dict(properties))

    def create_index(self, ctx, source_data, properties: Dict[str, str]):
        ctx.session.build_stats.clear()
        index = self._mk_index(source_data, properties)
        rel = source_data.logical_plan.collect_leaves()[0].relation
        return index, index.build_sketch_rows(ctx, rel)

    def describe_index(self, ctx, source_data, properties: Dict[str, str]):
        return self._mk_index(source_data, properties)
