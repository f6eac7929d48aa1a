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
rebuilds. A source past ``hyperspace.index.build.memoryBudgetBytes`` is
written in two passes over waves of its files
(``_write_zordered_streaming``): a stats pass freezes the encoder spec,
a spill pass writes each wave's rows into 64 z-ranges by B6's planes, and
each range is merged in ascending order (split deeper while it exceeds
the budget), so the device holds one wave, then one range. Stage wall
times (scan / z_address / sort / write; streamed: stats / spill / merge
with the counts waves, spill_files, ranges_merged and ranges_split) land
in ``session.build_stats``; z_address and sort include the transfers to
and from the device.
"""

from __future__ import annotations

import math
import os
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
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
        likewise z-sorts only the delta). The appended files and the
        previous data kept form one lazy input, materialized within the
        build memory budget and streamed past it."""
        from hyperspace_tpu_torch.indexes import covering_build

        ctx.session.build_stats.clear()
        config = covering_build._config_of(self, ZOrderCoveringIndexConfig)
        scans, mode = covering_build.refresh_scans(
            ctx, self, config, appended_df, deleted_source_file_ids, previous_content
        )
        if scans:
            combined = (
                scans[0] if len(scans) == 1 else covering_build.CompositeScan(tuple(scans))
            )
            write_zordered(
                ctx,
                covering_build.lazy_or_materialized(ctx, combined),
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


def _write_sorted(ctx, table, target_bytes: int, first_idx: int) -> List[str]:
    """Split a z-sorted table into ceil(bytes / target_bytes) files of
    equal row counts, ``part-{i:05d}-zorder.parquet`` from ``first_idx``."""
    num_parts = max(1, math.ceil(max(table.nbytes, 1) / target_bytes))
    rows_per_part = math.ceil(table.num_rows / num_parts)
    written = []
    for i in range(num_parts):
        chunk = table.slice(i * rows_per_part, rows_per_part)
        if chunk.num_rows == 0:
            continue
        path = os.path.join(
            ctx.index_data_path, f"part-{first_idx + len(written):05d}-zorder.parquet"
        )
        pio.write_table(path, chunk)
        written.append(path)
    return written


def write_zordered(ctx, data, indexed_cols: List[str], target_bytes: int) -> List[str]:
    """Global z-sort on the session's device, then the split into
    ceil(bytes / target_bytes) files of equal row counts
    (``_write_zordered`` of the reference). ``data`` is a ColumnarBatch, or
    past the build memory budget a lazy SourceScan / CompositeScan,
    written in two passes by :func:`_write_zordered_streaming`."""
    from hyperspace_tpu_torch.indexes.covering_build import (
        CompositeScan,
        SourceScan,
        _stage_add,
    )
    from hyperspace_tpu_torch.ops.sort import lexsort_permutation
    from hyperspace_tpu_torch.ops.zorder import ZOrderEncoder

    os.makedirs(ctx.index_data_path, exist_ok=True)
    if isinstance(data, (SourceScan, CompositeScan)):
        return _write_zordered_streaming(ctx, data, indexed_cols, target_bytes)
    batch = data
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
    written = _write_sorted(ctx, table, target_bytes, 0)
    _stage_add(ctx, "write", t0)
    return written


#: range-partition count of the streamed z-order spill: the top bits of the
#: most significant z-address plane (64 contiguous z-ranges; peak merge
#: memory about total / 64 for a balanced address space)
_ZORDER_SPILL_BITS = 6


def _frozen_encoder(ctx, scan, waves, indexed_cols: List[str]):
    """Pass 1 of the streamed z-order write: over a stats-only view of the
    waves, each column's global min/max of its order encodings (plus a
    stride sample a wave under quantile encoding), and for string columns
    the global dictionary union (wave-local ranks are not stable across
    waves), frozen into one ``ZOrderEncoder`` spec."""
    from hyperspace_tpu_torch.ops.zorder import ZOrderEncoder, order_u64_np

    conf = ctx.session.conf
    quantile = conf.zorder_quantile_enabled
    rel_err = conf.zorder_quantile_relative_error
    stats_scan = scan.stats_view(indexed_cols)
    k = len(indexed_cols)
    mins = [None] * k
    maxs = [None] * k
    samples: List[List] = [[] for _ in range(k)]
    dicts: List = [None] * k
    max_sample = max(int(1.0 / max(rel_err, 1e-4) ** 2), 1024)
    per_wave = max(max_sample // max(len(waves), 1), 64)
    for w in waves:
        b = stats_scan.materialize(w)
        for j, c in enumerate(indexed_cols):
            col = b.column(c)
            if col.kind == "string":
                if dicts[j] is None:
                    dicts[j] = set()
                dicts[j].update(col.dictionary)
                continue
            e = order_u64_np(col)
            if not len(e):
                continue
            lo, hi = e.min(), e.max()
            mins[j] = lo if mins[j] is None else min(mins[j], lo)
            maxs[j] = hi if maxs[j] is None else max(maxs[j], hi)
            if quantile:
                samples[j].append(e[:: max(1, len(e) // per_wave)])
    specs = []
    for j in range(k):
        if dicts[j] is not None:
            specs.append(("dict", sorted(dicts[j])))
        elif quantile:
            s = (
                np.sort(np.concatenate(samples[j]))
                if samples[j]
                else np.zeros(1, dtype=np.uint64)
            )
            specs.append(("quantile", s))
        else:
            specs.append(
                (
                    "range",
                    mins[j] if mins[j] is not None else np.uint64(0),
                    maxs[j] if maxs[j] is not None else np.uint64(0),
                )
            )
    return ZOrderEncoder(Z_BITS, specs)


def _write_zordered_streaming(
    ctx, scan, indexed_cols: List[str], target_bytes: int
) -> List[str]:
    """The out-of-core z-order write (reference ``zorder.py:240-...``), two
    passes over the waves:

    1. **Stats** (:func:`_frozen_encoder`): the frozen encoder spec, so
       z-addresses are the same in every later step and a range's local
       order is the global order.
    2. **Spill**: per wave, the z-address planes under the frozen spec
       (B6 on the device, brought to the host once), the rows spilled into
       2^6 contiguous z-ranges by the top bits of plane 0 (the streamed
       ``repartitionByRange`` on ``_zaddr``,
       ZOrderCoveringIndex.scala:139-153).
    3. **Merge**: per range, ascending, its parts re-encoded and
       lexsorted on the device, written as size-targeted files; a range
       past the budget splits on its next 6 z-address bits, down plane 0,
       then every deeper plane, and when every bit is spent (all rows one
       z-address) each part is sorted and written alone.

    The spill directory is removed whatever happens."""
    import shutil

    from hyperspace_tpu_torch.indexes.covering_build import (
        _stage_add,
        estimated_materialized_bytes,
        plan_waves,
        spill_root_for,
    )
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops.sort import lexsort_permutation
    from hyperspace_tpu_torch.ops.zorder import planes_to_numpy

    budget = ctx.session.conf.build_memory_budget or (1 << 62)
    stats = ctx.session.build_stats
    waves = plan_waves(scan.files, scan.fmt, budget, scan.file_sizes)
    t0 = _time.perf_counter()
    encoder = _frozen_encoder(ctx, scan, waves, indexed_cols)
    _stage_add(ctx, "stats", t0)
    stats["waves"] = len(waves)

    def host_planes(batch) -> np.ndarray:
        planes = encoder.planes([batch.column(c) for c in indexed_cols], ctx.device)
        return planes_to_numpy(planes)

    spill_root = spill_root_for(ctx.index_data_path, "z_")
    os.makedirs(spill_root, exist_ok=True)
    range_parts: dict = {}
    counts = {"spill_files": 0, "ranges_merged": 0, "ranges_split": 0}
    try:
        t0 = _time.perf_counter()
        for wi, w in enumerate(waves):
            batch = scan.materialize(w)
            if batch.num_rows == 0:
                continue
            pid = (host_planes(batch)[0] >> np.uint32(32 - _ZORDER_SPILL_BITS)).astype(np.int32)
            table = batch.to_arrow()
            del batch
            for p, idx in pio.bucket_runs(pid):
                path = os.path.join(spill_root, f"r{p:03d}-w{wi:05d}.parquet")
                pio.write_table(path, table.take(pa.array(idx)))
                range_parts.setdefault(p, []).append(path)
                counts["spill_files"] += 1
        _stage_add(ctx, "spill", t0)

        total_bits = len(indexed_cols) * encoder.bits
        n_planes = max(1, (total_bits + 31) // 32)

        def plane_floor(plane_idx):
            """Lowest meaningful bit of a plane: the last plane's tail below
            32 - (total_bits mod 32) is zero padding, which discriminates
            nothing."""
            if plane_idx == n_planes - 1:
                return 32 - (total_bits - 32 * (n_planes - 1))
            return 0

        written: List[str] = []

        def sort_and_write(batch) -> None:
            perm = lexsort_permutation(
                encoder.planes([batch.column(c) for c in indexed_cols], ctx.device)
            ).cpu().numpy()
            written.extend(
                _write_sorted(ctx, batch.take(perm).to_arrow(), target_bytes, len(written))
            )

        def next_window(plane_idx, shift):
            """The split window after (plane_idx, shift): down the current
            plane (the last window clamped to the plane's floor), then the
            next plane."""
            floor = plane_floor(plane_idx)
            if shift > floor:
                return plane_idx, max(shift - _ZORDER_SPILL_BITS, floor)
            nxt = plane_idx + 1
            return nxt, max(
                32 - _ZORDER_SPILL_BITS, plane_floor(nxt) if nxt < n_planes else 0
            )

        def merge_parts(parts, plane_idx, shift):
            est = estimated_materialized_bytes(parts, "parquet")
            if est <= budget or plane_idx >= n_planes:
                counts["ranges_merged"] += 1
                if plane_idx >= n_planes and est > budget:
                    # every z-address bit is spent: the rows share one
                    # complete z-address, whose relative order is arbitrary
                    for part in parts:
                        sort_and_write(ColumnarBatch.from_arrow(pio.read_table([part], None)))
                    return
                sort_and_write(ColumnarBatch.from_arrow(pio.read_table(parts, None)))
                return
            counts["ranges_split"] += 1
            sub_parts: dict = {}
            nxt = next_window(plane_idx, shift)
            for part in parts:
                b = ColumnarBatch.from_arrow(pio.read_table([part], None))
                plane = host_planes(b)[plane_idx]
                sub = ((plane >> np.uint32(shift))
                       & np.uint32((1 << _ZORDER_SPILL_BITS) - 1)).astype(np.int32)
                table = b.to_arrow()
                for sp, idx in pio.bucket_runs(sub):
                    path = part + f".s{sp:03d}"
                    pio.write_table(path, table.take(pa.array(idx)))
                    sub_parts.setdefault(sp, []).append(path)
            for sp in sorted(sub_parts):
                merge_parts(sub_parts[sp], *nxt)

        t0 = _time.perf_counter()
        for p in sorted(range_parts):
            merge_parts(range_parts[p], 0, 32 - 2 * _ZORDER_SPILL_BITS)
        _stage_add(ctx, "merge", t0)
        stats.update(counts)
        return written
    finally:
        shutil.rmtree(spill_root, ignore_errors=True)


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
