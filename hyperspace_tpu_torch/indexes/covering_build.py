"""Covering-index build pipeline, single device.

Counterpart of ``hyperspace_tpu/indexes/covering_build.py`` (reference:
``CoveringIndex.createIndexData:140-192`` + ``write:56-71``):

    host scan (arrow, per source file)  →  SoA batch w/ lineage column
      →  key reps to the session's device
      →  murmur3 bucket ids                       [ops/hash, kernel B1]
      →  stable sort by (bucket, keys)            [ops/sort, torch.sort]
      →  permutation and bucket offsets back to the host
      →  one parquet file per bucket under the new v__=N dir, written
         bucket by bucket on one writer thread

The last two steps are the reference's pipelined partition-first tail
(``hyperspace.index.build.partitionFirst``, default on,
``_write_bucketed_pipelined``); with the key off the legacy route runs
(``bucketize`` gathers the whole sorted batch, then
``write_bucket_files``). The bucket files are byte-identical to the
reference's on either route: the same rows in the same order, written
with the same encoding decision (computed once on the pre-sort input).
The reference's mesh exchange and streaming waves under a memory budget
are not ported yet (ROADMAP queue A items A.9 and A.8).

Optimize and refresh (CoveringIndexTrait:32-135) run the same tail: an
incremental refresh hashes and sorts the appended source files' rows, or,
when source files were deleted, the previous index data minus the rows
whose lineage id is among the deleted (``SourceScan.excluded_lineage_ids``)
together with the appended rows; a full refresh rebuilds from the source;
optimize rewrites the listed index files. Every input is materialized
whole (the reference streams it beyond its memory budget, A.8).

Stage wall times of the latest build (scan / hash_shuffle / sort / write)
land in ``session.build_stats``; the hash and sort stages include the
transfers to and from the device.
"""

from __future__ import annotations

import dataclasses
import json
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.constants import DATA_FILE_NAME_ID, LINEAGE_PROPERTY
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.base import UpdateMode
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.ops.hash import bucket_ids
from hyperspace_tpu_torch.ops.sort import bucket_sort_runs, partitioned_sort_permutation
from hyperspace_tpu_torch.utils import resolver


def _stage_add(ctx, name: str, t0: float) -> None:
    stats = ctx.session.build_stats
    stats[name] = stats.get(name, 0.0) + _time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Scan side: build index data from source files
# ---------------------------------------------------------------------------


def _scan_with_lineage(
    files: Sequence[str],
    fmt: str,
    columns: List[str],
    file_ids: Optional[Dict[str, int]],
) -> ColumnarBatch:
    """Read the projection from each source file; attach `_data_file_id`
    when lineage is on (CoveringIndex.createIndexData:177-186)."""
    batches = []
    for f in files:
        t = pio.read_table([f], columns, fmt)
        b = ColumnarBatch.from_arrow(t)
        if file_ids is not None:
            fid = np.full(b.num_rows, file_ids[f], dtype=np.int64)
            b = b.with_column(
                DATA_FILE_NAME_ID, Column("numeric", pa.int64(), values=fid)
            )
        batches.append(b)
    if not batches:
        raise HyperspaceException("No source files to index")
    return ColumnarBatch.concat(batches)


@dataclasses.dataclass
class SourceScan:
    """What the build reads: source files, projection and lineage ids."""

    files: Tuple[str, ...]
    fmt: str
    columns: Tuple[str, ...]  # projection to read
    file_ids: Optional[Dict[str, int]]  # lineage ids (None = lineage off)
    select_cols: Optional[Tuple[str, ...]] = None  # output column order
    # rows whose stored lineage id is listed are dropped at materialize
    # time: a refresh's delete compensation over previous index data
    excluded_lineage_ids: Optional[Tuple[int, ...]] = None

    def materialize(self) -> ColumnarBatch:
        batch = _scan_with_lineage(
            self.files, self.fmt, list(self.columns), self.file_ids
        )
        if self.excluded_lineage_ids:
            lineage = batch.column(DATA_FILE_NAME_ID).values
            keep = ~np.isin(
                lineage, np.array(self.excluded_lineage_ids, dtype=np.int64)
            )
            batch = batch.filter(keep)
        if self.select_cols is not None:
            batch = batch.select(list(self.select_cols))
        return batch

    def select(self, cols: Sequence[str]) -> "SourceScan":
        return dataclasses.replace(self, select_cols=tuple(cols))


def materialize(ctx, scans: Sequence[SourceScan]) -> ColumnarBatch:
    """The scans' rows as one batch, in order, their read timed as the
    build stage ``scan``: the materialized branch of the reference's
    ``lazy_or_materialized`` (covering_build.py:466; its streamed branch
    past the build memory budget is A.8)."""
    t0 = _time.perf_counter()
    parts = [s.materialize() for s in scans]
    out = parts[0] if len(parts) == 1 else ColumnarBatch.concat(parts)
    _stage_add(ctx, "scan", t0)
    return out


def previous_index_scan(
    previous_content, schema_cols: Sequence[str], deleted_source_file_ids
) -> SourceScan:
    """Scan of a previous index version's data files minus the rows of the
    deleted source files (the refresh's delete compensation input)."""
    return SourceScan(
        files=tuple(previous_content.files),
        fmt="parquet",
        columns=tuple(schema_cols),
        file_ids=None,
        select_cols=tuple(schema_cols),
        excluded_lineage_ids=tuple(deleted_source_file_ids),
    )


def resolve_index_schema(rel, config, properties: Dict[str, str]):
    """(indexed, included, lineage, schema_json) — shared by data-building
    ``prepare_covering_index`` and data-free ``describe_covering_index``
    so the begin-phase and final log entries can never diverge."""
    nested = resolver.nested_available_from(rel.column_names)
    indexed = [
        rc.normalized_name
        for rc in resolver.require_resolve(
            config.indexed_columns, rel.column_names, nested_available=nested
        )
    ]
    included = [
        rc.normalized_name
        for rc in resolver.require_resolve(
            config.included_columns, rel.column_names, nested_available=nested
        )
    ]
    lineage = str(properties.get(LINEAGE_PROPERTY, "false")).lower() == "true"
    schema = rel.schema
    schema_json = json.dumps(
        [[c, str(schema[c])] for c in indexed + included]
        + ([[DATA_FILE_NAME_ID, "int64"]] if lineage else [])
    )
    return indexed, included, lineage, schema_json


def describe_covering_index(ctx, source_df, config, properties: Dict[str, str]):
    """CoveringIndex object without scanning data (begin-phase log entry)."""
    from hyperspace_tpu_torch.indexes.covering import CoveringIndex

    rel = _single_relation(source_df)
    indexed, included, _lineage, schema_json = resolve_index_schema(
        rel, config, properties
    )
    return CoveringIndex(
        indexed, included, schema_json, ctx.session.conf.num_buckets,
        dict(properties),
    )


def _single_relation(source_df):
    leaves = source_df.logical_plan.collect_leaves()
    if len(leaves) != 1:
        raise HyperspaceException(
            f"Index source must have exactly one relation; got {len(leaves)}"
        )
    return leaves[0].relation


def prepare_covering_index(ctx, source_df, config, properties: Dict[str, str]):
    """(CoveringIndex, SourceScan) — column resolution and lineage-id
    registration, with no row read yet."""
    from hyperspace_tpu_torch.indexes.covering import CoveringIndex

    ctx.session.build_stats.clear()
    rel = _single_relation(source_df)
    indexed, included, lineage, schema_json = resolve_index_schema(
        rel, config, properties
    )
    file_ids = None
    if lineage:
        # key file ids by the provider's (path, size, mtime) view — the
        # same keys create_metadata_relation records
        file_ids = {}
        for path, size, mtime in source_file_infos(ctx.session, rel):
            file_ids[path] = ctx.file_id_tracker.add_file(path, size, mtime)
    index = CoveringIndex(
        indexed_columns=indexed,
        included_columns=included,
        schema_json=schema_json,
        num_buckets=ctx.session.conf.num_buckets,
        properties=dict(properties),
    )
    scan = SourceScan(
        files=tuple(rel.files),
        fmt=rel.fmt,
        columns=tuple(indexed + included),
        file_ids=file_ids,
    )
    return index, scan


def create_covering_index(ctx, source_df, config, properties: Dict[str, str]):
    """(CoveringIndex, index_data batch) — the reference's
    ``CoveringIndexConfig.createIndex:43-61``."""
    index, scan = prepare_covering_index(ctx, source_df, config, properties)
    return index, materialize(ctx, [scan])


def source_file_infos(session, plan_relation) -> List[Tuple[str, int, int]]:
    """(path, size, mtime) via the source provider SPI — restricted to the
    plan relation's current file subset."""
    provider_rel = session.source_manager.get_relation(plan_relation)
    subset = set(plan_relation.files)
    return [
        (p, size, mtime)
        for p, size, mtime in provider_rel.all_file_infos()
        if p in subset
    ]


# ---------------------------------------------------------------------------
# Hash + sort + bucketed write
# ---------------------------------------------------------------------------


def _hash_shuffle(
    ctx, batch: ColumnarBatch, indexed_cols: List[str], num_buckets: int
):
    """Bucket-id half of the pipeline: the key reps go to the session's
    device and kernel B1 computes murmur3 bucket ids there. Returns
    ``(buckets, reps)`` as device tensors, in the batch's row order (the
    reference's mesh exchange is not ported: one device holds every
    row)."""
    t0 = _time.perf_counter()
    reps = torch.from_numpy(batch.key_reps(indexed_cols)).to(ctx.device)
    buckets = bucket_ids(reps, num_buckets)
    if buckets.is_cuda:
        torch.cuda.synchronize(buckets.device)
    _stage_add(ctx, "hash_shuffle", t0)
    return buckets, reps


def bucketize(ctx, batch: ColumnarBatch, indexed_cols: List[str], num_buckets: int):
    """Route rows to buckets -> (bucket_ids, batch) in bucket-grouped,
    key-sorted order. The permutation is the reference's stable sort by
    (bucket, keys...), computed on the session's device."""
    buckets, reps = _hash_shuffle(ctx, batch, indexed_cols, num_buckets)
    t0 = _time.perf_counter()
    perm = partitioned_sort_permutation(reps, buckets, num_buckets)
    sorted_buckets = buckets[perm].cpu().numpy()
    perm = perm.cpu().numpy()
    out = sorted_buckets, batch.take(perm)
    _stage_add(ctx, "sort", t0)
    return out


def write_bucketed(
    ctx,
    batch: ColumnarBatch,
    indexed_cols: List[str],
    num_buckets: int,
    file_idx_offset: int = 0,
) -> List[str]:
    """The build pipeline tail: hash, sort-within-bucket, write one parquet
    per bucket (CoveringIndex.write:56-71 + saveWithBuckets), through the
    pipelined partition-first writer unless
    ``hyperspace.index.build.partitionFirst`` is off.

    The parquet dictionary-encoding decision is computed ONCE, on the
    pre-sort input, as the reference does, so the two routes write the
    same bytes."""
    import os

    if batch.num_rows == 0:
        os.makedirs(ctx.index_data_path, exist_ok=True)
        return []
    use_dict = pio.dictionary_columns_for_batch(batch)
    if ctx.session.conf.build_partition_first:
        return _write_bucketed_pipelined(
            ctx, batch, indexed_cols, num_buckets, file_idx_offset, use_dict
        )
    buckets, batch = bucketize(ctx, batch, indexed_cols, num_buckets)
    t0 = _time.perf_counter()
    out = pio.write_bucket_files(
        ctx.index_data_path,
        buckets,
        batch,
        num_buckets,
        file_idx_offset,
        use_dictionary=use_dict,
    )
    _stage_add(ctx, "write", t0)
    return out


def _write_bucketed_pipelined(
    ctx,
    batch: ColumnarBatch,
    indexed_cols: List[str],
    num_buckets: int,
    file_idx_offset: int,
    use_dict,
) -> List[str]:
    """Partition-first, pipelined tail of an in-memory build (reference
    ``covering_build.py:787-864``): the card hashes (B1) and sorts (B2)
    every row, the permutation and the bucket offsets come back in one
    copy (``ops/sort.bucket_sort_runs``), and each bucket's run goes to
    one writer thread as soon as it is known, the file written from the
    pre-sort table through the run's indices. No sorted copy of the
    whole batch is built. Every bucket is submitted before the drain, so
    a write that dies in raise mode (``mid_data_write``) still lets the
    buckets queued behind it land, as in the reference.

    Stages as the reference records them: ``sort`` spans the sort, the
    copy and the submissions (and the writes that overlap them);
    ``write`` is only the drain after the last submission."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    buckets, reps = _hash_shuffle(ctx, batch, indexed_cols, num_buckets)
    os.makedirs(ctx.index_data_path, exist_ok=True)
    t0 = _time.perf_counter()
    perm, offsets = bucket_sort_runs(reps, buckets, num_buckets)
    table = batch.to_arrow()
    written: List[str] = []
    with ThreadPoolExecutor(max_workers=1) as writer:
        futures = [
            writer.submit(
                pio.write_bucket_file,
                ctx.index_data_path,
                b,
                file_idx_offset,
                table,
                perm[offsets[b] : offsets[b + 1]],
                use_dict,
            )
            for b in range(num_buckets)
            if offsets[b + 1] > offsets[b]
        ]
        _stage_add(ctx, "sort", t0)
        t0 = _time.perf_counter()
        for f in futures:
            written.append(f.result())
    _stage_add(ctx, "write", t0)
    return written


# ---------------------------------------------------------------------------
# Optimize / refresh data plane (CoveringIndexTrait:57-134)
# ---------------------------------------------------------------------------


def rewrite_files(
    ctx, files_to_optimize: List[str], indexed_cols: List[str], num_buckets: int
) -> List[str]:
    """Optimize: read the listed index files and rewrite them compacted
    (CoveringIndexTrait.optimize:130-134, 'read files, then write')."""
    ctx.session.build_stats.clear()
    t0 = _time.perf_counter()
    batch = ColumnarBatch.from_arrow(pio.read_table(files_to_optimize, None))
    _stage_add(ctx, "scan", t0)
    return write_bucketed(ctx, batch, indexed_cols, num_buckets)


def refresh_scans(
    ctx, index, config, appended_df, deleted_source_file_ids, previous_content
):
    """The inputs of an incremental refresh of a covering-family index, as
    scans of the index's columns (lineage last): the appended source files
    resolved through ``config`` (their lineage ids registered in
    ``ctx.file_id_tracker``) and, when
    source files were deleted, the previous index data minus their rows.
    Returns ``(scans, UpdateMode)``."""
    schema_cols = list(index.indexed_columns) + list(index.included_columns)
    if index.lineage_enabled:
        schema_cols.append(DATA_FILE_NAME_ID)
    scans = []
    if appended_df is not None:
        _covering, scan = prepare_covering_index(
            ctx, appended_df, config, dict(index.properties)
        )
        scans.append(scan.select(schema_cols))
    if deleted_source_file_ids:
        if not index.lineage_enabled:
            raise HyperspaceException(
                "Cannot handle deleted source files without lineage"
            )
        scans.append(
            previous_index_scan(previous_content, schema_cols, deleted_source_file_ids)
        )
        return scans, UpdateMode.OVERWRITE
    return scans, UpdateMode.MERGE


def refresh_incremental(
    ctx, index, appended_df, deleted_source_file_ids: List[int], previous_content
):
    """CoveringIndexTrait.refreshIncremental:57-106: the appended source
    files' rows, and for deleted source files the previous index data
    minus their lineage ids, hashed, sorted and written into the new
    version dir. Returns ``(index, UpdateMode.MERGE | OVERWRITE)``."""
    ctx.session.build_stats.clear()
    scans, mode = refresh_scans(
        ctx, index, _config_of(index), appended_df, deleted_source_file_ids,
        previous_content,
    )
    if scans:
        batch = materialize(ctx, scans)
        write_bucketed(ctx, batch, index.indexed_columns, index.num_buckets)
    return index, mode


def refresh_full(ctx, index, df):
    """Rebuild the whole index from the current source
    (CoveringIndexTrait.refreshFull:108-126). Returns the REBUILT index:
    its schema_json reflects the current source types, which may have
    changed since the original build."""
    new_index, batch = create_covering_index(
        ctx, df, _config_of(index), dict(index.properties)
    )
    write_bucketed(ctx, batch, new_index.indexed_columns, new_index.num_buckets)
    return new_index


def _config_of(index, config_cls=None):
    """The config a refresh of ``index`` builds through: ``config_cls``
    (CoveringIndexConfig by default) over its columns."""
    if config_cls is None:
        from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as config_cls

    return config_cls("__refresh__", index.indexed_columns, index.included_columns)
