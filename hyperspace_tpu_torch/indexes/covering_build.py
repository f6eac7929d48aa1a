"""Covering-index build pipeline over the session's shard mesh.

Counterpart of ``hyperspace_tpu/indexes/covering_build.py`` (reference:
``CoveringIndex.createIndexData:140-192`` + ``write:56-71``):

    host scan (arrow, per source file)  →  SoA batch w/ lineage column
      →  key reps to the session's device
      →  murmur3 bucket ids                       [ops/hash, kernel B1]
      →  on a mesh of D > 1 shards, the bucket exchange: every row to the
         shard that owns its bucket (bucket % D)  [parallel/shuffle,
                                                   kernels B1, B8a, B8b]
      →  stable sort by (bucket, keys)            [ops/sort, torch.sort],
         each shard's slice on its own device (the sharded tail)
      →  permutation and bucket offsets back to the host
      →  one parquet file per bucket under the new v__=N dir, written
         bucket by bucket on one writer thread (a shard)

The last two steps are the reference's pipelined partition-first tail
(``hyperspace.index.build.partitionFirst``, default on,
``_write_bucketed_pipelined``); with the key off the legacy route runs
(``bucketize`` gathers the whole sorted batch, then
``write_bucket_files``). The bucket files are byte-identical to the
reference's on either route and at any shard count: a bucket lives
wholly on one shard, its rows arrive in original row order, and the
stable key sort restricted to it is the same; the encoding decision is
computed once on the pre-sort input. With ``hyperspace.build.
shardedTail.enabled`` (default on) each shard's slice sorts and writes
concurrently with the others (``_write_bucketed_sharded``); off, one tail
takes the whole exchanged batch.

A source whose estimated materialized size (parquet footers) exceeds
``hyperspace.index.build.memoryBudgetBytes`` is never read whole:
``create_covering_index`` hands back a lazy :class:`SourceScan` and
``_write_bucketed_streaming`` reads it in waves within the budget, hashes
and sorts each wave on the device, spills each bucket's run to disk and
at the end merges each bucket's runs with a key sort on the device, so the
device holds one wave, then one bucket. The files are the reference's
streamed ones byte for byte. On a mesh each wave is exchanged, and the
merges of different shards' buckets run concurrently when the largest
buckets fit the budget together.

On a job of several processes (``parallel/mesh.initialize_distributed``)
each process scans its stripe of the source files (``files[p::P]``,
``SourceScan.process_local``), the exchange moves rows to the process
that owns their bucket (the two-stage strategy over
``torch.distributed``), each process writes its own buckets and a
barrier (``_global_written``) hands every process the same file list.
A zero-row stripe still takes part in every collective.

Optimize and refresh (CoveringIndexTrait:32-135) run the same tail: an
incremental refresh hashes and sorts the appended source files' rows, or,
when source files were deleted, the previous index data minus the rows
whose lineage id is among the deleted (``SourceScan.excluded_lineage_ids``)
together with the appended rows, each side streamed past the budget; a
full refresh rebuilds from the source; optimize rewrites the listed index
files.

Stage wall times of the latest build (scan / hash_shuffle / sort / write,
and under a budget spill / merge with the counts waves / spill_files; on
the sharded tail tail_wall and tail_shards, its sort and write summing
each shard's busy time) land in ``session.build_stats``; the hash and
sort stages include the transfers to and from the device. The exchange's
telemetry (``shuffle_<key>`` of ``parallel/shuffle.last_shuffle_stats``,
its stage seconds summed over waves, the skew's max and mean over waves)
lands in ``session.build_telemetry``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.constants import (
    DATA_FILE_NAME_ID,
    INDEX_FILE_PREFIX,
    LINEAGE_PROPERTY,
)
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.base import UpdateMode
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.obs import trace as _obs_trace
from hyperspace_tpu_torch.ops.hash import bucket_ids
from hyperspace_tpu_torch.ops.sort import (
    bucket_sort_runs,
    partitioned_sort_permutation,
    shard_tail_plan,
    sort_permutation,
)
from hyperspace_tpu_torch.parallel import mesh as _mesh
from hyperspace_tpu_torch.parallel import shuffle as _shuffle
from hyperspace_tpu_torch.utils import resolver

# the shard tails add their stage seconds from several threads
_stats_lock = threading.Lock()


def _stage_add(ctx, name: str, t0: float) -> None:
    """Add ``[t0, now]`` to a build stage of ``session.build_stats`` and,
    under an active trace, record a stage span of exactly those seconds
    (the one build stage hook)."""
    dt = _time.perf_counter() - t0
    with _stats_lock:
        stats = ctx.session.build_stats
        stats[name] = stats.get(name, 0.0) + dt
    _obs_trace.stage(name, t0, seconds=dt)


def reset_build_stats(ctx) -> None:
    """A data operation's fresh start: empty stage seconds and exchange
    telemetry, and the exchange's once-a-build skew warning rearmed."""
    _shuffle.reset_skew_warning()
    with _stats_lock:
        ctx.session.build_stats.clear()
        ctx.session.build_telemetry.clear()


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
    """Lazy build-side input: what to read, not the rows themselves.

    Past ``hyperspace.index.build.memoryBudgetBytes`` the build keeps this
    descriptor and ``write_bucketed`` reads it in waves instead of
    materializing one batch (the role Spark's disk-backed shuffle plays
    for the reference, covering/CoveringIndex.scala:58-61)."""

    files: Tuple[str, ...]
    fmt: str
    columns: Tuple[str, ...]  # projection to read
    file_ids: Optional[Dict[str, int]]  # lineage ids (None = lineage off)
    select_cols: Optional[Tuple[str, ...]] = None  # output column order
    # per-file estimated materialized bytes, computed once at create time
    # (footer parses are a round trip each on object stores)
    file_sizes: Optional[Tuple[int, ...]] = None
    # rows whose stored lineage id is listed are dropped at materialize
    # time: a refresh's delete compensation over previous index data
    excluded_lineage_ids: Optional[Tuple[int, ...]] = None

    def process_local(self) -> "SourceScan":
        """This process's stripe of the files (``files[p::P]``) on a job of
        several processes: each scans, hashes and exchanges only its own
        rows, so the global row order becomes process-major. Itself in a
        single process."""
        nproc = _mesh.process_count()
        if nproc <= 1:
            return self
        p = _mesh.process_index()
        return dataclasses.replace(
            self,
            files=self.files[p::nproc],
            file_sizes=self.file_sizes[p::nproc] if self.file_sizes is not None else None,
        )

    def empty_batch(self) -> ColumnarBatch:
        """Zero-row batch with this scan's output structure (the stripe of
        a process with no files in a wave). Parquet-family
        sources read only the first file's footer schema; anything else
        materializes one file and slices it to zero rows."""
        if not self.files:
            raise HyperspaceException("No source files to index")
        if self.fmt in ("parquet", "delta", "iceberg"):
            try:
                import pyarrow.parquet as pq

                t = pq.read_schema(self.files[0]).empty_table()
                b = ColumnarBatch.from_arrow(t.select(list(self.columns)))
                if self.file_ids is not None:
                    b = b.with_column(
                        DATA_FILE_NAME_ID,
                        Column("numeric", pa.int64(), values=np.zeros(0, dtype=np.int64)),
                    )
                if self.select_cols is not None:
                    b = b.select(list(self.select_cols))
                return b
            except (
                OSError,
                KeyError,
                pa.ArrowInvalid,
                pa.ArrowNotImplementedError,
            ):  # nested/exotic schema or unreadable footer: pay the row read
                pass
        b = self.materialize(list(self.files[:1]))
        return b.filter(np.zeros(b.num_rows, dtype=bool))

    def materialize(self, files: Optional[Sequence[str]] = None) -> ColumnarBatch:
        """The rows of ``files`` (all of the scan's by default), in order."""
        batch = _scan_with_lineage(
            files if files is not None else self.files,
            self.fmt,
            list(self.columns),
            self.file_ids,
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

    def stats_view(self, stat_cols: Sequence[str]) -> "SourceScan":
        """A projection of this scan reading only ``stat_cols`` (plus the
        lineage column when delete exclusion applies, so excluded rows do
        not contribute to encoding statistics)."""
        cols = tuple(stat_cols)
        read = cols
        if self.excluded_lineage_ids and DATA_FILE_NAME_ID not in read:
            read = read + (DATA_FILE_NAME_ID,)
        return dataclasses.replace(self, columns=read, file_ids=None, select_cols=cols)

    def estimated_bytes(self) -> int:
        if self.file_sizes is not None:
            return sum(self.file_sizes)
        return estimated_materialized_bytes(self.files, self.fmt)


@dataclasses.dataclass
class CompositeScan:
    """Several :class:`SourceScan` parts streamed as one input: a z-order
    index's incremental refresh mixes appended source files (projection
    and lineage attach) with previous index files (lineage-filtered for
    deletes). Each keeps its own read semantics; wave planning and
    materialization see one ordered file list. All parts select the same
    output columns."""

    scans: Tuple[SourceScan, ...]

    @property
    def files(self) -> Tuple[str, ...]:
        return tuple(f for s in self.scans for f in s.files)

    @property
    def fmt(self) -> str:
        return self.scans[0].fmt

    @property
    def file_sizes(self) -> Tuple[int, ...]:
        out: List[int] = []
        for s in self.scans:
            out.extend(
                s.file_sizes
                if s.file_sizes is not None
                else per_file_materialized_bytes(s.files, s.fmt)
            )
        return tuple(out)

    def materialize(self, files: Optional[Sequence[str]] = None) -> ColumnarBatch:
        wanted = set(self.files if files is None else files)
        parts = []
        # scans are ordered and wave file lists are contiguous slices of
        # self.files, so per-scan grouping preserves global row order
        for s in self.scans:
            sub = [f for f in s.files if f in wanted]
            if sub:
                parts.append(s.materialize(sub))
        if not parts:
            raise HyperspaceException("No files to materialize")
        return ColumnarBatch.concat(parts)

    def process_local(self) -> "CompositeScan":
        return CompositeScan(tuple(s.process_local() for s in self.scans))

    def empty_batch(self) -> ColumnarBatch:
        return self.scans[0].empty_batch()

    def select(self, cols: Sequence[str]) -> "CompositeScan":
        return CompositeScan(tuple(s.select(cols) for s in self.scans))

    def stats_view(self, stat_cols: Sequence[str]) -> "CompositeScan":
        return CompositeScan(tuple(s.stats_view(stat_cols) for s in self.scans))

    def estimated_bytes(self) -> int:
        return sum(s.estimated_bytes() for s in self.scans)


def per_file_materialized_bytes(files: Sequence[str], fmt: str) -> List[int]:
    """Per-file rough in-memory size of every column: parquet's
    uncompressed data size from the footers; other formats the on-disk
    size times two."""
    import os

    if fmt in ("parquet", "delta", "iceberg"):
        import pyarrow.parquet as pq

        def uncompressed(p):
            md = pq.ParquetFile(p).metadata
            return sum(md.row_group(i).total_byte_size for i in range(md.num_row_groups))

        return [uncompressed(f) for f in files]
    return [os.path.getsize(f) * 2 for f in files]


def estimated_materialized_bytes(files: Sequence[str], fmt: str) -> int:
    return sum(per_file_materialized_bytes(files, fmt))


def plan_waves(
    files: Sequence[str],
    fmt: str,
    budget: int,
    file_sizes: Optional[Sequence[int]] = None,
) -> List[List[str]]:
    """Greedy pack files into waves of estimated materialized size <=
    ``budget`` (always at least one file per wave: a single file larger
    than the budget still has to be read whole). ``file_sizes`` reuses
    estimates computed at create time instead of re-parsing footers."""
    if file_sizes is None:
        file_sizes = per_file_materialized_bytes(files, fmt)
    waves: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for f, sz in zip(files, file_sizes):
        if cur and cur_bytes + sz > budget:
            waves.append(cur)
            cur, cur_bytes = [], 0
        cur.append(f)
        cur_bytes += sz
    if cur:
        waves.append(cur)
    return waves


def lazy_or_materialized(ctx, scan):
    """The build memory-budget rule, in one place: keep the scan lazy
    (streamed at write time through the wave loop) when its estimated
    materialized size exceeds ``hyperspace.index.build.memoryBudgetBytes``,
    else materialize it now, timed as the build stage ``scan``. Takes a
    SourceScan or a CompositeScan. On a job of several processes each
    materializes its own stripe (``process_local``); a process with no
    files gets a zero-row batch of the scan's schema."""
    budget = ctx.session.conf.build_memory_budget
    if budget and scan.estimated_bytes() > budget:
        return scan
    t0 = _time.perf_counter()
    local = scan.process_local()
    out = local.materialize() if local.files else scan.empty_batch()
    _stage_add(ctx, "scan", t0)
    return out


def previous_index_scan(
    ctx, previous_content, schema_cols: Sequence[str], deleted_source_file_ids
) -> SourceScan:
    """Lazy scan of a previous index version's data files minus the rows
    of the deleted source files (the refresh's delete compensation input).
    File sizes are computed once here when a budget is set."""
    files = tuple(previous_content.files)
    sizes = (
        tuple(per_file_materialized_bytes(files, "parquet"))
        if ctx.session.conf.build_memory_budget
        else None
    )
    return SourceScan(
        files=files,
        fmt="parquet",
        columns=tuple(schema_cols),
        file_ids=None,
        select_cols=tuple(schema_cols),
        file_sizes=sizes,
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
    """(CoveringIndex, lazy SourceScan) — column resolution and lineage-id
    registration, with no row read yet (the z-order incremental refresh
    composes the scan further before any row is read)."""
    from hyperspace_tpu_torch.indexes.covering import CoveringIndex

    reset_build_stats(ctx)
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
    budget = ctx.session.conf.build_memory_budget
    sizes = per_file_materialized_bytes(rel.files, rel.fmt) if budget else None
    scan = SourceScan(
        files=tuple(rel.files),
        fmt=rel.fmt,
        columns=tuple(indexed + included),
        file_ids=file_ids,
        file_sizes=tuple(sizes) if sizes is not None else None,
    )
    return index, scan


def create_covering_index(ctx, source_df, config, properties: Dict[str, str]):
    """(CoveringIndex, index data): a batch, or past the build memory
    budget a lazy SourceScan — the reference's
    ``CoveringIndexConfig.createIndex:43-61``."""
    index, scan = prepare_covering_index(ctx, source_df, config, properties)
    return index, lazy_or_materialized(ctx, scan)


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


def _decompose(batch: ColumnarBatch):
    """A batch as movable arrays and the spec that reassembles it: string
    columns as their int32 codes, numeric ones as values (and validity)."""
    arrays: List[np.ndarray] = []
    spec = []
    for name, col in batch.columns.items():
        if col.kind == "string":
            arrays.append(col.codes)
            spec.append(("string", name, col.arrow_type, col.dictionary, False))
        else:
            arrays.append(col.values)
            has_validity = col.validity is not None
            if has_validity:
                arrays.append(col.validity)
            spec.append(("numeric", name, col.arrow_type, None, has_validity))
    return arrays, spec


def _reassemble(spec, arrays: List[np.ndarray]) -> ColumnarBatch:
    cols = {}
    it = iter(arrays)
    for kind, name, atype, dictionary, has_validity in spec:
        if kind == "string":
            cols[name] = Column(
                "string", atype, codes=next(it).astype(np.int32), dictionary=dictionary
            )
        else:
            values = next(it)
            validity = next(it) if has_validity else None
            cols[name] = Column("numeric", atype, values=values, validity=validity)
    return ColumnarBatch(cols)


def _hash_shuffle(
    ctx, batch: ColumnarBatch, indexed_cols: List[str], num_buckets: int
):
    """Bucket-id half of the pipeline. Returns ``(buckets, reps, batch,
    shard_offsets)``: bucket ids [n] int32 and key reps [k, n] int64 as
    tensors on the session's device, in the returned batch's row order.

    On a mesh of D > 1 shards (a batch of at least D rows, or any batch on
    a job of several processes: the exchange is a collective every
    process must join, zero rows included) the key reps and every column
    go through the bucket exchange (``parallel/shuffle.bucket_shuffle``,
    the configured strategy) and come back in post-exchange order, with
    ``shard_offsets`` the ``[D + 1]`` row extents of each shard's buckets.
    Otherwise kernel B1 hashes the batch as it is on the session's device
    and ``shard_offsets`` is None."""
    t0 = _time.perf_counter()
    mesh = ctx.mesh
    shard_offs = None
    if mesh.size > 1 and (batch.num_rows >= mesh.size or mesh.processes > 1):
        conf = ctx.session.conf
        reps_np = batch.key_reps(indexed_cols)
        k = reps_np.shape[0]
        arrays, spec = _decompose(batch)
        ids, moved, shard_offs = _shuffle.bucket_shuffle(
            mesh, reps_np, list(reps_np) + arrays, num_buckets,
            with_shard_offsets=True,
            strategy=conf.build_exchange_strategy,
            twostage_hosts=conf.build_exchange_twostage_hosts,
        )
        reps_np = np.stack(moved[:k]) if k else np.zeros((0, len(ids)), dtype=np.int64)
        batch = _reassemble(spec, moved[k:])
        reps = torch.from_numpy(np.ascontiguousarray(reps_np, dtype=np.int64)).to(ctx.device)
        buckets = torch.from_numpy(ids).to(ctx.device)
        _record_shuffle_telemetry(ctx, _shuffle.last_shuffle_stats)
    else:
        reps = torch.from_numpy(batch.key_reps(indexed_cols)).to(ctx.device)
        buckets = bucket_ids(reps, num_buckets)
    if buckets.is_cuda:
        torch.cuda.synchronize(buckets.device)
    _stage_add(ctx, "hash_shuffle", t0)
    return buckets, reps, batch, shard_offs


def _record_shuffle_telemetry(ctx, stats: Dict) -> None:
    """Fold one exchange's snapshot into ``session.build_telemetry``: the
    latest value of every ``shuffle_<key>``, the pack / exchange / unpack
    seconds summed over waves, and the skew as a max and a running mean
    over waves with the wave count."""
    with _stats_lock:
        t = ctx.session.build_telemetry
        waves = t.get("shuffle_waves", 0.0) + 1.0
        for k, v in stats.items():
            key = "shuffle_" + k
            if k in ("pack_s", "exchange_s", "unpack_s"):
                t[key] = round(t.get(key, 0.0) + float(v), 4)
            else:
                t[key] = v
        skew = float(stats.get("skew_ratio", 1.0))
        prev_mean = t.get("shuffle_skew_ratio_mean", 0.0)
        t["shuffle_waves"] = waves
        t["shuffle_skew_ratio_max"] = max(t.get("shuffle_skew_ratio_max", 0.0), skew)
        t["shuffle_skew_ratio_mean"] = round(prev_mean + (skew - prev_mean) / waves, 3)


def _sharded_tail_offsets(ctx, shard_offs):
    """The shard offsets when the sharded tail applies, else None: the flag
    on (``hyperspace.build.shardedTail.enabled``), an exchange ran, and more
    than one shard holds rows."""
    if shard_offs is None or not ctx.session.conf.build_sharded_tail:
        return None
    occupied = int(np.count_nonzero(np.diff(shard_offs)))
    return shard_offs if occupied > 1 else None


def _shard_runs(ctx, buckets, reps, num_buckets: int, shard_offs, s: int):
    """Shard ``s``'s slice sorted by (bucket, keys) on the shard's own
    device: ``(perm, offsets)`` on the host, ``perm`` in the batch's row
    coordinates."""
    lo, hi = int(shard_offs[s]), int(shard_offs[s + 1])
    dev = ctx.mesh.device(s)
    perm, offsets = bucket_sort_runs(reps[:, lo:hi].to(dev), buckets[lo:hi].to(dev), num_buckets)
    return perm + lo, offsets


def bucketize(ctx, batch: ColumnarBatch, indexed_cols: List[str], num_buckets: int):
    """Route rows to buckets -> (bucket_ids, batch) in bucket-grouped,
    key-sorted order. The permutation is the reference's stable sort by
    (bucket, keys...), computed on the session's device, after the
    exchange on a mesh (the legacy route: one tail)."""
    buckets, reps, batch, _offs = _hash_shuffle(ctx, batch, indexed_cols, num_buckets)
    t0 = _time.perf_counter()
    perm = partitioned_sort_permutation(reps, buckets, num_buckets)
    sorted_buckets = buckets[perm].cpu().numpy()
    perm = perm.cpu().numpy()
    out = sorted_buckets, batch.take(perm)
    _stage_add(ctx, "sort", t0)
    return out


def write_bucketed(
    ctx,
    data,
    indexed_cols: List[str],
    num_buckets: int,
    file_idx_offset: int = 0,
) -> List[str]:
    """The build pipeline tail: hash, exchange on a mesh, sort-within-bucket,
    write one parquet per bucket (CoveringIndex.write:56-71 +
    saveWithBuckets), through the pipelined partition-first writer unless
    ``hyperspace.index.build.partitionFirst`` is off.

    ``data`` is a ColumnarBatch, a :class:`SourceScan` (streamed in waves
    by ``_write_bucketed_streaming``), or a list mixing both (an
    incremental refresh: the appended rows and the previous data kept).

    The parquet dictionary-encoding decision of an in-memory build is
    computed ONCE, on the pre-sort input, as the reference does, so the
    two routes write the same bytes. Every exit passes
    ``_global_written``, the barrier of a job of several processes."""
    import os

    sources = data if isinstance(data, list) else [data]
    if any(isinstance(s, SourceScan) for s in sources):
        return _global_written(
            ctx,
            _write_bucketed_streaming(ctx, sources, indexed_cols, num_buckets, file_idx_offset),
        )
    batch = sources[0] if len(sources) == 1 else ColumnarBatch.concat(sources)
    if batch.num_rows == 0 and _mesh.process_count() <= 1:
        # a job of several processes never takes this shortcut: a zero-row
        # stripe still owes its peers the exchange and the barrier
        os.makedirs(ctx.index_data_path, exist_ok=True)
        return []
    use_dict = pio.dictionary_columns_for_batch(batch)
    if ctx.session.conf.build_partition_first:
        return _global_written(
            ctx,
            _write_bucketed_pipelined(
                ctx, batch, indexed_cols, num_buckets, file_idx_offset, use_dict
            ),
        )
    buckets, batch = bucketize(ctx, batch, indexed_cols, num_buckets)
    t0 = _time.perf_counter()
    os.makedirs(ctx.index_data_path, exist_ok=True)
    out = pio.write_bucket_files(
        ctx.index_data_path,
        buckets,
        batch,
        num_buckets,
        file_idx_offset,
        use_dictionary=use_dict,
    )
    _stage_add(ctx, "write", t0)
    return _global_written(ctx, out)


def _global_written(ctx, written: List[str]) -> List[str]:
    """The written-file list a build hands the metadata plane: the writer's
    own in a single process; on a job of several processes, where each
    wrote only the buckets its shards own, the listing of the data
    directory after a barrier, the same on every process. Every
    ``write_bucketed`` exit reaches it on every process, zero-row stripes
    included. Registered in ``COLLECTIVE_SITES``."""
    if _mesh.process_count() <= 1:
        return written
    import os

    import torch.distributed as dist

    dist.barrier()
    d = ctx.index_data_path
    if not os.path.isdir(d):
        return []
    return [
        os.path.join(d, f)
        for f in sorted(os.listdir(d))
        if f.startswith(INDEX_FILE_PREFIX) and f.endswith(".parquet")
    ]


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
    buckets queued behind it land, as in the reference. After an exchange
    over more than one occupied shard the sharded tail runs instead
    (:func:`_write_bucketed_sharded`).

    Stages as the reference records them: ``sort`` spans the sort, the
    copy and the submissions (and the writes that overlap them);
    ``write`` is only the drain after the last submission."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    buckets, reps, batch, shard_offs = _hash_shuffle(ctx, batch, indexed_cols, num_buckets)
    os.makedirs(ctx.index_data_path, exist_ok=True)
    shard_offs = _sharded_tail_offsets(ctx, shard_offs)
    if shard_offs is not None:
        return _write_bucketed_sharded(
            ctx, buckets, reps, batch, file_idx_offset, use_dict, num_buckets, shard_offs
        )
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


def _write_bucketed_sharded(
    ctx,
    buckets: torch.Tensor,
    reps: torch.Tensor,
    batch: ColumnarBatch,
    file_idx_offset: int,
    use_dict,
    num_buckets: int,
    shard_offs: np.ndarray,
) -> List[str]:
    """The sharded tail of an in-memory build (reference
    ``_write_bucketed_sharded``, ``covering_build.py:877``): each shard's
    post-exchange slice (exactly the buckets it owns) sorts on its own
    device and writes its buckets on its own writer thread, concurrently
    with the other shards. The files are the single tail's byte for byte:
    a bucket lives wholly in one shard's slice and the stable sort
    restricted to it is the same.

    Stages: ``sort`` and ``write`` add each shard's busy seconds (their sum
    can pass the wall time); ``tail_wall`` is the tail's wall time and
    ``tail_shards`` the number of shard tails."""
    from concurrent.futures import ThreadPoolExecutor

    t_tail = _time.perf_counter()
    table = batch.to_arrow()
    shards = shard_tail_plan(shard_offs)

    def run_shard(s: int) -> List[Tuple[int, str]]:
        t0 = _time.perf_counter()
        perm, offsets = _shard_runs(ctx, buckets, reps, num_buckets, shard_offs, s)
        with ThreadPoolExecutor(max_workers=1) as writer:
            futures = [
                (b, writer.submit(
                    pio.write_bucket_file, ctx.index_data_path, b, file_idx_offset, table,
                    perm[offsets[b] : offsets[b + 1]], use_dict,
                ))
                for b in range(num_buckets)
                if offsets[b + 1] > offsets[b]
            ]
            _stage_add(ctx, "sort", t0)
            t0 = _time.perf_counter()
            out = [(b, f.result()) for b, f in futures]
        _stage_add(ctx, "write", t0)
        return out

    with ThreadPoolExecutor(max_workers=len(shards), thread_name_prefix="hs-shardtail") as pool:
        results = list(pool.map(_obs_trace.carry(run_shard), shards))
    with _stats_lock:
        stats = ctx.session.build_stats
        stats["tail_wall"] = stats.get("tail_wall", 0.0) + _time.perf_counter() - t_tail
        stats["tail_shards"] = float(len(shards))
    # ascending bucket id, the single tail's order
    return [path for _b, path in sorted(p for r in results for p in r)]


def spill_root_for(index_data_path: str, tag: str = "") -> str:
    """The spill directory of a streamed write into ``index_data_path``:
    beside the ``v__=N`` directory, inside the index directory, named
    ``_spill_<tag>v__<N>`` (no ``=`` in any spill path component: Arrow's
    dataset reader would hive-infer a partition column from it). On a job
    of several processes each process spills into its own
    ``..._p<rank>`` directory (a peer that finishes first must never
    remove parts another is still merging)."""
    import os

    suffix = f"-p{_mesh.process_index()}" if _mesh.process_count() > 1 else ""
    return os.path.join(
        os.path.dirname(index_data_path),
        "_spill_" + tag + os.path.basename(index_data_path).replace("=", "_") + suffix,
    )


def _spill_wave(ctx, batch, indexed_cols, num_buckets, spill_root, wave_idx,
                bucket_parts) -> None:
    """One wave of the streamed build: B1, the exchange on a mesh and the
    bucket sort on the device (a shard's slice on its own device on the
    sharded tail), then each bucket's key-sorted run spilled to
    ``b<bucket>-w<wave>.parquet``. The wave's device tensors die with this
    frame, before the next wave is read."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    buckets, reps, batch, shard_offs = _hash_shuffle(ctx, batch, indexed_cols, num_buckets)
    t0 = _time.perf_counter()
    shard_offs = _sharded_tail_offsets(ctx, shard_offs)
    if shard_offs is None:
        runs = [bucket_sort_runs(reps, buckets, num_buckets)] if batch.num_rows else []
    else:
        with ThreadPoolExecutor(max_workers=ctx.mesh.size, thread_name_prefix="hs-shardsort") as pool:
            runs = list(pool.map(
                lambda s: _shard_runs(ctx, buckets, reps, num_buckets, shard_offs, s),
                shard_tail_plan(shard_offs),
            ))
    _stage_add(ctx, "sort", t0)
    t0 = _time.perf_counter()
    table = batch.to_arrow()
    for perm, offsets in runs:
        for b in range(num_buckets):
            lo, hi = int(offsets[b]), int(offsets[b + 1])
            if hi == lo:
                continue
            path = os.path.join(spill_root, f"b{b:05d}-w{wave_idx:05d}.parquet")
            pio.write_table(path, table.take(pa.array(perm[lo:hi])))
            bucket_parts.setdefault(b, []).append(path)
    _stage_add(ctx, "spill", t0)


def _merge_bucket(ctx, wave_parts, b, indexed_cols, num_buckets, file_idx_offset,
                  device=None) -> List[str]:
    """A bucket's spilled runs (one a wave) read in wave order, key-sorted stably on the
    device (the bucket's shard's on a mesh; ties keep wave order) and
    written as the bucket's file with the encoding decision taken on the
    merged rows, as the reference does."""
    merged = ColumnarBatch.from_arrow(pio.read_table(wave_parts, None))
    reps = torch.from_numpy(merged.key_reps(indexed_cols)).to(device or ctx.device)
    perm = sort_permutation(reps).cpu().numpy()
    merged = merged.take(perm)
    return pio.write_bucket_files(
        ctx.index_data_path,
        np.full(merged.num_rows, b, dtype=np.int32),
        merged,
        num_buckets,
        file_idx_offset,
    )


def _wave_batches(ctx, src, budget: int):
    """A source's wave batches: a batch is one wave; a scan's files are
    packed into waves within the budget over the GLOBAL file list on
    every process (the same wave count, so the same number of exchanges
    everywhere), and on a job of several processes each process reads
    only its stripe of a wave (a zero-row batch of the scan's schema
    when it has none)."""
    if not isinstance(src, SourceScan):
        yield src
        return
    waves = plan_waves(src.files, src.fmt, budget, src.file_sizes)
    nproc = _mesh.process_count()
    if nproc <= 1:
        for w in waves:
            yield src.materialize(w)
        return
    index_of = {f: i for i, f in enumerate(src.files)}
    pid = _mesh.process_index()
    for w in waves:
        mine = [f for f in w if index_of[f] % nproc == pid]
        yield src.materialize(mine) if mine else src.empty_batch()


def _write_bucketed_streaming(
    ctx,
    sources,
    indexed_cols: List[str],
    num_buckets: int,
    file_idx_offset: int = 0,
) -> List[str]:
    """The out-of-core wave loop (reference ``covering_build.py:962-1112``).
    The device never holds more than one wave (<= the budget) and, at
    merge time, one bucket a merge worker:

    1. **Waves**: each SourceScan's files packed into waves within the
       budget (``plan_waves``; a batch among the sources is one wave); per
       wave, B1, the exchange on a mesh and the bucket sort on the device,
       and each bucket's run spilled to
       ``_spill_v__<N>/b<bucket>-w<wave>.parquet``;
    2. **Merge**: per bucket, ascending, its runs read in wave order,
       key-sorted on the device, written as the bucket's file. On a mesh
       with the sharded tail on, each shard's buckets merge on a worker of
       their own, on the shard's device, as many at once as the largest
       buckets fit the budget together (at most D).

    The spill directory is removed whatever happens. Stages: ``scan`` (the
    wave reads), hash_shuffle and sort (the device), ``spill``, ``merge``;
    counts ``waves``, ``spill_files`` and ``merge_workers``."""
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    budget = ctx.session.conf.build_memory_budget or (1 << 62)
    stats = ctx.session.build_stats
    nproc = _mesh.process_count()
    spill_root = spill_root_for(ctx.index_data_path)
    os.makedirs(spill_root, exist_ok=True)
    os.makedirs(ctx.index_data_path, exist_ok=True)
    wave_idx = 0
    bucket_parts: Dict[int, List[str]] = {}
    try:
        for src in sources:
            batches = _wave_batches(ctx, src, budget)
            while True:
                t0 = _time.perf_counter()
                batch = next(batches, None)
                _stage_add(ctx, "scan", t0)
                if batch is None:
                    break
                if batch.num_rows or nproc > 1:
                    _spill_wave(ctx, batch, indexed_cols, num_buckets, spill_root,
                                wave_idx, bucket_parts)
                    wave_idx += 1
                del batch
        stats["waves"] = wave_idx
        stats["spill_files"] = sum(len(p) for p in bucket_parts.values())
        t0 = _time.perf_counter()
        ordered = sorted(bucket_parts)
        mesh = ctx.mesh
        D = mesh.size
        workers = 1
        if D > 1 and ctx.session.conf.build_sharded_tail and len(ordered) > 1:
            # concurrent merges may widen the one-bucket bound to k
            # buckets only where k of the largest fit the budget
            biggest = max(
                sum(per_file_materialized_bytes(bucket_parts[b], "parquet")) for b in ordered
            )
            workers = max(1, min(D, int(budget // max(biggest, 1))))
        stats["merge_workers"] = workers

        def merge(b: int) -> List[str]:
            dev = mesh.device(b % D) if D > 1 else None
            return _merge_bucket(ctx, bucket_parts[b], b, indexed_cols, num_buckets,
                                 file_idx_offset, dev)

        written: List[str] = []
        if workers > 1:
            groups = _mesh.bucket_owner_groups(ordered, D)
            with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="hs-shardmerge") as pool:
                maps = list(pool.map(
                    _obs_trace.carry(lambda g: {ordered[i]: merge(ordered[i]) for i in g}), groups
                ))
            by_bucket = {b: fs for m in maps for b, fs in m.items()}
            for b in ordered:
                written.extend(by_bucket[b])
        else:
            for b in ordered:
                written.extend(merge(b))
        _stage_add(ctx, "merge", t0)
        return written
    finally:
        shutil.rmtree(spill_root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Optimize / refresh data plane (CoveringIndexTrait:57-134)
# ---------------------------------------------------------------------------


def rewrite_files(
    ctx, files_to_optimize: List[str], indexed_cols: List[str], num_buckets: int
) -> List[str]:
    """Optimize: read the listed index files and rewrite them compacted
    (CoveringIndexTrait.optimize:130-134, 'read files, then write'). On a
    job of several processes each reads its stripe of the files
    (``files[p::P]``; none: a zero-row batch of the first file's schema,
    which still joins the exchange) and the exchange routes the rows back
    to their owner process."""
    reset_build_stats(ctx)
    t0 = _time.perf_counter()
    nproc = _mesh.process_count()
    subset = files_to_optimize[_mesh.process_index()::nproc] if nproc > 1 else files_to_optimize
    if subset:
        batch = ColumnarBatch.from_arrow(pio.read_table(subset, None))
    else:
        import pyarrow.parquet as pq

        batch = ColumnarBatch.from_arrow(pq.read_schema(files_to_optimize[0]).empty_table())
    _stage_add(ctx, "scan", t0)
    return write_bucketed(ctx, batch, indexed_cols, num_buckets)


def refresh_scans(
    ctx, index, config, appended_df, deleted_source_file_ids, previous_content
):
    """The inputs of an incremental refresh of a covering-family index, as
    lazy scans of the index's columns (lineage last): the appended source
    files resolved through ``config`` (their lineage ids registered in
    ``ctx.file_id_tracker``) and, when source files were deleted, the
    previous index data minus their rows. Returns ``(scans, UpdateMode)``."""
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
            previous_index_scan(ctx, previous_content, schema_cols, deleted_source_file_ids)
        )
        return scans, UpdateMode.OVERWRITE
    return scans, UpdateMode.MERGE


def refresh_incremental(
    ctx, index, appended_df, deleted_source_file_ids: List[int], previous_content
):
    """CoveringIndexTrait.refreshIncremental:57-106: the appended source
    files' rows, and for deleted source files the previous index data
    minus their lineage ids, hashed, sorted and written into the new
    version dir; each side past the build memory budget streams through
    the wave loop. Returns ``(index, UpdateMode.MERGE | OVERWRITE)``."""
    reset_build_stats(ctx)
    scans, mode = refresh_scans(
        ctx, index, _config_of(index), appended_df, deleted_source_file_ids,
        previous_content,
    )
    if scans:
        parts = [lazy_or_materialized(ctx, s) for s in scans]
        write_bucketed(ctx, parts, index.indexed_columns, index.num_buckets)
    return index, mode


def refresh_full(ctx, index, df):
    """Rebuild the whole index from the current source, streamed past the
    build memory budget (CoveringIndexTrait.refreshFull:108-126). Returns
    the REBUILT index:
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
