"""Plan executor: walks the (optimized) logical plan and produces Arrow.

Counterpart of ``hyperspace_tpu/execution/executor.py`` for Scan, Filter,
Project and inner equi-Join. Column pruning and simple conjuncts are
pushed into the parquet read. A filter over an index scan first drops
what cannot hold a match: the bucket files whose murmur3 bucket no
literal hashes to (kernel B1 on the session's device), then the files and
row groups whose zone maps (``indexes/zonemaps.py``) miss the
predicate's ranges, which a narrowed scan then does not read. The
predicate mask is evaluated on the session's device (``ops/filter.py``):
a conjunction of numeric range terms takes the fused range mask (kernel
B3a), the rest the general device mask, and what does not lower
(``Unsupported``) the host evaluator; ``session.exec_stats`` counts each.

A join whose two sides keep aligned bucketed index layouts (the
JoinIndexRule rewrite) runs shuffle-free: each side is executed into
per-bucket batches (bucket id from the file names, rows in file order)
and ``execution/join_exec`` zips equal buckets pairwise, matching them
with kernel B4 (``ops/join.py``) on the session's device, or on a shard
mesh (``session.runtime``, more than one shard, the sharded tail on) a
block of buckets a shard on the shards' devices, whose pipelined prepare
then runs a worker a shard (``_serve_shards``). With the
pipelined serve on (``hyperspace.serve.pipeline.enabled``, default off)
and both sides clean index scans (``Project*(Scan)``), the two sides
prepare on two threads, each streaming its per-bucket reads from the
shared scan pool into ``join_exec.prepare_join_side_pipelined``; the rows
are the sequential route's. Any other join runs the unindexed
``inner_join`` through the same kernel as one segment.
``session.join_stats`` holds the latest join's stage seconds: ``scan``
(the sides' reads and decode, or on the pipelined route the waits for
them) and ``prepare`` (key reps) here, each the seconds of a side's own
thread summed over both sides; the rest in ``join_exec``.

A Filter over a scan whose predicate is a conjunction of numeric range
terms, on a batch of at least ``pipeline_compiler.
_NATIVE_FUSED_PIPELINE_MIN_ROWS`` rows, takes the fused select instead of
the mask: the passing rows' indices in one pass (kernel B3b), the rows
gathered through them (``hyperspace.serve.fusedpipeline.enabled``).

An Aggregate first tries the metadata plane (``pipeline_compiler.
try_metadata_aggregate``: row groups the predicate covers answered from
``_aggstate.json``, the boundary ones scanned), then the fused
filter→aggregate over the pruned index scan (``try_fused_aggregate``:
kernel B5f and B5 a chunk), then the interpreted chain:
``execution/aggregate_exec`` over its child's batch, group keys
factorized on the session's device, the reductions through kernel B5
(``ops/aggregate.py``). A Sort orders by
``ops/sort.ordering_permutation`` on the device; a Limit over a Sort
takes the first n of that permutation (top-n), passes through a Project,
and over a Scan or Filter(Scan) reads the files in groups of 1, 2, 4, ...
until it has n rows. ``session.agg_stats`` holds the latest query's
stage seconds: ``scan`` (the child batches of its aggregates and sorts),
``factorize``, ``reduce`` and ``finalize`` (``aggregate_exec``),
``sort``, and the wall seconds of a metadata (``metadata``) or fused
(``fused``) answer, whose reads are under ``scan``.

Hybrid Scan (``rules/hybrid.py``) leaves two shapes here. A ``Union`` of
the index scan and the appended source files concatenates the two sides,
index rows first; under a co-bucketed join the appended rows are hashed
into the index's buckets by kernel B1 on the session's device and each
such bucket's part follows the bucket's index rows (the pipelined route
prepares this delta on the scan pool while the index side reads,
``_prepare_delta``). A relation with ``excluded_file_ids`` (deleted
source files) reads the lineage column and drops those files' rows
(NOT-IN), even when the query does not project the column. Neither shape
takes the fused or metadata routes.

With the serve cache on (``hyperspace.serve.cache.enabled``,
``execution/serve_cache.py``) a clean index scan's decoded columns, a
co-bucketed join's prepared sides, per-bucket batches and the Hybrid Scan
delta stay in host RAM between queries, keyed by the fingerprint of their
files: a cached filter narrows the cached rows by binary search over a
key-sorted column and masks the rest (kernel B3a), a warm join matches
the cached sides (kernel B4), and the fused aggregate folds the cached
batch (kernel B5f). With the streaming join serve on
(``hyperspace.serve.stream.enabled``) a co-bucketed join over clean index
scans is read, prepared, matched and released a wave of buckets at a
time, each wave packed under ``hyperspace.serve.stream.maxBytes``
(``last_stream_stats`` counts the waves); its rows are the materializing
route's. ``hyperspace.io.mmap.enabled`` maps the parquet files the serve
reads.

Rows come out in the reference's order: files in relation order, rows in
file order, the mask applied in place; a co-bucketed join's rows bucket
by bucket; an aggregate's groups in key-rep order, on every route.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache as _lru_cache
from typing import Dict, Optional, Set

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.constants import DATA_FILE_NAME_ID
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.obs import trace as _obs_trace
from hyperspace_tpu_torch.ops.filter import (
    Unsupported,
    device_filter_mask,
    fused_range_mask,
)
from hyperspace_tpu_torch.ops.hash import bucket_ids
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Scan,
    Sort,
    Union,
)


def execute(plan: LogicalPlan, session):
    """Execute -> pyarrow.Table (column order = plan.output)."""
    session.agg_stats = {}
    batch = _exec(plan, set(plan.output), session)
    return batch.select(plan.output).to_arrow()


def _exec(plan: LogicalPlan, needed: Set[str], session) -> ColumnarBatch:
    if isinstance(plan, Scan):
        return _exec_scan(plan, needed, session)
    if isinstance(plan, Filter):
        child = _bucket_pruned_scan(plan.child, plan.condition, session)
        child = _range_pruned_scan(child, plan.condition, session)
        child_needed = set(needed) | E.references(plan.condition)
        if isinstance(child, Scan):
            cached = _cached_filter(child, plan.condition, child_needed, session)
            if cached is not None:
                return cached
            batch = _exec_scan(
                child,
                child_needed,
                session,
                pushdown=_pushdown_filters(plan.condition, child.relation),
            )
        else:
            batch = _exec(child, child_needed, session)
        if isinstance(child, Scan) and session.conf.serve_fusedpipeline_enabled:
            from hyperspace_tpu_torch.execution.pipeline_compiler import fused_filter_batch

            fused = fused_filter_batch(plan.condition, batch, session)
            if fused is not None:
                session.exec_stats.fused_selects += 1
                return fused
        return batch.filter(_filter_mask(plan.condition, batch, session))
    if isinstance(plan, Project):
        batch = _exec(plan.child, set(plan.columns), session)
        return batch.select(plan.columns)
    if isinstance(plan, Union):
        cols = [c for c in plan.output if c in needed] or plan.output[:1]
        left = _exec(plan.left, set(cols), session).select(cols)
        right = _exec(plan.right, set(cols), session).select(cols)
        return ColumnarBatch.concat([left, right])
    if isinstance(plan, Join):
        return _exec_join(plan, needed, session)
    if isinstance(plan, Aggregate):
        # one agg span over the metadata plane, the fused pass and the
        # interpreted chain, as the reference traces it
        with _obs_trace.span("agg"):
            return _exec_aggregate(plan, session)
    if isinstance(plan, Sort):
        child_needed = set(needed) | {c for c, _ in plan.keys}
        batch = _exec_input(plan.child, child_needed, session)
        if batch.num_rows == 0:
            return batch
        return _sorted_rows(batch, plan.keys, batch.num_rows, session)
    if isinstance(plan, Limit):
        return _exec_limit(plan.n, plan.child, needed, session)
    raise HyperspaceException(f"Unknown plan node: {type(plan).__name__}")


def _exec_aggregate(plan: Aggregate, session) -> ColumnarBatch:
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.execution.aggregate_exec import execute_aggregate
    from hyperspace_tpu_torch.execution.join_exec import _stats_add

    for route, counter, stage_name in (
        (PC.try_metadata_aggregate, "metadata_aggregates", "metadata"),
        (PC.try_fused_aggregate, "fused_aggregates", "fused"),
    ):
        t0 = time.perf_counter()
        served = route(plan, session)
        if served is not None:
            setattr(session.exec_stats, counter, getattr(session.exec_stats, counter) + 1)
            _stats_add(session.agg_stats, stage_name, t0)
            return served
    batch = _exec_input(plan.child, plan.input_columns, session)
    return execute_aggregate(
        batch, plan.group_by, plan.aggs, plan.child.schema(), session.device,
        session.agg_stats,
    )


def _exec_input(plan: LogicalPlan, needed: Set[str], session) -> ColumnarBatch:
    """An aggregate's or sort's child batch, its seconds under the
    ``scan`` stage unless the child records its own stages."""
    from hyperspace_tpu_torch.execution.join_exec import _stats_add

    if isinstance(plan, (Aggregate, Sort, Limit)):
        return _exec(plan, needed, session)
    t0 = time.perf_counter()
    batch = _exec(plan, needed, session)
    _stats_add(session.agg_stats, "scan", t0)
    return batch


def _sorted_rows(batch: ColumnarBatch, keys, n: int, session) -> ColumnarBatch:
    """The first ``n`` rows of ``batch`` in ``keys`` order (the ordering
    permutation on the session's device), under the ``sort`` stage."""
    from hyperspace_tpu_torch.execution.aggregate_exec import stage
    from hyperspace_tpu_torch.ops.sort import ordering_permutation

    with stage(session.agg_stats, "sort", session.device):
        perm = ordering_permutation(batch, keys, session.device)[:n].cpu().numpy()
        return batch.take(perm)


def _exec_limit(n: int, child: LogicalPlan, needed: Set[str], session) -> ColumnarBatch:
    """Limit execution that avoids materializing the full child.

    * Limit∘Sort = top-n: sort the permutation, materialize only n rows;
    * Limit pushes through Project and Union (row order is the child's
      deterministic order, so the first n of the left side come first);
    * Limit∘Scan / Limit∘Filter∘Scan stream file-by-file and stop as
      soon as n rows are produced.
    The reference gets all of this from Spark's CollectLimitExec /
    LocalLimit pushdown.
    """
    if n <= 0:
        schema = child.schema()
        cols = [c for c in child.output if c in needed] or child.output[:1]
        return ColumnarBatch.from_arrow(
            pa.table({c: pa.array([], type=schema[c]) for c in cols})
        )
    if isinstance(child, Sort):
        child_needed = set(needed) | {c for c, _ in child.keys}
        batch = _exec_input(child.child, child_needed, session)
        if batch.num_rows == 0:
            return batch
        return _sorted_rows(batch, child.keys, min(n, batch.num_rows), session)
    if isinstance(child, Project):
        return _exec_limit(
            n, child.child, set(child.columns), session
        ).select(child.columns)
    if isinstance(child, Union):
        cols = [c for c in child.output if c in needed] or child.output[:1]
        left = _exec_limit(n, child.left, set(cols), session).select(cols)
        if left.num_rows >= n:
            return left.take(np.arange(n))
        right = _exec_limit(n - left.num_rows, child.right, set(cols), session).select(cols)
        return ColumnarBatch.concat([left, right])
    # file-by-file streaming for Scan / Filter(Scan) over footer-counted
    # formats (parquet and the lake tables) without post-read row filtering
    scan = child.child if isinstance(child, Filter) else child
    streamable = (
        isinstance(scan, Scan)
        and scan.relation.fmt in pio.PARQUET_FAMILY
        and scan.relation.excluded_file_ids is None
        and len(scan.relation.files) > 1
    )
    if streamable:
        # geometric group sizes (1, 2, 4, …): a selective filter that ends
        # up reading everything still gets the threaded multi-file read
        # after the first few probes (log-many read_table calls total),
        # while a satisfied limit stops after one small group
        parts: list = []
        got = 0
        files = list(scan.relation.files)
        pos = 0
        group = 1
        while pos < len(files) and got < n:
            chunk = tuple(files[pos : pos + group])
            sub_scan = Scan(dataclasses.replace(scan.relation, files=chunk))
            sub: LogicalPlan = (
                Filter(child.condition, sub_scan)
                if isinstance(child, Filter)
                else sub_scan
            )
            b = _exec(sub, needed, session)
            parts.append(b)
            got += b.num_rows
            pos += len(chunk)
            group *= 2
        batch = ColumnarBatch.concat(parts)
        return batch.take(np.arange(min(n, batch.num_rows)))
    batch = _exec(child, needed, session)
    return batch.take(np.arange(min(n, batch.num_rows)))


def _literal_key_rep(value, arrow_type):
    """The literal's int64 key rep under the same path data takes
    (Column.key_rep), or None when it cannot be represented losslessly."""
    try:
        arr = pa.array([value], type=arrow_type)
    except (pa.ArrowInvalid, pa.ArrowTypeError, OverflowError, TypeError):
        return None
    col = Column.from_arrow(arr)
    if col.null_mask is not None:
        return None
    return int(col.key_rep()[0])


_MAX_PRUNE_COMBOS = 64


def _bucket_pruned_scan(plan: LogicalPlan, cond: E.Expr, session) -> LogicalPlan:
    """Bucket pruning: when a filter over a bucketed index scan pins every
    bucket column to literals (Eq / In conjuncts), drop the bucket files
    that cannot contain matching rows.

    The executor-side payoff of FilterIndexRule's bucketSpec — the
    reference gets this from Spark's bucket pruning when
    ``index.filterRule.useBucketSpec`` is on (IndexConstants.scala:56-57);
    here it turns a point lookup into a read of 1/num_buckets of the index.
    """
    if not isinstance(plan, Scan) or plan.relation.bucket_spec is None:
        return plan
    rel = plan.relation
    num_buckets, bucket_cols = rel.bucket_spec
    schema = rel.schema
    conjuncts = E.split_conjuncts(cond)
    value_lists = []
    for bc in bucket_cols:
        vals = None
        for cj in conjuncts:
            norm = E.normalize_comparison(cj)
            if norm is not None:
                op, name, lit = norm
                if op == "=" and name.lower() == bc.lower():
                    vals = [lit]
                    break
            elif (
                isinstance(cj, E.In)
                and isinstance(cj.child, E.Col)
                and cj.child.name.lower() == bc.lower()
            ):
                vals = [v for v in cj.values if v is not None]
                break
        if not vals:
            return plan  # bucket column not pinned: no pruning
        value_lists.append(vals)
    n_combos = 1
    for vl in value_lists:
        n_combos *= len(vl)
    if n_combos > _MAX_PRUNE_COMBOS:
        return plan
    rep_lists = []
    for bc, vals in zip(bucket_cols, value_lists):
        reps = []
        for v in vals:
            rep = _literal_key_rep(v, schema[bc])
            if rep is None:
                return plan
            reps.append(rep)
        rep_lists.append(reps)
    # one kernel launch over all combinations: [k, n_combos]
    combos = np.array(
        list(itertools.product(*rep_lists)), dtype=np.int64
    ).T.reshape(len(bucket_cols), -1)
    combos_t = torch.from_numpy(np.ascontiguousarray(combos)).to(session.device)
    keep_buckets = set(bucket_ids(combos_t, num_buckets).cpu().tolist())
    session.exec_stats.bucket_pruned_scans += 1
    bucket_of = _bucket_ids_of_files(rel.files)
    kept = tuple(
        f
        for f, b in zip(rel.files, bucket_of)
        if b is None or b in keep_buckets
    )
    if len(kept) == len(rel.files):
        return plan
    return Scan(dataclasses.replace(rel, files=kept))


@_lru_cache(maxsize=1024)
def _bucket_ids_of_files(files) -> tuple:
    """Per-file bucket ids for a relation's file tuple, memoized: bucket
    ids are a pure function of the immutable file NAMES, and a new index
    version is a new file tuple."""
    return tuple(pio.bucket_id_of_file(f) for f in files)


def _rangeprune_on(session) -> bool:
    """Zone-map range pruning and the fused range mask
    (``hyperspace.serve.rangeprune.enabled``, default on)."""
    return session.conf.serve_rangeprune_enabled


def _range_pruned_scan(plan: LogicalPlan, cond: E.Expr, session) -> LogicalPlan:
    """Zone-map pruning for index scans under a Filter: drop index files
    (and narrow survivors to matching row groups) that the predicate's
    range/Eq/In conjuncts cannot touch, per ``indexes/zonemaps.py`` — the
    payoff the reference gets from Spark's parquet min/max pruning, as
    one vectorized pass over all files at once. Recurses through Project
    and Union, so the Hybrid Scan index side prunes too; non-index
    relations (the appended files) pass through untouched."""
    if not _rangeprune_on(session):
        return plan
    from hyperspace_tpu_torch.indexes import zonemaps

    cache = _serve_cache(session)
    if isinstance(plan, Scan):
        if cache is not None and _cacheable_scan(plan.relation):
            # the serve cache keeps whole decoded files keyed by the
            # complete file set, shared across predicates and narrowed by
            # binary search: pruning a cacheable scan would only split that
            # entry into per-predicate file subsets
            return plan
        return zonemaps.prune_scan_relation(plan, cond, cache)
    if isinstance(plan, Project):
        child = _range_pruned_scan(plan.child, cond, session)
        return plan if child is plan.child else Project(plan.columns, child)
    if isinstance(plan, Union):
        left = _range_pruned_scan(plan.left, cond, session)
        right = _range_pruned_scan(plan.right, cond, session)
        if left is plan.left and right is plan.right:
            return plan
        return Union(left, right)
    return plan


def _pushable_literal(value, arrow_type):
    """Literal in a form pyarrow's parquet filters accept for a column of
    ``arrow_type``, or None when it must not be pushed (type-mismatched
    literals would make the dataset filter error at read time; the
    engine's own mask treats them as never-matching instead)."""
    if value is None or arrow_type is None:
        return None
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        value = value.item()
    if pa.types.is_temporal(arrow_type):
        if pa.types.is_duration(arrow_type):
            # arrow's scalar coercion for timedelta literals does not
            # mirror the engine's tick lowering; not pushing is safe
            return None
        if getattr(arrow_type, "tz", None) is not None:
            # tz-aware columns: arrow refuses naive-vs-aware comparisons
            return None
        # only literals exactly representable in the column type: ±inf
        # clamps and between-tick values would overflow/err in arrow's cast
        if not isinstance(E.lower_literal(value, arrow_type), np.int64):
            return None
        return E.normalize_temporal_literal(value, arrow_type)
    if pa.types.is_boolean(arrow_type):
        return value if isinstance(value, bool) else None
    if pa.types.is_integer(arrow_type) or pa.types.is_floating(arrow_type):
        if isinstance(value, bool):
            return int(value)  # engine: flag == True matches 1
        if isinstance(value, int):
            # arrow converts through C long: out-of-int64-range literals
            # raise there; the engine treats them as never-matching
            if not (-(2**63) <= value < 2**63):
                return None
            return value
        return value if isinstance(value, float) else None
    t = arrow_type
    if pa.types.is_dictionary(t):
        t = t.value_type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return value if isinstance(value, str) else None
    return None


def _pushdown_filters(cond: E.Expr, rel):
    """Pyarrow DNF filter (single conjunction) from the predicate's
    simple conjuncts.

    Sound under the ROW-LEVEL-superset invariant (``io/parquet.read_table``):
    every pushed conjunct keeps a superset of the rows the engine's own
    mask keeps — only plain col-op-literal and IN with exactly
    representable literals qualify, and the executor re-applies the full
    mask after the read. On a key-sorted index bucket this turns a point
    lookup into a read of the row group whose min/max covers the key.
    """
    if rel.fmt not in pio.PARQUET_FAMILY:
        return None
    cols = {c.lower(): c for c in rel.column_names}
    out = []
    for cj in E.split_conjuncts(cond):
        norm = E.normalize_comparison(cj)
        if norm is not None:
            op, name, lit = norm
            col = cols.get(name.lower())
            if col is None:
                continue
            lit = _pushable_literal(lit, rel.schema[col])
            if lit is None:
                continue
            out.append((col, op if op != "=" else "==", lit))
        elif isinstance(cj, E.In) and isinstance(cj.child, E.Col):
            col = cols.get(cj.child.name.lower())
            if col is None:
                continue
            vals = [
                lv
                for v in cj.values
                if v is not None
                for lv in [_pushable_literal(v, rel.schema[col])]
                if lv is not None
            ]
            if not vals or len(vals) != len(
                [v for v in cj.values if v is not None]
            ):
                continue  # partial lists would under-keep: skip
            out.append((col, "in", vals))
    return out or None


def _filter_mask(cond: E.Expr, batch: ColumnarBatch, session) -> np.ndarray:
    """The predicate's mask, evaluated on the session's device: a
    conjunction of numeric range terms through the fused range mask
    (kernel B3a) when range pruning is on, else the general device mask;
    the host evaluator only for what the lowering refuses."""
    if _rangeprune_on(session):
        mask = fused_range_mask(cond, batch, session.device)
        if mask is not None:
            session.exec_stats.fused_range_masks += 1
            return mask
    try:
        mask = device_filter_mask(cond, batch, session.device)
    except Unsupported:
        session.exec_stats.host_filter_evals += 1
        return E.filter_mask(cond, batch)
    session.exec_stats.device_filter_evals += 1
    return mask


def _read_cols(rel, cols):
    """The columns to read for ``cols``: with Hybrid Scan's delete
    compensation also the lineage column, which the NOT-IN filter needs
    even when the query does not project it
    (CoveringIndexRuleUtils.scala:244-253)."""
    if rel.excluded_file_ids is not None and DATA_FILE_NAME_ID not in cols:
        return list(cols) + [DATA_FILE_NAME_ID]
    return list(cols)


def _drop_excluded(batch: ColumnarBatch, rel) -> ColumnarBatch:
    """The rows whose lineage id is not among the relation's excluded
    (deleted) source files, in order."""
    if rel.excluded_file_ids is None:
        return batch
    lineage = batch.column(DATA_FILE_NAME_ID).values
    return batch.filter(
        ~np.isin(lineage, np.array(rel.excluded_file_ids, dtype=np.int64))
    )


def _exec_scan(
    plan: Scan, needed: Set[str], session, pushdown=None
) -> ColumnarBatch:
    rel = plan.relation
    cols = [c for c in rel.column_names if c in needed] or rel.column_names[:1]
    read_cols = _read_cols(rel, cols)
    if not rel.files:
        empty = pa.table({c: pa.array([], type=rel.schema[c]) for c in cols})
        return ColumnarBatch.from_arrow(empty)
    if rel.file_row_groups is not None:
        # zone-map row-group narrowing (_range_pruned_scan): read only the
        # surviving row groups; the residual mask the caller applies makes
        # over-reading harmless and under-reading impossible. Pushdown
        # filters do not compose with explicit row-group reads, and the
        # narrowing already did their row-group half.
        table = pio.read_table_row_groups(
            list(rel.files), list(rel.file_row_groups), read_cols, rel.fmt
        )
    else:
        table = pio.read_table(
            list(rel.files), read_cols, rel.fmt, filters=pushdown,
            memory_map=_io_mmap_on(session),
        )
    return _drop_excluded(ColumnarBatch.from_arrow(table), rel).select(cols)


# -- serve cache ---------------------------------------------------------------


def _serve_cache(session):
    """The session's ServeCache, or None when serve-server mode is off."""
    return session.serve_cache


def _serve_stream_on(session) -> bool:
    """Streaming per-bucket join serve (``hyperspace.serve.stream.enabled``,
    default off)."""
    return session.conf.serve_stream_enabled


def _io_mmap_on(session) -> bool:
    """Memory-mapped parquet reads (``hyperspace.io.mmap.enabled``, default
    off)."""
    return session.conf.io_mmap_enabled


# Wave counters of the LAST streamed join in this process, reset at the
# start of each: ``stream_waves`` and ``stream_buckets``. Process-global and
# last-writer-wins, as in the reference: concurrent streamed joins blur the
# attribution, never the rows.
last_stream_stats: Dict[str, int] = {}
_stream_stats_lock = threading.Lock()


def stream_stats_reset() -> None:
    with _stream_stats_lock:
        last_stream_stats.clear()


def _stream_stats_add(key: str, amount: int = 1) -> None:
    with _stream_stats_lock:
        last_stream_stats[key] = last_stream_stats.get(key, 0) + amount


def _scan_cache_entry(rel, needed: Set[str], session):
    """(ScanCacheEntry, cols) of a clean index scan from the serve cache
    (one entry a file set, columns accruing as queries need them), or None
    when serve-server mode is off or the scan is not cacheable."""
    cache = _serve_cache(session)
    if cache is None or not _cacheable_scan(rel):
        return None
    from hyperspace_tpu_torch.execution.serve_cache import ScanCacheEntry, file_fingerprint

    fp = file_fingerprint(rel.files)
    if fp is None:
        return None
    cols = tuple(c for c in rel.column_names if c in needed) or (rel.column_names[0],)
    key = ("scan", fp)
    state = cache.get(key)
    if state is None:
        counts = pio.file_row_counts(list(rel.files))
        segs = []
        pos = 0
        for c in counts:
            segs.append((pos, pos + c))
            pos += c
        state = ScanCacheEntry(segs)
    missing = [c for c in cols if c not in state.columns]
    if missing:
        table = pio.read_table(list(rel.files), missing, rel.fmt)
        new_cols = {c: Column.from_arrow(table.column(c)) for c in missing}
        # copy-on-write publication: never mutate an entry other threads
        # may hold, and merge onto the FRESHEST published entry (a
        # non-counting peek) so a racing thread's new columns survive; the
        # union keeps this thread's stale-entry columns too, which the
        # freshest entry may lack after an evict/recreate race, so the
        # returned entry always covers ``cols``
        latest = cache.peek(key)
        base = latest if latest is not None else state
        stale_extra = {c: col for c, col in state.columns.items() if c not in base.columns}
        state = base.with_new_columns({**stale_extra, **new_cols})
        cache.put(key, state, state.budget_nbytes)
    return state, cols


def _cached_filter(scan: Scan, cond: E.Expr, child_needed: Set[str], session):
    """A Filter∘Scan served from the serve cache, or None when the cache is
    off or the scan is not cacheable (the caller reads as usual). On a
    key-sorted cached column a pinned-key or range conjunct narrows the
    candidate rows by binary search before the whole predicate's mask
    (``_filter_mask``, kernel B3a for range terms) runs over them."""
    hit = _scan_cache_entry(scan.relation, child_needed, session)
    if hit is None:
        return None
    state, cols = hit
    batch = state.batch_for(cols)
    idx = _sorted_narrow(state, cond, scan.relation)
    if idx is not None:
        sub = batch.take(idx)
        return sub.filter(_filter_mask(cond, sub, session))
    return batch.filter(_filter_mask(cond, batch, session))


def _order_preserving(t: pa.DataType) -> bool:
    """Key-rep order is value order: signed ints, temporals, bools (not
    floats, whose reps are a sign-bit view, nor strings, hashed)."""
    return pa.types.is_signed_integer(t) or pa.types.is_temporal(t) or pa.types.is_boolean(t)


def _sorted_narrow(state, cond: E.Expr, rel) -> Optional[np.ndarray]:
    """Candidate row indices (ascending) from the first conjunct that can
    binary-search a segment-sorted cached column, else None.

    The returned set is a SUPERSET of the rows the whole condition keeps
    (the caller applies the full mask over it): equality and IN search by
    key rep hold for every type (equal values have equal reps); range
    conjuncts need rep order to be value order (``_order_preserving``)."""
    cols = {c.lower(): c for c in rel.column_names}
    for cj in E.split_conjuncts(cond):
        col = None
        pts = None  # key reps of = / IN
        bound = None  # (op, rep) of a range conjunct
        norm = E.normalize_comparison(cj)
        if norm is not None:
            op, name, lit = norm
            col = cols.get(name.lower())
            if col is None or lit is None:
                continue
            rep = _literal_key_rep(lit, rel.schema[col])
            if rep is None:
                continue
            if op == "=":
                pts = [rep]
            elif op in ("<", "<=", ">", ">=") and _order_preserving(rel.schema[col]):
                bound = (op, rep)
            else:
                continue
        elif isinstance(cj, E.In) and isinstance(cj.child, E.Col):
            col = cols.get(cj.child.name.lower())
            if col is None:
                continue
            vals = [v for v in cj.values if v is not None]
            if not vals or len(vals) > _MAX_PRUNE_COMBOS:
                continue
            pts = []
            for v in vals:
                rep = _literal_key_rep(v, rel.schema[col])
                if rep is None:
                    pts = None
                    break
                pts.append(rep)
            if pts is None:
                continue
        else:
            continue
        if col not in state.columns:
            continue
        krep, sorted_ok = state.column_state(col)
        if not sorted_ok:
            continue
        parts = []
        for s, e in state.segments:
            seg = krep[s:e]
            if pts is not None:
                for p in set(pts):
                    a = int(np.searchsorted(seg, p, side="left"))
                    b = int(np.searchsorted(seg, p, side="right"))
                    if b > a:
                        parts.append(np.arange(s + a, s + b, dtype=np.int64))
            else:
                op, rep = bound
                if op == "<":
                    a, b = 0, int(np.searchsorted(seg, rep, side="left"))
                elif op == "<=":
                    a, b = 0, int(np.searchsorted(seg, rep, side="right"))
                elif op == ">":
                    a, b = int(np.searchsorted(seg, rep, side="right")), e - s
                else:  # >=
                    a, b = int(np.searchsorted(seg, rep, side="left")), e - s
                if b > a:
                    parts.append(np.arange(s + a, s + b, dtype=np.int64))
        if not parts:
            return np.zeros(0, dtype=np.int64)
        # ascending row order (IN points may interleave within a segment);
        # the ranges are disjoint after the per-point dedup
        return np.sort(np.concatenate(parts))
    return None


# -- joins ---------------------------------------------------------------------


def _exec_join(plan: Join, needed: Set[str], session) -> ColumnarBatch:
    from hyperspace_tpu_torch.execution.join_exec import (
        _stage_add,
        co_bucketed_join_prepared,
        inner_join,
    )

    pairs = E.equi_join_pairs(plan.condition)
    if pairs is None:
        raise HyperspaceException(
            f"Only conjunctive equi-joins are executable: {plan.condition!r}"
        )
    lcols = set(plan.left.output)
    on = [(a, b) if a in lcols else (b, a) for a, b in pairs]
    l_keys = [l for l, _ in on]
    r_keys = [r for _, r in on]
    l_needed = (needed & lcols) | set(l_keys)
    r_needed = (needed & set(plan.right.output)) | set(r_keys)
    stats: dict = {}
    layout = _aligned_bucket_layouts(plan, on)
    if layout is None:
        session.exec_stats.unbucketed_joins += 1
        t0 = time.perf_counter()
        left = _exec(plan.left, l_needed, session)
        right = _exec(plan.right, r_needed, session)
        _stage_add(stats, "scan", t0)
        out = inner_join(left, right, on, session.device, stats)
        session.join_stats = stats
        return out
    # Shuffle-free co-bucketed join (the JoinIndexRule payoff; the
    # physical analogue of Spark SMJ over co-bucketed index scans with
    # no Exchange, JoinIndexRule.scala:619-634): equal buckets are
    # matched pairwise by kernel B4. Prepared sides are kept by the serve
    # cache, so a warm join pays only the match and the assembly.
    session.exec_stats.co_bucketed_joins += 1
    _, l_bucket_cols, r_bucket_cols = layout
    if _serve_stream_on(session):
        # Out-of-core serve: buckets stream through in waves sized by
        # hyperspace.serve.stream.maxBytes, each side's prepared state
        # built, matched and released a wave at a time. None when either
        # side's shape does not stream: the materializing route below runs.
        streamed = _exec_join_streaming(plan, needed, session, layout, on, l_needed,
                                        r_needed, stats)
        if streamed is not None:
            session.join_stats = stats
            return streamed
    sides = (
        (plan.left, l_needed, l_keys, l_bucket_cols),
        (plan.right, r_needed, r_keys, r_bucket_cols),
    )
    # Pipelined serve: both sides prepare concurrently, each into its own
    # stats. Gated on both children being clean index-scan shapes, whose
    # reads share nothing and whose only device work is B1 over a Hybrid
    # Scan's appended rows (``_prepare_delta``, on the scan pool). A
    # self-join whose sides resolve to the same serve-cache entry stays
    # sequential: racing both sides past the shared miss would read and
    # prepare twice what the second side gets from the first side's put.
    rels_l = _joinside_cache_relations(plan.left)
    rels_r = _joinside_cache_relations(plan.right)
    same_cached_side = (
        _serve_cache(session) is not None
        and rels_l is not None
        and rels_l == rels_r
        and l_needed == r_needed
        and l_keys == r_keys
    )
    if (
        _serve_pipeline_on(session)
        and rels_l is not None
        and rels_r is not None
        and not same_cached_side
    ):
        side_stats = ({}, {})
        with ThreadPoolExecutor(max_workers=2, thread_name_prefix="hs-joinside") as pool:
            futs = [
                # carry: contextvars do not cross pool threads, so each
                # side's stage spans join the query's trace through it
                pool.submit(_obs_trace.carry(_prepared_join_side), *side, session, st)
                for side, st in zip(sides, side_stats)
            ]
            lp, rp = (f.result() for f in futs)
        _merge_stats(stats, side_stats)
    else:
        lp, rp = (_prepared_join_side(*side, session, stats) for side in sides)
    joined = None
    if lp is not None and rp is not None:
        joined = co_bucketed_join_prepared(lp, rp, on, session.device, stats,
                                           _serve_mesh(session))
    session.join_stats = stats
    if joined is not None:
        return joined
    return _empty_join(plan, needed, l_keys, r_keys)


def _empty_join(plan: Join, needed: Set[str], l_keys, r_keys) -> ColumnarBatch:
    """The schema-correct empty result of a co-bucketed join."""
    schema = plan.schema()
    out_cols = [c for c in plan.output if c in (needed | set(l_keys) | set(r_keys))]
    return ColumnarBatch.from_arrow(
        pa.table({c: pa.array([], type=schema[c]) for c in out_cols})
    )


def _merge_stats(stats: dict, parts) -> None:
    """Add each side thread's stage seconds into the join's."""
    for st in parts:
        for k, v in st.items():
            stats[k] = stats.get(k, 0.0) + v


def _serve_shards(session) -> int:
    """Shards of the sharded serve tail (``hyperspace.build.shardedTail.
    enabled``, one flag for the build and the serve): the session mesh's
    local shards when the flag is on, else 1. The shard layout is the
    build's bucket ownership (``bucket % D``): each prepare worker takes
    the buckets its shard owns, and the match a contiguous block of
    buckets a shard; the rows come out the same at every count."""
    if not session.conf.build_sharded_tail:
        return 1
    return session.runtime.mesh.local_size


def _serve_mesh(session):
    """The mesh a co-bucketed join matches over (one block of buckets a
    shard, kernel B4 on each shard's device), or None for one device."""
    return session.runtime.mesh if _serve_shards(session) > 1 else None


def _serve_pipeline_on(session) -> bool:
    """Pipelined join serve (``hyperspace.serve.pipeline.enabled``,
    default off)."""
    return session.conf.serve_pipeline_enabled


def _cacheable_scan(rel) -> bool:
    """A clean index scan: index data in a parquet-like format with files
    to read, no row-level delete compensation and no injected partition
    constants (both are query-shaped state that must not leak between
    queries). The serve cache, the fused and the metadata routes take only
    such scans."""
    return (
        rel.index_info is not None
        and rel.fmt in pio.PARQUET_FAMILY
        and rel.excluded_file_ids is None
        and not rel.file_partition_values
        and bool(rel.files)
    )


def _joinside_cache_relations(plan: LogicalPlan):
    """The relations whose file fingerprints key a cacheable prepared join
    side, or None when the child's shape is not cacheable. Two shapes: a
    ``Project*`` chain over a clean index scan, and a ``Project*`` chain
    over a Hybrid Scan append ``Union`` of such a chain and a ``Project*``
    chain over the appended parquet files (keyed on both file sets, so a
    further append or a refresh changes the key). Delete compensation
    (``excluded_file_ids``) breaks the shape. These are also the shapes the
    pipelined join serve takes."""

    def walk(node):
        while isinstance(node, Project):
            node = node.child
        return node

    node = walk(plan)
    if isinstance(node, Scan) and _cacheable_scan(node.relation):
        return [node.relation]
    if isinstance(node, Union):
        left, right = walk(node.left), walk(node.right)
        if (
            isinstance(left, Scan)
            and isinstance(right, Scan)
            and _cacheable_scan(left.relation)
            and right.relation.fmt in pio.PARQUET_FAMILY
            and right.relation.excluded_file_ids is None
            and not right.relation.file_partition_values
            and bool(right.relation.files)
        ):
            return [left.relation, right.relation]
    return None


def _prepared_join_side(
    plan: LogicalPlan, needed: Set[str], key_cols, bucket_cols, session, stats,
):
    """A PreparedJoinSide for one co-bucketed join child, or None for an
    empty side. Served from the serve cache (``("joinside", fps, cols,
    keys)``) when the child is a clean shape (``_joinside_cache_relations``).
    Otherwise: with the pipelined serve on and a clean shape, the
    per-bucket batches flow straight into ``prepare_join_side_pipelined``
    (bucket *i*'s prepare runs while the scan pool still reads bucket
    *i+1*); else the sequential ``_bucket_fetches`` + ``prepare_join_side``.
    A side the cache will keep does not also cache its raw bucketed
    batches: the prepared side holds the same decoded data."""
    from hyperspace_tpu_torch.execution.join_exec import (
        _stage_add,
        prepare_join_side,
        prepare_join_side_pipelined,
    )

    cache = _serve_cache(session)
    key = None
    rels = _joinside_cache_relations(plan)
    if cache is not None and rels is not None:
        from hyperspace_tpu_torch.execution.serve_cache import file_fingerprint

        fps = tuple(file_fingerprint(r.files) for r in rels)
        if None not in fps:
            key = ("joinside", fps, tuple(sorted(needed)), tuple(key_cols))
            hit = cache.get(key)
            if hit is not None:
                return hit
    t0 = time.perf_counter()
    if _serve_pipeline_on(session) and rels is not None and (cache is None or key is not None):
        fetches = _bucket_fetches(plan, needed, session, True, bucket_cols, stats)
        _stage_add(stats, "scan", t0)
        shards = _serve_shards(session)
        if shards > 1:
            prep = prepare_join_side_pipelined(fetches, key_cols, stats, num_shards=shards)
        else:
            prep = prepare_join_side_pipelined(fetches, key_cols, stats)
    else:
        delta: dict = {}
        fetches = _bucket_fetches(plan, needed, session, False, bucket_cols, delta,
                                  cache_scan=key is None)
        batches = {b: fetch() for b, fetch in fetches}
        _stage_add(stats, "scan", t0)
        # the appended rows' hashing ran inside this window: it is prepare
        moved = delta.get("prepare", 0.0)
        stats["scan"] -= moved
        stats["prepare"] = stats.get("prepare", 0.0) + moved
        prep = prepare_join_side(batches, key_cols, stats) if batches else None
    if prep is not None and key is not None:
        prep.sort_perms = {}  # a kept side sorts once (bucket_sort_perm)
        cache.put(key, prep, prep.nbytes)
    return prep


# -- the streaming join serve ----------------------------------------------------


def _stream_side_probe(plan: LogicalPlan, needed: Set[str], session, bucket_cols):
    """The wave-streamable decomposition of one join side, or None when its
    shape does not stream (the caller takes the materializing route): a
    ``Project*`` chain over a clean multi-file bucketed index scan,
    optionally through one Hybrid Scan append ``Union`` whose appended
    rows are split by bucket once up front (``_prepare_delta``; capped by
    the Hybrid Scan ratio, so fixed residency across waves). Reads only
    parquet footers: the per-bucket row counts seed the wave planner."""
    sel_chain = []  # the Project selects, outermost first
    node = plan
    nd = set(needed)
    while isinstance(node, Project):
        cols = [c for c in node.columns if c in nd] or node.columns
        sel_chain.append(cols)
        nd = set(cols)
        node = node.child
    read_cols = None
    delta_parts = None
    inner_chain = []
    if isinstance(node, Union):
        cols = [c for c in node.output if c in nd] or node.output[:1]
        read_cols = sorted(set(cols) | set(bucket_cols))
        spec = _bucket_layout(node.left)
        if spec is None:
            return None
        delta_parts = _prepare_delta(
            node.right, read_cols, session, bucket_cols, spec[0], None, _serve_cache(session)
        )
        inner = node.left
        nd = set(read_cols)
        while isinstance(inner, Project):
            cols = [c for c in inner.columns if c in nd] or inner.columns
            inner_chain.append(cols)
            nd = set(cols)
            inner = inner.child
        node = inner
    if not isinstance(node, Scan):
        return None
    rel = node.relation
    groups: dict = {}
    for f, b in zip(rel.files, _bucket_ids_of_files(rel.files)):
        groups.setdefault(b, []).append(f)
    streamable = (
        rel.fmt in pio.PARQUET_FAMILY
        and rel.excluded_file_ids is None
        and not rel.file_partition_values
        and len(rel.files) > 1
        and None not in groups
    )
    if not streamable:
        return None
    scan_cols = [c for c in rel.column_names if c in nd] or rel.column_names[:1]
    all_files = [f for b in sorted(groups) for f in groups[b]]
    rows_of = dict(zip(all_files, pio.file_row_counts(all_files)))
    bucket_rows = {b: sum(rows_of[f] for f in groups[b]) for b in groups}
    return {
        "rel": rel,
        "groups": groups,
        "scan_cols": scan_cols,
        "bucket_rows": bucket_rows,
        "sel_chain": sel_chain,
        "inner_chain": inner_chain,
        "read_cols": read_cols,
        "delta_parts": delta_parts,
    }


def _stream_side_bytes(state) -> Dict[int, int]:
    """Estimated decoded bytes a bucket for the wave packing: footer row
    counts x projected columns x 8 for the scan part (a planning estimate;
    strings cost more, and the prepared side's reps and combined keys ride
    on top), plus the real size of any delta part in the bucket."""
    est = {b: r * len(state["scan_cols"]) * 8 for b, r in state["bucket_rows"].items()}
    if state["delta_parts"]:
        from hyperspace_tpu_torch.execution.serve_cache import batch_nbytes

        for b, part in state["delta_parts"].items():
            est[b] = est.get(b, 0) + batch_nbytes(part)
    return est


def _select_chain(batch: ColumnarBatch, chain) -> ColumnarBatch:
    for cols in reversed(chain):
        batch = batch.select([c for c in cols if c in batch.column_names])
    return batch


def _stream_wave_side(state, wave, session, stats):
    """One wave of one side. The clean-scan shape gives ``(batch, buckets,
    sizes)``: one read of the wave's files whose decoded table IS the
    bucket-ordered concatenation, for ``prepare_join_side_contiguous``. The
    Hybrid Scan ``Union`` shape gives a per-bucket dict: the index slices
    merged with the delta parts, as ``_bucket_fetches``' Union merges
    them."""
    from hyperspace_tpu_torch.execution.join_exec import _stage_add

    groups = state["groups"]
    rel = state["rel"]
    in_scan = [b for b in wave if b in groups]
    table = None
    if in_scan:
        files = [f for b in in_scan for f in groups[b]]
        t0 = time.perf_counter()
        table = pio.read_table(files, state["scan_cols"], rel.fmt,
                               memory_map=_io_mmap_on(session))
        _stage_add(stats, "scan", t0)
    if state["read_cols"] is None:
        # clean index scan: decode the wave's read once, select once
        t0 = time.perf_counter()
        batch = _select_chain(ColumnarBatch.from_arrow(table), state["sel_chain"])
        _stage_add(stats, "prepare", t0)
        return batch, in_scan, [state["bucket_rows"][b] for b in in_scan]
    t0 = time.perf_counter()
    out = {}
    pos = 0
    for b in in_scan:
        c = state["bucket_rows"][b]
        bb = _select_chain(ColumnarBatch.from_arrow(table.slice(pos, c)), state["inner_chain"])
        pos += c
        out[b] = bb.select(state["read_cols"])
    for b in wave:
        part = state["delta_parts"].get(b)
        if part is not None:
            out[b] = ColumnarBatch.concat([out[b], part]) if b in out else part
    out = {b: _select_chain(bb, state["sel_chain"]) for b, bb in out.items()}
    _stage_add(stats, "prepare", t0)
    return out


def _stream_wave_prepared(state, wave, key_cols, session, stats):
    """PreparedJoinSide of one side's wave (None for an empty wave)."""
    from hyperspace_tpu_torch.execution.join_exec import (
        prepare_join_side,
        prepare_join_side_contiguous,
    )

    side = _stream_wave_side(state, wave, session, stats)
    if isinstance(side, dict):
        return prepare_join_side(side, key_cols, stats) if side else None
    batch, buckets, sizes = side
    return prepare_join_side_contiguous(batch, tuple(buckets), sizes, key_cols, stats)


def pack_waves(est: Dict[int, int], budget: int) -> list:
    """Buckets in ascending order packed greedily into waves whose summed
    estimate stays within ``budget``; a bucket over it is a wave alone."""
    waves = []
    cur: list = []
    cur_bytes = 0
    for b in sorted(est):
        if cur and cur_bytes + est[b] > budget:
            waves.append(cur)
            cur, cur_bytes = [], 0
        cur.append(b)
        cur_bytes += est[b]
    if cur:
        waves.append(cur)
    return waves


def _exec_join_streaming(plan: Join, needed: Set[str], session, layout, on, l_needed,
                         r_needed, stats):
    """Streaming per-bucket join serve: the bucket is the unit of
    residency. The buckets both sides hold are packed into WAVES whose
    estimated decoded bytes across both sides fit
    ``hyperspace.serve.stream.maxBytes`` (a bucket over the budget runs as
    a wave of its own: correctness never depends on the estimate). Each
    wave is read and prepared (the two sides on two threads), matched by
    kernel B4 on the session's device and RELEASED before the next wave's
    read, so the prepared state held at once is one wave's, not the
    join's. Wave outputs concatenate in ascending bucket order: the
    materializing route's rows in order (buckets are independent, and each
    wave's null sentinels and sortedness are decided as for a whole side).
    None when either side's shape does not stream. The serve cache's
    joinside and bucketed entries are not used: streaming is for sides too
    large to keep. A B4 fault inside a wave propagates (ROADMAP C.7)."""
    from hyperspace_tpu_torch.execution.join_exec import _stage_add, co_bucketed_join_prepared

    _, l_bucket_cols, r_bucket_cols = layout
    l_state = _stream_side_probe(plan.left, l_needed, session, l_bucket_cols)
    if l_state is None:
        return None
    r_state = _stream_side_probe(plan.right, r_needed, session, r_bucket_cols)
    if r_state is None:
        return None
    stream_stats_reset()
    l_keys = [l for l, _ in on]
    r_keys = [r for _, r in on]
    l_est = _stream_side_bytes(l_state)
    r_est = _stream_side_bytes(r_state)
    # only buckets on BOTH sides can give pairs; one-sided buckets are
    # never read (the materializing route reads them and drops them)
    common = sorted(set(l_est) & set(r_est))
    waves = pack_waves({b: l_est[b] + r_est[b] for b in common},
                       session.conf.serve_stream_max_bytes)
    parts = []
    if waves:
        with ThreadPoolExecutor(max_workers=2, thread_name_prefix="hs-stream") as side_pool:
            for wave in waves:
                t0 = time.perf_counter()
                side_stats = ({}, {})
                fl = side_pool.submit(_obs_trace.carry(_stream_wave_prepared), l_state, wave,
                                      l_keys, session, side_stats[0])
                fr = side_pool.submit(_obs_trace.carry(_stream_wave_prepared), r_state, wave,
                                      r_keys, session, side_stats[1])
                lp, rp = fl.result(), fr.result()
                _merge_stats(stats, side_stats)
                joined = (
                    co_bucketed_join_prepared(lp, rp, on, session.device, stats,
                                              _serve_mesh(session))
                    if lp is not None and rp is not None
                    else None
                )
                if joined is not None:
                    parts.append(joined)
                # the wave's prepared sides go here: the wave, not the join,
                # is the high-water mark
                lp = rp = None
                _stream_stats_add("stream_waves")
                _stream_stats_add("stream_buckets", len(wave))
                _stage_add(stats, "stream_wave", t0)
    if parts:
        return ColumnarBatch.concat(parts)
    return _empty_join(plan, needed, l_keys, r_keys)


def _bucket_layout(plan: LogicalPlan):
    """(num_buckets, bucket_cols) if the subtree preserves a bucketed scan
    layout (Scan with bucket_spec under Filter/Project/Union)."""
    if isinstance(plan, Scan):
        return plan.relation.bucket_spec
    if isinstance(plan, Filter):
        return _bucket_layout(plan.child)
    if isinstance(plan, Project):
        spec = _bucket_layout(plan.child)
        if spec and all(c in plan.columns for c in spec[1]):
            return spec
        return None
    if isinstance(plan, Union):
        # Hybrid Scan: the index side (left) defines the layout; the
        # appended side is bucketed at execution time
        return _bucket_layout(plan.left)
    return None


def _aligned_bucket_layouts(plan: Join, on):
    """Both sides bucketed, same count, and bucket columns positionally
    aligned through the join mapping (order matters: the bucket hash chains
    over columns in order — mirroring Spark's order-sensitive
    HashPartitioning compatibility)."""
    l_spec = _bucket_layout(plan.left)
    r_spec = _bucket_layout(plan.right)
    if not l_spec or not r_spec:
        return None
    (ln, lcols), (rn, rcols) = l_spec, r_spec
    if ln != rn or len(lcols) != len(rcols):
        return None
    mapping = dict(on)
    for lc, rc in zip(lcols, rcols):
        if mapping.get(lc) != rc:
            return None
    return ln, tuple(lcols), tuple(rcols)


def _prepare_delta(
    plan: LogicalPlan, read_cols, session, bucket_cols, num_buckets: int, stats, cache=None
):
    """Per-bucket parts of the Hybrid Scan appended-files delta: the
    appended source rows, hashed into the index's bucket layout by kernel
    B1 on the session's device and split by bucket, each part in row
    order: the execution-time equivalent of the reference's on-the-fly
    shuffle of appended data (CoveringIndexRuleUtils.
    transformPlanToShuffleUsingBucketSpec:357-417). The hashing and the
    split count as ``prepare`` in ``stats``.

    With a serve ``cache`` (the pipelined and streamed routes pass the
    session's) the parts are kept under the delta's FILE FINGERPRINT (with
    the columns, bucket columns and bucket count): appended source files
    are immutable once written and a further append changes the file set,
    so repeated Hybrid Scan joins pay only the per-bucket merge."""
    from hyperspace_tpu_torch.execution.join_exec import _stage_add

    key = None
    if cache is not None:
        node = plan
        while isinstance(node, Project):
            node = node.child
        if (
            isinstance(node, Scan)
            and node.relation.excluded_file_ids is None
            and not node.relation.file_partition_values
            and node.relation.files
        ):
            from hyperspace_tpu_torch.execution.serve_cache import file_fingerprint

            fp = file_fingerprint(node.relation.files)
            if fp is not None:
                key = ("delta", fp, tuple(read_cols), tuple(bucket_cols), num_buckets)
                hit = cache.get(key)
                if hit is not None:
                    return hit
    appended = _exec(plan, set(read_cols), session).select(read_cols)
    t0 = time.perf_counter()
    parts = {}
    if appended.num_rows:
        reps = torch.from_numpy(appended.key_reps(list(bucket_cols))).to(session.device)
        bids = bucket_ids(reps, num_buckets).cpu().numpy()
        for b in np.unique(bids):
            parts[int(b)] = appended.filter(bids == b)
    _stage_add(stats, "prepare", t0)
    if key is not None:
        from hyperspace_tpu_torch.execution.serve_cache import batch_nbytes

        cache.put(key, dict(parts), sum(batch_nbytes(p) for p in parts.values()))
    return parts


def _bucket_fetches(
    plan: LogicalPlan, needed: Set[str], session, stream: bool, bucket_cols, stats,
    cache_scan: bool = True,
):
    """Execute a linear subtree over a bucketed index scan into ordered
    ``[(bucket, fetch)]`` pairs, ``fetch()`` giving the bucket's batch:
    bucket id from each file's name, a bucket's rows in file order. The
    files are read one table each on a thread pool before this returns;
    with ``stream`` (the pipelined join serve) one read a bucket goes to
    the shared scan pool (``io/scan.scan_pool``) instead, and each fetch
    waits for its own. Over a Hybrid Scan ``Union`` each bucket's
    appended part (``_prepare_delta``) follows its index rows, and a
    bucket only the appended rows reach comes in bucket order; streamed,
    the delta prepares on the scan pool while the index side reads. The
    batches are the same either way.

    On the sequential route with the serve cache on, a clean multi-file
    index scan's per-bucket batches are kept under ``("bucketed", fp,
    cols)`` (``cache_scan``; off where the prepared side itself is kept)."""
    if isinstance(plan, Scan):
        rel = plan.relation
        groups: dict = {}
        for f, b in zip(rel.files, _bucket_ids_of_files(rel.files)):
            if b is None:
                raise HyperspaceException(f"Not a bucket file: {f}")
            groups.setdefault(b, []).append(f)
        cols = [c for c in rel.column_names if c in needed] or rel.column_names[:1]
        read_cols = _read_cols(rel, cols)
        buckets = sorted(groups)
        mmap = _io_mmap_on(session)
        cache = _serve_cache(session)
        key = None
        if (not stream and cache_scan and cache is not None and _cacheable_scan(rel)
                and len(rel.files) > 1):
            from hyperspace_tpu_torch.execution.serve_cache import file_fingerprint

            fp = file_fingerprint(rel.files)
            if fp is not None:
                key = ("bucketed", fp, tuple(cols))
                hit = cache.get(key)
                if hit is not None:
                    return [(b, lambda bb=hit[b]: bb) for b in sorted(hit)]
        if stream:
            from hyperspace_tpu_torch.io.scan import scan_pool

            pool = scan_pool()
            read = _obs_trace.carry(pio.read_tables)
            reads = [pool.submit(read, groups[b], read_cols, rel.fmt, mmap).result
                     for b in buckets]
        else:
            ordered = [f for b in buckets for f in groups[b]]
            tables = iter(pio.read_tables(ordered, read_cols, rel.fmt, mmap))
            parts = [[next(tables) for _ in groups[b]] for b in buckets]
            reads = [lambda ts=ts: ts for ts in parts]
        if key is not None:
            from hyperspace_tpu_torch.execution.serve_cache import batch_nbytes

            out = {
                b: _drop_excluded(ColumnarBatch.from_arrow(pa.concat_tables(read())), rel)
                .select(cols)
                for b, read in zip(buckets, reads)
            }
            cache.put(key, dict(out), sum(batch_nbytes(bb) for bb in out.values()))
            return [(b, lambda bb=out[b]: bb) for b in buckets]

        def decode(read):
            return lambda: _drop_excluded(
                ColumnarBatch.from_arrow(pa.concat_tables(read())), rel
            ).select(cols)

        return [(b, decode(read)) for b, read in zip(buckets, reads)]
    if isinstance(plan, Filter):
        child_needed = set(needed) | E.references(plan.condition)

        def filtered(fetch):
            def run():
                batch = fetch()
                return batch.filter(_filter_mask(plan.condition, batch, session))

            return run

        return [
            (b, filtered(fetch))
            for b, fetch in _bucket_fetches(
                plan.child, child_needed, session, stream, bucket_cols, stats, cache_scan
            )
        ]
    if isinstance(plan, Project):
        cols = [c for c in plan.columns if c in needed] or plan.columns

        def project(fetch):
            def run():
                batch = fetch()
                return batch.select([c for c in cols if c in batch.column_names])

            return run

        return [
            (b, project(fetch))
            for b, fetch in _bucket_fetches(
                plan.child, set(cols), session, stream, bucket_cols, stats, cache_scan
            )
        ]
    if isinstance(plan, Union):
        cols = [c for c in plan.output if c in needed] or plan.output[:1]
        read_cols = sorted(set(cols) | set(bucket_cols))
        num_buckets = _bucket_layout(plan.left)[0]
        if stream:
            from hyperspace_tpu_torch.io.scan import scan_pool

            # submitted first, so it takes a pool worker at once and runs
            # beside the index side's bucket reads queued after it
            delta_stats: dict = {}
            delta_fut = scan_pool().submit(
                _obs_trace.carry(_prepare_delta), plan.right, read_cols, session, bucket_cols,
                num_buckets, delta_stats, _serve_cache(session),
            )
            collected = []

            def delta_parts():
                parts = delta_fut.result()
                if not collected:  # the consumer thread, once
                    collected.append(True)
                    for k, v in delta_stats.items():
                        stats[k] = stats.get(k, 0.0) + v
                return parts
        else:
            parts = _prepare_delta(
                plan.right, read_cols, session, bucket_cols, num_buckets, stats
            )

            def delta_parts():
                return parts

        left = {
            b: fetch
            for b, fetch in _bucket_fetches(
                plan.left, set(read_cols), session, stream, bucket_cols, stats, cache_scan
            )
        }

        def merged(b):
            def run():
                part = delta_parts().get(b)
                if b not in left:
                    return part
                batch = left[b]().select(read_cols)
                return batch if part is None else ColumnarBatch.concat([batch, part])

            return run

        # with every bucket on the index side (the normal state) the
        # delta cannot add one, so the streamed prepare need not wait for
        # it before its first bucket
        if stream and len(left) == num_buckets:
            all_buckets = sorted(left)
        else:
            all_buckets = sorted(set(left) | set(delta_parts()))
        return [(b, merged(b)) for b in all_buckets]
    raise HyperspaceException(
        f"Node not supported in bucketed execution: {type(plan).__name__}"
    )
