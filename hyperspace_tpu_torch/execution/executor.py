"""Plan executor: walks the (optimized) logical plan and produces Arrow.

Counterpart of ``hyperspace_tpu/execution/executor.py`` for Scan, Filter
and Project. Column pruning and simple conjuncts are pushed into the
parquet read; a filter over a bucketed index scan first drops the bucket
files that cannot hold a match (murmur3 of the literals, kernel B1 on the
session's device); the predicate mask is then evaluated on the session's
device (``ops/filter.py``), with the host evaluator kept for what does not
lower (``Unsupported``) and counted in ``session.exec_stats``.

Rows come out in the reference's order: files in relation order, rows in
file order, the mask applied in place. Not ported yet: joins, aggregates,
sort and limit, zone-map range pruning, the fused serve pipeline, the
serve cache and Hybrid Scan (ROADMAP queue A items 4-7 and 10).
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import lru_cache as _lru_cache
from typing import Set

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.ops.filter import Unsupported, device_filter_mask
from hyperspace_tpu_torch.ops.hash import bucket_ids
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import Filter, LogicalPlan, Project, Scan


def execute(plan: LogicalPlan, session):
    """Execute -> pyarrow.Table (column order = plan.output)."""
    batch = _exec(plan, set(plan.output), session)
    return batch.select(plan.output).to_arrow()


def _exec(plan: LogicalPlan, needed: Set[str], session) -> ColumnarBatch:
    if isinstance(plan, Scan):
        return _exec_scan(plan, needed, session)
    if isinstance(plan, Filter):
        child = _bucket_pruned_scan(plan.child, plan.condition, session)
        child_needed = set(needed) | E.references(plan.condition)
        if isinstance(child, Scan):
            batch = _exec_scan(
                child,
                child_needed,
                session,
                pushdown=_pushdown_filters(plan.condition, child.relation),
            )
        else:
            batch = _exec(child, child_needed, session)
        return batch.filter(_filter_mask(plan.condition, batch, session))
    if isinstance(plan, Project):
        batch = _exec(plan.child, set(plan.columns), session)
        return batch.select(plan.columns)
    raise NotImplementedError(
        f"{type(plan).__name__} is not ported yet (ROADMAP queue A)"
    )


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
    if rel.fmt != "parquet":
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
    """The predicate's mask, evaluated on the session's device; the host
    evaluator only for what the lowering refuses."""
    try:
        mask = device_filter_mask(cond, batch, session.device)
    except Unsupported:
        session.exec_stats.host_filter_evals += 1
        return E.filter_mask(cond, batch)
    session.exec_stats.device_filter_evals += 1
    return mask


def _exec_scan(
    plan: Scan, needed: Set[str], session, pushdown=None
) -> ColumnarBatch:
    rel = plan.relation
    cols = [c for c in rel.column_names if c in needed] or rel.column_names[:1]
    if not rel.files:
        empty = pa.table({c: pa.array([], type=rel.schema[c]) for c in cols})
        return ColumnarBatch.from_arrow(empty)
    table = pio.read_table(list(rel.files), cols, rel.fmt, filters=pushdown)
    return ColumnarBatch.from_arrow(table).select(cols)
