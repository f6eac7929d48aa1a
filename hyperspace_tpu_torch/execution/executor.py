"""Plan executor: walks the (optimized) logical plan and produces Arrow.

Counterpart of ``hyperspace_tpu/execution/executor.py`` for Scan, Filter,
Project and inner equi-Join. Column pruning and simple conjuncts are
pushed into the parquet read; a filter over a bucketed index scan first
drops the bucket files that cannot hold a match (murmur3 of the literals,
kernel B1 on the session's device); the predicate mask is then evaluated
on the session's device (``ops/filter.py``), with the host evaluator kept
for what does not lower (``Unsupported``) and counted in
``session.exec_stats``.

A join whose two sides keep aligned bucketed index layouts (the
JoinIndexRule rewrite) runs shuffle-free: each side is executed into
per-bucket batches (bucket id from the file names, rows in file order)
and ``execution/join_exec`` zips equal buckets pairwise, matching them
with kernel B4 (``ops/join.py``) on the session's device. Any other join
runs the unindexed ``inner_join`` through the same kernel as one segment.
``session.exec_stats`` counts both kinds; ``session.join_stats`` holds the
latest join's stage seconds: ``scan`` (both sides read, filtered and
projected) here, the rest in ``join_exec``.

Rows come out in the reference's order: files in relation order, rows in
file order, the mask applied in place; a co-bucketed join's rows bucket
by bucket. Not ported yet: aggregates, sort and limit, zone-map range
pruning, the fused serve pipeline, the serve cache, the pipelined and
streaming join serve, and Hybrid Scan (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from functools import lru_cache as _lru_cache
from typing import Set

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.ops.filter import Unsupported, device_filter_mask
from hyperspace_tpu_torch.ops.hash import bucket_ids
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Project, Scan


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
    if isinstance(plan, Join):
        return _exec_join(plan, needed, session)
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


# -- joins ---------------------------------------------------------------------


def _exec_join(plan: Join, needed: Set[str], session) -> ColumnarBatch:
    from hyperspace_tpu_torch.execution.join_exec import (
        co_bucketed_join_prepared,
        inner_join,
        prepare_join_side,
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
        stats["scan"] = time.perf_counter() - t0
        out = inner_join(left, right, on, session.device, stats)
        session.join_stats = stats
        return out
    # Shuffle-free co-bucketed join (the JoinIndexRule payoff; the
    # physical analogue of Spark SMJ over co-bucketed index scans with
    # no Exchange, JoinIndexRule.scala:619-634): equal buckets are
    # matched pairwise by kernel B4.
    session.exec_stats.co_bucketed_joins += 1
    _num_buckets, l_bucket_cols, r_bucket_cols = layout
    t0 = time.perf_counter()
    lbs = _exec_bucketed(plan.left, l_needed, session, l_bucket_cols)
    rbs = _exec_bucketed(plan.right, r_needed, session, r_bucket_cols)
    stats["scan"] = time.perf_counter() - t0
    joined = None
    if lbs and rbs:
        lp = prepare_join_side(lbs, l_keys, stats)
        rp = prepare_join_side(rbs, r_keys, stats)
        joined = co_bucketed_join_prepared(lp, rp, on, session.device, stats)
    session.join_stats = stats
    if joined is not None:
        return joined
    schema = plan.schema()
    out_cols = [c for c in plan.output if c in (needed | set(l_keys) | set(r_keys))]
    return ColumnarBatch.from_arrow(
        pa.table({c: pa.array([], type=schema[c]) for c in out_cols})
    )


def _bucket_layout(plan: LogicalPlan):
    """(num_buckets, bucket_cols) if the subtree preserves a bucketed scan
    layout (Scan with bucket_spec under Filter/Project)."""
    if isinstance(plan, Scan):
        return plan.relation.bucket_spec
    if isinstance(plan, Filter):
        return _bucket_layout(plan.child)
    if isinstance(plan, Project):
        spec = _bucket_layout(plan.child)
        if spec and all(c in plan.columns for c in spec[1]):
            return spec
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


def _exec_bucketed(plan: LogicalPlan, needed: Set[str], session, bucket_cols):
    """Execute a linear subtree over a bucketed index scan into per-bucket
    batches: bucket id from each file's name, a bucket's rows in file
    order. The files are read one table each on a thread pool."""
    if isinstance(plan, Scan):
        rel = plan.relation
        groups: dict = {}
        for f, b in zip(rel.files, _bucket_ids_of_files(rel.files)):
            if b is None:
                raise HyperspaceException(f"Not a bucket file: {f}")
            groups.setdefault(b, []).append(f)
        cols = [c for c in rel.column_names if c in needed] or rel.column_names[:1]
        ordered = [f for b in sorted(groups) for f in groups[b]]
        tables = dict(zip(ordered, pio.read_tables(ordered, cols, rel.fmt)))
        return {
            b: ColumnarBatch.from_arrow(
                pa.concat_tables([tables[f] for f in groups[b]])
            ).select(cols)
            for b in sorted(groups)
        }
    if isinstance(plan, Filter):
        child_needed = set(needed) | E.references(plan.condition)
        return {
            b: batch.filter(_filter_mask(plan.condition, batch, session))
            for b, batch in _exec_bucketed(
                plan.child, child_needed, session, bucket_cols
            ).items()
        }
    if isinstance(plan, Project):
        cols = [c for c in plan.columns if c in needed] or plan.columns
        return {
            b: batch.select([c for c in cols if c in batch.column_names])
            for b, batch in _exec_bucketed(
                plan.child, set(cols), session, bucket_cols
            ).items()
        }
    raise HyperspaceException(
        f"Node not supported in bucketed execution: {type(plan).__name__}"
    )
