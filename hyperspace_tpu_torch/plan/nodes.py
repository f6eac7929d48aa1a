"""Logical plan nodes: Scan / Filter / Project / Join / Aggregate / Sort / Limit.

Counterpart of ``hyperspace_tpu/plan/nodes.py``. In the reference these are
Catalyst's ``LogicalRelation``, ``Filter``, ``Project``, ``Join``,
``Aggregate``, ``Sort`` and ``GlobalLimit``, matched against in
``covering/FilterIndexRule.scala:33-55`` (Filter[→Project] over a
relation) and ``covering/JoinIndexRule.scala:122-170`` (inner equi-join of
linear children). The reference delegates aggregate, sort and limit
execution to Spark; here the engine is the serve path, so they are
first-class plan nodes. Plans are immutable; rewrites build new trees.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import expressions as E


class LogicalPlan:
    """Base node. ``output`` is the ordered list of column names; ``schema``
    maps name -> pyarrow type."""

    @property
    def children(self) -> List["LogicalPlan"]:
        return []

    @property
    def output(self) -> List[str]:
        raise NotImplementedError

    def schema(self) -> Dict[str, pa.DataType]:
        raise NotImplementedError

    # -- traversal ----------------------------------------------------------
    def collect_leaves(self) -> List["Scan"]:
        if isinstance(self, Scan):
            return [self]
        out: List[Scan] = []
        for c in self.children:
            out.extend(c.collect_leaves())
        return out

    def transform_up(self, fn) -> "LogicalPlan":
        """Bottom-up rewrite: fn(node_with_new_children) -> node."""
        node = self.with_children([c.transform_up(fn) for c in self.children])
        return fn(node)

    def with_children(self, children: List["LogicalPlan"]) -> "LogicalPlan":
        if not children:
            return self
        raise NotImplementedError

    def pretty(self, indent: int = 0) -> str:
        s = "  " * indent + self._node_string()
        for c in self.children:
            s += "\n" + c.pretty(indent + 1)
        return s

    def _node_string(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.pretty()


@dataclasses.dataclass(frozen=True)
class Relation:
    """A file-based source snapshot a Scan reads.

    The planner-side analogue of the reference's ``FileBasedRelation``
    (``sources/interfaces.scala:43-277``): root paths + concrete data files
    + schema + format. ``index_info`` is set when this relation *is* an
    index's data (the rewrite target state, like ``IndexHadoopFsRelation``,
    ``plans/logical/IndexHadoopFsRelation.scala:29-53``).
    """

    root_paths: Tuple[str, ...]
    files: Tuple[str, ...]
    fmt: str
    schema_fields: Tuple[Tuple[str, pa.DataType], ...]
    options: Tuple[Tuple[str, str], ...] = ()
    index_info: Optional[Tuple[str, int, str]] = None  # (name, log_version, abbr)
    bucket_spec: Optional[Tuple[int, Tuple[str, ...]]] = None  # (numBuckets, cols)
    # query-time row-level compensation (Hybrid Scan deletes): lineage ids
    # whose rows the scan drops, None if not needed
    excluded_file_ids: Optional[Tuple[int, ...]] = None
    # hive-style partitioned sources (e.g. partitioned Delta): per file, the
    # partition column values that are NOT stored in the data file and must
    # be injected as constants at scan time: (path, ((col, str_value),...)).
    # As in the reference, no reader fills it yet (ROADMAP C.15).
    file_partition_values: Tuple[
        Tuple[str, Tuple[Tuple[str, Optional[str]], ...]], ...
    ] = ()
    # query-time row-group pruning (zone maps, executor._range_pruned_scan):
    # aligned with ``files``; per file either None (read every row group)
    # or the ascending row-group indices to read. None for the whole field
    # means no narrowing anywhere. Set only by the range-pruning pass on a
    # Filter's direct scan: the selection is query-shaped state.
    file_row_groups: Optional[Tuple[Optional[Tuple[int, ...]], ...]] = None

    @property
    def schema(self) -> Dict[str, pa.DataType]:
        return dict(self.schema_fields)

    @property
    def column_names(self) -> List[str]:
        return [n for n, _ in self.schema_fields]


class Scan(LogicalPlan):
    def __init__(self, relation: Relation):
        self.relation = relation

    @property
    def output(self) -> List[str]:
        return self.relation.column_names

    def schema(self) -> Dict[str, pa.DataType]:
        return self.relation.schema

    def with_children(self, children):
        assert not children
        return self

    def _node_string(self):
        r = self.relation
        if r.index_info:
            name, ver, abbr = r.index_info
            return (
                f"Scan Hyperspace(Type: {abbr}, Name: {name}, "
                f"LogVersion: {ver}) [{', '.join(self.output)}]"
            )
        roots = ",".join(r.root_paths)
        return f"Scan {r.fmt} {roots} [{', '.join(self.output)}]"


class Filter(LogicalPlan):
    def __init__(self, condition: E.Expr, child: LogicalPlan):
        self.condition = condition
        self.child = child

    @property
    def children(self):
        return [self.child]

    @property
    def output(self):
        return self.child.output

    def schema(self):
        return self.child.schema()

    def with_children(self, children):
        (c,) = children
        return Filter(self.condition, c)

    def _node_string(self):
        return f"Filter {self.condition!r}"


class Project(LogicalPlan):
    def __init__(self, columns: Sequence[str], child: LogicalPlan):
        missing = [c for c in columns if c not in child.output]
        if missing:
            raise HyperspaceException(
                f"Cannot project {missing}; child outputs {child.output}"
            )
        self.columns = list(columns)
        self.child = child

    @property
    def children(self):
        return [self.child]

    @property
    def output(self):
        return list(self.columns)

    def schema(self):
        s = self.child.schema()
        return {c: s[c] for c in self.columns}

    def with_children(self, children):
        (c,) = children
        return Project(self.columns, c)

    def _node_string(self):
        return f"Project [{', '.join(self.columns)}]"


class Union(LogicalPlan):
    """Same-schema union (no dedup), for Hybrid Scan: the index data and
    the appended source files read side by side, the logical role of the
    reference's ``BucketUnion`` (``plans/logical/BucketUnion.scala:31-68``).
    Bucket alignment of the appended rows happens at execution time."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan):
        if list(left.output) != list(right.output):
            raise HyperspaceException(
                f"Union children must align: {left.output} vs {right.output}"
            )
        self.left = left
        self.right = right

    @property
    def children(self):
        return [self.left, self.right]

    @property
    def output(self):
        return self.left.output

    def schema(self):
        return self.left.schema()

    def with_children(self, children):
        left, right = children
        return Union(left, right)

    def _node_string(self):
        return "Union"


class Join(LogicalPlan):
    """Inner equi-join (the only join type JoinIndexRule handles;
    ``JoinIndexRule.scala:155-162`` requires inner + equi-CNF)."""

    def __init__(
        self,
        left: LogicalPlan,
        right: LogicalPlan,
        condition: E.Expr,
        how: str = "inner",
    ):
        if how != "inner":
            raise HyperspaceException(f"Unsupported join type: {how}")
        self.left = left
        self.right = right
        self.condition = condition
        self.how = how
        dup = set(left.output) & set(right.output)
        if dup:
            raise HyperspaceException(
                f"Ambiguous join output columns: {sorted(dup)}; "
                "project/rename before joining"
            )

    @property
    def children(self):
        return [self.left, self.right]

    @property
    def output(self):
        return self.left.output + self.right.output

    def schema(self):
        s = dict(self.left.schema())
        s.update(self.right.schema())
        return s

    def with_children(self, children):
        left, right = children
        return Join(left, right, self.condition, self.how)

    def _node_string(self):
        return f"Join {self.how} on {self.condition!r}"


_AGG_FUNCS = ("sum", "count", "min", "max", "avg")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate output: ``func(column) AS alias``. ``column`` is None
    for ``count(*)``."""

    func: str
    column: Optional[str]
    name: str

    def __post_init__(self):
        if self.func not in _AGG_FUNCS:
            raise HyperspaceException(
                f"Unknown aggregate {self.func!r}; supported: {_AGG_FUNCS}"
            )
        if self.column is None and self.func != "count":
            raise HyperspaceException(f"{self.func}(*) is not defined")

    def __repr__(self):
        arg = "*" if self.column is None else self.column
        return f"{self.func}({arg}) AS {self.name}"

    def alias(self, name: str) -> "AggSpec":
        return dataclasses.replace(self, name=name)


def _is_string_type(t: pa.DataType) -> bool:
    if pa.types.is_dictionary(t):
        t = t.value_type
    return pa.types.is_string(t) or pa.types.is_large_string(t)


def _agg_output_type(spec: AggSpec, child_schema) -> pa.DataType:
    """Output type, validating the input type at PLAN time (execution must
    never be the first place an unsupported agg/type pairing surfaces)."""
    if spec.func == "count":
        return pa.int64()
    t = child_schema[spec.column]
    numeric = pa.types.is_floating(t) or pa.types.is_integer(t)
    if spec.func == "avg":
        # booleans are NOT summable/averageable (Spark rejects
        # sum/avg(boolean) at analysis time); min/max(bool) stays legal
        if not numeric:
            raise HyperspaceException(
                f"avg() over non-numeric column {spec.column!r} ({t})"
            )
        return pa.float64()
    if spec.func == "sum":
        if not numeric:
            raise HyperspaceException(
                f"sum() over non-numeric column {spec.column!r} ({t})"
            )
        return pa.float64() if pa.types.is_floating(t) else pa.int64()
    numeric = numeric or pa.types.is_boolean(t)
    # min/max preserve the input type; orderable = numeric/temporal/string
    if not (
        numeric
        or pa.types.is_temporal(t)
        or _is_string_type(t)
    ):
        raise HyperspaceException(
            f"{spec.func}() over unorderable column {spec.column!r} ({t})"
        )
    return t


class Aggregate(LogicalPlan):
    """Hash aggregate: ``group_by`` key columns + aggregate outputs.
    Output order = group columns then aggregate aliases."""

    def __init__(
        self,
        group_by: Sequence[str],
        aggs: Sequence[AggSpec],
        child: LogicalPlan,
    ):
        if not aggs:
            raise HyperspaceException("Aggregate needs at least one aggregate")
        missing = [c for c in group_by if c not in child.output]
        missing += [
            a.column
            for a in aggs
            if a.column is not None and a.column not in child.output
        ]
        if missing:
            raise HyperspaceException(
                f"Cannot aggregate {missing}; child outputs {child.output}"
            )
        names = list(group_by) + [a.name for a in aggs]
        if len(set(names)) != len(names):
            raise HyperspaceException(f"Duplicate aggregate output names: {names}")
        self.group_by = list(group_by)
        self.aggs = list(aggs)
        self.child = child

    @property
    def children(self):
        return [self.child]

    @property
    def output(self):
        return list(self.group_by) + [a.name for a in self.aggs]

    @property
    def input_columns(self) -> set:
        """Child columns this aggregate consumes (keys + agg arguments)."""
        return set(self.group_by) | {
            a.column for a in self.aggs if a.column is not None
        }

    def schema(self):
        s = self.child.schema()
        out = {c: s[c] for c in self.group_by}
        for a in self.aggs:
            out[a.name] = _agg_output_type(a, s)
        return out

    def with_children(self, children):
        (c,) = children
        return Aggregate(self.group_by, self.aggs, c)

    def _node_string(self):
        keys = ", ".join(self.group_by) or "()"
        return f"Aggregate [{keys}] [{', '.join(map(repr, self.aggs))}]"


class Sort(LogicalPlan):
    """Total order by ``keys`` = ((column, ascending), ...). Nulls last."""

    def __init__(self, keys: Sequence[Tuple[str, bool]], child: LogicalPlan):
        if not keys:
            raise HyperspaceException("Sort needs at least one key")
        missing = [c for c, _ in keys if c not in child.output]
        if missing:
            raise HyperspaceException(
                f"Cannot sort by {missing}; child outputs {child.output}"
            )
        self.keys = [(c, bool(asc)) for c, asc in keys]
        self.child = child

    @property
    def children(self):
        return [self.child]

    @property
    def output(self):
        return self.child.output

    def schema(self):
        return self.child.schema()

    def with_children(self, children):
        (c,) = children
        return Sort(self.keys, c)

    def _node_string(self):
        ks = ", ".join(f"{c} {'ASC' if a else 'DESC'}" for c, a in self.keys)
        return f"Sort [{ks}]"


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        if n < 0:
            raise HyperspaceException(f"Limit must be >= 0, got {n}")
        self.n = int(n)
        self.child = child

    @property
    def children(self):
        return [self.child]

    @property
    def output(self):
        return self.child.output

    def schema(self):
        return self.child.schema()

    def with_children(self, children):
        (c,) = children
        return Limit(self.n, c)

    def _node_string(self):
        return f"Limit {self.n}"


def prune_join_columns(plan: LogicalPlan, needed: Optional[set] = None) -> LogicalPlan:
    """Insert explicit Projects above Join children so each side carries
    only the columns used above it.

    The reference's rules run after Catalyst's column pruning, so
    ``JoinIndexRule`` sees minimal child outputs; this pass provides the
    same invariant for our IR. Only Join children are wrapped — existing
    Filter/Project chains are preserved so the Filter-rule plan shapes
    stay matchable.
    """
    if needed is None:
        needed = set(plan.output)
    if isinstance(plan, Project):
        return Project(plan.columns, prune_join_columns(plan.child, set(plan.columns)))
    if isinstance(plan, Filter):
        child_needed = needed | E.references(plan.condition)
        return Filter(plan.condition, prune_join_columns(plan.child, child_needed))
    if isinstance(plan, Aggregate):
        child_needed = plan.input_columns
        pruned = prune_join_columns(plan.child, child_needed)
        # insert the Project Catalyst's ColumnPruning would (above the
        # child chain) so index rules see minimal required columns
        cols = [c for c in pruned.output if c in child_needed]
        if cols and cols != pruned.output:
            pruned = Project(cols, pruned)
        return Aggregate(plan.group_by, plan.aggs, pruned)
    if isinstance(plan, Sort):
        child_needed = needed | {c for c, _ in plan.keys}
        return Sort(plan.keys, prune_join_columns(plan.child, child_needed))
    if isinstance(plan, Limit):
        return Limit(plan.n, prune_join_columns(plan.child, needed))
    if isinstance(plan, Join):
        refs = E.references(plan.condition)
        out = []
        for child in (plan.left, plan.right):
            child_needed = (needed | refs) & set(child.output)
            pruned = prune_join_columns(child, child_needed)
            cols = [c for c in pruned.output if c in child_needed]
            if cols != pruned.output:
                pruned = Project(cols, pruned)
            out.append(pruned)
        return Join(out[0], out[1], plan.condition, plan.how)
    return plan
