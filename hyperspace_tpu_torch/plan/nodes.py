"""Logical plan nodes: Scan / Filter / Project / Join.

Counterpart of ``hyperspace_tpu/plan/nodes.py``, cut to the nodes of the
filter-serve and join-serve slices (Aggregate, Sort, Limit and Union are
ported with their slices, ROADMAP queue A). In the reference these are
Catalyst's ``LogicalRelation``, ``Filter``, ``Project`` and ``Join``,
matched against in ``covering/FilterIndexRule.scala:33-55`` (Filter[→Project]
over a relation) and ``covering/JoinIndexRule.scala:122-170`` (inner
equi-join of linear children). Plans are immutable; rewrites build new
trees.
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
