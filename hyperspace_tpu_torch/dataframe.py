"""DataFrame API — the user-facing query surface.

Counterpart of ``hyperspace_tpu/dataframe.py``: filter, select, inner
equi-join, group_by / agg, sort and limit, collect, ``collect_approx``
(the approximate plane, ``execution/approx_exec.py``) and explain. A
DataFrame is a
(session, logical plan) pair; ``collect()`` runs the session's optimizer —
where index rewrites happen when ``enable_hyperspace()`` is on, like the
reference's injected ``ApplyHyperspace`` rule (``package.scala:82-93``) —
then the executor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    AggSpec,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Sort,
)


def _resolve_plan_name(plan: LogicalPlan, name: str) -> str:
    """Map a user-facing name to a plan column. A dotted struct path
    (``nested.leaf.cnt``) resolves to its flattened
    ``__hs_nested.``-prefixed column when present — the query-surface side
    of the reference's nested-field support
    (``util/ResolverUtils.scala:130-234``); a literal column of the same
    dotted name always wins."""
    if name in plan.output:
        return name
    from hyperspace_tpu_torch.constants import NESTED_FIELD_PREFIX

    prefixed = NESTED_FIELD_PREFIX + name
    if prefixed in plan.output:
        return prefixed
    raise HyperspaceException(
        f"No such column {name!r}; available: {plan.output}"
    )


class DataFrame:
    def __init__(self, session, plan: LogicalPlan):
        self._session = session
        self._plan = plan

    # -- schema surface -----------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return self._plan.output

    def schema(self):
        return self._plan.schema()

    @property
    def logical_plan(self) -> LogicalPlan:
        return self._plan

    def _resolve_name(self, name: str) -> str:
        return _resolve_plan_name(self._plan, name)

    def __getitem__(self, name: str) -> E.Col:
        return E.Col(self._resolve_name(name))

    # -- transformations ----------------------------------------------------
    def filter(self, condition: E.Expr) -> "DataFrame":
        if not isinstance(condition, E.Expr):
            raise HyperspaceException("filter() takes an expression")
        return DataFrame(self._session, Filter(condition, self._plan))

    where = filter

    def select(self, *columns: str) -> "DataFrame":
        cols = list(
            columns[0]
            if len(columns) == 1 and isinstance(columns[0], (list, tuple))
            else columns
        )
        cols = [self._resolve_name(c) for c in cols]
        return DataFrame(self._session, Project(cols, self._plan))

    def join(
        self,
        other: "DataFrame",
        on: Union[E.Expr, str, Sequence[str]],
        how: str = "inner",
    ) -> "DataFrame":
        if isinstance(on, (str, list, tuple)):
            raise HyperspaceException(
                "Same-name join keys are ambiguous in this IR; "
                "join with an expression like left['a'] == right['b']"
            )
        return DataFrame(self._session, Join(self._plan, other._plan, on, how))

    def group_by(self, *columns: str) -> "GroupedData":
        cols = list(
            columns[0]
            if len(columns) == 1 and isinstance(columns[0], (list, tuple))
            else columns
        )
        cols = [self._resolve_name(c) for c in cols]
        return GroupedData(self._session, self._plan, cols)

    groupBy = group_by

    def agg(self, *aggs: AggSpec) -> "DataFrame":
        """Global aggregate (no grouping)."""
        return GroupedData(self._session, self._plan, []).agg(*aggs)

    def sort(self, *keys, ascending: Union[bool, Sequence[bool]] = True) -> "DataFrame":
        """``sort("a", "b")`` / ``sort(("a", False), "b")`` /
        ``sort("a", "b", ascending=[False, True])``."""
        names = list(
            keys[0]
            if len(keys) == 1 and isinstance(keys[0], list)
            else keys
        )
        if isinstance(ascending, bool):
            asc = [ascending] * len(names)
        else:
            asc = list(ascending)
            if len(asc) != len(names):
                raise HyperspaceException(
                    "ascending list length must match the number of sort keys"
                )
        resolved = []
        for k, a in zip(names, asc):
            if isinstance(k, tuple):
                resolved.append((self._resolve_name(k[0]), bool(k[1])))
            else:
                resolved.append((self._resolve_name(k), a))
        return DataFrame(self._session, Sort(resolved, self._plan))

    order_by = sort
    orderBy = sort

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._session, Limit(n, self._plan))

    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this DataFrame in the session catalog for
        ``session.sql`` (Spark's createOrReplaceTempView shape)."""
        self._session.register_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    # -- actions ------------------------------------------------------------
    def collect(self) -> pa.Table:
        return self._session.execute(self._plan)

    def collect_approx(self, max_rel_error=None) -> pa.Table:
        """An approximate answer for an ungrouped or single-key grouped
        COUNT/SUM aggregate from the index's stratified row sample, with
        95 % confidence intervals (columns ``x``, ``x_lo``, ``x_hi`` per
        aggregate ``x``; a grouped shape leads with the key column, one row
        a group the sample saw, key-sorted). Opt in with
        ``hyperspace.serve.approx.enabled``; an estimate wider than the
        error budget (``max_rel_error`` or
        ``hyperspace.serve.approx.maxRelativeError``) in any group raises
        ApproximationError."""
        from hyperspace_tpu_torch.execution.approx_exec import approx_aggregate

        return approx_aggregate(self._session, self._plan, max_rel_error)

    def to_arrow(self) -> pa.Table:
        return self.collect()

    def count(self) -> int:
        return self.collect().num_rows

    def explain(self) -> str:
        """Optimized plan string (for the full with/without-index diff use
        ``Hyperspace.explain``)."""
        return self._session.optimize(self._plan).pretty()

    def __repr__(self):
        return f"DataFrame[{', '.join(self.columns)}]"


class GroupedData:
    """Result of ``DataFrame.group_by`` — terminal ``agg(...)`` builds the
    Aggregate node (Spark's ``RelationalGroupedDataset`` shape)."""

    def __init__(self, session, plan: LogicalPlan, group_by: List[str]):
        self._session = session
        self._plan = plan
        self._group_by = group_by

    def agg(self, *aggs: AggSpec) -> DataFrame:
        specs = list(
            aggs[0]
            if len(aggs) == 1 and isinstance(aggs[0], (list, tuple))
            else aggs
        )
        for s in specs:
            if not isinstance(s, AggSpec):
                raise HyperspaceException(
                    f"agg() takes AggSpec values (hyperspace_tpu_torch.functions); "
                    f"got {s!r}"
                )
        specs = [
            s
            if s.column is None
            else dataclasses.replace(
                s, column=_resolve_plan_name(self._plan, s.column)
            )
            for s in specs
        ]
        return DataFrame(
            self._session, Aggregate(self._group_by, specs, self._plan)
        )

    def count(self) -> DataFrame:
        from hyperspace_tpu_torch import functions as F

        return self.agg(F.count())
