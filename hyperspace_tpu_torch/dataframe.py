"""DataFrame API — the user-facing query surface.

Counterpart of ``hyperspace_tpu/dataframe.py`` for this slice: filter,
select, collect and explain (join, group_by, sort and limit are ported with
their slices, ROADMAP queue A). A DataFrame is a (session, logical plan)
pair; ``collect()`` runs the session's optimizer —
where index rewrites happen when ``enable_hyperspace()`` is on, like the
reference's injected ``ApplyHyperspace`` rule (``package.scala:82-93``) —
then the executor.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import Filter, LogicalPlan, Project


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

    # -- actions ------------------------------------------------------------
    def collect(self) -> pa.Table:
        return self._session.execute(self._plan)

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
