"""Hyperspace — the user-facing API facade.

Reference: ``Hyperspace.scala:27-193`` and its Python binding
(``python/hyperspace/hyperspace.py:9-192``). Counterpart of
``hyperspace_tpu/hyperspace.py`` for the ported slices: create, list,
one index's statistics and explain.
Index maintenance runs with the query-rewrite rule disabled so
maintenance scans never get rewritten to use the index being maintained
(``ApplyHyperspace.withHyperspaceRuleDisabled``,
rules/ApplyHyperspace.scala:68-75). Delete, restore, vacuum, refresh,
optimize, cancel and recover are ported with the rest of the lifecycle
(ROADMAP queue A); explain's verbose and mode arguments and whyNot with
the tooling (item A.7).
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry


class Hyperspace:
    def __init__(self, session):
        self.session = session
        self._manager = session.index_manager

    def create_index(self, df, index_config) -> None:
        """Build an index over ``df`` (Hyperspace.scala:43-52)."""
        from hyperspace_tpu_torch.rules.apply import hyperspace_rule_disabled

        with hyperspace_rule_disabled():
            self._manager.create(df, index_config)

    def indexes(self) -> pa.Table:
        """Summary table of all indexes: name, indexed and included
        columns, number of buckets, schema, location and state
        (IndexStatistics summary columns, IndexStatistics.scala:58-60)."""
        from hyperspace_tpu_torch.plananalysis.statistics import indexes_summary_table

        return indexes_summary_table(self._manager.get_indexes())

    def index(self, index_name: str) -> pa.Table:
        """Extended statistics of one index (Hyperspace.scala:153-158);
        raises for a missing index."""
        from hyperspace_tpu_torch.plananalysis.statistics import index_stats_table

        entry = self._manager.get_index_log_entry(index_name)
        if entry is None or entry.state == States.DOESNOTEXIST:
            raise HyperspaceException(f"Index not found: {index_name!r}")
        return index_stats_table(entry)

    def get_index(self, index_name: str) -> Optional[IndexLogEntry]:
        """The latest stable log entry of ``index_name``, or None."""
        return self._manager.get_index_log_entry(index_name)

    def explain(self, df) -> str:
        """Plan diff with vs without Hyperspace (PlanAnalyzer.explainString)."""
        from hyperspace_tpu_torch.plananalysis.explain import explain_string

        return explain_string(df, self.session)
