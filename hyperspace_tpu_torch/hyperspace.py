"""Hyperspace — the user-facing API facade.

Reference: ``Hyperspace.scala:27-193`` and its Python binding
(``python/hyperspace/hyperspace.py:9-192``). Counterpart of
``hyperspace_tpu/hyperspace.py`` for this slice: create, list and explain.
Index maintenance runs with the query-rewrite rule disabled so
maintenance scans never get rewritten to use the index being maintained
(``ApplyHyperspace.withHyperspaceRuleDisabled``,
rules/ApplyHyperspace.scala:68-75). Delete, restore, vacuum, refresh,
optimize, cancel and recover are ported with the rest of the lifecycle
(ROADMAP queue A item 6); statistics and whyNot with the tooling (item 10).
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from hyperspace_tpu_torch.metadata.entry import IndexLogEntry


class Hyperspace:
    def __init__(self, session):
        self.session = session
        self._manager = session.index_manager

    def create_index(self, df, index_config) -> None:
        """Build a covering index over ``df`` (Hyperspace.scala:43-52)."""
        from hyperspace_tpu_torch.rules.apply import hyperspace_rule_disabled

        with hyperspace_rule_disabled():
            self._manager.create(df, index_config)

    def indexes(self) -> pa.Table:
        """One row per index: name, indexed and included columns, number
        of buckets, state and log version."""
        entries = self._manager.get_indexes()
        return pa.table(
            {
                "name": [e.name for e in entries],
                "indexedColumns": [
                    list(e.derived_dataset.indexed_columns) for e in entries
                ],
                "includedColumns": [
                    list(e.derived_dataset.included_columns) for e in entries
                ],
                "numBuckets": [
                    getattr(e.derived_dataset, "num_buckets", None)
                    for e in entries
                ],
                "state": [e.state for e in entries],
                "logVersion": [e.id for e in entries],
            }
        )

    def get_index(self, index_name: str) -> Optional[IndexLogEntry]:
        """The latest stable log entry of ``index_name``, or None."""
        return self._manager.get_index_log_entry(index_name)

    def explain(self, df) -> str:
        """Plan diff with vs without Hyperspace (PlanAnalyzer.explainString)."""
        from hyperspace_tpu_torch.plananalysis.explain import explain_string

        return explain_string(df, self.session)
