"""Hyperspace — the user-facing API facade.

Reference: ``Hyperspace.scala:27-193`` and its Python binding
(``python/hyperspace/hyperspace.py:9-192``). Counterpart of
``hyperspace_tpu/hyperspace.py`` for the ported slices: create, the
lifecycle (delete, restore, vacuum, refresh, optimize, cancel, recover), list,
one index's statistics and explain.
Index maintenance runs with the query-rewrite rule disabled so
maintenance scans never get rewritten to use the index being maintained
(``ApplyHyperspace.withHyperspaceRuleDisabled``,
rules/ApplyHyperspace.scala:68-75). ``recover`` repairs a crashed writer's
leavings (``metadata/recovery.py``). Explain's verbose and mode arguments
and whyNot come with the tooling (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry


class Hyperspace:
    def __init__(self, session):
        self.session = session
        self._manager = session.index_manager

    # -- index CRUD (Hyperspace.scala:43-151) -------------------------------
    def create_index(self, df, index_config) -> None:
        """Build an index over ``df`` (Hyperspace.scala:43-52)."""
        with self._maintenance():
            self._manager.create(df, index_config)

    def delete_index(self, index_name: str) -> None:
        """Soft delete: queries stop using the index, its data stays."""
        with self._maintenance():
            self._manager.delete(index_name)

    def restore_index(self, index_name: str) -> None:
        """Undo a soft delete."""
        with self._maintenance():
            self._manager.restore(index_name)

    def vacuum_index(self, index_name: str) -> None:
        """Hard-delete a deleted index, or drop an active index's outdated
        version directories."""
        with self._maintenance():
            self._manager.vacuum(index_name)

    def refresh_index(self, index_name: str, mode: str = C.REFRESH_MODE_FULL) -> None:
        """Bring the index up to date with its source: ``full`` rebuilds,
        ``incremental`` indexes the appended files and drops the deleted
        ones, ``quick`` records the change in the log alone."""
        with self._maintenance():
            self._manager.refresh(index_name, mode)

    def optimize_index(self, index_name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> None:
        """Compact each bucket's index files into one: those below
        ``hyperspace.index.optimize.fileSizeThreshold`` (``quick``) or all
        of them (``full``)."""
        with self._maintenance():
            self._manager.optimize(index_name, mode)

    def cancel(self, index_name: str) -> None:
        """Roll an interrupted action back to the last stable state."""
        with self._maintenance():
            self._manager.cancel(index_name)

    def recover(self, index_name: str, gc: bool = True) -> dict:
        """Repair a crashed writer's leavings on one index: roll back a
        stranded transient log entry (lease expired, or torn), heal a stale
        latestStable pointer and garbage-collect orphan data files
        (quarantine, then delete after the grace period). Idempotent;
        returns the report."""
        with self._maintenance():
            return self._manager.recover(index_name, gc=gc)

    def _maintenance(self):
        from hyperspace_tpu_torch.rules.apply import hyperspace_rule_disabled

        return hyperspace_rule_disabled()

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
