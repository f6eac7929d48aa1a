"""ApplyHyperspace — the optimizer entry point.

Reference: ``rules/ApplyHyperspace.scala:32-76``: gated by config and a
thread-local maintenance disable (`:43`; index-maintenance scans must not
be rewritten to read the index being maintained); fetches ACTIVE log
entries, collects candidates, runs the score-based optimizer; **any
exception falls back to the original plan** (`:60-64`).
"""

from __future__ import annotations

import contextlib
import logging
import threading

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, prune_join_columns
from hyperspace_tpu_torch.rules.candidate import collect_candidates
from hyperspace_tpu_torch.rules.score import ScoreBasedIndexPlanOptimizer

logger = logging.getLogger(__name__)

_local = threading.local()


@contextlib.contextmanager
def hyperspace_rule_disabled():
    """Thread-local guard (ApplyHyperspace.withHyperspaceRuleDisabled:68-75)."""
    prev = getattr(_local, "disabled", False)
    _local.disabled = True
    try:
        yield
    finally:
        _local.disabled = prev


def apply_hyperspace(
    session, plan: LogicalPlan, entries=None
) -> LogicalPlan:
    """Rewrite ``plan`` against the ACTIVE index entries (``entries``
    pins the candidate set; None reads the current entries)."""
    if getattr(_local, "disabled", False):
        return plan
    try:
        if entries is None:
            entries = session.index_manager.get_indexes([States.ACTIVE])
        if not entries:
            return plan
        plan = prune_join_columns(plan)
        candidates = collect_candidates(session, plan, entries)
        if not candidates:
            return plan
        return ScoreBasedIndexPlanOptimizer(session).apply(plan, candidates)
    # catch-all is the contract (reference ApplyHyperspace :60-64): a
    # rewrite failure must degrade to the original plan, never the query
    except Exception:
        logger.exception("Hyperspace plan rewrite failed; using original plan")
        return plan
