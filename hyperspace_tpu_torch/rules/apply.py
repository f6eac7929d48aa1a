"""ApplyHyperspace — the optimizer entry point.

Reference: ``rules/ApplyHyperspace.scala:32-76``: gated by config and a
thread-local maintenance disable (`:43`; index-maintenance scans must not
be rewritten to read the index being maintained); fetches ACTIVE log
entries, collects candidates, runs the score-based optimizer; **any
exception falls back to the original plan** (`:60-64`), apart from a
fault of a hand-written kernel (``kernels.KERNEL_FAULTS``: a build
failure, or an error code that a wrapper turns into
``KernelLaunchError``), which raises instead of hiding the kernel behind
the unindexed plan. The one kernel a rule runs is the data-skipping
rule's Bloom probe (B7); its wrapper reads the indices back through
``ops/bloom.to_host``, so a fault while B7 runs raises the same way.
"""

from __future__ import annotations

import contextlib
import logging
import threading

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.kernels import KERNEL_FAULTS
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, prune_join_columns
from hyperspace_tpu_torch.rules.candidate import collect_candidates
from hyperspace_tpu_torch.rules.score import ScoreBasedIndexPlanOptimizer
from hyperspace_tpu_torch.telemetry import HyperspaceIndexUsageEvent

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
        new_plan = ScoreBasedIndexPlanOptimizer(session).apply(plan, candidates)
        if new_plan is not plan:
            used = sorted(
                {
                    leaf.relation.index_info[0]
                    for leaf in new_plan.collect_leaves()
                    if leaf.relation.index_info
                }
            )
            if used:
                session.event_logging.log_event(
                    HyperspaceIndexUsageEvent(index_names=used, plan=new_plan.pretty())
                )
        return new_plan
    except KERNEL_FAULTS:
        raise
    # catch-all is the contract (reference ApplyHyperspace :60-64): a
    # rewrite failure must degrade to the original plan, never the query;
    # a kernel's fault is re-raised above (C.7)
    except Exception:  # hslint: disable=HS402
        logger.exception("Hyperspace plan rewrite failed; using original plan")
        return plan
