"""Rule + filter scaffolding.

Reference: ``rules/HyperspaceRule.scala:28-91`` (template: query-plan
filters → ranker → applyIndex + score) and ``rules/IndexFilter.scala:26-110``
(``withFilterReasonTag`` instrumentation feeding ``whyNot``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.plananalysis.filter_reasons import FilterReason
from hyperspace_tpu_torch.rules import tags

# candidate map: Scan node -> applicable index log entries
CandidateMap = Dict[Scan, List[IndexLogEntry]]


def tag_filter_reason(
    entry: IndexLogEntry, plan_key, reason: FilterReason
) -> None:
    """Record why `entry` was rejected for `plan_key` — only when analysis
    is enabled (IndexFilter.withFilterReasonTag, rules/IndexFilter.scala:26-110)."""
    if not entry.get_tag(None, tags.INDEX_PLAN_ANALYSIS_ENABLED):
        return
    reasons = entry.get_tag(plan_key, tags.FILTER_REASONS) or []
    reasons.append(reason)
    entry.set_tag(plan_key, tags.FILTER_REASONS, reasons)


class HyperspaceRule:
    """A rewrite rule: (plan, candidates) -> (new plan, score).

    Score 0 means inapplicable and new plan == plan
    (HyperspaceRule.apply:62-79; NoOpRule keeps recursion going,
    rules/NoOpRule.scala:26-41).
    """

    name = "HyperspaceRule"

    def apply(
        self, session, plan: LogicalPlan, candidates: CandidateMap
    ) -> Tuple[LogicalPlan, int]:
        return plan, 0


class NoOpRule(HyperspaceRule):
    name = "NoOpRule"
