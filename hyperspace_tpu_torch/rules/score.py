"""Score-based plan optimizer.

Reference: ``rules/ScoreBasedIndexPlanOptimizer.scala:31-81`` — a
recursive, memoized search: at every node, either some rule rewrites the
subtree (its score), or the children are optimized independently (sum of
child scores); keep the max. The reference's rule set is `:32-33`;
the port registers FilterIndexRule, JoinIndexRule,
ZOrderFilterIndexRule, ApplyDataSkippingIndex, AggregateIndexRule and
NoOpRule, the reference's order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from hyperspace_tpu_torch.plan.nodes import LogicalPlan
from hyperspace_tpu_torch.rules.base import CandidateMap, HyperspaceRule, NoOpRule


def _all_rules() -> List[HyperspaceRule]:
    """The filter, join, z-order filter, data-skipping and aggregate
    rules, in the reference's order."""
    from hyperspace_tpu_torch.rules.agg_rule import AggregateIndexRule
    from hyperspace_tpu_torch.rules.dataskipping_rule import ApplyDataSkippingIndex
    from hyperspace_tpu_torch.rules.filter_rule import FilterIndexRule
    from hyperspace_tpu_torch.rules.join_rule import JoinIndexRule
    from hyperspace_tpu_torch.rules.zorder_rule import ZOrderFilterIndexRule

    return [
        FilterIndexRule(),
        JoinIndexRule(),
        ZOrderFilterIndexRule(),
        ApplyDataSkippingIndex(),
        AggregateIndexRule(),
        NoOpRule(),
    ]


class ScoreBasedIndexPlanOptimizer:
    def __init__(self, session):
        self.session = session
        self.rules = _all_rules()

    def apply(self, plan: LogicalPlan, candidates: CandidateMap) -> LogicalPlan:
        best, _score = self.apply_with_score(plan, candidates)
        return best

    def apply_with_score(
        self, plan: LogicalPlan, candidates: CandidateMap
    ) -> Tuple[LogicalPlan, int]:
        """The search result with its winning score."""
        self._memo: Dict[int, Tuple[LogicalPlan, int]] = {}
        return self._rec_apply(plan, candidates)

    def _rec_apply(
        self, plan: LogicalPlan, candidates: CandidateMap
    ) -> Tuple[LogicalPlan, int]:
        key = id(plan)
        if key in self._memo:
            return self._memo[key]
        # Option A: optimize children independently
        best_plan, best_score = plan, 0
        if plan.children:
            new_children = []
            child_score = 0
            for c in plan.children:
                p, s = self._rec_apply(c, candidates)
                new_children.append(p)
                child_score += s
            if child_score > 0:
                best_plan, best_score = plan.with_children(new_children), child_score
        # Option B: a rule rewrites this subtree wholesale
        for rule in self.rules:
            p, s = rule.apply(self.session, plan, candidates)
            if s > best_score:
                best_plan, best_score = p, s
        self._memo[key] = (best_plan, best_score)
        return best_plan, best_score
