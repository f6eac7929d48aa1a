"""AggregateIndexRule: rewrite a bare Aggregate∘Scan onto a covering index.

Counterpart of ``hyperspace_tpu/rules/agg_rule.py``. The filter rules only
fire under a Filter node, so a full-table aggregate
(``df.group_by(k).agg(count())``, ``df.agg(min(c))``) never reaches an
index scan. This rule closes that gap: an ``Aggregate`` whose child is a
plain source ``Scan`` (under Projects) rewrites onto the smallest ACTIVE
covering or z-order covering index that covers all of its input columns,
after which the metadata aggregate can answer its row groups from the
index's sidecars.

Correctness gate: the rewrite changes ROW ORDER (index data is
bucketed/sorted), so only order-insensitive aggregates are eligible —
COUNT, MIN, MAX, and integer SUM/AVG (wrapping addition is associative);
float SUM/AVG would reassociate and is left on the source scan. Hybrid
candidates (appended/deleted compensation) are excluded: a hybrid-required
entry is never served from metadata.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Aggregate, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.rules import tags
from hyperspace_tpu_torch.rules.base import CandidateMap, HyperspaceRule
from hyperspace_tpu_torch.rules.rule_utils import transform_plan_to_use_index


class AggregateIndexRule(HyperspaceRule):
    name = "AggregateIndexRule"

    index_kinds = ("CoveringIndex", "ZOrderCoveringIndex")
    # below FilterIndexRule/JoinIndexRule (50): a filter- or join-served
    # rewrite always wins when both shapes match
    base_score = 15

    def apply(self, session, plan, candidates: CandidateMap):
        if not isinstance(plan, Aggregate):
            return plan, 0
        if not session.conf.index_agg_enabled:
            return plan, 0
        projects = []
        node = plan.child
        while isinstance(node, Project):
            projects.append(node)
            node = node.child
        scan = node
        if not isinstance(scan, Scan) or scan.relation.index_info is not None:
            return plan, 0
        schema = scan.relation.schema
        for spec in plan.aggs:
            if spec.func in ("sum", "avg") and spec.column is not None:
                t = schema.get(spec.column)
                if t is None or pa.types.is_floating(t):
                    # float sums reassociate across the index's row order
                    return plan, 0
        required = {c.lower() for c in plan.input_columns}
        for p in projects:
            required |= {c.lower() for c in p.columns}
        eligible: List[IndexLogEntry] = []
        for e in candidates.get(scan, []):
            index = e.derived_dataset
            if index.kind not in self.index_kinds:
                continue
            if e.get_tag(scan, tags.HYBRIDSCAN_REQUIRED):
                continue  # appended/deleted compensation: not this rule
            covered = {c.lower() for c in index.referenced_columns()}
            if required <= covered:
                eligible.append(e)
        if not eligible:
            return plan, 0
        best = min(eligible, key=lambda e: (e.content.size_in_bytes, e.name))
        child: LogicalPlan = transform_plan_to_use_index(session, best, scan)
        for p in reversed(projects):
            child = Project(list(p.columns), child)
        return (
            Aggregate(list(plan.group_by), list(plan.aggs), child),
            self.base_score,
        )
