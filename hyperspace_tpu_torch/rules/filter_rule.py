"""FilterIndexRule: rewrite Scan→Filter[→Project] to a covering-index scan.

Reference: ``covering/FilterIndexRule.scala:129-174`` with its filters —
``FilterPlanNodeFilter`` (:33-55, plan shape), ``FilterColumnFilter``
(:62-103, first indexed column must appear in the predicate AND the index
must cover every referenced column), ``FilterRankFilter`` /
``FilterIndexRanker`` (covering/FilterIndexRanker.scala:43-63: Hybrid Scan
→ max common bytes, else min index size). Score = 50·coverage (:151-173).
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import Filter, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.plananalysis import filter_reasons as FR
from hyperspace_tpu_torch.rules import tags
from hyperspace_tpu_torch.rules.base import CandidateMap, HyperspaceRule, tag_filter_reason
from hyperspace_tpu_torch.rules.rule_utils import transform_plan_to_use_index


def _match(plan: LogicalPlan):
    """-> (project|None, filter, scan) when the plan has the target shape."""
    project = None
    node = plan
    if isinstance(node, Project):
        project = node
        node = node.child
    if not isinstance(node, Filter):
        return None
    if not isinstance(node.child, Scan):
        return None
    return project, node, node.child


class FilterIndexRule(HyperspaceRule):
    name = "FilterIndexRule"

    # which index kinds this rule consumes (IndexTypeFilter)
    index_kind = "CoveringIndex"
    # first indexed column must appear in the predicate (z-order relaxes it)
    require_first_indexed_col = True
    base_score = 50

    def apply(self, session, plan, candidates: CandidateMap):
        m = _match(plan)
        if m is None:
            return plan, 0
        project, filt, scan = m
        entries = [
            e
            for e in candidates.get(scan, [])
            if e.derived_dataset.kind == self.index_kind
        ]
        if not entries:
            return plan, 0
        eligible = self._filter_columns(project, filt, scan, entries)
        if not eligible:
            return plan, 0
        best = self._rank(scan, eligible)
        new_scan = transform_plan_to_use_index(
            session,
            best,
            scan,
            use_bucket_spec=session.conf.filter_rule_use_bucket_spec,
        )
        new_plan: LogicalPlan = Filter(filt.condition, new_scan)
        if project is not None:
            new_plan = Project(project.columns, new_plan)
        else:
            # preserve the original output column order
            new_plan = Project(plan.output, new_plan)
        return new_plan, self._score(scan, best)

    # -- FilterColumnFilter (:62-103) ---------------------------------------
    def _filter_columns(
        self,
        project: Optional[Project],
        filt: Filter,
        scan: Scan,
        entries: List[IndexLogEntry],
    ) -> List[IndexLogEntry]:
        cond_cols = {c.lower() for c in E.references(filt.condition)}
        output_cols = {
            c.lower()
            for c in (project.columns if project is not None else scan.output)
        }
        required = cond_cols | output_cols
        out = []
        for e in entries:
            index = e.derived_dataset
            indexed = [c.lower() for c in index.indexed_columns]
            covered = {c.lower() for c in index.referenced_columns()}
            if self.require_first_indexed_col:
                ok_pred = indexed[0] in cond_cols
                reason = FR.no_first_indexed_col_cond(
                    indexed[0], ",".join(sorted(cond_cols))
                )
            else:
                ok_pred = bool(set(indexed) & cond_cols)
                reason = FR.no_indexed_col_cond(
                    ",".join(indexed), ",".join(sorted(cond_cols))
                )
            if not ok_pred:
                tag_filter_reason(e, scan, reason)
                continue
            if not required <= covered:
                tag_filter_reason(
                    e,
                    scan,
                    FR.missing_required_col(
                        ",".join(sorted(required)), ",".join(sorted(covered))
                    ),
                )
                continue
            out.append(e)
        return out

    # -- FilterRankFilter / FilterIndexRanker -------------------------------
    def _rank(self, scan: Scan, entries: List[IndexLogEntry]) -> IndexLogEntry:
        def hybrid_common(e):
            return e.get_tag(scan, tags.COMMON_SOURCE_SIZE_IN_BYTES)

        if all(hybrid_common(e) is not None for e in entries):
            best = max(entries, key=lambda e: (hybrid_common(e), e.name))
        else:
            best = min(entries, key=lambda e: (e.content.size_in_bytes, e.name))
        for e in entries:
            if e is not best:
                tag_filter_reason(e, scan, FR.another_index_applied(best.name))
        return best

    # -- score (:151-173) ---------------------------------------------------
    def _score(self, scan: Scan, entry: IndexLogEntry) -> int:
        common = entry.get_tag(scan, tags.COMMON_SOURCE_SIZE_IN_BYTES)
        if common is not None and entry.source_files_size_in_bytes:
            total = entry.source_files_size_in_bytes
            return max(1, int(self.base_score * min(1.0, common / total)))
        return self.base_score
