"""JoinIndexRule — rewrite an equi-join so BOTH sides read co-bucketed
covering indexes, eliminating the join shuffle.

Counterpart of ``hyperspace_tpu/rules/join_rule.py``. Reference:
``covering/JoinIndexRule.scala`` (the headline rule):

* eligibility — inner sort-merge-joinable shape (`:122-125`), *linear*
  children (each side is a Scan/Filter/Project chain, `:150-151`),
  conjunctive equi-conditions (`:164-170`), one-to-one left/right
  attribute mapping (``JoinAttributeFilter.ensureAttributeRequirements
  :262-301``);
* candidates — per side, indexes whose **indexed columns equal the join
  columns exactly** and which cover every referenced column
  (``JoinColumnFilter.getUsableIndexes:434-463``);
* ranking — prefer pairs with equal bucket counts (shuffle-free zip),
  then the larger common source bytes, a Hybrid Scan candidate's tag or
  else the index's whole source size (``JoinIndexRanker.rank:52-89``);
* score — 70·coverage per side (`:689-719`).

Execution-side payoff: both index relations carry ``bucket_spec``; the
executor zips equal buckets pairwise (``execution/executor._exec_join``)
and matches each pair with kernel B4 on the session's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.plananalysis import filter_reasons as FR
from hyperspace_tpu_torch.rules import tags
from hyperspace_tpu_torch.rules.base import CandidateMap, HyperspaceRule, tag_filter_reason
from hyperspace_tpu_torch.rules.rule_utils import transform_plan_to_use_index


class _Side:
    """A linear join child: Project*/Filter* chain over one Scan."""

    def __init__(self, root: LogicalPlan):
        self.root = root
        self.scan: Optional[Scan] = None
        self.filter_refs: set = set()
        node = root
        while True:
            if isinstance(node, Scan):
                self.scan = node
                break
            if isinstance(node, (Project, Filter)):
                if isinstance(node, Filter):
                    self.filter_refs |= E.references(node.condition)
                node = node.child
                continue
            break  # non-linear (join/union below) -> ineligible

    @property
    def ok(self) -> bool:
        return self.scan is not None

    def required_columns(self) -> set:
        return {c.lower() for c in self.root.output} | {
            c.lower() for c in self.filter_refs
        }

    def rebuilt_with(self, new_scan: LogicalPlan) -> LogicalPlan:
        old_scan = self.scan

        def swap(node):
            return new_scan if node is old_scan else node

        return self.root.transform_up(swap)


class JoinIndexRule(HyperspaceRule):
    name = "JoinIndexRule"
    base_score_per_side = 70

    def apply(self, session, plan, candidates: CandidateMap):
        if not isinstance(plan, Join):
            return plan, 0
        pairs = E.equi_join_pairs(plan.condition)
        if not pairs:
            return plan, 0
        left, right = _Side(plan.left), _Side(plan.right)
        if not (left.ok and right.ok):
            return plan, 0
        mapping = self._attribute_mapping(plan, pairs)
        if mapping is None:
            return plan, 0
        lcols, rcols = mapping
        l_best = self._usable(left, lcols, candidates)
        r_best = self._usable(right, rcols, candidates)
        if not l_best or not r_best:
            return plan, 0
        l_entry, r_entry = self._rank_pair(left.scan, right.scan, l_best, r_best)
        new_left = left.rebuilt_with(
            transform_plan_to_use_index(
                session, l_entry, left.scan, use_bucket_spec=True
            )
        )
        new_right = right.rebuilt_with(
            transform_plan_to_use_index(
                session, r_entry, right.scan, use_bucket_spec=True
            )
        )
        # Restore each side's original schema: the index scan may add columns
        # (e.g. the lineage column) that must not surface in the Join output
        # (CoveringIndexRuleUtils filters updatedOutput to the relation's
        # original attributes).
        if list(new_left.output) != list(plan.left.output):
            new_left = Project(plan.left.output, new_left)
        if list(new_right.output) != list(plan.right.output):
            new_right = Project(plan.right.output, new_right)
        score = self._score(left.scan, l_entry) + self._score(right.scan, r_entry)
        return Join(new_left, new_right, plan.condition, plan.how), score

    # -- attribute one-to-one mapping (:262-301) ---------------------------
    def _attribute_mapping(self, plan: Join, pairs):
        l_out = {c.lower() for c in plan.left.output}
        r_out = {c.lower() for c in plan.right.output}
        l2r: Dict[str, str] = {}
        r2l: Dict[str, str] = {}
        lcols: List[str] = []
        rcols: List[str] = []
        for a, b in pairs:
            al, bl = a.lower(), b.lower()
            if al in l_out and bl in r_out:
                lc, rc = al, bl
            elif bl in l_out and al in r_out:
                lc, rc = bl, al
            else:
                return None
            # one-to-one: a left column maps to exactly one right column
            if l2r.setdefault(lc, rc) != rc or r2l.setdefault(rc, lc) != lc:
                return None
            if lc not in lcols:
                lcols.append(lc)
                rcols.append(rc)
        return lcols, rcols

    # -- usable indexes per side (:434-463) ---------------------------------
    def _usable(
        self, side: _Side, join_cols: List[str], candidates: CandidateMap
    ) -> List[IndexLogEntry]:
        entries = [
            e
            for e in candidates.get(side.scan, [])
            if e.derived_dataset.kind == "CoveringIndex"
        ]
        required = side.required_columns()
        out = []
        for e in entries:
            index = e.derived_dataset
            indexed = [c.lower() for c in index.indexed_columns]
            covered = {c.lower() for c in index.referenced_columns()}
            if set(indexed) != set(join_cols):
                tag_filter_reason(
                    e,
                    side.scan,
                    FR.not_eligible_join(
                        f"indexed columns {indexed} != join columns {join_cols}"
                    ),
                )
                continue
            if not required <= covered:
                tag_filter_reason(
                    e,
                    side.scan,
                    FR.missing_required_col(
                        ",".join(sorted(required)), ",".join(sorted(covered))
                    ),
                )
                continue
            out.append(e)
        return out

    # -- pair ranking (JoinIndexRanker.rank:52-89) --------------------------
    def _rank_pair(self, l_scan, r_scan, l_entries, r_entries):
        def common(scan, e):
            v = e.get_tag(scan, tags.COMMON_SOURCE_SIZE_IN_BYTES)
            return v if v is not None else e.source_files_size_in_bytes

        best = None
        best_key = None
        for le in l_entries:
            for re in r_entries:
                lb = getattr(le.derived_dataset, "num_buckets", 0)
                rb = getattr(re.derived_dataset, "num_buckets", 0)
                key = (
                    0 if lb == rb else 1,  # equal bucket counts first
                    -(common(l_scan, le) + common(r_scan, re)),
                    le.name,
                    re.name,
                )
                if best_key is None or key < best_key:
                    best, best_key = (le, re), key
        return best

    def _score(self, scan, entry: IndexLogEntry) -> int:
        common = entry.get_tag(scan, tags.COMMON_SOURCE_SIZE_IN_BYTES)
        if common is not None and entry.source_files_size_in_bytes:
            ratio = min(1.0, common / entry.source_files_size_in_bytes)
            return max(1, int(self.base_score_per_side * ratio))
        return self.base_score_per_side
