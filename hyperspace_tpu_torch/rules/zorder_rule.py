"""ZOrderFilterIndexRule.

Counterpart of ``hyperspace_tpu/rules/zorder_rule.py`` (reference:
``zordercovering/ZOrderFilterIndexRule.scala:36-153``) — the
FilterIndexRule variant for z-order covering indexes: ANY indexed column
(not only the first) may appear in the predicate, and no bucketSpec is
attached (z-order files are range-laid-out, not hash-bucketed).
"""

from __future__ import annotations

from hyperspace_tpu_torch.rules.filter_rule import FilterIndexRule


class ZOrderFilterIndexRule(FilterIndexRule):
    # The class attributes specialize the parent pipeline; a z-order
    # relation never gets a bucketSpec because ZOrderCoveringIndex has no
    # num_buckets (rule_utils.index_scan_relation checks hasattr).
    name = "ZOrderFilterIndexRule"
    index_kind = "ZOrderCoveringIndex"
    require_first_indexed_col = False
    base_score = 50
