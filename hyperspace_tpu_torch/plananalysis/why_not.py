"""`hs.why_not(df)` — why each index was (not) applied to a plan.

Reference: ``plananalysis/CandidateIndexAnalyzer.scala:30-43`` — set the
``INDEX_PLAN_ANALYSIS_ENABLED`` tag on every ACTIVE index, re-run the
candidate collector and the score-based optimizer, then harvest the
``FILTER_REASONS`` tags the rule filters recorded
(``IndexFilter.withFilterReasonTag``, rules/IndexFilter.scala:26-110).
Counterpart of ``hyperspace_tpu/plananalysis/why_not.py``; the report is
the JAX package's byte for byte. Host code: no device work.
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.rules import tags
from hyperspace_tpu_torch.rules.candidate import collect_candidates
from hyperspace_tpu_torch.rules.score import ScoreBasedIndexPlanOptimizer

_BAR = "=" * 65


def _analyze(df, session, entries):
    """Re-run collection + optimization with analysis tagging enabled;
    returns (applied index names, entries with FILTER_REASONS tags)."""
    from hyperspace_tpu_torch.plan.nodes import prune_join_columns

    for e in entries:
        # drop reasons accumulated by earlier analyses of other plans
        for key, _ in e.collect_tag(tags.FILTER_REASONS):
            e.unset_tag(key, tags.FILTER_REASONS)
        e.set_tag(None, tags.INDEX_PLAN_ANALYSIS_ENABLED, True)
    try:
        plan = prune_join_columns(df.logical_plan)
        candidates = collect_candidates(session, plan, entries)
        optimized = ScoreBasedIndexPlanOptimizer(session).apply(plan, candidates)
        applied = {
            s.relation.index_info[0]
            for s in optimized.collect_leaves()
            if s.relation.index_info
        }
        return applied, entries
    finally:
        for e in entries:
            e.unset_tag(None, tags.INDEX_PLAN_ANALYSIS_ENABLED)


def why_not_string(
    df,
    session,
    manager,
    index_name: Optional[str] = None,
    extended: bool = False,
) -> str:
    entries = manager.get_indexes([States.ACTIVE])
    if index_name is not None:
        entries = [e for e in entries if e.name == index_name]
        if not entries:
            raise HyperspaceException(
                f"No ACTIVE index named {index_name!r} to analyze"
            )
    if not entries:
        return "No ACTIVE indexes to analyze."

    applied, entries = _analyze(df, session, entries)

    buf = [
        _BAR,
        "Plan:",
        _BAR,
        df.logical_plan.pretty(),
        "",
        _BAR,
        "Applicable indexes:",
        _BAR,
    ]
    applicable = sorted(n for n in applied)
    for n in applicable:
        buf.append(f"{n}: applied by the optimizer for this plan")
    if not applicable:
        buf.append("(none)")
    buf += ["", _BAR, "Non-applicable indexes:", _BAR]
    any_reason = False
    for e in sorted(entries, key=lambda e: e.name):
        if e.name in applied:
            continue
        any_reason = True
        reasons = [r for _, rs in e.collect_tag(tags.FILTER_REASONS) for r in rs]
        buf.append(f"{e.name} ({e.derived_dataset.kind}):")
        if reasons:
            seen = set()
            for r in reasons:
                line = "  - " + r.to_string(extended)
                if line not in seen:
                    seen.add(line)
                    buf.append(line)
        else:
            buf.append(
                "  - [NO_CANDIDATE_SCAN] the plan has no scan this index's "
                "source files match"
            )
    if not any_reason:
        buf.append("(none)")
    buf.append("")
    return "\n".join(buf)
