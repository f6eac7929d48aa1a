"""What-if scoring — hypothetical indexes through the REAL rule chain.

Counterpart of ``hyperspace_tpu/advisor/whatif.py``, over the port's
``rules/candidate``, ``rules/score``, ``indexes/context`` and
``signatures``. Scoring runs no kernel.

The contract (docs/advisor.md): a candidate index is evaluated by
building a hypothetical :class:`IndexLogEntry` — the exact entry
``CreateAction.begin_log_entry`` would stamp (real
``IndexSignatureProvider`` fingerprint over the current source
snapshot, real ``describe_index`` schema, EMPTY content) — injecting
it into ``collect_candidates`` beside the lake's ACTIVE entries, and
re-running ``ScoreBasedIndexPlanOptimizer`` over the recorded plan.
Nothing is ever written: no index data, no metadata log — the entry
lives only in this process.

Because the fingerprint is computed the same way a real create
computes it, the candidate passes the same ``FileSignatureFilter`` a
real index must pass; because the content is empty (size 0), the
rules' min-size ranking prefers the hypothetical exactly when a
fresh real index would win. The score DELTA (with-candidate minus
baseline) is therefore the rule chain's own opinion of the candidate
— never a parallel cost model that could drift from what serve
actually rewrites.

Convergence falls out of the same property: once a recommendation is
applied, the baseline already contains the real index, the
hypothetical twin adds no score, the gain is 0, and the next advise()
pass recommends nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.indexes.context import IndexerContext
from hyperspace_tpu_torch.metadata.entry import (
    Content,
    FileIdTracker,
    IndexLogEntry,
    Source,
    SourcePlan,
)
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.plan.nodes import LogicalPlan
from hyperspace_tpu_torch.rules.candidate import collect_candidates
from hyperspace_tpu_torch.rules.score import ScoreBasedIndexPlanOptimizer
from hyperspace_tpu_torch.signatures import IndexSignatureProvider


def hypothetical_entry(session, df, index_config) -> IndexLogEntry:
    """The no-execute twin of ``CreateAction.begin_log_entry``: a fully
    formed ACTIVE entry for ``index_config`` over ``df``'s (single)
    source relation, with ``Content.from_leaf_files([])`` — never
    written to the lake."""
    tracker = FileIdTracker()
    leaf = df.logical_plan.collect_leaves()[0]
    source_rel = session.source_manager.get_relation(leaf.relation)
    meta_relation = source_rel.create_metadata_relation(tracker)
    fingerprint = IndexSignatureProvider(session.source_manager).fingerprint(
        df.logical_plan
    )
    props = {
        C.LINEAGE_PROPERTY: str(session.conf.lineage_enabled).lower(),
    }
    if leaf.relation.fmt in ("parquet", "delta", "iceberg"):
        props[C.HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY] = "true"
    ctx = IndexerContext(session, tracker, index_data_path="")
    index = index_config.describe_index(ctx, df, props)
    return IndexLogEntry(
        name=index_config.index_name,
        derived_dataset=index,
        content=Content.from_leaf_files([]),
        source=Source(SourcePlan([meta_relation], provider="default")),
        fingerprint=fingerprint,
        properties={},
        state=States.ACTIVE,
    )


def score_plan(
    session, plan: LogicalPlan, entries: List[IndexLogEntry]
) -> int:
    """One plan's best score against an entry set — the optimizer's own
    number (0 = no rule applies, the unrewritten plan)."""
    if not entries:
        return 0
    from hyperspace_tpu_torch.plan.nodes import prune_join_columns

    pruned = prune_join_columns(plan)
    candidates = collect_candidates(session, pruned, entries)
    if not candidates:
        return 0
    _best, score = ScoreBasedIndexPlanOptimizer(session).apply_with_score(
        pruned, candidates
    )
    return score


def score_workload(
    session,
    plans: List[Tuple[LogicalPlan, float]],
    active: List[IndexLogEntry],
    candidate: Optional[IndexLogEntry],
) -> Dict[str, float]:
    """Score a weighted workload (plan, weight_seconds) against the
    ACTIVE entries, with ``candidate`` optionally injected. Returns::

        score          Σ weight·score(active + candidate)
        gain           Σ weight·(score - baseline)   (score units)
        benefit_s      Σ weight·(score - baseline)/score — the gain as
                       a fraction of each plan's winning score, in the
                       weight's unit (recorded seconds): the advisor's
                       estimated-benefit heuristic
        plans_improved plans whose score strictly rose

    The ``advisor.score`` stage of the advise() trace."""
    with obs_trace.span("advisor.score"):
        entries = list(active) + ([candidate] if candidate is not None else [])
        total = 0.0
        gain = 0.0
        benefit_s = 0.0
        improved = 0
        for plan, weight in plans:
            s = score_plan(session, plan, entries)
            total += weight * s
            if candidate is not None:
                base = score_plan(session, plan, active)
                if s > base:
                    gain += weight * (s - base)
                    benefit_s += weight * (s - base) / s
                    improved += 1
        return {
            "score": total,
            "gain": gain,
            "benefit_s": benefit_s,
            "plans_improved": improved,
        }
