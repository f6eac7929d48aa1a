"""Budgeted apply — recommendations into lifecycle actions.

Counterpart of ``hyperspace_tpu/advisor/apply.py``; the actions run on the
session's device (a create launches kernel B1, and B5f in its captures,
on the card).

Opt-in (``hyperspace.advisor.apply.enabled``): walk a ranked
recommendation list and execute each through the :class:`Hyperspace`
facade — which means every create/refresh/optimize runs as a normal
lifecycle action, lease-stamped and heartbeat-renewed by the crash
recovery plane (``metadata/recovery.py``), so a fleet's serve traffic
sees advisor maintenance
exactly like operator maintenance (pinned snapshots keep serving; a
dead advisor's lease expires and its half-built index is recoverable).

Two budgets bound a pass (both from config, overridable per call):
``maxBytes`` caps the summed ESTIMATED build bytes of executed
recommendations — a recommendation whose estimate would cross the
remaining budget is skipped (cheaper ones later in the ranking may
still fit); ``maxSeconds`` caps wall time — once spent, the pass stops
outright. Failures are recorded per recommendation and never abort the
pass (one bad candidate must not starve the rest of the budget), apart
from a kernel's fault (``kernels.KERNEL_FAULTS``), which fails the pass
(ROADMAP C.7).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from hyperspace_tpu_torch.advisor.recommend import Recommendation
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.kernels import KERNEL_FAULTS
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig
from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndexConfig


def _config_for(rec: Recommendation):
    cls = (
        ZOrderCoveringIndexConfig
        if rec.index_kind == "ZOrderCoveringIndex"
        else CoveringIndexConfig
    )
    return cls(
        rec.index_name, list(rec.indexed_columns), list(rec.included_columns)
    )


def apply_recommendations(
    session,
    recommendations: List[Recommendation],
    max_bytes: Optional[int] = None,
    max_seconds: Optional[float] = None,
    force: bool = False,
) -> Dict:
    """Execute ``recommendations`` in order under the byte/time budget.
    Requires ``hyperspace.advisor.apply.enabled`` unless ``force`` (the
    CLI's explicit ``apply`` subcommand sets it — typing the command IS
    the opt-in). Returns a summary dict: per-recommendation outcomes
    plus budget accounting."""
    conf = session.conf
    if not (force or conf.advisor_apply_enabled):
        raise HyperspaceException(
            "advisor apply is disabled; set "
            "hyperspace.advisor.apply.enabled=true to opt in"
        )
    budget_bytes = max_bytes if max_bytes is not None else conf.advisor_apply_max_bytes
    budget_s = (
        max_seconds if max_seconds is not None else conf.advisor_apply_max_seconds
    )
    from hyperspace_tpu_torch.hyperspace import Hyperspace

    hs = Hyperspace(session)
    t0 = time.perf_counter()
    spent_bytes = 0
    outcomes: List[Dict] = []
    for rec in recommendations:
        elapsed = time.perf_counter() - t0
        if elapsed >= budget_s:
            outcomes.append(
                {"index": rec.index_name, "kind": rec.kind, "outcome": "skipped",
                 "why": f"time budget exhausted ({elapsed:.1f}s)"}
            )
            continue
        cost = max(0, int(rec.estimated_build_bytes))
        if spent_bytes + cost > budget_bytes:
            outcomes.append(
                {"index": rec.index_name, "kind": rec.kind, "outcome": "skipped",
                 "why": f"byte budget exhausted ({spent_bytes + cost} > "
                        f"{budget_bytes})"}
            )
            continue
        try:
            if rec.kind == "create":
                reader = getattr(
                    session.read, rec.source_fmt, session.read.parquet
                )
                df = reader(*rec.source_paths)
                hs.create_index(df, _config_for(rec))
            elif rec.kind == "refresh":
                hs.refresh_index(rec.index_name, mode=rec.mode or "incremental")
            elif rec.kind == "optimize":
                hs.optimize_index(rec.index_name, mode=rec.mode or "quick")
            else:
                raise HyperspaceException(
                    f"Unknown recommendation kind {rec.kind!r}"
                )
        except KERNEL_FAULTS:
            raise  # a kernel's fault fails the pass, never a skipped rec (C.7)
        except Exception as exc:  # hslint: disable=HS402
            # one bad candidate must not starve the rest of the budget
            outcomes.append(
                {"index": rec.index_name, "kind": rec.kind,
                 "outcome": "failed", "why": str(exc)[:200]}
            )
            continue
        spent_bytes += cost
        outcomes.append(
            {"index": rec.index_name, "kind": rec.kind, "outcome": "applied",
             "estimated_bytes": cost}
        )
    return {
        "applied": sum(1 for o in outcomes if o["outcome"] == "applied"),
        "failed": sum(1 for o in outcomes if o["outcome"] == "failed"),
        "skipped": sum(1 for o in outcomes if o["outcome"] == "skipped"),
        "spent_bytes": spent_bytes,
        "elapsed_s": round(time.perf_counter() - t0, 3),
        "outcomes": outcomes,
    }
