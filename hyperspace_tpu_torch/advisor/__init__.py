"""Workload advisor — query-log mining, what-if scoring, budgeted apply.

Counterpart of ``hyperspace_tpu/advisor/``: the closed loop of
``docs/advisor.md``, over the port's query log (``obs/querylog.py``, the
reference's format, so either package's advisor reads either package's
log) and the port's rule chain:

1. ``profile``   — union the fleet's query-log segments into a bounded
                   per-shape workload profile (frequency x cost x
                   stages x indexes x degrade events).
2. ``recommend`` — enumerate candidate indexes from the hot shapes and
                   score each with a HYPOTHETICAL ``IndexLogEntry``
                   through the real ``ScoreBasedIndexPlanOptimizer``
                   rule chain (``whatif``) — no parallel cost model.
3. ``apply``     — opt-in, budget-bounded execution of the ranked
                   recommendations through the ``Hyperspace`` facade
                   (lease-stamped lifecycle actions, like any operator).

Replay (``testing/replay.py``) closes the loop empirically: re-run the
recorded workload before/after apply and compare latencies. CLI:
``python -m hyperspace_tpu_torch.advisor report|recommend [--apply]|replay``
(the session subcommands run on the card unless given ``--device cpu``).
"""

from hyperspace_tpu_torch.advisor.apply import apply_recommendations
from hyperspace_tpu_torch.advisor.profile import (
    ShapeStats,
    WorkloadProfile,
    build_profile,
    profile_directory,
)
from hyperspace_tpu_torch.advisor.recommend import (
    AdvisorReport,
    Recommendation,
    advise,
)
from hyperspace_tpu_torch.advisor.whatif import (
    hypothetical_entry,
    score_plan,
    score_workload,
)

__all__ = [
    "AdvisorReport",
    "Recommendation",
    "ShapeStats",
    "WorkloadProfile",
    "advise",
    "apply_recommendations",
    "build_profile",
    "hypothetical_entry",
    "profile_directory",
    "score_plan",
    "score_workload",
]
