"""Recommendation engine — profile in, ranked actions out.

Counterpart of ``hyperspace_tpu/advisor/recommend.py``.

``advise()`` is the tentpole loop (docs/advisor.md): take a workload
profile (``advisor/profile.py``), enumerate candidate indexes from the
hot shapes' recorded plans, score each through the what-if machinery
(``advisor/whatif.py`` — the real rule chain, hypothetical entry,
nothing written), and emit ranked CREATE / REFRESH / OPTIMIZE
recommendations with an estimated workload benefit and an estimated
build cost. The whole pass runs under one ``advisor.run`` root span
with ``advisor.scan`` / ``advisor.score`` stages, so the advisor's own
cost is visible in the plane it consumes.

Candidate enumeration is plan-shape-driven, mirroring the rules that
would consume each candidate:

* Filter[->Project] over a source scan -> covering index (indexed =
  equality columns then range columns — FilterIndexRule requires the
  FIRST indexed column in the predicate; included = every other
  referenced column), plus a z-order covering index when >= 2 range
  columns filter the same scan (ZOrderFilterIndexRule relaxes the
  leading-column requirement).
* Inner equi-join -> one covering index per side (indexed = exactly
  that side's join keys — JoinIndexRule's eligibility — included =
  the side's other referenced columns).
* Aggregate over a source scan -> covering index (indexed = group-by
  keys, included = aggregated columns; consumed by AggregateIndexRule).

REFRESH is recommended for ACTIVE entries serving with a pending
quick-refresh source delta (``has_source_update`` — every query pays
Hybrid-Scan compensation), OPTIMIZE for entries whose data has >= 2
files under ``hyperspace.index.optimize.fileSizeThreshold``. Both are
no-ops once applied, so a second advise() pass converges to empty.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig
from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndexConfig
from hyperspace_tpu_torch.obs import planspec as obs_planspec
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    Join,
    LogicalPlan,
    Project,
    Scan,
)
from hyperspace_tpu_torch.advisor import whatif
from hyperspace_tpu_torch.advisor.profile import WorkloadProfile, profile_directory
from hyperspace_tpu_torch.obs import querylog as obs_querylog
from hyperspace_tpu_torch.utils.hashing import md5_hex


@dataclasses.dataclass
class Recommendation:
    """One ranked advisor action."""

    kind: str  # "create" | "refresh" | "optimize"
    index_name: str
    index_kind: str  # "CoveringIndex" | "ZOrderCoveringIndex" | existing kind
    indexed_columns: List[str]
    included_columns: List[str]
    source_paths: List[str]
    estimated_benefit_s: float
    estimated_build_bytes: int
    score_gain: float
    shapes: List[str]  # predicate shapes this recommendation serves
    reason: str
    mode: Optional[str] = None  # refresh/optimize mode
    source_fmt: str = "parquet"

    def to_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "index_name": self.index_name,
            "index_kind": self.index_kind,
            "indexed_columns": list(self.indexed_columns),
            "included_columns": list(self.included_columns),
            "source_paths": list(self.source_paths),
            "estimated_benefit_s": round(self.estimated_benefit_s, 6),
            "estimated_build_bytes": int(self.estimated_build_bytes),
            "score_gain": round(self.score_gain, 3),
            "shapes": list(self.shapes),
            "reason": self.reason,
            "mode": self.mode,
            "source_fmt": self.source_fmt,
        }


@dataclasses.dataclass
class AdvisorReport:
    profile: WorkloadProfile
    recommendations: List[Recommendation]
    candidates_scored: int
    candidates_skipped: int
    shapes_with_plans: int

    def to_dict(self, top: Optional[int] = None) -> Dict:
        return {
            "profile": self.profile.to_dict(top),
            "recommendations": [r.to_dict() for r in self.recommendations],
            "candidates_scored": self.candidates_scored,
            "candidates_skipped": self.candidates_skipped,
            "shapes_with_plans": self.shapes_with_plans,
        }


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Candidate:
    config: object  # IndexConfigTrait
    kind: str
    source_paths: Tuple[str, ...]
    fmt: str
    shapes: List[str] = dataclasses.field(default_factory=list)


def _split_filter_cols(cond: E.Expr) -> Tuple[List[str], List[str]]:
    """(equality columns, range columns) of a conjunctive predicate, in
    first-appearance order."""
    eq_cols: List[str] = []
    range_cols: List[str] = []
    for conj in E.split_conjuncts(cond):
        cols = sorted(E.references(conj))
        if isinstance(conj, (E.Eq, E.In, E.IsNull)):
            target = eq_cols
        elif isinstance(conj, (E.Lt, E.Le, E.Gt, E.Ge)):
            target = range_cols
        else:
            target = range_cols  # Or/Not/mixed: usable but not leading
        for c in cols:
            if c not in eq_cols and c not in range_cols:
                target.append(c)
    return eq_cols, range_cols


def _source_scan(node: LogicalPlan) -> Optional[Scan]:
    """The node itself when it is a non-index source Scan."""
    if isinstance(node, Scan) and node.relation.index_info is None:
        return node
    return None


def _linear_scan(node: LogicalPlan) -> Optional[Tuple[Scan, set]]:
    """Walk Project/Filter chains to a source scan, collecting every
    referenced column on the way (JoinIndexRule's 'linear' children)."""
    refs: set = set()
    while True:
        scan = _source_scan(node)
        if scan is not None:
            return scan, refs
        if isinstance(node, Project):
            refs |= set(node.columns)
            node = node.child
        elif isinstance(node, Filter):
            refs |= set(E.references(node.condition))
            node = node.child
        else:
            return None


def _candidate_name(kind: str, paths, indexed, included) -> str:
    sig = md5_hex(
        "|".join([kind, ",".join(paths), ",".join(indexed), ",".join(included)])
    )[:10]
    return f"adv_{sig}"


def _mk(kind: str, scan: Scan, indexed, included) -> Optional[_Candidate]:
    indexed = [c for c in indexed if c in scan.output]
    included = sorted(
        c for c in included if c in scan.output and c not in indexed
    )
    if not indexed:
        return None
    paths = tuple(scan.relation.root_paths)
    name = _candidate_name(kind, paths, indexed, included)
    cls = (
        ZOrderCoveringIndexConfig
        if kind == "ZOrderCoveringIndex"
        else CoveringIndexConfig
    )
    return _Candidate(
        config=cls(name, list(indexed), list(included)),
        kind=kind,
        source_paths=paths,
        fmt=scan.relation.fmt,
    )


def enumerate_candidates(plan: LogicalPlan) -> List[_Candidate]:
    """Candidate index configs one recorded plan motivates (see module
    docstring for the shape -> candidate mapping)."""
    out: List[_Candidate] = []
    stack: List[LogicalPlan] = [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        if isinstance(node, Filter):
            scan = _source_scan(node.child)
            if scan is None:
                continue
            eq_cols, range_cols = _split_filter_cols(node.condition)
            indexed = eq_cols + range_cols
            covered = set(E.references(node.condition)) | set(plan.output)
            cand = _mk("CoveringIndex", scan, indexed, covered)
            if cand is not None:
                out.append(cand)
            if len(range_cols) >= 2:
                z = _mk("ZOrderCoveringIndex", scan, range_cols, covered)
                if z is not None:
                    out.append(z)
        elif isinstance(node, Join):
            pairs = E.equi_join_pairs(node.condition)
            if not pairs:
                continue
            for side, keys in (
                (node.left, [l for l, _ in pairs]),
                (node.right, [r for _, r in pairs]),
            ):
                got = _linear_scan(side)
                if got is None:
                    continue
                scan, refs = got
                side_keys = [k for k in keys if k in scan.output]
                if not side_keys:
                    continue
                covered = (refs | set(side.output)) & set(scan.output)
                # JoinIndexRule eligibility: indexed columns must equal
                # the join keys exactly — nothing more, nothing less
                cand = _mk("CoveringIndex", scan, side_keys, covered)
                if cand is not None:
                    out.append(cand)
        elif isinstance(node, Aggregate):
            inner = node.child
            refs: set = set()
            while isinstance(inner, Project):
                refs |= set(inner.columns)
                inner = inner.child
            scan = _source_scan(inner)
            if scan is None or not node.group_by:
                continue
            covered = set(node.input_columns) | refs
            cand = _mk("CoveringIndex", scan, list(node.group_by), covered)
            if cand is not None:
                out.append(cand)
    return out


# ---------------------------------------------------------------------------
# Scoring + ranking
# ---------------------------------------------------------------------------


def _source_bytes(session, scan: Scan) -> int:
    try:
        rel = session.source_manager.get_relation(scan.relation)
        return sum(size for _, size, _ in rel.all_file_infos())
    except Exception:  # hslint: disable=HS402
        # estimation helper: a missing source means cost 0, not a crash
        return 0


def _build_cost_bytes(session, scan: Scan, config) -> int:
    """Source bytes x referenced-column fraction — the advisor's build
    cost estimate (a covering index rewrites the referenced projection
    of the source, bucketed)."""
    total = _source_bytes(session, scan)
    ncols = max(1, len(scan.output))
    frac = min(1.0, len(config.referenced_columns) / ncols)
    return int(total * frac)


def advise(
    session,
    directory: Optional[str] = None,
    profile: Optional[WorkloadProfile] = None,
    max_candidates: Optional[int] = None,
) -> AdvisorReport:
    """The full advisor pass: profile (built from ``directory`` unless
    given), candidate enumeration, what-if scoring, ranked output —
    nothing executed, nothing written (that is ``advisor.apply``'s
    job)."""
    root = obs_trace.root("advisor.run")
    with obs_trace.activate(root):
        try:
            return _advise_under_root(
                session, directory, profile, max_candidates, root
            )
        finally:
            root.finish()


def _advise_under_root(
    session, directory, profile, max_candidates, root
) -> AdvisorReport:
    conf = session.conf
    if profile is None:
        if directory is None:
            directory = obs_querylog.obs_root(conf)
        profile = profile_directory(
            directory, max_shapes=conf.advisor_profile_max_shapes
        )
    cap = max_candidates or conf.advisor_max_candidates

    # rebuild the hot shapes' recorded plans (hottest first — the
    # candidate budget spends itself on the expensive shapes). Weight =
    # recorded seconds; a log with no durations at all (generated
    # scenarios record 0) falls back to frequency, else every gain
    # would multiply to zero
    use_counts = profile.total_s <= 0
    plans: List[Tuple[str, LogicalPlan, float]] = []
    for shape in profile.hot_shapes():
        if shape.replay is None:
            continue
        try:
            plan = obs_planspec.from_spec(session, shape.replay)
        except Exception:  # hslint: disable=HS402
            # a shape whose source moved away must not kill the pass
            continue
        weight = float(shape.count) if use_counts else shape.total_s
        plans.append((shape.shape, plan, weight))

    # enumerate + dedup candidates, attributing shapes to each
    candidates: Dict[str, _Candidate] = {}
    truncated = 0
    for shape_key, plan, _w in plans:
        for cand in enumerate_candidates(plan):
            known = candidates.get(cand.config.index_name)
            if known is None:
                if len(candidates) >= cap:
                    truncated += 1
                    continue
                known = candidates[cand.config.index_name] = cand
            if shape_key not in known.shapes:
                known.shapes.append(shape_key)

    active = session.index_manager.get_indexes([States.ACTIVE])
    existing = {e.name for e in active}

    recs: List[Recommendation] = []
    scored = 0
    skipped = 0
    for cand in candidates.values():
        if cand.config.index_name in existing:
            # an applied recommendation's twin scores gain 0 anyway;
            # skip the what-if pass outright (fast convergence)
            continue
        reader = getattr(session.read, cand.fmt, session.read.parquet)
        try:
            df = reader(*cand.source_paths)
            hypo = whatif.hypothetical_entry(session, df, cand.config)
        except Exception:  # hslint: disable=HS402
            # unindexable source / unresolvable columns: skip candidate
            skipped += 1
            continue
        workload = [
            (plan, weight)
            for shape_key, plan, weight in plans
            if shape_key in cand.shapes
        ]
        result = whatif.score_workload(session, workload, active, hypo)
        scored += 1
        if result["gain"] <= 0:
            continue
        leaf = df.logical_plan.collect_leaves()[0]
        benefit = result["benefit_s"]
        recs.append(
            Recommendation(
                kind="create",
                index_name=cand.config.index_name,
                index_kind=cand.kind,
                indexed_columns=cand.config.indexed_columns,
                included_columns=cand.config.included_columns,
                source_paths=list(cand.source_paths),
                estimated_benefit_s=benefit,
                estimated_build_bytes=_build_cost_bytes(
                    session, leaf, cand.config
                ),
                score_gain=result["gain"],
                shapes=list(cand.shapes),
                reason=(
                    f"what-if gain {result['gain']:.0f} over "
                    f"{result['plans_improved']} recorded plan(s)"
                ),
                source_fmt=cand.fmt,
            )
        )

    recs.extend(_maintenance_recommendations(session, active, profile))
    recs.sort(key=lambda r: (-r.estimated_benefit_s, r.index_name))
    root.set("recommendations", len(recs))
    root.set("candidates_scored", scored)
    if truncated:
        root.add_event("candidates_truncated", dropped=truncated)
    return AdvisorReport(
        profile=profile,
        recommendations=recs,
        candidates_scored=scored,
        candidates_skipped=skipped + truncated,
        shapes_with_plans=len(plans),
    )


def _index_workload_s(profile: WorkloadProfile, index_name: str) -> float:
    """Seconds of recorded workload served by ``index_name``."""
    total = 0.0
    for shape in profile.shapes.values():
        if index_name in shape.indexes:
            total += shape.total_s * (
                shape.indexes[index_name] / max(1, shape.count)
            )
    return total


def _maintenance_recommendations(
    session, active, profile: WorkloadProfile
) -> List[Recommendation]:
    recs: List[Recommendation] = []
    threshold = session.conf.optimize_file_size_threshold
    for entry in active:
        served_s = _index_workload_s(profile, entry.name)
        index = entry.derived_dataset
        if entry.has_source_update:
            recs.append(
                Recommendation(
                    kind="refresh",
                    index_name=entry.name,
                    index_kind=index.kind,
                    indexed_columns=list(index.indexed_columns),
                    included_columns=[],
                    source_paths=[],
                    # every serve of this index pays Hybrid-Scan delta
                    # compensation until the data catches up
                    estimated_benefit_s=served_s * 0.5,
                    estimated_build_bytes=entry.source_files_size_in_bytes,
                    score_gain=0.0,
                    shapes=[],
                    reason="pending quick-refresh source delta "
                    "(queries pay compensation)",
                    mode=C.REFRESH_MODE_INCREMENTAL,
                )
            )
            continue
        small = [
            info
            for _, info in entry.content.file_infos
            if 0 <= info.size < threshold
        ]
        if len(small) >= 2:
            recs.append(
                Recommendation(
                    kind="optimize",
                    index_name=entry.name,
                    index_kind=index.kind,
                    indexed_columns=list(index.indexed_columns),
                    included_columns=[],
                    source_paths=[],
                    estimated_benefit_s=served_s * 0.1,
                    estimated_build_bytes=sum(i.size for i in small),
                    score_gain=0.0,
                    shapes=[],
                    reason=f"{len(small)} index files under the optimize "
                    "threshold (per-file open cost on every serve)",
                    mode=C.OPTIMIZE_MODE_QUICK,
                )
            )
    return recs
