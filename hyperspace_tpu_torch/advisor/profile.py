"""Workload profile — the query-log aggregation the advisor mines.

Counterpart of ``hyperspace_tpu/advisor/profile.py``. The fleet-safe
reader side of the query log turned into the advisor's workload
structure: union every process's JSONL
segments (``querylog.read_valid_records`` — torn tails skipped,
unsealed active files of crashed writers picked up, unknown
``schema_v`` records counted and dropped) and fold them into per-shape
groups keyed by the literal-scrubbed predicate shape. Each group
carries frequency x cost x stage breakdown x indexes-chosen x
degrade/retry events — everything the what-if scorer
(``advisor/whatif.py``) and the CLI report need, with no user data
(shapes are scrubbed; the opt-in ``replay`` spec is carried through
verbatim for shapes that recorded one).

Residency contract (ALLOC_SITES const-bounded): the profile holds at
most ``hyperspace.advisor.profile.maxShapes`` groups — records for
further shapes fold into ``overflow_records`` (and a counter) instead
of growing the dict — and per-group duration samples are capped at
``_DURATION_SAMPLES``. The profile is O(maxShapes), never O(records).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from hyperspace_tpu_torch.obs import metrics as _metrics
from hyperspace_tpu_torch.obs import querylog as _querylog
from hyperspace_tpu_torch.obs import trace as obs_trace

#: per-shape duration-sample cap (p50 estimates; oldest kept — the
#: profile answers "what is this shape like", not "what changed")
_DURATION_SAMPLES = 512

#: advisor plane health (OBS_SITES: hyperspace_tpu_torch.advisor.profile)
profiles_total = _metrics.registry.counter(
    "hs_advisor_profiles_total", "workload profiles built"
)
profile_overflow_total = _metrics.registry.counter(
    "hs_advisor_profile_overflow_total",
    "query-log records folded into the overflow bucket (shape cap)",
)


@dataclasses.dataclass
class ShapeStats:
    """One predicate-shape group of the workload profile."""

    shape: str
    count: int = 0
    failed: int = 0
    total_s: float = 0.0
    durations: List[float] = dataclasses.field(default_factory=list)
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    indexes: Dict[str, int] = dataclasses.field(default_factory=dict)
    rules: Dict[str, int] = dataclasses.field(default_factory=dict)
    slo_classes: Dict[str, int] = dataclasses.field(default_factory=dict)
    degrades: int = 0
    retries: int = 0
    rows_returned: int = 0
    rows_pruned: int = 0
    last_ts_ms: int = 0
    #: first recorded re-executable plan spec (obs/planspec.py), when
    #: the workload was recorded with querylog.recordPlans on
    replay: Optional[Dict] = None

    def add(self, rec: Dict) -> None:
        self.count += 1
        dur = float(rec.get("duration_s", 0.0))
        self.total_s += dur
        if len(self.durations) < _DURATION_SAMPLES:
            self.durations.append(dur)
        if rec.get("status") != "ok":
            self.failed += 1
        for stage, v in (rec.get("stages") or {}).items():
            if isinstance(v, (int, float)):
                self.stages[stage] = self.stages.get(stage, 0.0) + float(v)
        for name in rec.get("indexes") or []:
            self.indexes[name] = self.indexes.get(name, 0) + 1
        rule = rec.get("rule")
        if rule:
            self.rules[rule] = self.rules.get(rule, 0) + 1
        slo = rec.get("slo_class")
        if slo:
            self.slo_classes[slo] = self.slo_classes.get(slo, 0) + 1
        for ev in rec.get("events") or []:
            name = ev.get("name") if isinstance(ev, dict) else None
            if name == "degrade":
                self.degrades += 1
            elif name == "retry":
                self.retries += 1
        self.rows_returned += int(rec.get("rows_returned", 0) or 0)
        self.rows_pruned += int(rec.get("rows_pruned", 0) or 0)
        self.last_ts_ms = max(self.last_ts_ms, int(rec.get("ts_ms", 0) or 0))
        if self.replay is None and isinstance(rec.get("replay"), dict):
            self.replay = rec["replay"]

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    @property
    def p50_s(self) -> float:
        if not self.durations:
            return 0.0
        s = sorted(self.durations)
        return s[len(s) // 2]

    def to_dict(self) -> Dict:
        return {
            "shape": self.shape,
            "count": self.count,
            "failed": self.failed,
            "total_s": round(self.total_s, 6),
            "mean_s": round(self.mean_s, 6),
            "p50_s": round(self.p50_s, 6),
            "stages": {k: round(v, 6) for k, v in sorted(self.stages.items())},
            "indexes": dict(sorted(self.indexes.items())),
            "rules": dict(sorted(self.rules.items())),
            "slo_classes": dict(sorted(self.slo_classes.items())),
            "degrades": self.degrades,
            "retries": self.retries,
            "rows_returned": self.rows_returned,
            "rows_pruned": self.rows_pruned,
            "last_ts_ms": self.last_ts_ms,
            "has_replay": self.replay is not None,
        }


@dataclasses.dataclass
class WorkloadProfile:
    """Bounded aggregate of one query-log directory's records."""

    records: int = 0
    failed: int = 0
    total_s: float = 0.0
    shapes: Dict[str, ShapeStats] = dataclasses.field(default_factory=dict)
    #: records whose shape arrived after the maxShapes cap filled
    overflow_records: int = 0
    max_shapes: int = 256

    def add(self, rec: Dict) -> None:
        self.records += 1
        if rec.get("status") != "ok":
            self.failed += 1
        self.total_s += float(rec.get("duration_s", 0.0))
        shape = str(rec.get("predicate", "") or "")
        group = self.shapes.get(shape)
        if group is None:
            if len(self.shapes) >= self.max_shapes:
                self.overflow_records += 1
                profile_overflow_total.inc()
                return
            group = self.shapes[shape] = ShapeStats(shape=shape)
        group.add(rec)

    def hot_shapes(self, n: Optional[int] = None) -> List[ShapeStats]:
        """Shape groups by aggregate cost (count x duration), hottest
        first — the candidate-enumeration order."""
        out = sorted(
            self.shapes.values(),
            key=lambda s: (-s.total_s, -s.count, s.shape),
        )
        return out if n is None else out[:n]

    def to_dict(self, top: Optional[int] = None) -> Dict:
        return {
            "records": self.records,
            "failed": self.failed,
            "total_s": round(self.total_s, 6),
            "shapes": len(self.shapes),
            "overflow_records": self.overflow_records,
            "hot_shapes": [s.to_dict() for s in self.hot_shapes(top)],
        }


def build_profile(records, max_shapes: int = 256) -> WorkloadProfile:
    """Fold an iterable of querylog records into a bounded profile
    (``advisor.scan`` stage under the advise() root)."""
    with obs_trace.span("advisor.scan"):
        profile = WorkloadProfile(max_shapes=max(1, int(max_shapes)))
        for rec in records:
            profile.add(rec)
        profiles_total.inc()
        return profile


def profile_directory(directory: str, max_shapes: int = 256) -> WorkloadProfile:
    """Union one obs directory's query-log segments (every process,
    torn tails and unknown schema_v skipped) into a profile."""
    return build_profile(
        _querylog.read_valid_records(directory), max_shapes=max_shapes
    )
