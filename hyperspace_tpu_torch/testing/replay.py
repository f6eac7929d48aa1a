"""Workload replay — recorded query logs back through the session.

Counterpart of ``hyperspace_tpu/testing/replay.py``. Two halves:

* :func:`replay_records` takes query-log records (the JSONL schema of
  ``obs/querylog.py``) and re-runs every record that carries a
  ``replay`` plan spec (``obs/planspec.py``): arrival order preserved
  (``ts_ms`` sort), optionally honouring the recorded inter-arrival gaps
  (``preserve_timing`` / ``speedup``), each submitted through
  ``session.serve_frontend`` with its recorded ``slo_class``.
  ``keep_results`` keeps each completed query's table
  (``ReplayResult.tables``, in arrival order), so a replay can be held to
  the original rows. Records without a spec are counted and skipped.

* Scenario generators (:func:`skewed_keys`, :func:`hot_key_storm`,
  :func:`rolling_appends`, :func:`tenant_mix`) emit canned workloads in
  query-log format, each record carrying a replay spec;
  :func:`record_workload` writes any record list through a real
  :class:`~hyperspace_tpu_torch.obs.querylog.QueryLog`.

``last_replay_stats`` is rebind-only telemetry (SHARED_STATE); the replay
counters live in the metrics registry (OBS_SITES
``hyperspace_tpu_torch.testing.replay``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import time
from typing import Dict, List, Optional

from hyperspace_tpu_torch.exceptions import ServeOverloadedError
from hyperspace_tpu_torch.obs import metrics as _metrics
from hyperspace_tpu_torch.obs import planspec as _planspec
from hyperspace_tpu_torch.obs import querylog as _querylog

#: replay harness health (OBS_SITES: hyperspace_tpu_torch.testing.replay)
replay_queries_total = _metrics.registry.counter(
    "hs_replay_queries_total", "queries re-submitted by the replay harness"
)
replay_skipped_total = _metrics.registry.counter(
    "hs_replay_skipped_total",
    "records skipped by replay (no replay spec, or spec rebuild failed)",
)
replay_failed_total = _metrics.registry.counter(
    "hs_replay_failed_total", "replayed queries that failed or were shed"
)

#: last completed replay's summary — telemetry, rebind-only
#: (SHARED_STATE: hyperspace_tpu_torch.testing.replay.last_replay_stats)
last_replay_stats: Dict = {}


@dataclasses.dataclass
class ReplayResult:
    """One replay pass's outcome."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    skipped: int = 0
    duration_s: float = 0.0
    latencies: List[float] = dataclasses.field(default_factory=list)
    #: completed queries' tables in arrival order (``keep_results``); a
    #: failed query leaves None in its place
    tables: List = dataclasses.field(default_factory=list)

    @property
    def qps(self) -> float:
        return self.completed / self.duration_s if self.duration_s > 0 else 0.0

    def _pct(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        s = sorted(self.latencies)
        return s[min(len(s) - 1, int(q * len(s)))]

    @property
    def p50_s(self) -> float:
        return self._pct(0.50)

    @property
    def p95_s(self) -> float:
        return self._pct(0.95)

    def to_dict(self) -> Dict:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "skipped": self.skipped,
            "duration_s": round(self.duration_s, 6),
            "qps": round(self.qps, 3),
            "p50_s": round(self.p50_s, 6),
            "p95_s": round(self.p95_s, 6),
        }


def replay_records(
    session,
    records: List[Dict],
    preserve_timing: bool = False,
    speedup: float = 1.0,
    use_slo_classes: bool = True,
    max_inflight: int = 1,
    keep_results: bool = False,
) -> ReplayResult:
    """Re-submit ``records`` through ``session.serve_frontend``.

    Arrival ORDER is always the recorded one (``ts_ms`` sort, stable).
    With ``preserve_timing`` the recorded inter-arrival gaps are honoured
    too, compressed by ``speedup``; without it, submission is
    back-to-back. ``max_inflight`` bounds overlap: 1 (default) replays
    strictly serially, larger values pipeline submissions the way
    concurrent clients would. Each record's ``slo_class`` is submitted
    with it unless ``use_slo_classes`` is off. Per-query latency is
    measured submit-to-result; a shed submit counts as failed."""
    frontend = session.serve_frontend
    ordered = sorted(records, key=lambda r: int(r.get("ts_ms", 0) or 0))
    result = ReplayResult()
    inflight: List = []  # (future, t_submit, slot)
    base_ts: Optional[int] = None
    speedup = max(1e-9, float(speedup))
    max_inflight = max(1, int(max_inflight))
    t0 = time.perf_counter()

    def drain_one() -> None:
        fut, t_submit, slot = inflight.pop(0)
        try:
            table = fut.result()
        except Exception:  # hslint: disable=HS402
            # replay reports failures, it never aborts on one query
            result.failed += 1
            replay_failed_total.inc()
        else:
            result.completed += 1
            if slot is not None:
                result.tables[slot] = table
        result.latencies.append(time.perf_counter() - t_submit)

    for rec in ordered:
        spec = rec.get("replay")
        if not isinstance(spec, dict):
            result.skipped += 1
            replay_skipped_total.inc()
            continue
        try:
            plan = _planspec.from_spec(session, spec)
        except Exception:  # hslint: disable=HS402
            # spec outside this build's replayable subset: skip + count
            result.skipped += 1
            replay_skipped_total.inc()
            continue
        if preserve_timing:
            ts = int(rec.get("ts_ms", 0) or 0)
            if base_ts is None:
                base_ts = ts
            due = (ts - base_ts) / 1000.0 / speedup
            delay = due - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
        slot = None
        if keep_results:
            slot = len(result.tables)
            result.tables.append(None)
        slo = rec.get("slo_class") if use_slo_classes else None
        t_submit = time.perf_counter()
        try:
            fut = frontend.submit(plan, slo_class=slo)
        except ServeOverloadedError:
            result.submitted += 1
            result.failed += 1
            replay_queries_total.inc()
            replay_failed_total.inc()
            continue
        result.submitted += 1
        replay_queries_total.inc()
        inflight.append((fut, t_submit, slot))
        while len(inflight) >= max_inflight:
            drain_one()
    while inflight:
        drain_one()
    result.duration_s = time.perf_counter() - t0
    global last_replay_stats
    last_replay_stats = result.to_dict()  # rebind-only telemetry publish
    return result


# ---------------------------------------------------------------------------
# scenario generators — canned workloads in query-log format
# ---------------------------------------------------------------------------


def _spec_shape(spec: Dict) -> str:
    """Deterministic literal-free shape string for a generated spec —
    the generator-side stand-in for ``querylog.predicate_shape`` (live
    records get theirs from the real plan repr)."""

    def walk(node) -> str:
        if not isinstance(node, dict):
            return "?"
        op = node.get("op", "?")
        if op == "scan":
            return f"scan({node.get('fmt')})"
        if op == "col":
            return f"col:{node.get('name')}"
        if op == "lit":
            return "?"
        if op == "in":
            return f"in({walk(node.get('child'))},?)"
        parts = [
            walk(node[k])
            for k in ("cond", "child", "left", "right")
            if k in node
        ]
        extra = ""
        if op == "project":
            extra = ",".join(node.get("cols", []))
        elif op == "aggregate":
            extra = ",".join(node.get("group_by", []))
        return f"{op}({extra + ':' if extra else ''}{','.join(parts)})"

    return walk(spec)[:2048]


def _record(
    spec: Dict, ts_ms: int, slo_class: Optional[str] = None
) -> Dict:
    """One query-log-format record around a replay spec. Fingerprint is
    the spec hash (literals included — distinct lookups stay distinct,
    exactly like the serve plane's plan fingerprint)."""
    fp = hashlib.md5(
        json.dumps(spec, sort_keys=True, default=str).encode()
    ).hexdigest()
    rec = {
        "ts_ms": int(ts_ms),
        "fingerprint": fp,
        "duration_s": 0.0,
        "status": "ok",
        "stages": {},
        "rows_returned": 0,
        "predicate": _spec_shape(spec),
        "replay": spec,
    }
    if slo_class is not None:
        rec["slo_class"] = slo_class
    return rec


def _scan(paths: List[str], fmt: str = "parquet") -> Dict:
    return {"op": "scan", "fmt": fmt, "paths": list(paths)}


def _eq(col: str, value) -> Dict:
    return {
        "op": "eq",
        "left": {"op": "col", "name": col},
        "right": {"op": "lit", "value": value},
    }


def _point_lookup(
    paths: List[str], key: str, value, project: Optional[List[str]], fmt: str
) -> Dict:
    spec: Dict = {
        "op": "filter",
        "cond": _eq(key, value),
        "child": _scan(paths, fmt),
        "spec_v": _planspec.SPEC_V,
    }
    if project:
        spec = {
            "op": "project",
            "cols": list(project),
            "child": spec,
            "spec_v": _planspec.SPEC_V,
        }
    return spec


def skewed_keys(
    paths: List[str],
    key: str,
    values: List,
    n: int,
    zipf_s: float = 1.2,
    project: Optional[List[str]] = None,
    fmt: str = "parquet",
    start_ts_ms: int = 1_000,
    interarrival_ms: int = 10,
    seed: int = 7,
) -> List[Dict]:
    """Point lookups with Zipf-skewed key popularity: the canonical
    "one hot template dominates" workload an index advisor must catch.
    Deterministic for a given seed."""
    rng = random.Random(seed)
    weights = [1.0 / (i + 1) ** zipf_s for i in range(len(values))]
    out = []
    for i in range(n):
        v = rng.choices(values, weights=weights, k=1)[0]
        out.append(
            _record(
                _point_lookup(paths, key, v, project, fmt),
                start_ts_ms + i * interarrival_ms,
            )
        )
    return out


def hot_key_storm(
    paths: List[str],
    key: str,
    hot_value,
    background_values: List,
    n: int,
    storm_fraction: float = 0.8,
    project: Optional[List[str]] = None,
    fmt: str = "parquet",
    start_ts_ms: int = 1_000,
    interarrival_ms: int = 2,
    seed: int = 11,
) -> List[Dict]:
    """A burst where one key absorbs ``storm_fraction`` of traffic at
    tight inter-arrival — the single-flight/dedup stressor (identical
    in-flight plans collapse onto one execution on replay too)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if rng.random() < storm_fraction:
            v = hot_value
        else:
            v = rng.choice(background_values)
        out.append(
            _record(
                _point_lookup(paths, key, v, project, fmt),
                start_ts_ms + i * interarrival_ms,
            )
        )
    return out


def rolling_appends(
    paths: List[str],
    ts_col: str,
    watermarks: List,
    queries_per_watermark: int = 4,
    fmt: str = "parquet",
    start_ts_ms: int = 1_000,
    interarrival_ms: int = 50,
) -> List[Dict]:
    """Recent-window scans whose lower bound advances through
    ``watermarks`` — the append-heavy shape whose profile should push
    the advisor toward REFRESH recommendations, not new indexes."""
    out = []
    i = 0
    for mark in watermarks:
        cond = {
            "op": "ge",
            "left": {"op": "col", "name": ts_col},
            "right": {"op": "lit", "value": mark},
        }
        spec = {
            "op": "filter",
            "cond": cond,
            "child": _scan(paths, fmt),
            "spec_v": _planspec.SPEC_V,
        }
        for _ in range(queries_per_watermark):
            out.append(_record(spec, start_ts_ms + i * interarrival_ms))
            i += 1
    return out


def tenant_mix(
    paths: List[str],
    key: str,
    values: List,
    classes: Dict[str, int],
    project: Optional[List[str]] = None,
    fmt: str = "parquet",
    start_ts_ms: int = 1_000,
    interarrival_ms: int = 5,
    seed: int = 13,
) -> List[Dict]:
    """Interleaved per-tenant streams: ``classes`` maps an SLO class
    name to its query count; records carry ``slo_class`` so replay
    exercises the fleet's per-class admission queues."""
    rng = random.Random(seed)
    stream = [
        cls for cls, count in sorted(classes.items()) for _ in range(count)
    ]
    rng.shuffle(stream)
    out = []
    for i, cls in enumerate(stream):
        v = rng.choice(values)
        out.append(
            _record(
                _point_lookup(paths, key, v, project, fmt),
                start_ts_ms + i * interarrival_ms,
                slo_class=cls,
            )
        )
    return out


def record_workload(
    records: List[Dict],
    directory: str,
    max_bytes: Optional[int] = None,
    max_files: Optional[int] = None,
) -> int:
    """Write ``records`` through a real :class:`QueryLog` (rotation,
    sealing, ``schema_v``) so a generated scenario round-trips the same
    reader path a fleet's live segments do. Returns records written."""
    kwargs = {}
    if max_bytes is not None:
        kwargs["max_bytes"] = max_bytes
    if max_files is not None:
        kwargs["max_files"] = max_files
    log = _querylog.QueryLog(directory, **kwargs)
    n = 0
    for rec in records:
        if log.append(dict(rec)):
            n += 1
    log.close()
    return n
