"""Durable query log — the workload profile the advisor mines.

Counterpart of ``hyperspace_tpu/obs/querylog.py``; the on-disk format is
the reference's, so either package reads the other's segments. One
JSONL record a served query, appended to a bounded, rotated sidecar
directory next to the lake (``<hyperspace.system.path>/_hyperspace_obs/``).

Record schema (one JSON object a line; ``schema_v`` bumps on change)::

    ts_ms            admission wall-clock ms
    trace_id         the query's root span (None with tracing off)
    fingerprint      sha256[:16] of the plan fingerprint
    predicate        structural predicate shape (no literals)
    slo_class        admission class or None
    indexes          index names serving the rewritten plan ([] = source)
    rule             rewrite flavor ("join"/"filter"/"agg"/... or None)
    duration_s       client-observed serve seconds
    stages           {stage: busy_seconds} from the root span's children
    rows_returned    result rows
    rows_pruned      row groups pruned by the range plane during THIS
                     execution (obs/trace.accumulate onto the root)
    replay           optional re-executable plan spec (obs/planspec.py),
                     only with ``hyperspace.obs.querylog.recordPlans``
    events           the root's point events (retries, degrades, links)
    status           "ok" | "failed"

:func:`record_from_root` builds a record from a query's root span.

Fleet safety: every process appends to its own files
(``querylog.<pid>.<nonce>.jsonl``); the reader unions all files.

Rotation: past ``maxBytes`` the active file is flushed and fsynced, then
renamed to a sealed segment, then a fresh active file is opened; at most
``maxFiles`` sealed segments are kept a process. The
``mid_querylog_rotate`` crash point (``testing/faults.py``) fires between
the fsync and the rename: a writer dying there leaves the active file
fsynced but unsealed, and readers union it like any segment.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid
from typing import Dict, List, Optional

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.obs import metrics as _metrics
from hyperspace_tpu_torch.testing import faults
from hyperspace_tpu_torch.utils import files as file_utils

SCHEMA_V = 1


def obs_root(conf) -> str:
    """``<hyperspace.system.path>/_hyperspace_obs`` — the lake-level
    observability sidecar directory."""
    system_path = conf.get_str(
        C.INDEX_SYSTEM_PATH, C.INDEX_SYSTEM_PATH_DEFAULT
    )
    return os.path.join(system_path, C.HYPERSPACE_OBS_DIR)


class QueryLog:
    """One process's append handle on a query-log directory.

    Thread model: ``append`` may be called from any serve worker; one
    lock serializes the write+rotate critical section (file I/O runs
    under it deliberately — this is a diagnostics plane, its lock is
    shared with nothing else and its latency is one buffered line
    write; rotation is rare and bounded)."""

    def __init__(
        self,
        directory: str,
        max_bytes: int = C.OBS_QUERYLOG_MAX_BYTES_DEFAULT,
        max_files: int = C.OBS_QUERYLOG_MAX_FILES_DEFAULT,
    ):
        self.directory = directory
        self.max_bytes = max(1, int(max_bytes))
        self.max_files = max(1, int(max_files))
        # pid + nonce: a recycled pid (or two logs in one test process)
        # must never append to a previous incarnation's active file
        self._tag = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self._seq = 0
        self.records = 0
        self.rotations = 0
        self.errors = 0

    # -- paths ---------------------------------------------------------------
    def _active_path(self) -> str:
        return os.path.join(self.directory, f"querylog.{self._tag}.jsonl")

    def _sealed_path(self, seq: int) -> str:
        return os.path.join(
            self.directory, f"querylog.{self._tag}.{seq:06d}.sealed.jsonl"
        )

    # -- append --------------------------------------------------------------
    def append(self, record: Dict) -> bool:
        """Write one record (adds ``schema_v``). Returns False — never
        raises — when the sidecar is unwritable: the query log is a
        diagnostics plane and must not fail the query it describes."""
        record = dict(record)
        record.setdefault("schema_v", SCHEMA_V)
        record.setdefault("ts_ms", int(time.time() * 1000))
        try:
            line = json.dumps(record, default=str, sort_keys=True) + "\n"
        except (TypeError, ValueError):
            self.errors += 1
            _metrics.querylog_errors_total.inc()
            return False
        # lock-held file I/O is this plane's documented design (class
        # docstring): the lock is private, shared with nothing else,
        # and one buffered line write is the hot cost
        with self._lock:  # hslint: disable=HS502
            try:
                if self._fh is None:
                    os.makedirs(self.directory, exist_ok=True)
                    self._fh = open(self._active_path(), "a", encoding="utf-8")
                    self._size = self._fh.tell()
                self._fh.write(line)
                self._fh.flush()
                self._size += len(line.encode("utf-8"))
                self.records += 1
                _metrics.querylog_records_total.inc()
                if self._size >= self.max_bytes:
                    self._rotate_locked()
            except OSError:
                self.errors += 1
                _metrics.querylog_errors_total.inc()
                return False
        return True

    def _rotate_locked(self) -> None:
        """Seal the active file (fsync → crash point → atomic rename →
        dir fsync), open a fresh one, prune old segments. A crash at
        ``mid_querylog_rotate`` leaves the fsynced active file in place
        under its active name — readers union it like any segment, the
        next process uses its own tag, nothing is lost or doubled."""
        fh, self._fh = self._fh, None
        try:
            fh.flush()
            os.fsync(fh.fileno())
        finally:
            fh.close()
        # the crash window the recovery matrix exercises: data durable,
        # segment not yet sealed
        faults.crash("mid_querylog_rotate", self._active_path())
        self._seq += 1
        os.replace(self._active_path(), self._sealed_path(self._seq))
        file_utils.fsync_dir(self.directory)
        self.rotations += 1
        _metrics.querylog_rotations_total.inc()
        self._size = 0
        self._fh = open(self._active_path(), "a", encoding="utf-8")
        self._prune_locked()

    def _prune_locked(self) -> None:
        """Keep at most ``max_files`` sealed segments of THIS process
        (other processes prune their own — no cross-process races)."""
        prefix = f"querylog.{self._tag}."
        try:
            names = sorted(
                n
                for n in os.listdir(self.directory)
                if n.startswith(prefix) and n.endswith(".sealed.jsonl")
            )
        except OSError:
            return
        for name in names[: max(0, len(names) - self.max_files)]:
            file_utils.delete(os.path.join(self.directory, name))

    def close(self) -> None:
        # same private-lock I/O contract as append()
        with self._lock:  # hslint: disable=HS502
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except (OSError, ValueError):
                    pass
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "QueryLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def record_from_root(root, duration_s: Optional[float] = None) -> Dict:
    """One query-log record from a finished (or finishing) query root
    span, in the reference frontend's schema (its ``_querylog_append``):
    the root's attributes ``fingerprint``, ``predicate``, ``slo_class``,
    ``indexes``, ``rule``, ``rows_returned``, ``rows_pruned``, ``status``
    and ``replay``, its stage seconds and its last 32 events.
    ``duration_s`` defaults to the root's own duration, or the seconds
    since it started while it is open."""
    if duration_s is None:
        duration_s = (
            root.duration_s
            if root.duration_s is not None
            else time.perf_counter() - root._t0
        )
    rec = {
        "ts_ms": root.start_ms,
        "trace_id": root.trace_id,
        "fingerprint": root.attrs.get("fingerprint", ""),
        "predicate": root.attrs.get("predicate", ""),
        "slo_class": root.attrs.get("slo_class"),
        "indexes": root.attrs.get("indexes", []),
        "rule": root.attrs.get("rule"),
        "duration_s": duration_s,
        "stages": {k: round(v, 6) for k, v in root.stage_seconds().items()},
        "rows_returned": root.attrs.get("rows_returned", 0),
        "rows_pruned": int(root.attrs.get("rows_pruned", 0)),
        "events": [dict(ev) for ev in root.events[-32:]],
        "status": root.attrs.get("status", "ok"),
    }
    spec = root.attrs.get("replay")
    if spec is not None:
        rec["replay"] = spec
    return rec


def open_log(conf, directory: Optional[str] = None) -> Optional[QueryLog]:
    """The serve tier's query log (reference ``serve/frontend.py:196-203``):
    a :class:`QueryLog` under ``directory`` (default :func:`obs_root`)
    sized by ``hyperspace.obs.querylog.maxBytes`` and ``.maxFiles``, when
    ``hyperspace.obs.enabled`` and ``hyperspace.obs.querylog.enabled`` are
    both on; None otherwise."""
    if not (conf.obs_enabled and conf.obs_querylog_enabled):
        return None
    return QueryLog(
        directory or obs_root(conf),
        max_bytes=conf.obs_querylog_max_bytes,
        max_files=conf.obs_querylog_max_files,
    )


def plan_attrs(conf, plan) -> Dict:
    """A query root's plan attributes as the reference frontend sets them
    at admission (``serve/frontend.py:296-306``): the literal-free
    ``predicate`` shape, and, with ``hyperspace.obs.querylog.recordPlans``
    on, the ``replay`` spec (``obs.planspec.to_spec``; specs carry
    literals, so they are opt-in)."""
    attrs = {"predicate": predicate_shape(plan)}
    if conf.obs_querylog_record_plans:
        from hyperspace_tpu_torch.obs import planspec

        spec = planspec.to_spec(plan)
        if spec is not None:
            attrs["replay"] = spec
    return attrs

def read_records(directory: str) -> List[Dict]:
    """Union every process's records under ``directory`` (active files
    AND sealed segments), oldest-file-first, torn trailing lines
    skipped — the reader side of the fleet-safe contract."""
    try:
        names = sorted(
            n
            for n in os.listdir(directory)
            if n.startswith("querylog.") and n.endswith(".jsonl")
        )
    except OSError:
        return []
    out: List[Dict] = []
    for name in names:
        out.extend(_metrics.read_jsonl(os.path.join(directory, name)))
    return out


def read_valid_records(directory: str) -> List[Dict]:
    """:func:`read_records` plus the forward-compat filter every
    CONSUMER (advisor, replay, bench gates) must apply: records whose
    ``schema_v`` is missing, non-int, or NEWER than this reader
    understands are skipped and counted
    (``hs_obs_querylog_skipped_total``), never raised on — a fleet mid
    rolling-upgrade has old readers and new writers sharing one
    directory, and an old advisor choking on a new record shape would
    turn a diagnostics plane into an outage."""
    out: List[Dict] = []
    for rec in read_records(directory):
        v = rec.get("schema_v")
        if not isinstance(v, int) or isinstance(v, bool) or v > SCHEMA_V:
            _metrics.querylog_skipped_total.inc()
            continue
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Plan summaries (profile-safe: structure, never literals)
# ---------------------------------------------------------------------------

_LITERAL_STR = re.compile(r"'[^']*'|\"[^\"]*\"")
_LITERAL_NUM = re.compile(r"(?<![\w.])\d+(?:\.\d+)?(?![\w.])")


def predicate_shape(plan) -> str:
    """The plan's structural shape with every literal scrubbed to ``?``
    — stable across parameter values, so the advisor can group records
    by query TEMPLATE (the unit index recommendations apply to) without
    the log ever retaining user data."""
    try:
        shape = repr(plan)
    except Exception:  # hslint: disable=HS402
        # a summary helper must never fail the query it describes
        return ""
    shape = _LITERAL_STR.sub("'?'", shape)
    shape = _LITERAL_NUM.sub("?", shape)
    return shape[:2048]


def indexes_in_plan(plan) -> List[str]:
    """Index names serving a REWRITTEN plan: leaf relations reading
    from a ``v__=N`` index version directory name the index one path
    component up. Empty list = the source plan (no rewrite)."""
    names: List[str] = []
    try:
        for leaf in plan.collect_leaves():
            for f in leaf.relation.files[:1]:
                parts = str(f).replace("\\", "/").split("/")
                for i, part in enumerate(parts):
                    if part.startswith(C.INDEX_VERSION_DIR_PREFIX + "=") and i:
                        if parts[i - 1] not in names:
                            names.append(parts[i - 1])
                        break
    except Exception:  # hslint: disable=HS402
        return names
    return names


def rule_flavor(plan) -> Optional[str]:
    """Coarse rewrite flavor from the ORIGINAL plan's shape — the
    advisor's grouping key, not a precise rule name. The dominant
    operator wins: any Join anywhere makes it a join plan, else an
    Aggregate makes it agg, else filter/scan by the top shape."""
    try:
        kinds = set()
        stack = [plan]
        while stack:
            node = stack.pop()
            kinds.add(type(node).__name__)
            for attr in ("child", "left", "right"):
                sub = getattr(node, attr, None)
                if sub is not None:
                    stack.append(sub)
        if "Join" in kinds:
            return "join"
        if "Aggregate" in kinds:
            return "agg"
        if "Filter" in kinds or "Project" in kinds:
            return "filter"
        if "Union" in kinds:
            return "union"
        return "scan"
    except Exception:  # hslint: disable=HS402
        return None


def validate_record(record: Dict) -> Optional[str]:
    """Schema check for one record (the bench_smoke replay gate):
    returns an error string or None. Required fields must exist with
    the right JSON types; unknown fields are allowed (forward
    compatibility)."""
    required = {
        "schema_v": int,
        "ts_ms": int,
        "fingerprint": str,
        "duration_s": (int, float),
        "status": str,
        "stages": dict,
        "rows_returned": int,
    }
    for field, typ in required.items():
        if field not in record:
            return f"missing field {field!r}"
        if not isinstance(record[field], typ):
            return (
                f"field {field!r} has type "
                f"{type(record[field]).__name__}, want {typ}"
            )
    if record["status"] not in ("ok", "failed"):
        return f"bad status {record['status']!r}"
    for stage, v in record["stages"].items():
        if not isinstance(v, (int, float)):
            return f"stage {stage!r} timing is not numeric"
    return None
