"""Typed metrics registry — counters, gauges, stage timers, views.

Counterpart of ``hyperspace_tpu/obs/metrics.py``, same surface:

* **Instruments.** :class:`Counter`, :class:`Gauge`,
  :class:`LabeledCounter` and :class:`StageTimer`, each with its own
  lock, registered by name in the process-global :data:`registry`.
  The reference keeps its serve and build breakdowns as module dicts
  that its stage timers adopt. The port keeps them on the session
  (``session.join_stats``, ``session.build_stats``), so its two
  breakdown instruments, ``hs_serve_stage_seconds`` and
  ``hs_build_stage_seconds``, are stage timers over a *source*: a
  callable that reads the latest session's own dict
  (:meth:`StageTimer.follow`). No second copy is kept.

* **Views.** Live ``stats()`` providers (the serve cache) register a
  snapshot callable; :meth:`MetricsRegistry.snapshot` and the Prometheus
  exporter read through them.

* **Exporters.** :meth:`MetricsRegistry.render_prometheus` (instruments
  and flattened numeric view leaves, Prometheus text format) and
  :class:`JsonlSink` (JSON lines, fsync on close; the sink of
  ``telemetry.JsonlEventLogger``).

* :func:`merge_snapshots`: numeric values sum, ``snapshot_at_ms`` /
  ``*high_water*`` / ``max_*`` take the max, percentile keys are
  dropped, nested dicts merge recursively.

Stdlib-only and import-cheap. All registry state is declared in
``SHARED_STATE`` (``hyperspace_tpu_torch/concurrency.py``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional


def _now_ms() -> int:
    return int(time.time() * 1000)


class Counter:
    """Monotonic counter. ``inc`` is the only mutator (own lock)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self):
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written value (set/add under the lock)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class LabeledCounter:
    """Counter family keyed by one label value (event types, fired
    points). ``data`` is the backing dict — mutate only through
    :meth:`inc` (the lock), read via :meth:`snapshot`."""

    __slots__ = ("name", "help", "lock", "data")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.lock = threading.Lock()
        self.data: Dict[str, int] = {}

    def inc(self, label: str, n: int = 1) -> None:
        with self.lock:
            self.data[label] = self.data.get(label, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self.lock:
            return dict(self.data)

    def reset(self) -> None:
        with self.lock:
            self.data.clear()


class StageTimer:
    """Per-stage busy-seconds accumulator. A caller that already owns a
    breakdown dict passes it as ``data`` (the instrument adopts that
    storage), or passes ``source``, a callable returning the dict to read
    at snapshot time: the session breakdowns are rebound per query, so
    the port's breakdown instruments read through a source and own no
    storage (``reset`` then leaves the session's dict alone)."""

    __slots__ = ("name", "help", "lock", "data", "source")

    def __init__(
        self,
        name: str,
        help_: str = "",
        data: Optional[Dict[str, float]] = None,
        lock: Optional[threading.Lock] = None,
        source: Optional[Callable[[], Dict[str, float]]] = None,
    ):
        self.name = name
        self.help = help_
        self.lock = lock if lock is not None else threading.Lock()
        self.data: Dict[str, float] = data if data is not None else {}
        self.source = source

    def add(self, stage: str, dt: float) -> None:
        with self.lock:
            self.data[stage] = self.data.get(stage, 0.0) + dt

    def snapshot(self) -> Dict[str, float]:
        source = self.source
        if source is not None:
            try:
                return dict(source())
            except Exception:  # hslint: disable=HS402
                # a collected session's source must not fail the exporter
                return {}
        with self.lock:
            return dict(self.data)

    def reset(self) -> None:
        with self.lock:
            self.data.clear()

    def follow(self, obj, attr: str) -> "StageTimer":
        """Read ``getattr(obj, attr)`` at snapshot time, through a weak
        reference (a replaced session is never kept alive). The last call
        wins, like views: the instrument follows the newest session."""
        import weakref

        ref = weakref.ref(obj)

        def source() -> Dict[str, float]:
            live = ref()
            return getattr(live, attr) if live is not None else {}

        with self.lock:
            self.source = source
        return self


_INSTRUMENT_TYPES = (Counter, Gauge, LabeledCounter, StageTimer)


class MetricsRegistry:
    """Name -> instrument/view map. One lock guards the maps; every
    instrument guards its own state — snapshotting acquires registry
    lock first, instrument locks second (one direction, no cycle), and
    no I/O ever runs under either."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self._views: Dict[str, Callable[[], dict]] = {}

    # -- registration --------------------------------------------------------
    def _get_or_create(self, cls, name: str, help_: str):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help_)
                self._instruments[name] = inst
            elif type(inst) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_)

    def labeled_counter(self, name: str, help_: str = "") -> LabeledCounter:
        return self._get_or_create(LabeledCounter, name, help_)

    def stage_timer(
        self,
        name: str,
        help_: str = "",
        data: Optional[Dict[str, float]] = None,
        lock: Optional[threading.Lock] = None,
    ) -> StageTimer:
        """Get-or-create a stage timer; pass ``data``/``lock`` to adopt
        a pre-existing breakdown dict + its declared lock (see
        :class:`StageTimer`)."""
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = StageTimer(name, help_, data=data, lock=lock)
                self._instruments[name] = inst
            elif type(inst) is not StageTimer:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not StageTimer"
                )
            return inst

    def register_view(self, name: str, provider: Callable[[], dict]) -> None:
        """Register a live snapshot provider (``stats()`` of a frontend
        or cache). Last registration wins — the process-global
        last-writer-wins telemetry doctrine; a dead provider (raises)
        renders as an empty view, never fails the snapshot."""
        with self._lock:
            self._views[name] = provider

    def register_weak_view(self, name: str, obj) -> Callable[[], dict]:
        """Register ``obj.stats()`` as the view named ``name``, weakly
        bound so the registry never keeps a replaced instance (and its
        memory) alive. Returns the provider — pass it back to
        :meth:`unregister_view` so only the CURRENT registrant can
        remove the view. ``is not None``, never truthiness: ``__len__``
        makes an empty container falsy, which would blank the view
        exactly when it matters."""
        import weakref

        ref = weakref.ref(obj)

        def provider() -> dict:
            live = ref()
            return live.stats() if live is not None else {}

        self.register_view(name, provider)
        return provider

    def unregister_view(self, name: str, provider=None) -> None:
        """Remove the view — but with ``provider`` given, only when it
        is still the registered one (a closing instance must not tear
        down a NEWER instance's live view under last-wins)."""
        with self._lock:
            if provider is None or self._views.get(name) is provider:
                self._views.pop(name, None)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """One coherent-enough dict of everything registered:
        per-instrument snapshots plus each view's current ``stats()``.
        Cross-instrument consistency is NOT promised (each instrument
        snapshots under its own lock) — the same contract as reading
        two ``last_*`` dicts was."""
        with self._lock:
            instruments = dict(self._instruments)
            views = dict(self._views)
        out: dict = {"snapshot_at_ms": _now_ms(), "instruments": {}, "views": {}}
        for name, inst in sorted(instruments.items()):
            out["instruments"][name] = inst.snapshot()
        for name, provider in sorted(views.items()):
            try:
                out["views"][name] = provider()
            except Exception:  # hslint: disable=HS402
                # a closed frontend's view must not fail the exporter
                out["views"][name] = {}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the registry: instruments as
        their natural types, views flattened to numeric leaves as
        gauges (``hs_view_<view>_<path>``)."""
        snap = self.snapshot()
        with self._lock:
            instruments = dict(self._instruments)
        lines: List[str] = []

        def emit(name, kind, help_, samples):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(samples)

        for name in sorted(instruments):
            inst = instruments[name]
            metric = _prom_name(name)
            val = snap["instruments"][name]
            if isinstance(inst, Counter):
                emit(metric, "counter", inst.help, [f"{metric} {val}"])
            elif isinstance(inst, Gauge):
                emit(metric, "gauge", inst.help, [f"{metric} {_prom_num(val)}"])
            elif isinstance(inst, LabeledCounter):
                emit(
                    metric,
                    "counter",
                    inst.help,
                    [
                        f'{metric}{{label="{k}"}} {v}'
                        for k, v in sorted(val.items())
                    ],
                )
            elif isinstance(inst, StageTimer):
                emit(
                    metric,
                    "counter",
                    inst.help,
                    [
                        f'{metric}{{stage="{k}"}} {_prom_num(v)}'
                        for k, v in sorted(val.items())
                    ],
                )
        for view_name in sorted(snap["views"]):
            flat = _flatten_numeric(snap["views"][view_name])
            if not flat:
                continue
            metric = _prom_name(f"hs_view_{view_name}")
            lines.append(f"# TYPE {metric} gauge")
            lines.extend(
                f'{metric}{{key="{k}"}} {_prom_num(v)}'
                for k, v in sorted(flat.items())
            )
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every instrument and drop the views (test isolation;
        instruments stay registered — module-level handles keep
        working)."""
        with self._lock:
            instruments = list(self._instruments.values())
            self._views.clear()
        for inst in instruments:
            inst.reset()


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PROM_BAD.sub("_", name)


def _prom_num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _flatten_numeric(d: dict, prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    if not isinstance(d, dict):
        return out
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, bool):
            out[key] = float(v)
        elif isinstance(v, (int, float)):
            out[key] = v
        elif isinstance(v, dict):
            out.update(_flatten_numeric(v, prefix=f"{key}_"))
    return out


#: the process-global registry (SHARED_STATE: its maps mutate only
#: under its lock; instruments carry their own locks)
registry = MetricsRegistry()

#: trace-plane counters (obs/trace.py increments these at root finish)
traces_total = registry.counter(
    "hs_obs_traces_total", "completed root spans (queries + actions)"
)
spans_total = registry.counter(
    "hs_obs_spans_total", "completed spans across all traces"
)
#: telemetry events routed through EventLogging (labeled by event class)
events_total = registry.labeled_counter(
    "hs_events_total", "telemetry events by event class"
)
#: querylog plumbing health (obs/querylog.py)
querylog_records_total = registry.counter(
    "hs_querylog_records_total", "query-log records appended"
)
querylog_rotations_total = registry.counter(
    "hs_querylog_rotations_total", "query-log segment rotations"
)
querylog_errors_total = registry.counter(
    "hs_querylog_errors_total", "query-log append/rotate failures (dropped)"
)
querylog_skipped_total = registry.counter(
    "hs_obs_querylog_skipped_total",
    "query-log records skipped by readers (unknown/newer schema_v)",
)


# ---------------------------------------------------------------------------
# Snapshot merging (the three hand-merge sites this replaces:
# testing/fleet_harness.py per-worker fleet sums x3; bench.py reads the
# merged dict)
# ---------------------------------------------------------------------------

#: keys combined by max, not sum (watermarks and snapshot stamps)
_MAX_KEYS = re.compile(r"(^|_)(high_water|max)(_|$)|snapshot_at_ms")
#: keys that do not merge at all (percentiles of disjoint populations)
_DROP_KEYS = re.compile(r"^p\d+(_|$)")


def merge_snapshots(*snaps: dict) -> dict:
    """Merge counter snapshots (``stats()`` dicts) from several
    frontends/processes into one: numeric values SUM, watermark-style
    keys (``*high_water*``, ``max_*``/``*_max``, ``snapshot_at_ms``)
    take the MAX, percentile keys (``p50_ms``…) are dropped
    (percentiles of disjoint populations do not merge), nested dicts
    merge recursively, and non-numeric leaves keep the first value
    seen. The one documented way to combine fleet counters —
    bench.py/fleet_harness hand-rolled this thrice before."""
    out: dict = {}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for k, v in snap.items():
            if _DROP_KEYS.search(str(k)):
                continue
            if isinstance(v, dict):
                prev = out.get(k)
                out[k] = merge_snapshots(
                    prev if isinstance(prev, dict) else {}, v
                )
            elif isinstance(v, bool) or not isinstance(v, (int, float)):
                out.setdefault(k, v)
            elif k not in out or not isinstance(out[k], (int, float)):
                out[k] = v
            elif _MAX_KEYS.search(str(k)):
                out[k] = max(out[k], v)
            else:
                out[k] = out[k] + v
    return out


# ---------------------------------------------------------------------------
# JSONL sink
# ---------------------------------------------------------------------------


class JsonlSink:
    """Append-only JSON-lines sink (one record per line, flushed per
    write so a crash loses at most the in-flight line; the reader side
    skips torn trailing lines). Thread-safe; ``close`` fsyncs."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, record: dict) -> None:
        line = json.dumps(record, default=str, sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        # lock-held I/O is this sink's deliberate design: the lock is
        # private to the sink, shared with nothing else, and serializes
        # writers against a once-per-process close
        with self._lock:  # hslint: disable=HS502
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except (OSError, ValueError):
                pass
            self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> List[dict]:
    """Parse a JSONL file, skipping torn/partial lines (the crash
    contract of :class:`JsonlSink` and the query log)."""
    out: List[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return out
    return out
