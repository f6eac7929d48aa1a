"""Typed telemetry events + pluggable event logger.

Reference: ``telemetry/HyperspaceEvent.scala:28-166`` (event case classes),
``telemetry/HyperspaceEventLogging.scala:30-68`` (pluggable logger via
``spark.hyperspace.eventLoggerClass``, default no-op).

The obs plane (docs/observability.md) gives this port a real in-tree
sink at last: :class:`JsonlEventLogger` (select it with
``hyperspace.eventLoggerClass =
hyperspace_tpu_torch.telemetry.JsonlEventLogger``; default stays the no-op)
appends one JSON line per event, and EVERY event — whatever the logger —
counts into the metrics registry (``hs_events_total`` by event class)
and carries the active trace id, so lifecycle events join the same
stream queries trace through.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import time
from typing import List, Optional

from hyperspace_tpu_torch import constants as C


@dataclasses.dataclass
class AppInfo:
    """Reference: telemetry/HyperspaceEvent.scala AppInfo(sparkUser, appId, appName)."""

    user: str = ""
    app_id: str = ""
    # the reference's app name, so the two packages' event lines agree
    app_name: str = "hyperspace_tpu"


@dataclasses.dataclass
class HyperspaceEvent:
    app_info: AppInfo = dataclasses.field(default_factory=AppInfo)
    message: str = ""
    # 0 = "not yet emitted": EventLogging.log_event stamps the EMIT
    # time. A dataclass default_factory stamped CONSTRUCTION time, so a
    # batch of events built up front all shared one timestamp — the
    # log's timeline lied about when things actually happened.
    timestamp_ms: int = 0


@dataclasses.dataclass
class HyperspaceIndexCRUDEvent(HyperspaceEvent):
    index_name: str = ""


@dataclasses.dataclass
class CreateActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class DeleteActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class RestoreActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class VacuumActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class VacuumOutdatedActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class RefreshActionEvent(HyperspaceIndexCRUDEvent):
    mode: str = C.REFRESH_MODE_FULL


@dataclasses.dataclass
class RefreshIncrementalActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class RefreshQuickActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class OptimizeActionEvent(HyperspaceIndexCRUDEvent):
    mode: str = C.OPTIMIZE_MODE_QUICK


@dataclasses.dataclass
class CancelActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclasses.dataclass
class HyperspaceIndexUsageEvent(HyperspaceEvent):
    """Emitted when the planner picks index(es) for a query.

    Reference: covering/JoinIndexRule.scala:678-684.
    """

    index_names: List[str] = dataclasses.field(default_factory=list)
    plan: str = ""


class EventLogger:
    """Pluggable sink. Default = no-op (telemetry/HyperspaceEventLogging.scala:66)."""

    def log_event(self, event: HyperspaceEvent) -> None:  # pragma: no cover
        pass


class JsonlEventLogger(EventLogger):
    """The real in-tree sink (default-OFF — select it via
    ``hyperspace.eventLoggerClass``): one JSON line per event, appended
    to ``hyperspace.obs.eventlog.path`` or, when that is empty, to
    ``<hyperspace.system.path>/_hyperspace_obs/events.<pid>.jsonl``
    (per-process file — fleet-safe like the query log; readers union).
    Write failures are swallowed after the first warning: an event log
    must never fail the action it describes."""

    def __init__(self, conf=None):
        self._conf = conf
        self._sink = None
        self._dead = False

    def _resolve_sink(self):
        from hyperspace_tpu_torch.obs import metrics as obs_metrics
        from hyperspace_tpu_torch.obs import querylog as obs_querylog

        path = ""
        if self._conf is not None:
            path = self._conf.get_str(
                C.OBS_EVENTLOG_PATH, C.OBS_EVENTLOG_PATH_DEFAULT
            )
            if not path:
                path = os.path.join(
                    obs_querylog.obs_root(self._conf),
                    f"events.{os.getpid()}.jsonl",
                )
        else:
            path = os.path.join(
                C.INDEX_SYSTEM_PATH_DEFAULT,
                C.HYPERSPACE_OBS_DIR,
                f"events.{os.getpid()}.jsonl",
            )
        return obs_metrics.JsonlSink(path)

    def log_event(self, event: HyperspaceEvent) -> None:
        if self._dead:
            return
        try:
            if self._sink is None:
                self._sink = self._resolve_sink()
            record = dataclasses.asdict(event)
            record["event"] = type(event).__name__
            self._sink.emit(record)
        except OSError:
            # an unwritable sidecar downgrades to the no-op logger for
            # the rest of the process — same never-fail-the-caller
            # stance as the query log
            self._dead = True

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


class EventLogging:
    """Dispatches events to the logger class named in config — and,
    since the obs plane, stamps every event's ``timestamp_ms`` at EMIT
    time, attaches the active trace id, and counts it into the metrics
    registry (``hs_events_total`` by event class): action events ride
    the same observability path queries do, whatever sink is
    configured."""

    def __init__(self, conf):
        self._conf = conf
        self._logger: Optional[EventLogger] = None
        self._logger_cls_name: Optional[str] = None

    def _resolve(self) -> EventLogger:
        name = self._conf.get_str(
            C.EVENT_LOGGER_CLASS, C.EVENT_LOGGER_CLASS_DEFAULT
        )
        if self._logger is None or name != self._logger_cls_name:
            if name:
                mod, _, cls = name.rpartition(".")
                logger_cls = getattr(importlib.import_module(mod), cls)
                try:
                    # in-tree loggers take the session conf (the Jsonl
                    # sink resolves its path from it); third-party ones
                    # keep the reference's zero-arg contract
                    self._logger = logger_cls(self._conf)
                except TypeError:
                    self._logger = logger_cls()
            else:
                self._logger = EventLogger()
            self._logger_cls_name = name
        return self._logger

    def log_event(self, event: HyperspaceEvent) -> None:
        from hyperspace_tpu_torch.obs import metrics as obs_metrics
        from hyperspace_tpu_torch.obs import trace as obs_trace

        if not event.timestamp_ms:
            event.timestamp_ms = int(time.time() * 1000)
        obs_metrics.events_total.inc(type(event).__name__)
        trace_id = obs_trace.current_trace_id()
        if trace_id is not None:
            obs_trace.event(
                "telemetry", event=type(event).__name__, message=event.message
            )
        self._resolve().log_event(event)
