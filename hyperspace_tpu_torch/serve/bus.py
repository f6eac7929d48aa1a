"""Index-version fanout bus: the fleet's publish/subscribe plane.

Counterpart of ``hyperspace_tpu/serve/bus.py``; the event files and their
names are the reference's, so either package's frontends read the other's
events. A refresh, optimize or vacuum in one frontend process is made
visible to its peers through the smallest durable interface that works on a
shared filesystem:

* **Publish.** Every committed lifecycle action appends one JSON event file
  under ``<system.path>/_hyperspace_fleet/bus/`` (fsync-before-replace,
  ``utils/files.py``), named ``<ms>.<owner>.<n>.json`` so a lexicographic
  sort is a time sort. Events carry the index root to invalidate and, for
  actions that leave the index ACTIVE with fresh aggregate sidecars, the
  pushed ``("aggstate", fp)`` payload (``indexes/aggindex.fanout_payload``).
* **Subscribe.** Each fleet frontend runs one poll thread
  (``hyperspace.fleet.bus.pollMs``) that lists the bus directory, applies
  unseen events oldest-first and skips its own publications.
* **Retention.** Publishers prune event files older than
  ``hyperspace.fleet.bus.retainMs``. Correctness never depends on an event
  arriving: every cache key fingerprints the immutable file set, so a
  missed event costs a lazy re-read, not a stale answer.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.utils import files as file_utils

_log = logging.getLogger("hyperspace_tpu_torch.fleet.bus")

#: this process's bus identity — subscribers skip events they published
_process_owner = uuid.uuid4().hex[:12]

# process-wide event sequence: every publisher (frontends, the
# lifecycle-action hook) names events through this one counter, so two
# publishes in the same millisecond can never collide on a file name
# (SHARED_STATE: guarded by _seq_lock)
_seq_lock = threading.Lock()
_seq = 0


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def fleet_root(conf) -> str:
    """``<hyperspace.system.path>/_hyperspace_fleet`` — the lake-level
    coordination directory (bus events + single-flight spool)."""
    system_path = conf.get_str(
        C.INDEX_SYSTEM_PATH, C.INDEX_SYSTEM_PATH_DEFAULT
    )
    return os.path.join(system_path, C.HYPERSPACE_FLEET_DIR)


def bus_dir(conf) -> str:
    return os.path.join(fleet_root(conf), "bus")


def _now_ms() -> int:
    return int(time.time() * 1000)


class FleetBus:
    """One process's handle on the fanout bus directory.

    Thread model: ``publish``/``poll_once`` may be called from any
    thread (they touch only local variables and the filesystem);
    ``start``/``stop`` manage the single poll thread. The seen-set is
    owned by the poll side (one mutator; ``poll_once`` from tests and
    the poll thread are never concurrent by contract)."""

    def __init__(
        self,
        directory: str,
        poll_ms: int = C.FLEET_BUS_POLL_MS_DEFAULT,
        retain_ms: int = C.FLEET_BUS_RETAIN_MS_DEFAULT,
        owner: Optional[str] = None,
    ):
        self.directory = directory
        # per-INSTANCE identity: a frontend must still receive events
        # published by a lifecycle action in its own process (the
        # action's publisher is a different instance), while skipping
        # its own publications
        self.owner = owner or uuid.uuid4().hex[:12]
        self.poll_ms = max(1, int(poll_ms))
        self.retain_ms = max(0, int(retain_ms))
        self._seen: set = set()
        self._primed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # telemetry (single-writer each: publish side / poll side)
        self.published = 0
        self.received = 0
        self.pruned = 0

    # -- publish -------------------------------------------------------------
    def publish(self, event: Dict) -> Optional[str]:
        """Append one event (fsync-before-replace); returns the event
        file name, or None when the bus directory is unwritable (the
        fleet degrades to age-out invalidation, never fails the
        action)."""
        name = f"{_now_ms():013d}.{self.owner}.{_next_seq():06d}.json"
        payload = dict(event)
        payload["owner"] = self.owner
        # the durable name rides IN the payload too: the fast push plane
        # forwards the same payload, and subscribers dedup push-vs-poll
        # delivery by this name
        payload["name"] = name
        try:
            file_utils.atomic_overwrite(
                os.path.join(self.directory, name), json.dumps(payload)
            )
        except OSError as exc:
            _log.warning("fleet bus publish failed: %s", exc)
            return None
        self.published += 1
        self._prune()
        return name

    def _prune(self) -> None:
        """Drop event files older than the retention window (publisher
        duty, best-effort)."""
        if self.retain_ms <= 0:
            return
        horizon = _now_ms() - self.retain_ms
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            stamp = name.split(".", 1)[0]
            if stamp.isdigit() and int(stamp) < horizon:
                file_utils.delete(os.path.join(self.directory, name))
                self.pruned += 1

    # -- subscribe -----------------------------------------------------------
    def prime(self) -> None:
        """Mark every event already on the bus as seen — a frontend
        attaching now starts from current state (its caches are empty;
        history would only be redundant work)."""
        try:
            self._seen = set(os.listdir(self.directory))
        except OSError:
            self._seen = set()
        self._primed = True

    def poll_once(self) -> List[Dict]:
        """Unseen peer events, oldest first (and marked seen)."""
        if not self._primed:
            self.prime()
            return []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        out: List[Dict] = []
        for name in names:
            if name in self._seen or not name.endswith(".json"):
                continue
            self._seen.add(name)
            try:
                with open(
                    os.path.join(self.directory, name), "r", encoding="utf-8"
                ) as fh:
                    event = json.load(fh)
            except (OSError, ValueError):
                continue  # pruned under us, or torn on a non-atomic mount
            if event.get("owner") == self.owner:
                continue
            self.received += 1
            out.append(event)
        # forget names that no longer exist so the seen-set stays bounded
        # by the retention window
        self._seen &= set(names)
        return out

    def start(self, callback: Callable[[Dict], None]) -> None:
        """Run the poll loop on a daemon thread, handing each peer event
        to ``callback`` (exceptions are contained per event — one bad
        payload must not kill the subscription)."""
        if self._thread is not None:
            return
        self.prime()

        def _loop() -> None:
            while not self._stop.wait(self.poll_ms / 1000.0):
                for event in self.poll_once():
                    try:
                        callback(event)
                    except Exception as exc:  # hslint: disable=HS402
                        # contain by contract: the bus is an optimization
                        # plane; a poisoned event costs one warning, not
                        # the subscription (every cache key is
                        # fingerprint-addressed, so skipping is safe)
                        _log.warning("fleet bus event failed: %s", exc)

        self._thread = threading.Thread(
            target=_loop, name="hs-fleet-bus", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# The lifecycle publisher (called by actions/base.py after commit)
# ---------------------------------------------------------------------------


def publish_action_event(session, index_name, index_path, action_name, entry):
    """Publish one committed lifecycle action to the fleet bus. No-op
    outside fleet mode; never raises (the action already committed — a
    failed fanout costs peers a lazy re-read, nothing else)."""
    conf = session.conf
    if not conf.fleet_enabled:
        return
    event: Dict = {
        "type": "index_changed",
        "action": action_name,
        "index": index_name,
        "root": str(index_path).replace("\\", "/"),
    }
    # cross-process trace propagation: the publishing action's trace id
    # rides the event, so a peer's eviction or install links to the action
    # that caused it (absent with obs off)
    from hyperspace_tpu_torch.obs import trace as obs_trace

    trace_id = obs_trace.current_trace_id()
    if trace_id is not None:
        event["trace_id"] = trace_id
    try:
        if (
            entry is not None
            and entry.state == C.States.ACTIVE
            and conf.index_agg_enabled
        ):
            from hyperspace_tpu_torch.indexes import aggindex

            payload = aggindex.fanout_payload(entry.content.files)
            if payload is not None:
                event["aggstate"] = payload
        bus = FleetBus(
            bus_dir(conf),
            poll_ms=conf.fleet_bus_poll_ms,
            retain_ms=conf.fleet_bus_retain_ms,
        )
        name = bus.publish(event)
        if name is not None and conf.fleet_fast_enabled:
            # fast fanout AFTER the durable write: peers the push
            # reaches evict in microseconds; peers it misses see the
            # identical payload (same "name") at their next poll
            from hyperspace_tpu_torch.serve import router as fleet_router

            fleet_router.push_event_to_members(
                conf, {**event, "owner": bus.owner, "name": name}
            )
    except Exception as exc:  # hslint: disable=HS402
        # catch-all IS the contract: fanout is best-effort by design
        _log.warning("fleet bus publish failed for %s: %s", index_name, exc)
