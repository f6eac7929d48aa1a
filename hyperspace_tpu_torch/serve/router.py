"""Owner routing for the fleet fast plane: membership and rendezvous.

Counterpart of ``hyperspace_tpu/serve/router.py``; the member files are
the reference's. The durable single-flight plane (``serve/fleet.py``) is an
election: every process races an atomic claim file, losers poll a spool.
This module removes the race for same-host peers: each fleet frontend
announces its fast-bus socket in a lease-expiring member file under
``<system.path>/_hyperspace_fleet/members/`` (a member that stops renewing
is dead and gets reaped, file and socket both), and plan digests are
rendezvous-hashed over the live member set, so every process agrees on one
owner a digest. The owner executes (or serves its in-memory result cache)
and streams the Arrow result back. The durable planes stay underneath: a
dead owner costs one failed connect and a claim-election retry, never a
wrong answer.

The router also carries the plane's one-way traffic: index-version fanout
pushes (:func:`push_event_to_members`), single-flight result-ready wakeups
and per-class queue-depth gossip. All of it is droppable by design.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from hyperspace_tpu_torch.serve import bus as fleet_bus
from hyperspace_tpu_torch.serve import fastbus
from hyperspace_tpu_torch.utils import files as file_utils

_log = logging.getLogger("hyperspace_tpu_torch.fleet.router")

#: member listings are cached this long — owner routing must not list a
#: directory per query (that would be the polling tax coming back)
_MEMBERS_CACHE_S = 0.25


def members_dir(conf) -> str:
    return os.path.join(fleet_bus.fleet_root(conf), "members")


def read_members(directory: str, now_ms: Optional[int] = None) -> Dict[str, Dict]:
    """``{owner: {"sock", "pid", "expiresAtMs"}}`` for every member file
    whose lease has not expired. Torn/unreadable files are skipped (the
    writer is mid-replace, or the member just got reaped)."""
    now = int(time.time() * 1000) if now_ms is None else now_ms
    out: Dict[str, Dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(
                os.path.join(directory, name), "r", encoding="utf-8"
            ) as fh:
                doc = json.load(fh)
            if int(doc["expiresAtMs"]) > now and doc.get("sock"):
                out[str(doc["owner"])] = doc
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def rendezvous_owner(owners, digest: str) -> Optional[str]:
    """Highest-random-weight choice: every process hashing the same
    member set picks the same owner, and a membership change only moves
    the digests that hashed to the lost/gained member."""
    best, best_score = None, b""
    for owner in owners:
        score = hashlib.sha256(f"{owner}:{digest}".encode("utf-8")).digest()
        if best is None or score > best_score:
            best, best_score = owner, score
    return best


def reap_members(
    directory: str, force_dead: bool = False
) -> Tuple[int, list]:
    """Reap expired member files and their socket files. With
    ``force_dead`` (same-host callers only — the harness's convergence
    check), a member whose pid no longer exists is reaped regardless of
    lease, the way a GC after the rung must not wait out a generous
    lease. Returns ``(reaped, leftover_paths)`` where leftovers are
    member or socket files that SHOULD be gone but survived."""
    now = int(time.time() * 1000)
    reaped = 0
    leftovers: list = []
    try:
        names = os.listdir(directory)
    except OSError:
        return 0, []
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            expired = int(doc.get("expiresAtMs", 0)) <= now
            pid = int(doc.get("pid", 0))
        except (OSError, ValueError, TypeError):
            # torn or vanished: treat as expired garbage
            doc, expired, pid = {}, True, 0
        dead = False
        if force_dead and pid > 0:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                dead = True
            except OSError:
                pass
        if not (expired or dead):
            continue
        file_utils.delete(path)
        sock = doc.get("sock")
        if sock:
            file_utils.delete(sock)
            if os.path.exists(sock):
                leftovers.append(sock)
        if os.path.exists(path):
            leftovers.append(path)
        reaped += 1
    return reaped, leftovers


def push_event_to_members(conf, event: Dict) -> int:
    """Best-effort fast fanout of one (already durably published) bus
    event to every live member's socket; returns deliveries. Called by
    the lifecycle publisher (``serve/bus.publish_action_event``) right
    after its durable write — a member the push misses sees the same
    event at its next poll, keyed by the same bus file name, so the two
    planes can never double-apply."""
    delivered = 0
    for _owner, doc in read_members(members_dir(conf)).items():
        try:
            if fastbus.push(doc["sock"], {"type": "event", "event": event}):
                delivered += 1
        except OSError:
            # an armed fastbus_send fault (or any send failure) degrades
            # to durable-poll delivery — the push is an optimization
            continue
    return delivered


class FleetRouter:
    """One frontend's membership + routing handle on the fast plane.

    Owns the member lease file, the fast-bus server, and the ONE
    maintenance thread (lease renewal, gossip push, expired-member
    reaping). ``handler`` receives every inbound message
    (``serve/fleet.py`` dispatches by header type). Raises ``OSError``
    at construction when the plane cannot come up (unwritable members
    dir, socket bind failure) — the caller degrades to durable-only.
    """

    def __init__(
        self,
        conf,
        owner: str,
        handler: Callable[[Dict, bytes], Optional[Tuple[Dict, bytes]]],
    ):
        self.owner = owner
        self._dir = members_dir(conf)
        self._lease_ms = conf.fleet_fast_member_lease_ms
        self._gossip_s = conf.fleet_fast_gossip_ms / 1000.0
        self._gossip_source: Optional[Callable[[], Dict]] = None
        self._server = fastbus.FastBusServer(handler)
        self._member_path = os.path.join(self._dir, f"{owner}.json")
        os.makedirs(self._dir, exist_ok=True)
        # telemetry — single-writer (maintenance thread) except
        # push_sent, which request/push callers bump under _tel_lock
        self._tel_lock = threading.Lock()
        self.gossip_sent = 0
        self.push_sent = 0
        self.members_reaped = 0
        self._members_cache: Tuple[float, Dict[str, Dict]] = (0.0, {})
        self._renew()  # listed before the first query routes
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hs-fleet-router", daemon=True
        )
        self._thread.start()

    # -- membership ----------------------------------------------------------
    def _renew(self) -> None:
        file_utils.atomic_overwrite(
            self._member_path,
            json.dumps(
                {
                    "owner": self.owner,
                    "pid": os.getpid(),
                    "sock": self._server.path,
                    "expiresAtMs": int(time.time() * 1000) + self._lease_ms,
                }
            ),
        )

    def members(self, refresh: bool = False) -> Dict[str, Dict]:
        """The live member set (cached ~250ms — routing must not pay a
        directory listing per query)."""
        now = time.monotonic()
        ts, cached = self._members_cache
        if not refresh and now - ts < _MEMBERS_CACHE_S:
            return cached
        fresh = read_members(self._dir)
        self._members_cache = (now, fresh)
        return fresh

    def owner_of(self, digest: str) -> Optional[Tuple[str, str]]:
        """``(owner, sock_path)`` this digest routes to, or None when
        membership is unreadable/empty."""
        mem = self.members()
        winner = rendezvous_owner(mem.keys(), digest)
        if winner is None:
            return None
        return winner, mem[winner]["sock"]

    # -- one-way traffic -----------------------------------------------------
    def push_to_peers(self, header: Dict, body: bytes = b"") -> int:
        """Push one message to every live member except self; returns
        deliveries (failures are the durable plane's problem)."""
        delivered = 0
        for owner, doc in self.members().items():
            if owner == self.owner:
                continue
            try:
                if fastbus.push(doc["sock"], header, body):
                    delivered += 1
            except OSError:
                continue  # armed fault / dead peer: durable plane covers
        if delivered:
            with self._tel_lock:
                self.push_sent += delivered
        return delivered

    def set_gossip_source(self, source: Callable[[], Dict]) -> None:
        """Install the per-class depth snapshot provider; the
        maintenance thread pushes it to peers every gossip period."""
        self._gossip_source = source

    def push_gossip_now(self) -> int:
        """One immediate gossip push (tests and the admission path on
        sharp depth changes; the cadence push stays the steady state)."""
        source = self._gossip_source
        if source is None:
            return 0
        sent = self.push_to_peers(
            {"type": "gossip", "owner": self.owner, "classes": source()}
        )
        if sent:
            with self._tel_lock:
                self.gossip_sent += sent
        return sent

    # -- maintenance ---------------------------------------------------------
    def _loop(self) -> None:
        renew_due = time.monotonic() + self._lease_ms / 3000.0
        reap_due = time.monotonic() + self._lease_ms / 1000.0
        while not self._stop.wait(self._gossip_s):
            now = time.monotonic()
            try:
                if now >= renew_due:
                    self._renew()
                    renew_due = now + self._lease_ms / 3000.0
                self.push_gossip_now()
                if now >= reap_due:
                    reaped, _left = reap_members(self._dir)
                    if reaped:
                        with self._tel_lock:
                            self.members_reaped += reaped
                        self._members_cache = (0.0, {})
                    reap_due = now + self._lease_ms / 1000.0
            except OSError as exc:
                # a flaky members dir degrades the fast plane, never the
                # frontend: routing misses just fall back to claims
                _log.warning("fleet router maintenance failed: %s", exc)

    def stop(self) -> None:
        """Leave cleanly: stop the maintenance thread, close + unlink
        the socket, remove the member file."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._server.stop()
        file_utils.delete(self._member_path)
