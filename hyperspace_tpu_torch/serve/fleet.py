"""FleetFrontend: one member of a replicated serve fleet.

Counterpart of ``hyperspace_tpu/serve/fleet.py``; claim, spool, pin and
member files are the reference's, so frontends of both packages can share
one lake. ``ServeFrontend`` scales one process to many clients; the fleet is
N processes sharing one index lake, coordinated for correctness through
small, durable, lease-stamped files next to the data:

* **Durable pins.** Every admitted query's pinned snapshot is also
  published as a lease-expiring file under ``<index>/_hyperspace_pins/``
  (``metadata/recovery.register_pins(durable=True)``, lease
  ``hyperspace.fleet.pin.leaseMs``), heartbeat-renewed, so an orphan GC or
  a vacuum in another process never deletes files under a live query, and
  a frontend killed with -9 stops renewing and its pins age out.
* **Version fanout.** The frontend subscribes to the fleet bus
  (``serve/bus.py``): a lifecycle action committed by any peer evicts this
  process's ``ServeCache`` entries and the zone-map and aggregate LRUs for
  the changed index, and installs pushed ``("aggstate", fp)`` payloads.
* **Cross-process single-flight.** Identical plans (same fingerprint, same
  pinned snapshot) elect one executor fleet-wide through an atomic claim
  file, and the winner publishes its answer as an Arrow IPC file in a
  bounded spool the losers read. A lost claim and a missing result execute
  locally after ``hyperspace.fleet.singleflight.waitMs``.
* **The fast plane** (``hyperspace.fleet.fast.*``; ``serve/fastbus.py``,
  ``serve/router.py``): fanout events, result-ready wakeups and SLO gossip
  pushed over Unix sockets; plan digests rendezvous-routed to one owner,
  which verifies the digest against its own pin and streams the Arrow
  result back. Any fast-path failure falls back to the claim/spool plane.
* **Fleet-wide SLO.** Per-class queue depths gossip between members, and
  the admission check counts live peers' depths.

**Kernel faults (ROADMAP C.21, beside C.7 and C.11).** The reference turns a
failed execution into a ``miss`` reply on the owner and a local rerun on an
in-process follower. In the port a hand-written kernel's fault
(``kernels.KERNEL_FAULTS``) is never hidden: the owner replies
``{"status": "miss", "reason": "kernel"}`` and counts it in
``stats()["fleet"]["kernel_faults"]``, and a follower re-raises the
leader's fault instead of rerunning the query.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import random
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

import pyarrow as pa

from hyperspace_tpu_torch.kernels import KERNEL_FAULTS
from hyperspace_tpu_torch.metadata import recovery
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import planspec as obs_planspec
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.serve import bus as fleet_bus
from hyperspace_tpu_torch.serve import fastbus
from hyperspace_tpu_torch.serve.frontend import ServeFrontend, plan_fingerprint
from hyperspace_tpu_torch.serve.router import FleetRouter
from hyperspace_tpu_torch.utils import files as file_utils

_log = logging.getLogger("hyperspace_tpu_torch.fleet")

#: claim losers re-check the spool at this cadence while waiting (the
#: result-ready push usually wakes them first; this is the roof)
_SPOOL_POLL_S = 0.01

#: jittered exponential backoff between LOST claim attempts — losers
#: must not hammer the claim file at a fixed cadence (the election part
#: of the polling tax; base doubles per loss up to the cap, then a
#: 0.5-1.5x jitter decorrelates the herd)
_ELECTION_BACKOFF_BASE_S = 0.01
_ELECTION_BACKOFF_CAP_S = 0.5

#: bus event names applied via fast push, remembered so the durable
#: poll skips re-applying them (idempotent either way; this caps the
#: memory, not the correctness)
_FAST_APPLIED_MAX = 512

# election telemetry as registered metrics (the serve.fleet module is an
# OBS_SITES "metric" site): process-global across frontends, exported by
# every sink; the per-instance stats() counters stay the per-frontend view
_election_attempts_total = obs_metrics.registry.counter(
    "hs_fleet_election_attempts_total",
    "Cross-process single-flight claim attempts",
)
_election_wins_total = obs_metrics.registry.counter(
    "hs_fleet_election_wins_total",
    "Cross-process single-flight claims won",
)
_election_losses_total = obs_metrics.registry.counter(
    "hs_fleet_election_losses_total",
    "Cross-process single-flight claims lost (a live peer held it)",
)


def spool_dir(conf) -> str:
    return os.path.join(fleet_bus.fleet_root(conf), "spool")


class FleetFrontend(ServeFrontend):
    """A :class:`ServeFrontend` wired into the fleet planes. Drop-in:
    ``session.serve_frontend`` returns one automatically when
    ``hyperspace.fleet.enabled`` is true."""

    def __init__(self, session):
        super().__init__(session)
        conf = session.conf
        self._spool_dir = spool_dir(conf)
        self._pin_lease_ms = conf.fleet_pin_lease_ms
        self._sf_enabled = conf.fleet_singleflight_enabled
        self._sf_wait_s = conf.fleet_singleflight_wait_ms / 1000.0
        self._sf_claim_ms = conf.fleet_singleflight_claim_ms
        self._spool_max_bytes = conf.fleet_spool_max_bytes
        # fleet counters (mutated under the frontend lock, like the
        # base counters; all I/O happens outside it)
        self._spool_hits = 0
        self._claims_won = 0
        self._claim_waits = 0
        self._sf_local = 0
        self._bus_events = 0
        self._bus_evicted = 0
        self._bus_installed = 0
        self._election_attempts = 0
        self._election_wins = 0
        self._election_losses = 0
        self._spool_reaped_traces = 0
        self._spool_reaped_claims = 0
        self._spool_reaped_tmp = 0
        self._spool_pruned_results = 0
        # fast plane counters
        self._fast_result_hits = 0
        self._fast_dedup_joins = 0
        self._fast_handoffs = 0
        self._fast_fallbacks = 0
        self._fast_requests_served = 0
        self._fast_push_received = 0
        self._fast_wakes = 0
        self._gossip_received = 0
        self._spool_publishes = 0
        self._spool_publish_drops = 0
        # kernel faults met answering a routed request (ROADMAP C.21)
        self._kernel_faults = 0
        # push-vs-poll wait telemetry: how long serves waited on each plane
        self._fast_wait_ms_total = 0.0
        self._fast_waits = 0
        self._poll_wait_ms_total = 0.0
        self._poll_waits = 0
        # fast plane state (all mutated under the frontend lock)
        self._fast_results: OrderedDict = OrderedDict()
        self._fast_results_bytes = 0
        self._fast_inflight: Dict[str, Future] = {}
        self._wake_events: Dict[str, list] = {}
        self._fast_applied: set = set()
        self._fast_applied_order: deque = deque()
        self._peer_slo: Dict[str, Tuple[float, Dict]] = {}
        self._fast_enabled = conf.fleet_fast_enabled
        self._fast_routing = conf.fleet_fast_routing_enabled
        self._fast_timeout_s = conf.fleet_fast_request_timeout_ms / 1000.0
        self._fast_cache_bytes = conf.fleet_fast_result_cache_bytes
        self._slo_fleet_wide = conf.fleet_fast_slo_fleet_wide
        self._gossip_stale_s = max(10 * conf.fleet_fast_gossip_ms, 2000) / 1000.0
        self._bus = fleet_bus.FleetBus(
            fleet_bus.bus_dir(conf),
            poll_ms=conf.fleet_bus_poll_ms,
            retain_ms=conf.fleet_bus_retain_ms,
        )
        self._bus.start(self._on_durable_bus_event)
        self._router: Optional[FleetRouter] = None
        self._publish_q: Optional[queue.Queue] = None
        self._publish_thread: Optional[threading.Thread] = None
        if self._fast_enabled:
            try:
                self._router = FleetRouter(
                    conf, owner=self._bus.owner, handler=self._on_fast_message
                )
                self._router.set_gossip_source(self._gossip_payload)
            except OSError as exc:
                # the fast plane is an optimization: an unbindable socket
                # or unwritable members dir degrades to durable-only
                _log.warning("fleet fast plane unavailable: %s", exc)
                self._router = None
            else:
                self._publish_q = queue.Queue(maxsize=16)
                self._publish_thread = threading.Thread(
                    target=self._publish_loop,
                    name="hs-fleet-publish",
                    daemon=True,
                )
                self._publish_thread.start()

    # -- durable pins --------------------------------------------------------
    def _register_pins(self, pin: Optional[Tuple]) -> int:
        return recovery.register_pins(
            pin, durable=True, lease_ms=self._pin_lease_ms
        )

    # -- version fanout ------------------------------------------------------
    def _on_durable_bus_event(self, event: dict) -> None:
        """The poll-plane subscriber: skips events already applied via
        fast push (keyed by the durable bus file name both planes carry
        — re-applying would be idempotent, just wasted evictions)."""
        name = event.get("name")
        if name:
            with self._lock:
                if name in self._fast_applied:
                    return
        self._on_bus_event(event)

    def _on_bus_event(self, event: dict) -> None:
        if event.get("type") != "index_changed":
            return
        with self._lock:
            self._bus_events += 1
        root = event.get("root")
        cache = self._session.serve_cache
        evicted = 0
        from hyperspace_tpu_torch.indexes import aggindex, zonemaps

        if root:
            if cache is not None:
                evicted = cache.evict_paths_under(str(root))
            # the module LRUs hold assembled per-version state too —
            # scoped the same way (fingerprint-keyed, so this is pure
            # memory reclamation: a refresh of index A must not cost
            # index B its warm state on every peer)
            zonemaps.invalidate_paths_under(str(root))
            aggindex.invalidate_paths_under(str(root))
        installed = False
        payload = event.get("aggstate")
        if payload:
            # the push plane: install the new version's
            # aggregate state instead of waiting for a lazy re-read
            installed = aggindex.install_fanout_payload(payload, cache)
        with self._lock:
            self._bus_evicted += evicted
            self._bus_installed += bool(installed)

    # -- fast plane: inbound -------------------------------------------------
    def _on_fast_message(
        self, header: dict, body: bytes
    ) -> Optional[Tuple[dict, bytes]]:
        """Dispatch one pushed/requested message (fastbus handler
        threads). One-way types return None; ``exec`` returns a reply."""
        mtype = header.get("type")
        if mtype == "event":
            event = header.get("event") or {}
            if event.get("owner") == self._bus.owner:
                return None  # own publication, mirror the poll-side skip
            name = event.get("name")
            with self._lock:
                self._fast_push_received += 1
                if name:
                    if name in self._fast_applied:
                        return None  # durable poll beat the push
                    self._fast_applied.add(name)
                    self._fast_applied_order.append(name)
                    while len(self._fast_applied_order) > _FAST_APPLIED_MAX:
                        self._fast_applied.discard(
                            self._fast_applied_order.popleft()
                        )
            self._on_bus_event(event)
            return None
        if mtype == "gossip":
            owner = header.get("owner")
            if owner and owner != self._bus.owner:
                with self._lock:
                    self._gossip_received += 1
                    self._peer_slo[owner] = (
                        time.monotonic(),
                        header.get("classes") or {},
                    )
            return None
        if mtype == "result_ready":
            with self._lock:
                self._fast_wakes += 1
                entry = self._wake_events.get(header.get("digest"))
            if entry is not None:
                entry[0].set()
            return None
        if mtype == "exec":
            return self._handle_exec(header)
        return {"status": "bad_request"}, b""

    def _handle_exec(self, header: dict) -> Tuple[dict, bytes]:
        """Owner side of a routed single-flight: result cache, else
        rebuild the shipped plan spec, pin, VERIFY the digest matches
        the requested identity, execute through the local in-memory
        single-flight, stream the Arrow result back. Any mismatch or
        failure replies "miss" — the requester's durable fallback is
        the correctness plane, this path only ever returns the exact
        answer to the requested (plan, snapshot) digest."""
        digest = header.get("digest")
        if not digest:
            return {"status": "bad_request"}, b""
        with self._lock:
            out = self._fast_cache_get_locked(digest)
            if out is not None:
                self._fast_result_hits += 1
                self._fast_requests_served += 1
        if out is not None:
            return {"status": "hit"}, fastbus.table_to_bytes(out)
        spec = header.get("spec")
        if spec is None:
            return {"status": "miss", "reason": "no_spec"}, b""
        try:
            plan = obs_planspec.from_spec(self._session, spec)
        except Exception:  # hslint: disable=HS402
            # an unreplayable spec degrades to a miss, never an error
            # reply the requester has to interpret
            return {"status": "miss", "reason": "spec"}, b""
        pin = self._pin()
        if not pin:
            return {"status": "miss", "reason": "pin"}, b""
        token = self._register_pins(pin)
        try:
            if self._plan_digest(plan, pin) != digest:
                # snapshot skew between requester and owner (a refresh
                # mid-flight): answering would be answering a DIFFERENT
                # question — the requester falls back to its own plane
                return {"status": "miss", "reason": "snapshot"}, b""
            try:
                out = self._serve_digest(digest, plan, pin)
            except KERNEL_FAULTS:
                # never hidden (ROADMAP C.21): counted, and named in the
                # reply; the requester's own execution meets it again
                with self._lock:
                    self._kernel_faults += 1
                return {"status": "miss", "reason": "kernel"}, b""
            except Exception:  # hslint: disable=HS402
                return {"status": "miss", "reason": "exec"}, b""
            with self._lock:
                self._fast_requests_served += 1
            return {"status": "hit"}, fastbus.table_to_bytes(out)
        finally:
            recovery.release_pins(token)

    # -- fast plane: result cache + local single-flight ----------------------
    def _fast_cache_get_locked(self, digest: str):
        item = self._fast_results.get(digest)
        if item is None:
            return None
        self._fast_results.move_to_end(digest)
        return item[0]

    def _fast_cache_put(self, digest: str, table) -> None:
        if self._fast_cache_bytes <= 0:
            return
        try:
            nbytes = int(table.nbytes)
        except (TypeError, ValueError):
            return
        if nbytes > self._fast_cache_bytes:
            return
        with self._lock:
            old = self._fast_results.pop(digest, None)
            if old is not None:
                self._fast_results_bytes -= old[1]
            self._fast_results[digest] = (table, nbytes)
            self._fast_results_bytes += nbytes
            while self._fast_results_bytes > self._fast_cache_bytes:
                _k, (_t, nb) = self._fast_results.popitem(last=False)
                self._fast_results_bytes -= nb

    def _serve_digest(self, digest: str, plan, pin):
        """Owner-side serve of one digest: result cache -> in-process
        single-flight (followers join the leader's Future) -> execute
        -> cache + async spool publish. No claim file anywhere — owner
        routing made this process THE executor for the digest."""
        with self._lock:
            out = self._fast_cache_get_locked(digest)
            if out is not None:
                self._fast_result_hits += 1
                return out
            fut = self._fast_inflight.get(digest)
            if fut is None:
                fut = Future()
                self._fast_inflight[digest] = fut
                leader = True
            else:
                leader = False
        if not leader:
            try:
                out = fut.result(timeout=self._sf_wait_s)
                with self._lock:
                    self._fast_dedup_joins += 1
                return out
            except KERNEL_FAULTS:
                # the leader's kernel fault fails this query too: no silent
                # local rerun (ROADMAP C.21)
                raise
            except Exception:  # hslint: disable=HS402
                # failed/slow leader: forfeit the dedup win, never the
                # answer (the exact claim-timeout contract, in memory)
                with self._lock:
                    self._sf_local += 1
                return super()._execute_pinned(plan, pin)
        try:
            out = super()._execute_pinned(plan, pin)
        except BaseException as exc:
            fut.set_exception(exc)
            with self._lock:
                self._fast_inflight.pop(digest, None)
            raise
        self._fast_cache_put(digest, out)
        fut.set_result(out)
        with self._lock:
            self._fast_inflight.pop(digest, None)
        self._spool_publish_async(digest, out)
        return out

    # -- fast plane: outbound ------------------------------------------------
    def _fast_serve(self, digest: str, plan, pin):
        """Requester side of owner routing. Returns the Table, or None
        — the caller continues on the durable claim/spool plane."""
        router = self._router
        if router is None or not self._fast_routing:
            return None
        with self._lock:
            out = self._fast_cache_get_locked(digest)
            if out is not None:
                self._fast_result_hits += 1
                return out
        target = router.owner_of(digest)
        if target is None:
            return None
        owner, sock = target
        if owner == router.owner:
            return self._serve_digest(digest, plan, pin)
        spec = obs_planspec.to_spec(plan)
        if spec is None:
            return None  # unshippable plan: durable plane handles it
        t0 = time.monotonic()
        try:
            reply, body = fastbus.request(
                sock,
                {
                    "type": "exec",
                    "digest": digest,
                    "spec": spec,
                    "wait_ms": int(self._fast_timeout_s * 1000),
                },
                timeout_s=self._fast_timeout_s,
            )
            if reply.get("status") == "hit" and body:
                out = fastbus.table_from_bytes(body)
                with self._lock:
                    self._fast_handoffs += 1
                    self._fast_waits += 1
                    self._fast_wait_ms_total += (
                        time.monotonic() - t0
                    ) * 1000.0
                obs_trace.event("fast_handoff", digest=digest, owner=owner)
                self._fast_cache_put(digest, out)
                return out
        except (OSError, ValueError, pa.ArrowInvalid):
            # dead owner / timeout / armed fastbus_send fault / torn
            # reply: all the same degradation — the durable plane is
            # the answer, this was only the fast lane to it
            pass
        with self._lock:
            self._fast_fallbacks += 1
            self._fast_waits += 1
            self._fast_wait_ms_total += (time.monotonic() - t0) * 1000.0
        obs_trace.event("fast_fallback", digest=digest, owner=owner)
        return None

    # -- fast plane: async spool publish ------------------------------------
    def _spool_publish_async(self, digest: str, table) -> None:
        """Queue the owner's result for background spool publication
        (cross-host peers + crash recovery keep the durable artifact;
        the fsync just left the serve hot path). Overflow drops the
        publish — the spool is an optimization, peers re-execute."""
        if self._publish_q is None:
            return
        try:
            self._publish_q.put_nowait((digest, table))
        except queue.Full:
            with self._lock:
                self._spool_publish_drops += 1

    def _publish_loop(self) -> None:
        while True:
            item = self._publish_q.get()
            if item is None:
                return
            digest, table = item
            result_path = os.path.join(self._spool_dir, digest + ".arrow")
            self._write_trace_sidecar(result_path)
            self._write_spool(result_path, table)
            with self._lock:
                self._spool_publishes += 1
            if self._router is not None:
                self._router.push_to_peers(
                    {"type": "result_ready", "digest": digest}
                )

    # -- fleet-wide SLO ------------------------------------------------------
    def _gossip_payload(self) -> Dict[str, int]:
        """Per-class local depth snapshot the router pushes to peers."""
        with self._lock:
            return {
                name: cls.running + len(cls.pending)
                for name, cls in self._slo_classes.items()
            }

    def _fleet_class_depth_locked(self, cls) -> int:
        """Live peers' gossiped depth for this class (called with the
        frontend lock held — _peer_slo mutates under the same lock).
        Stale entries are ignored: a dead peer must not pin its last
        depth into every admission decision forever."""
        if not self._slo_fleet_wide or self._router is None:
            return 0
        horizon = time.monotonic() - self._gossip_stale_s
        return sum(
            classes.get(cls.name, 0)
            for ts, classes in self._peer_slo.values()
            if ts >= horizon
        )

    # -- cross-process single-flight -----------------------------------------
    def _plan_digest(self, plan, pin) -> Optional[str]:
        """Fleet-wide identity of (plan, pinned snapshot): the in-process
        fingerprint minus the process-local conf version, hashed. Every
        component is strings/ints/tuples, so ``repr`` is deterministic
        across processes."""
        try:
            key = (
                plan_fingerprint(plan),
                tuple((e.name, e.id) for e in pin),
            )
            return hashlib.sha256(repr(key).encode("utf-8")).hexdigest()[:40]
        except Exception:  # hslint: disable=HS402
            # any unfingerprintable plan simply skips the dedup plane
            return None

    def _read_spool(self, path: str):
        try:
            with open(path, "rb") as fh:
                data = fh.read()
            return pa.ipc.open_stream(pa.py_buffer(data)).read_all()
        except (OSError, pa.ArrowInvalid):
            return None

    def _write_spool(self, path: str, table) -> None:
        """Publish a result (fsync-before-replace; best-effort — an
        unwritable spool costs peers the dedup win, not the answer)."""
        try:
            file_utils.atomic_overwrite_bytes(
                path, fastbus.table_to_bytes(table)
            )
        except (OSError, pa.ArrowInvalid) as exc:
            _log.warning("fleet spool write failed: %s", exc)
            return
        self._prune_spool()

    def _prune_spool(self) -> None:
        """Keep the spool inside its byte budget (oldest results first)
        and sweep expired claims, orphaned trace sidecars and crash-
        leaked publish temps on the same lease-aged pass — every reap
        counted into ``stats()`` so a leak shows up as a number, not a
        du(1) surprise."""
        try:
            names = os.listdir(self._spool_dir)
        except OSError:
            return
        now = time.time()
        entries = []
        reaped_traces = reaped_claims = reaped_tmp = pruned = 0
        for name in names:
            p = os.path.join(self._spool_dir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            if name.endswith(".arrow.trace"):
                # trace-link sidecar: lives and dies with its result.
                # Published BEFORE the .arrow, so an orphan is only
                # reaped past the claim lease — a peer pruning in the
                # sidecar->result publish window must not eat it
                if name[: -len(".trace")] not in names and (
                    (now - st.st_mtime) * 1000 > self._sf_claim_ms
                ):
                    file_utils.delete(p)
                    reaped_traces += 1
            elif name.endswith(".arrow"):
                entries.append((st.st_mtime, st.st_size, p))
            elif name.startswith(".tmp_spool_"):
                # a kill -9 mid-publish leaks the temp; claim lease is a
                # generous upper bound on how long a legitimate publish
                # can still be in flight
                if (now - st.st_mtime) * 1000 > self._sf_claim_ms:
                    file_utils.delete(p)
                    reaped_tmp += 1
            elif name.endswith(".claim"):
                if (now - st.st_mtime) * 1000 > self._sf_claim_ms:
                    file_utils.delete(p)
                    reaped_claims += 1
        total = sum(size for _m, size, _p in entries)
        if self._spool_max_bytes > 0:
            for _mtime, size, p in sorted(entries):
                if total <= self._spool_max_bytes:
                    break
                file_utils.delete(p)
                file_utils.delete(p + ".trace")
                total -= size
                pruned += 1
        if reaped_traces or reaped_claims or reaped_tmp or pruned:
            with self._lock:
                self._spool_reaped_traces += reaped_traces
                self._spool_reaped_claims += reaped_claims
                self._spool_reaped_tmp += reaped_tmp
                self._spool_pruned_results += pruned

    def _try_claim(self, claim_path: str) -> str:
        """One attempt at the executor election: ``"won"`` | ``"held"``
        (a live peer owns it) | ``"error"`` (spool unusable — execute
        locally, the plane is an optimization)."""
        nonce = uuid.uuid4().hex
        payload = json.dumps(
            {
                "owner": fleet_bus._process_owner,
                "nonce": nonce,
                "pid": os.getpid(),
                "expiresAtMs": int(time.time() * 1000) + self._sf_claim_ms,
                # the claimant's trace id: waiting losers link their
                # root span to the winner's trace (cross-process
                # single-flight shows up as ONE logical execution in
                # the obs plane; absent with obs off)
                "traceId": obs_trace.current_trace_id(),
            }
        )
        try:
            if file_utils.atomic_write_if_absent(claim_path, payload):
                return "won"
            # held: by a live winner, or leaked by a dead one (kill -9
            # mid-serve) — the lease decides, exactly like the writer
            # and pin leases
            try:
                with open(claim_path, "r", encoding="utf-8") as fh:
                    doc = json.load(fh)
                expires = int(doc["expiresAtMs"])
            except (OSError, ValueError, KeyError, TypeError):
                expires = 0  # torn/vanished: treat as expired
            if expires <= int(time.time() * 1000):
                # takeover by atomic REPLACE, never delete+create: a
                # delete could destroy a racing contender's fresh claim
                # and elect two winners. Racers overwrite each other;
                # the settle-then-verify read picks exactly one (last
                # write) and the others keep waiting.
                file_utils.atomic_overwrite(claim_path, payload)
                time.sleep(0.002)
                try:
                    with open(claim_path, "r", encoding="utf-8") as fh:
                        if json.load(fh).get("nonce") == nonce:
                            return "won"
                except (OSError, ValueError):
                    pass
            return "held"
        except OSError:
            return "error"

    def _execute_pinned(self, plan, pin: Optional[Tuple]):
        if not self._sf_enabled or not pin:
            # unpinned/degraded serves skip the plane: their identity is
            # not snapshot-addressed, so sharing would be unsound
            return super()._execute_pinned(plan, pin)
        digest = self._plan_digest(plan, pin)
        if digest is None:
            return super()._execute_pinned(plan, pin)
        if self._fast_enabled and self._router is not None:
            out = self._fast_serve(digest, plan, pin)
            if out is not None:
                return out
        return self._execute_durable(digest, plan, pin)

    # -- wake registry (durable losers park on a result-ready push) ----------
    def _register_wake(self, digest: str) -> threading.Event:
        with self._lock:
            entry = self._wake_events.get(digest)
            if entry is None:
                entry = [threading.Event(), 0]
                self._wake_events[digest] = entry
            entry[1] += 1
            return entry[0]

    def _unregister_wake(self, digest: str) -> None:
        with self._lock:
            entry = self._wake_events.get(digest)
            if entry is not None:
                entry[1] -= 1
                if entry[1] <= 0:
                    self._wake_events.pop(digest, None)

    def _execute_durable(self, digest: str, plan, pin):
        """The claim/spool election — the always-correct plane the fast
        path degrades to. Losers park on a result-ready push (roofed by
        the spool poll cadence) and retry the claim with jittered
        exponential backoff instead of hammering it at a fixed rate."""
        result_path = os.path.join(self._spool_dir, digest + ".arrow")
        claim_path = os.path.join(self._spool_dir, digest + ".claim")
        deadline = time.monotonic() + self._sf_wait_s
        waiting = False
        losses = 0
        next_claim_at = 0.0
        wake: Optional[threading.Event] = None
        t_wait0: Optional[float] = None

        def _note_poll_wait() -> None:
            if t_wait0 is not None:
                with self._lock:
                    self._poll_waits += 1
                    self._poll_wait_ms_total += (
                        time.monotonic() - t_wait0
                    ) * 1000.0

        try:
            while True:
                out = self._read_spool(result_path)
                if out is not None:
                    with self._lock:
                        self._spool_hits += 1
                    _note_poll_wait()
                    # link loser -> winner: the result's trace sidecar
                    # names the executing process's trace, so a cross-
                    # process dedup reads as ONE logical execution
                    obs_trace.event(
                        "spool_hit",
                        digest=digest,
                        winner_trace_id=self._read_trace_sidecar(result_path),
                    )
                    self._fast_cache_put(digest, out)
                    return out
                now = time.monotonic()
                verdict = None
                if now >= next_claim_at:
                    with self._lock:
                        self._election_attempts += 1
                    _election_attempts_total.inc()
                    verdict = self._try_claim(claim_path)
                    if verdict == "won":
                        with self._lock:
                            self._claims_won += 1
                            self._election_wins += 1
                        _election_wins_total.inc()
                        _note_poll_wait()
                        obs_trace.event("singleflight_won", digest=digest)
                        try:
                            out = super()._execute_pinned(plan, pin)
                        except BaseException:
                            # free the peers immediately: a failed winner
                            # must not make every waiter ride out the
                            # claim lease
                            file_utils.delete(claim_path)
                            raise
                        # sidecar BEFORE the result: a loser polling every
                        # 2ms must never see the .arrow without its link
                        self._write_trace_sidecar(result_path)
                        self._write_spool(result_path, out)
                        file_utils.delete(claim_path)
                        if self._router is not None:
                            # wake parked losers NOW, not a poll later
                            self._router.push_to_peers(
                                {"type": "result_ready", "digest": digest}
                            )
                        self._fast_cache_put(digest, out)
                        return out
                    if verdict == "held":
                        losses += 1
                        with self._lock:
                            self._election_losses += 1
                        _election_losses_total.inc()
                        delay = min(
                            _ELECTION_BACKOFF_CAP_S,
                            _ELECTION_BACKOFF_BASE_S * (1 << min(losses, 6)),
                        )
                        next_claim_at = now + delay * (
                            0.5 + random.random()
                        )
                if verdict == "error" or now >= deadline:
                    # forfeits the dedup win, never the answer
                    with self._lock:
                        self._sf_local += 1
                    _note_poll_wait()
                    return super()._execute_pinned(plan, pin)
                if not waiting:
                    waiting = True
                    t_wait0 = now
                    with self._lock:
                        self._claim_waits += 1
                    obs_trace.event(
                        "singleflight_wait",
                        digest=digest,
                        winner_trace_id=self._read_claim_trace(claim_path),
                    )
                    wake = self._register_wake(digest)
                timeout = min(
                    _SPOOL_POLL_S,
                    max(0.001, next_claim_at - time.monotonic()),
                    max(0.001, deadline - time.monotonic()),
                )
                if wake is not None:
                    if wake.wait(timeout):
                        wake.clear()
                else:
                    time.sleep(timeout)
        finally:
            if wake is not None:
                self._unregister_wake(digest)

    # -- trace linkage (best-effort everywhere) -------------------------------
    def _write_trace_sidecar(self, result_path: str) -> None:
        """Publish the winner's trace id next to its spooled result so
        later spool hits can link to it (claim files vanish at commit)."""
        trace_id = obs_trace.current_trace_id()
        if trace_id is None:
            return
        try:
            file_utils.atomic_overwrite(
                result_path + ".trace", json.dumps({"traceId": trace_id})
            )
        except OSError:
            pass

    def _read_trace_sidecar(self, result_path: str) -> Optional[str]:
        try:
            with open(result_path + ".trace", "r", encoding="utf-8") as fh:
                return json.load(fh).get("traceId")
        except (OSError, ValueError):
            return None

    def _read_claim_trace(self, claim_path: str) -> Optional[str]:
        try:
            with open(claim_path, "r", encoding="utf-8") as fh:
                return json.load(fh).get("traceId")
        except (OSError, ValueError):
            return None

    # -- introspection / lifecycle ------------------------------------------
    def stats(self) -> dict:
        out = super().stats()
        router = self._router
        with self._lock:
            out["fleet"] = {
                "spool_hits": self._spool_hits,
                "claims_won": self._claims_won,
                "claim_waits": self._claim_waits,
                "singleflight_local": self._sf_local,
                "election_attempts": self._election_attempts,
                "election_wins": self._election_wins,
                "election_losses": self._election_losses,
                "spool_reaped_traces": self._spool_reaped_traces,
                "spool_reaped_claims": self._spool_reaped_claims,
                "spool_reaped_tmp": self._spool_reaped_tmp,
                "spool_pruned_results": self._spool_pruned_results,
                "spool_publishes": self._spool_publishes,
                "spool_publish_drops": self._spool_publish_drops,
                "bus_events": self._bus_events,
                "bus_evicted": self._bus_evicted,
                "bus_installed": self._bus_installed,
                "bus_published": self._bus.published,
                # fast plane (0/1 per frontend so merged snapshots count
                # fast-armed members; merge_snapshots sums counters)
                "fast_frontends": int(router is not None),
                "fast_result_hits": self._fast_result_hits,
                "fast_dedup_joins": self._fast_dedup_joins,
                "fast_handoffs": self._fast_handoffs,
                "fast_fallbacks": self._fast_fallbacks,
                "fast_requests_served": self._fast_requests_served,
                "fast_push_received": self._fast_push_received,
                "fast_wakes": self._fast_wakes,
                "gossip_received": self._gossip_received,
                "fast_result_cache_bytes": self._fast_results_bytes,
                "fast_wait_ms_total": round(self._fast_wait_ms_total, 3),
                "fast_waits": self._fast_waits,
                "poll_wait_ms_total": round(self._poll_wait_ms_total, 3),
                "poll_waits": self._poll_waits,
                "kernel_faults": self._kernel_faults,
            }
        if router is not None:
            out["fleet"]["fast_push_sent"] = router.push_sent
            out["fleet"]["gossip_sent"] = router.gossip_sent
            out["fleet"]["members_reaped"] = router.members_reaped
        return out

    def close(self, wait: bool = True) -> None:
        if self._router is not None:
            self._router.stop()
        if self._publish_q is not None:
            self._publish_q.put(None)
            if self._publish_thread is not None:
                self._publish_thread.join(timeout=5.0)
        self._bus.stop()
        super().close(wait=wait)
