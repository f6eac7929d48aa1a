"""Crash-safe lifecycle recovery: leases, rollback, orphan GC.

Counterpart of ``hyperspace_tpu/metadata/recovery.py``. The operation
log's OCC protocol (``actions/base.py``, ``metadata/log_manager.py``) is
correct for writers that finish; a writer that dies in ``op()`` strands a
transient entry (CREATING, REFRESHING, ...) and the data files it half
wrote. This module repairs both:

* **Writer lease and heartbeat.** ``Action.run`` stamps an owner id and a
  lease expiry into the transient begin entry and re-stamps it every
  ``leaseMs/3`` while the op runs (:class:`LeaseHeartbeat`, through
  ``IndexLogManager.overwrite_log``, legal only for the owner of a
  transient entry). A slow writer keeps its lease fresh; a dead writer's
  lease expires, and every other piece keys on that expiry.

* **Stranded-entry rollback.** :func:`ensure_recovered` runs at action
  start (``Action.run``) and at session attach
  (``manager.IndexCollectionManager``). A latest entry that is transient
  with an expired lease, or torn (:class:`LogCorruptedError`), is rolled
  back along ``States.ROLLBACK`` by appending a copy of the last stable
  entry at the next id (``cancel``'s write, shared here). The append is
  the OCC create-if-absent write, so of two recoverers one wins and the
  other sees its entry. A crash between the end entry and the
  latestStable publish needs no rollback, only the pointer re-published.

* **Orphan GC.** :func:`gc_orphans` moves index data files that no
  stable entry references into ``<index>/_hyperspace_quarantine/<stamp>/``
  and deletes stamps older than ``hyperspace.recovery.orphanGraceMs``.
  Files pinned by an in-process snapshot (:func:`register_pins`) or by a
  live durable pin file of another process are never quarantined.

Everything is idempotent: a rollback loses races gracefully, a second GC
finds nothing, healing rewrites the same bytes. The port has no spill
tier yet (ROADMAP A.8), so :func:`reap_spill_orphans` treats every spill
file as unindexed by a live cache.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hyperspace_tpu_torch.constants import (
    FLEET_PIN_LEASE_MS_DEFAULT,
    HYPERSPACE_LOG_DIR,
    HYPERSPACE_PINS_DIR,
    HYPERSPACE_QUARANTINE_DIR,
    HYPERSPACE_SPILL_DIR,
    SERVE_SPILL_ORPHAN_TTL_MS_DEFAULT,
    INDEX_VERSION_DIR_PREFIX,
    RECOVERY_LEASE_MS_DEFAULT,
    RECOVERY_ORPHAN_GRACE_MS_DEFAULT,
    States,
)
from hyperspace_tpu_torch.exceptions import LogCorruptedError
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.utils import files as file_utils
from hyperspace_tpu_torch.utils import paths as path_utils

# Lease bookkeeping lives in the entry's free-form ``properties`` dict —
# round-trips through the existing JSON schema untouched, and pre-lease
# entries simply lack the keys (timestamp fallback below).
LEASE_OWNER_PROP = "recovery.leaseOwner"
LEASE_EXPIRES_PROP = "recovery.leaseExpiresAtMs"


def now_ms() -> int:
    return int(time.time() * 1000)


def new_owner_id() -> str:
    return uuid.uuid4().hex


# ---------------------------------------------------------------------------
# Leases
# ---------------------------------------------------------------------------


def stamp_lease(
    entry: IndexLogEntry, owner: str, lease_ms: int, now: Optional[int] = None
) -> None:
    """Stamp (or renew) the writer lease on a transient entry."""
    now = now_ms() if now is None else now
    entry.properties[LEASE_OWNER_PROP] = owner
    entry.properties[LEASE_EXPIRES_PROP] = str(now + lease_ms)


def clear_lease(entry: IndexLogEntry) -> None:
    entry.properties.pop(LEASE_OWNER_PROP, None)
    entry.properties.pop(LEASE_EXPIRES_PROP, None)


def lease_expires_at(entry: IndexLogEntry, lease_ms: int) -> int:
    """When this entry's writer must be presumed dead (ms epoch).

    Entries from before the lease era (or written with recovery off)
    have no lease properties; their write timestamp plus one lease
    period is the conservative stand-in."""
    raw = entry.properties.get(LEASE_EXPIRES_PROP)
    if raw is not None:
        try:
            return int(raw)
        except (TypeError, ValueError):
            pass
    return int(entry.timestamp) + lease_ms


def is_stranded(
    entry: Optional[IndexLogEntry],
    lease_ms: int = RECOVERY_LEASE_MS_DEFAULT,
    now: Optional[int] = None,
) -> bool:
    """True when ``entry`` is a dead writer's leavings: a transient
    state whose lease has expired. A torn entry (``entry is None`` from
    a caught LogCorruptedError) is always stranded — a live writer's
    entry parses, its publish is fsynced before the name exists."""
    if entry is None:
        return True
    if entry.state in States.STABLE_STATES:
        return False
    now = now_ms() if now is None else now
    return lease_expires_at(entry, lease_ms) <= now


class LeaseHeartbeat:
    """Renews the writer lease on a transient entry every ``lease/3``
    until stopped. Owned by ``Action.run``: started right after the
    begin entry wins its OCC write, stopped in the commit/abort path.
    An ``os._exit`` crash (or SIGKILL) never stops it — the thread dies
    with the process and the lease expires, which is the signal."""

    def __init__(
        self,
        log_manager: IndexLogManager,
        log_id: int,
        entry: IndexLogEntry,
        owner: str,
        lease_ms: int,
    ):
        self._log_manager = log_manager
        self._log_id = log_id
        self._entry = entry
        self._owner = owner
        self._lease_ms = lease_ms
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"hs-lease-{log_id}", daemon=True
        )

    def start(self) -> "LeaseHeartbeat":
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = max(self._lease_ms / 3000.0, 0.005)
        while not self._stop.wait(interval):
            stamp_lease(self._entry, self._owner, self._lease_ms)
            try:
                self._log_manager.overwrite_log(self._log_id, self._entry)
            except OSError:
                # best-effort: a failed renewal only ages the lease; the
                # next tick retries, and a recovery triggered by a
                # genuinely unreachable log dir is the correct outcome
                pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Rollback + pointer healing
# ---------------------------------------------------------------------------


def _latest_stable_by_scan(
    log_manager: IndexLogManager, below_id: int
) -> Optional[IndexLogEntry]:
    """Newest parseable stable entry with id < ``below_id`` — the
    rollback source. Scans the numbered entries, never the pointer (the
    pointer may itself be stale or torn after a crash)."""
    for log_id in range(below_id - 1, -1, -1):
        try:
            entry = log_manager.get_log(log_id)
        except LogCorruptedError:
            continue
        if entry is not None and entry.state in States.STABLE_STATES:
            return entry
    return None


def rollback(
    log_manager: IndexLogManager, latest_id: Optional[int] = None
) -> Tuple[Optional[IndexLogEntry], bool]:
    """Roll the log back from a transient/torn latest entry to its
    stable predecessor along the ``States.ROLLBACK`` edge.

    Appends a copy of the last stable entry (or the transient entry
    restamped with its rollback state when nothing stable ever existed
    — the failed-create case) at ``latest_id + 1`` and republishes
    latestStable. OCC-safe: the append is create-if-absent, so of two
    concurrent recoverers exactly one writes; the loser re-reads and
    returns whatever won. Shared by ``actions/cancel.py`` (the manual
    override, which does not check leases) and
    :func:`ensure_recovered` (which does).

    Returns ``(tip_entry, we_wrote)``: the entry now at the log tip
    (None when the log ended up empty) and whether THIS call performed
    the recovery. ``we_wrote=False`` means a competitor's write — a
    concurrent recoverer's rollback, or the not-dead-after-all writer's
    own end-commit — won the id; the caller decides whether the
    survivor satisfies it (auto-recovery: yes, any stable tip does;
    cancel: no, a commit is the opposite of a cancel)."""
    if latest_id is None:
        latest_id = log_manager.get_latest_id()
    if latest_id is None:
        return None, False
    try:
        latest = log_manager.get_log(latest_id)
    except LogCorruptedError:
        latest = None
    if latest is not None and latest.state in States.STABLE_STATES:
        return latest, False  # nothing to roll back (someone already did)
    stable = _latest_stable_by_scan(log_manager, latest_id)
    if stable is not None:
        entry = stable.copy()
    elif latest is not None:
        # no stable history (a crashed first create): the ROLLBACK edge
        # names the target — DOESNOTEXIST for CREATING
        target = States.ROLLBACK.get(latest.state, States.DOESNOTEXIST)
        entry = latest.with_state(target)
    else:
        # single torn entry and no stable history: the index never
        # reached a publishable state — clear the wreckage so the name
        # is reusable (get_latest_id -> None == DOESNOTEXIST)
        file_utils.delete(log_manager._path_for(latest_id))
        log_manager.delete_latest_stable_log()
        return None, True
    clear_lease(entry)
    if not log_manager.write_log(latest_id + 1, entry):
        # another recoverer (or the not-dead-after-all writer's commit)
        # won the id: their write is the truth now
        try:
            return log_manager.get_log(log_manager.get_latest_id()), False
        except LogCorruptedError:
            return None, False
    log_manager.create_latest_stable_log(latest_id + 1)
    return entry, True


def ensure_recovered(
    log_manager: IndexLogManager,
    lease_ms: int = RECOVERY_LEASE_MS_DEFAULT,
    now: Optional[int] = None,
) -> Dict[str, object]:
    """Detect and repair a dead writer's leavings at the log tip.

    Three cases, all idempotent:

    * latest entry stable but the latestStable pointer behind/missing
      (crash between end-log and publish) → re-publish the pointer;
    * latest entry transient/torn with an EXPIRED lease → rollback;
    * latest entry transient with a LIVE lease → leave it alone (a slow
      writer is not a dead one) and report it.

    Returns a report dict: ``rolled_back``, ``healed_pointer``,
    ``live_writer`` (bool each) + ``latest_state``.
    """
    report: Dict[str, object] = {
        "rolled_back": False,
        "healed_pointer": False,
        "live_writer": False,
        "latest_state": None,
    }
    latest_id = log_manager.get_latest_id()
    if latest_id is None:
        return report
    try:
        latest = log_manager.get_log(latest_id)
    except LogCorruptedError:
        latest = None
    if latest is not None and latest.state in States.STABLE_STATES:
        report["latest_state"] = latest.state
        if log_manager.get_latest_stable_pointer_id() != latest_id:
            log_manager.create_latest_stable_log(latest_id)
            report["healed_pointer"] = True
        return report
    if not is_stranded(latest, lease_ms, now):
        report["latest_state"] = latest.state
        report["live_writer"] = True
        return report
    rolled, _we_wrote = rollback(log_manager, latest_id)
    # either way the tip is repaired — by us or by the competitor whose
    # write beat ours; auto-recovery only cares that it IS repaired
    report["rolled_back"] = True
    report["latest_state"] = rolled.state if rolled is not None else None
    return report


# ---------------------------------------------------------------------------
# Serve snapshot pins (GC coordination)
# ---------------------------------------------------------------------------

_pins_lock = threading.Lock()
_active_pins: Dict[int, frozenset] = {}
_pin_seq = 0

#: this process's durable-pin identity (immutable; pin files are named
#: ``<owner>.<token>.json`` so two readers in two processes can never
#: collide, and a restarted process never renews its predecessor's pins)
_pin_owner = uuid.uuid4().hex[:16]

# token -> {"lease_ms": int, "paths": {pin file path: [files]}} for the
# heartbeat's renewal sweep (guarded by _pins_lock)
_durable_pins: Dict[int, Dict[str, object]] = {}
_pin_heartbeat = None  # the renewal thread, started on first durable pin


def _index_root_of(path: str) -> Optional[str]:
    """The index root a data file lives under — the parent of its
    ``v__=N`` version-dir component — or None for a path outside any
    version dir (not durably pinnable; the in-memory pin still holds)."""
    norm = path.replace("\\", "/")
    parts = norm.split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i].startswith(INDEX_VERSION_DIR_PREFIX + "="):
            return "/".join(parts[:i])
    return None


def _pin_file_payload(token: int, files: List[str], lease_ms: int) -> str:
    return json.dumps(
        {
            "owner": _pin_owner,
            "pid": os.getpid(),
            "token": token,
            "leaseMs": int(lease_ms),
            "expiresAtMs": now_ms() + int(lease_ms),
            "files": sorted(files),
        }
    )


def _write_pin_files(
    token: int, by_root: Dict[str, List[str]], lease_ms: int
) -> Dict[str, List[str]]:
    """Publish one pin file per index root (fsync-before-replace);
    returns {pin file path: files}. Best-effort per root: an unwritable
    pins dir costs the durable protection for that index only — the
    in-memory pin still guards same-process GC, and failing the QUERY
    over a bookkeeping write would invert the priorities."""
    out: Dict[str, List[str]] = {}
    for root, files in by_root.items():
        pin_path = os.path.join(
            root, HYPERSPACE_PINS_DIR, f"{_pin_owner}.{token}.json"
        )
        try:
            file_utils.atomic_overwrite(
                pin_path, _pin_file_payload(token, files, lease_ms)
            )
        except OSError:
            continue
        out[pin_path] = files
    return out


class _PinHeartbeat:
    """Renews every live durable pin file each ``min(lease)/3`` until the
    process exits — the reader-side twin of :class:`LeaseHeartbeat`. A
    SIGKILL never stops it; the leases expire and the next GC/vacuum in
    any process reaps the pins, which is the signal."""

    def __init__(self):
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hs-pin-heartbeat", daemon=True
        )
        self._thread.start()

    def wake(self) -> None:
        """Cut the current wait short — a newly registered pin may carry
        a much shorter lease than the interval the thread is sleeping
        on."""
        self._wake.set()

    def _run(self) -> None:
        while True:
            # clear BEFORE snapshotting: a pin registered after the
            # snapshot sets the event and cuts the wait short; one
            # registered before it is in the snapshot — either way no
            # short-lease pin waits out a stale interval
            self._wake.clear()
            with _pins_lock:
                snapshot = [
                    (t, int(info["lease_ms"]), dict(info["paths"]))
                    for t, info in _durable_pins.items()
                ]
            interval = (
                min((lease for _t, lease, _p in snapshot), default=1000)
                / 3000.0
            )
            self._wake.wait(max(interval, 0.005))
            if self._stop.is_set():
                return
            for token, lease_ms, paths in snapshot:
                with _pins_lock:
                    live = token in _durable_pins
                if not live:
                    continue
                for pin_path, files in paths.items():
                    try:
                        file_utils.atomic_overwrite(
                            pin_path,
                            _pin_file_payload(token, files, lease_ms),
                        )
                    except OSError:
                        # best-effort, like the writer lease: a failed
                        # renewal only ages the pin; the next tick
                        # retries, and expiry under a truly dead store
                        # is the designed outcome
                        continue
                    # write-then-verify: release_pins may have deleted
                    # the file between the liveness check above and our
                    # rewrite — a resurrected pin would block GC/vacuum
                    # for a full lease, so re-check and undo
                    with _pins_lock:
                        live = token in _durable_pins
                    if not live:
                        file_utils.delete(pin_path)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()


def register_pins(
    entries: Optional[Iterable[IndexLogEntry]],
    durable: bool = False,
    lease_ms: int = FLEET_PIN_LEASE_MS_DEFAULT,
    heartbeat: bool = True,
) -> int:
    """Record the index files a serve snapshot depends on; returns a
    token for :func:`release_pins`. GC never quarantines a pinned file,
    so a query that pinned its snapshot before a version went
    unreferenced still finds every byte.

    With ``durable=True`` (the reference's fleet mode) the pin is
    ALSO published as a lease-expiring file per index root —
    ``<index>/_hyperspace_pins/<proc>.<seq>.json``, fsync-before-replace
    — so an orphan GC or vacuum running in ANOTHER process sees it too.
    A heartbeat renews the lease every ``lease_ms/3``; a reader that
    dies (kill -9) stops renewing and the pin is reaped at expiry
    (``heartbeat=False`` exists for the tests that simulate exactly
    that death)."""
    files: Set[str] = set()
    for e in entries or ():
        files.update(p.replace("\\", "/") for p in e.content.files)
    global _pin_seq, _pin_heartbeat
    with _pins_lock:
        _pin_seq += 1
        token = _pin_seq
        _active_pins[token] = frozenset(files)
    if not durable or not files:
        return token
    by_root: Dict[str, List[str]] = {}
    for f in files:
        root = _index_root_of(f)
        if root is not None:
            by_root.setdefault(root, []).append(f)
    # file I/O stays OUTSIDE the pins lock (no I/O under a lock that
    # serving threads contend on)
    written = _write_pin_files(token, by_root, lease_ms)
    if written:
        with _pins_lock:
            if token in _active_pins:
                _durable_pins[token] = {
                    "lease_ms": int(lease_ms),
                    "paths": written,
                }
                if heartbeat:
                    if _pin_heartbeat is None:
                        _pin_heartbeat = _PinHeartbeat()
                    else:
                        _pin_heartbeat.wake()
                doomed = {}
            else:
                # release_pins raced us between the write and this
                # record: the pin files must not outlive the token
                doomed = written
        for pin_path in doomed:
            file_utils.delete(pin_path)
    return token


def release_pins(token: int) -> None:
    with _pins_lock:
        _active_pins.pop(token, None)
        durable = _durable_pins.pop(token, None)
    if durable:
        for pin_path in durable["paths"]:
            file_utils.delete(pin_path)


def pinned_files() -> Set[str]:
    """Union of all currently pinned index files (normalized paths)."""
    with _pins_lock:
        snapshots = list(_active_pins.values())
    out: Set[str] = set()
    for s in snapshots:
        out |= s
    return out


def _scan_durable_pins(
    index_path: str, now: Optional[int] = None, reap: bool = True
) -> Tuple[Set[str], int]:
    """(files protected by UNEXPIRED pin files under ``index_path``,
    expired/torn pin files reaped). An expired pin belongs to a dead
    reader — its query either finished or died with it, so the file
    set converges back to the referenced-or-quarantined partition; a
    torn pin file can protect nothing and is reaped the same way."""
    pins_dir = os.path.join(index_path, HYPERSPACE_PINS_DIR)
    if not os.path.isdir(pins_dir):
        return set(), 0
    now = now_ms() if now is None else now
    out: Set[str] = set()
    reaped = 0
    for name in sorted(os.listdir(pins_dir)):
        if not name.endswith(".json"):
            continue  # publish temps (.tmp_log_*) are not pins
        p = os.path.join(pins_dir, name)
        try:
            with open(p, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            expires = int(doc["expiresAtMs"])
        except (OSError, ValueError, KeyError, TypeError):
            if reap:
                file_utils.delete(p)
                reaped += 1
            continue
        if expires <= now:
            if reap:
                file_utils.delete(p)
                reaped += 1
            continue
        out.update(str(f).replace("\\", "/") for f in doc.get("files", ()))
    if reap:
        try:
            if not os.listdir(pins_dir):
                os.rmdir(pins_dir)
        except OSError:
            pass
    return out, reaped


def durable_pinned_files(
    index_path: str, now: Optional[int] = None
) -> Set[str]:
    """Files protected by live (lease-unexpired) cross-process pin files
    under ``index_path``; expired pins are reaped along the way."""
    files, _reaped = _scan_durable_pins(index_path, now)
    return files


def all_pinned_files(index_path: str, now: Optional[int] = None) -> Set[str]:
    """Everything a GC or vacuum of ``index_path`` must not delete:
    this process's in-memory pins UNION every process's live durable
    pin files."""
    return pinned_files() | durable_pinned_files(index_path, now)


# ---------------------------------------------------------------------------
# Orphan GC
# ---------------------------------------------------------------------------


def _referenced_files(log_manager: IndexLogManager) -> Set[str]:
    """Every data file any parseable STABLE entry references. Stable
    entries are the only ones whose content is a promise — a transient
    entry's content either becomes stable (then its files appear there
    too) or gets rolled back (then its files are exactly the orphans)."""
    out: Set[str] = set()
    latest = log_manager.get_latest_id()
    if latest is None:
        return out
    for log_id in range(latest, -1, -1):
        try:
            entry = log_manager.get_log(log_id)
        except LogCorruptedError:
            continue
        if entry is not None and entry.state in States.STABLE_STATES:
            out.update(p.replace("\\", "/") for p in entry.content.files)
    return out


def find_orphans(index_path: str) -> List[str]:
    """Data files under the index's version dirs that no stable log
    entry references (quarantine excluded). The zero-orphans assert of
    the crash matrix and the chaos harness."""
    log_manager = IndexLogManager(index_path)
    if log_manager.get_latest_id() is None:
        return []
    referenced = _referenced_files(log_manager)
    orphans: List[str] = []
    for name in sorted(os.listdir(index_path)):
        if name in (
            HYPERSPACE_LOG_DIR,
            HYPERSPACE_QUARANTINE_DIR,
            HYPERSPACE_PINS_DIR,
            HYPERSPACE_SPILL_DIR,
        ):
            continue
        root = os.path.join(index_path, name)
        if not os.path.isdir(root):
            continue
        for p, _size, _mtime in file_utils.list_leaf_files(root):
            norm = p.replace("\\", "/")
            if path_utils.is_data_path(norm) and norm not in referenced:
                orphans.append(norm)
    return orphans


def gc_orphans(
    index_path: str,
    grace_ms: int = RECOVERY_ORPHAN_GRACE_MS_DEFAULT,
    now: Optional[int] = None,
    lease_ms: int = RECOVERY_LEASE_MS_DEFAULT,
) -> Dict[str, object]:
    """Quarantine-then-delete unreferenced index data files.

    Two phases, each idempotent:

    1. every data file under a version dir that no stable entry
       references — and no live in-process serve pin names — MOVES to
       ``_hyperspace_quarantine/<now_ms>/`` (directories left with no
       data files go wholesale, sidecars and all);
    2. quarantine stamps older than ``grace_ms`` are deleted.

    A LIVE writer (transient log tip whose lease has not expired) skips
    phase 1 entirely: its half-written version dir is referenced by no
    entry yet, and no per-file test can tell its work from a dead
    writer's leavings — only the lease can. Phase 2 still purges old
    stamps.

    With ``grace_ms=0`` the sweep is immediate (tests, the chaos
    harness); production keeps the default TTL so out-of-process
    readers of a just-vacated version get the grace window the
    in-process pin registry gives local queries.
    """
    now = now_ms() if now is None else now
    log_manager = IndexLogManager(index_path)
    report: Dict[str, object] = {
        "quarantined_files": 0,
        "quarantined_dirs": 0,
        "kept_pinned": 0,
        "purged_stamps": 0,
        "reaped_pins": 0,
        "skipped_live_writer": False,
    }
    latest_id = log_manager.get_latest_id()
    if latest_id is None:
        return report
    try:
        tip = log_manager.get_log(latest_id)
    except LogCorruptedError:
        tip = None
    if (
        tip is not None
        and tip.state not in States.STABLE_STATES
        and not is_stranded(tip, lease_ms, now)
    ):
        report["skipped_live_writer"] = True
        _purge_quarantine(index_path, grace_ms, now, report)
        return report
    referenced = _referenced_files(log_manager)
    durable, reaped = _scan_durable_pins(index_path, now)
    report["reaped_pins"] = reaped
    pinned = pinned_files() | durable
    quarantine_root = os.path.join(index_path, HYPERSPACE_QUARANTINE_DIR)
    stamp_dir = os.path.join(quarantine_root, str(now))

    def _move(src: str) -> None:
        rel = os.path.relpath(src, index_path)
        dst = os.path.join(stamp_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.move(src, dst)

    for name in sorted(os.listdir(index_path)):
        if name in (
            HYPERSPACE_LOG_DIR,
            HYPERSPACE_QUARANTINE_DIR,
            HYPERSPACE_PINS_DIR,
            HYPERSPACE_SPILL_DIR,
        ):
            continue
        root = os.path.join(index_path, name)
        if not os.path.isdir(root):
            continue
        listed = file_utils.list_leaf_files(root)
        data = [
            p.replace("\\", "/")
            for p, _s, _m in listed
            if path_utils.is_data_path(p)
        ]
        live = [p for p in data if p in referenced]
        doomed = [p for p in data if p not in referenced and p not in pinned]
        report["kept_pinned"] += sum(
            1 for p in data if p not in referenced and p in pinned
        )
        if not live and len(doomed) == len(data):
            # nothing referenced or pinned survives in this version dir:
            # take the whole dir, sidecars included
            if data or listed:
                _move(root)
                report["quarantined_dirs"] += 1
            continue
        for p in doomed:
            _move(p)
            report["quarantined_files"] += 1

    _purge_quarantine(index_path, grace_ms, now, report)
    return report


def _purge_quarantine(
    index_path: str, grace_ms: int, now: int, report: Dict[str, object]
) -> None:
    """Phase 2: delete quarantine stamps older than the grace TTL."""
    quarantine_root = os.path.join(index_path, HYPERSPACE_QUARANTINE_DIR)
    if not os.path.isdir(quarantine_root):
        return
    for stamp in sorted(os.listdir(quarantine_root)):
        try:
            stamped_at = int(stamp)
        except ValueError:
            continue
        if stamped_at + grace_ms <= now:
            file_utils.delete(os.path.join(quarantine_root, stamp))
            report["purged_stamps"] += 1
    if not os.listdir(quarantine_root):
        file_utils.delete(quarantine_root)


def reap_spill_orphans(
    system_path: str,
    ttl_ms: int = SERVE_SPILL_ORPHAN_TTL_MS_DEFAULT,
    now: Optional[int] = None,
) -> Dict[str, int]:
    """Delete expired spill-tier leavings under
    ``<system_path>/_hyperspace_spill/``.

    Spill files are DERIVED state: every byte is reproducible from
    parquet, so the reaper deletes rather than quarantines — the
    ``gc_orphans`` move-then-grace dance exists to protect source-of-
    truth index data, which spill files never are. Three protections
    keep a live serve unharmed:

    * files a live in-process serve cache still indexes are never
      touched, mirroring the serve-pin exemption of :func:`gc_orphans`
      (the port has no serve cache yet, ROADMAP A.8, so none is);
    * files younger than ``ttl_ms`` (``hyperspace.serve.spill\
.orphanTtlMs``) are kept — a sibling process's cache may index them,
      and a freshly published file is by definition younger than its
      writer's next eviction cycle;
    * deletion races are benign by construction: a restore that loses
      the race sees a vanished file and degrades to a cache miss.

    Torn ``.tmp_spool_*`` temps from a writer that died mid-publish
    (the ``mid_spill_write`` crash point) age out the same way.
    Idempotent; returns ``{"reaped": n, "kept_live": n, "kept_young":
    n}``.
    """
    report = {"reaped": 0, "kept_live": 0, "kept_young": 0}
    spill_dir = os.path.join(system_path, HYPERSPACE_SPILL_DIR)
    if not os.path.isdir(spill_dir):
        return report
    now = now_ms() if now is None else now
    live: Set[str] = set()  # no serve cache indexes spill files yet (A.8)
    for name in sorted(os.listdir(spill_dir)):
        if not (name.endswith(".spill") or name.startswith(".tmp_spool_")):
            continue
        path = os.path.join(spill_dir, name)
        if path in live:
            report["kept_live"] += 1
            continue
        try:
            age_ms = now - int(os.path.getmtime(path) * 1000)
        except OSError:
            continue  # vanished under us — someone else reaped it
        if age_ms < ttl_ms:
            report["kept_young"] += 1
            continue
        try:
            file_utils.delete(path)
            report["reaped"] += 1
        except OSError:
            pass
    return report
