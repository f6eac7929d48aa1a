"""Config-keyed fault and crash injection.

Counterpart of ``hyperspace_tpu/testing/faults.py``. Two registries, both
process-global and thread-safe, and both a single dict check at a site
when nothing is armed.

**Fault points** (``hyperspace.faults.<point>``) make an I/O read fail:

========================  ====================================================
point                     armed site
========================  ====================================================
``parquet_read``          ``io/parquet.read_table`` / ``read_tables`` /
                          ``read_file_row_groups`` (every data read)
``log_read``              ``metadata/log_manager.py`` log-entry and
                          latestStable reads
``cache_insert``          ``ServeCache.put``: a fired fault drops the insert
                          (the query still answers, uncached; counted in
                          ``ServeCache.insert_failures``)
``fastbus_send``          ``serve/fastbus.push`` / ``request``, the fleet
                          fast plane's send seam: a fired fault is a dead
                          peer socket, and the caller falls back to the
                          durable planes with the same answer
========================  ====================================================

Spec grammar::

    "transient"              fail the next 1 matching call, then recover
    "transient:3"            fail the next 3 matching calls, then recover
    "persistent"             fail every matching call until disarmed
    "persistent;match=v__="  only calls whose detail contains the substring
    "off" / ""               disarm

``check`` raises :class:`InjectedFault`, an ``OSError``, so an injected
fault travels the path a real I/O error takes; :func:`degraded` is the
non-raising form for a site whose contract is to degrade in place
(``cache_insert``).

The reference's ``kernel_dispatch`` point is deliberately not ported: there
a fired fault makes a kernel wrapper return None and take its plain
version, a fallback that would hide the kernel. A kernel's fault in the
port is raised (``kernels.KERNEL_FAULTS``, ROADMAP C.7), so arming
``kernel_dispatch`` raises :class:`HyperspaceException` (ROADMAP C.11).

**Crash points** (``hyperspace.faults.crash.<point>``) are named places
inside every action where a writer can die mid-protocol, leaving a
transient log entry and orphan data files for ``metadata/recovery.py``::

    "raise"              raise SimulatedCrash at the point (in process)
    "exit"               os._exit(CRASH_EXIT_CODE): the process really dies,
                         no finally block, no heartbeat shutdown
    "raise;at=3"         fire on the 3rd matching call (after two bucket
                         files landed)
    "raise;match=v__=2"  only calls whose detail contains the substring

========================  ====================================================
crash point               armed site
========================  ====================================================
``after_begin_log``       ``actions/base.py``: begin entry published, no data
                          work yet, no lease heartbeat yet
``mid_data_write``        ``io/parquet.py`` bucket and table writes: between
                          the data files of the new version dir
``after_data_write``      ``actions/base.py``: op() done, end entry not
                          written
``after_end_log``         ``actions/base.py``: end entry committed,
                          latestStable not republished
``mid_vacuum_delete``     ``actions/vacuum.py``: between the deletes of a
                          vacuum or a vacuum of outdated versions
``mid_sidecar_publish``   ``indexes/aggindex.py``: before the replace that
                          publishes ``_aggstate.json`` / ``_aggsample.parquet``
``mid_spill_write``       ``execution/serve_cache.py``: a demotion between
                          choosing its spill path and the atomic publish
``mid_querylog_rotate``   ``obs/querylog.py``: a rotation between the fsync
                          of the active file and its rename to a sealed
                          segment
========================  ====================================================

A crash point is one-shot in ``raise``
mode: it disarms itself when it fires, so the recovery and retry that
follow run clean. :class:`SimulatedCrash` is a ``BaseException``: no
``except Exception`` cleanup may swallow it, as a real crash would not
have run that handler either.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from hyperspace_tpu_torch.exceptions import HyperspaceException

POINTS = ("parquet_read", "log_read", "cache_insert", "fastbus_send")

#: the reference's point that the port refuses to arm (module docstring)
KERNEL_DISPATCH = "kernel_dispatch"

CRASH_POINTS = (
    "after_begin_log",
    "mid_data_write",
    "after_data_write",
    "after_end_log",
    "mid_vacuum_delete",
    "mid_sidecar_publish",
    "mid_spill_write",
    "mid_querylog_rotate",
)

#: ``exit``-mode status: a subprocess test tells a simulated crash from an
#: ordinary failure of the child by it
CRASH_EXIT_CODE = 86


class SimulatedCrash(BaseException):
    """An armed crash point fired in ``raise`` mode (a process death, so not
    an ``Exception``)."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point


class InjectedFault(OSError):
    """A fault fired by an armed injection point (an ``OSError``, so it is
    classified as a real I/O error is)."""

    def __init__(self, point: str, transient: bool):
        kind = "transient" if transient else "persistent"
        super().__init__(f"injected {kind} fault at {point}")
        self.point = point
        self.transient = transient


class _FaultPoint:
    """One armed point: remaining budget (None = unlimited), substring
    filter. ``fire`` updates its counters under the registry lock."""

    def __init__(self, point: str, transient: bool, remaining: Optional[int],
                 match: Optional[str]):
        self.point = point
        self.transient = transient
        self.remaining = remaining
        self.match = match

    def fire(self, detail: str) -> bool:
        if self.match and self.match not in detail:
            return False
        with _lock:
            if self.remaining is not None:
                if self.remaining <= 0:
                    return False
                self.remaining -= 1
            _fired_totals[self.point] = _fired_totals.get(self.point, 0) + 1
        return True


class _CrashPoint:
    """One armed crash point: fire mode (raise/exit), the 1-based call
    ordinal it fires at, substring filter."""

    def __init__(self, point: str, exit_: bool, at: int, match: Optional[str]):
        self.point = point
        self.exit = exit_
        self.at = at
        self.match = match
        self.calls = 0

    def fire(self, detail: str) -> bool:
        if self.match and self.match not in detail:
            return False
        with _lock:
            self.calls += 1
            if self.calls != self.at:
                return False
            key = "crash." + self.point
            _fired_totals[key] = _fired_totals.get(key, 0) + 1
        return True


_lock = threading.Lock()
_active: Dict[str, _FaultPoint] = {}
_crash_active: Dict[str, _CrashPoint] = {}
# totals survive a disarm and re-arm; crash points count as "crash.<point>"
_fired_totals: Dict[str, int] = {}


def _refuse_kernel_dispatch() -> None:
    raise HyperspaceException(
        "fault point 'kernel_dispatch' is not ported: a kernel's fault is "
        "raised, never turned into its plain version (ROADMAP C.7, C.11)"
    )


def parse_spec(spec: str):
    """``(transient, remaining, match)`` from a fault spec, or None for
    off/empty. A malformed spec raises ValueError."""
    s = str(spec).strip()
    if not s or s.lower() == "off":
        return None
    match = None
    parts = s.split(";")
    for opt in parts[1:]:
        k, _, v = opt.partition("=")
        if k.strip() == "match" and v:
            match = v
        else:
            raise ValueError(f"bad fault option {opt!r} in {spec!r}")
    mode, _, count = parts[0].strip().lower().partition(":")
    if mode == "transient":
        remaining = int(count) if count else 1
        if remaining <= 0:
            raise ValueError(f"transient count must be positive: {spec!r}")
        return True, remaining, match
    if mode == "persistent":
        if count:
            raise ValueError(f"persistent takes no count: {spec!r}")
        return False, None, match
    raise ValueError(f"unknown fault mode {mode!r} in {spec!r}")


def set_fault(point: str, spec: str) -> bool:
    """Arm (or disarm, spec="off") one injection point; True when armed."""
    if point == KERNEL_DISPATCH:
        _refuse_kernel_dispatch()
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r}; have {POINTS}")
    parsed = parse_spec(spec)
    with _lock:
        if parsed is None:
            _active.pop(point, None)
            return False
        _active[point] = _FaultPoint(point, *parsed)
        return True


def parse_crash_spec(spec: str):
    """``(exit, at, match)`` from a crash spec, or None for off/empty. A
    malformed spec raises ValueError."""
    s = str(spec).strip()
    if not s or s.lower() == "off":
        return None
    match = None
    at = 1
    parts = s.split(";")
    for opt in parts[1:]:
        k, _, v = opt.partition("=")
        k = k.strip()
        if k == "match" and v:
            match = v
        elif k == "at":
            at = int(v)
            if at <= 0:
                raise ValueError(f"crash at= must be positive: {spec!r}")
        else:
            raise ValueError(f"bad crash option {opt!r} in {spec!r}")
    mode = parts[0].strip().lower()
    if mode not in ("raise", "exit"):
        raise ValueError(f"unknown crash mode {mode!r} in {spec!r}")
    return mode == "exit", at, match


def set_crash(point: str, spec: str) -> bool:
    """Arm (or disarm, spec="off") one crash point; True when armed."""
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r}; have {CRASH_POINTS}")
    parsed = parse_crash_spec(spec)
    with _lock:
        if parsed is None:
            _crash_active.pop(point, None)
            return False
        _crash_active[point] = _CrashPoint(point, *parsed)
        return True


def configure(conf) -> int:
    """Arm every ``hyperspace.faults.<point>`` and
    ``hyperspace.faults.crash.<point>`` key of a session config; returns the
    number of points armed. Points without a key are left as they are."""
    from hyperspace_tpu_torch.constants import CRASH_KEY_PREFIX, FAULTS_KEY_PREFIX

    n = 0
    for key, spec in conf.prefixed(CRASH_KEY_PREFIX).items():
        if set_crash(key[len(CRASH_KEY_PREFIX):], str(spec)):
            n += 1
    for key, spec in conf.prefixed(FAULTS_KEY_PREFIX).items():
        if key.startswith(CRASH_KEY_PREFIX):
            continue
        if set_fault(key[len(FAULTS_KEY_PREFIX):], str(spec)):
            n += 1
    return n


def reset() -> None:
    """Disarm every point and zero the fired totals."""
    with _lock:
        _active.clear()
        _crash_active.clear()
        _fired_totals.clear()


def check(point: str, detail="") -> None:
    """Raise :class:`InjectedFault` when ``point`` is armed and fires.
    ``detail`` is stringified only when the point is armed."""
    if not _active:
        return
    fp = _active.get(point)
    if fp is not None and fp.fire(str(detail)):
        raise InjectedFault(point, fp.transient)


def degraded(point: str, detail="") -> bool:
    """True when ``point`` is armed and fires: the non-raising form for
    sites that degrade in place (a dropped cache insert). ``detail`` is
    stringified only when the point is armed."""
    if not _active:
        return False
    fp = _active.get(point)
    return fp is not None and fp.fire(str(detail))


def crash(point: str, detail="") -> None:
    """Die at ``point`` when armed: raise :class:`SimulatedCrash` (``raise``
    mode, one-shot) or ``os._exit(CRASH_EXIT_CODE)`` (``exit`` mode, which
    skips every finally block, exit handler and lease heartbeat, as a
    kill -9 would)."""
    if not _crash_active:
        return
    cp = _crash_active.get(point)
    if cp is None or not cp.fire(str(detail)):
        return
    if cp.exit:
        os._exit(CRASH_EXIT_CODE)
    with _lock:
        _crash_active.pop(point, None)
    raise SimulatedCrash(point)


def stats() -> Dict[str, int]:
    """Fired count a point since the last reset; crash points appear as
    ``crash.<point>``."""
    with _lock:
        return dict(_fired_totals)
