"""Action protocol: validate / begin / op / end.

Reference: ``actions/Action.scala:34-108``. Counterpart of
``hyperspace_tpu/actions/base.py``. The id
arithmetic (`:35-36`): ``baseId`` = latest existing log id (0 if none);
begin writes ``baseId+1`` (transient), end writes ``baseId+2`` (final)
and recreates the ``latestStable`` pointer. ``NoChangesException`` from
``validate`` makes the whole action a graceful no-op.

Crash safety (``metadata/recovery.py``): ``run()`` first repairs a dead
writer's leavings at the log tip (``ensure_recovered``: rollback of a
lease-expired transient entry, latestStable healing), re-snapshots
``base_id``, stamps a writer lease into the begin entry and heartbeats
that lease while ``op()`` and the commit run, so a slow writer is never
taken for a dead one. A begin write that loses the OCC race to another
writer retries from a fresh snapshot with backoff, up to
``hyperspace.recovery.retry.maxAttempts`` tries. Nothing else is
retried: an exception from ``validate`` or ``op``, a kernel's fault
(``kernels.KERNEL_FAULTS``) above all, propagates on the first attempt
and leaves the leased transient entry for the next action's recovery once
the lease has expired. The crash points after_begin_log, after_data_write
and after_end_log (``testing/faults.py``) sit here; mid_data_write and
mid_vacuum_delete at the data seams.

Jobs of several processes (``parallel/mesh.initialize_distributed``):
the metadata plane keeps one writer. Only the coordinator (rank 0) runs
recovery, the begin and commit log writes (:func:`_publish_log`) and the
latestStable publish (:func:`_publish_latest_stable`), in
:meth:`Action._run_coordinated`; every other process runs the data plane
(:meth:`Action._run_data_plane`): the same snapshot and validate, then
``op()``, whose exchange and ``_global_written`` barrier every process
reaches alike. Three abort-aware rendezvous (:func:`_action_rendezvous`,
an ``all_gather`` of each process's verdict) order the protocol and turn a
one-sided failure into a ``ConcurrentWriteException`` on every process
instead of a hang: workers snapshot after the coordinator's recovery
(``recovered``), every process validates before the begin entry exists
(``validate``; a no-op must be unanimous), and no worker enters the data
plane before the begin entry is written (``begin``). One action at a time
a job: the coordinator makes one begin-write attempt, since a quiet retry
on one process would put the rendezvous out of step.

A committed action publishes one fleet event (``serve/bus.py``) in fleet
mode, and every action runs under a root span (``obs/trace.py``).
"""

from __future__ import annotations

import abc
import time
from typing import Optional

from hyperspace_tpu_torch.exceptions import (
    ConcurrentWriteException,
    NoChangesException,
)
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.parallel import mesh as _mesh
from hyperspace_tpu_torch.telemetry import HyperspaceEvent
from hyperspace_tpu_torch.testing import faults


def _multiprocess() -> bool:
    return _mesh.process_count() > 1


#: per-process step verdicts exchanged at each rendezvous
_STEP_FAIL, _STEP_PROCEED, _STEP_NOOP = 0, 1, 2


def _action_rendezvous(step: str, verdict: int) -> int:
    """Gather every process's verdict for ``step`` and return the
    unanimous one. Any failure, or a proceed / no-op disagreement, raises
    ``ConcurrentWriteException`` on every process. Registered in
    ``COLLECTIVE_SITES`` (``per-host-lane``)."""
    import torch
    import torch.distributed as dist

    dev = _mesh.comm_device()
    mine = torch.tensor([verdict], dtype=torch.int32, device=dev)
    gathered = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    flags = [int(g.item()) for g in gathered]
    if _STEP_FAIL in flags or len(set(flags)) > 1:
        raise ConcurrentWriteException(
            f"multi-process action aborted at step {step!r}: per-process verdicts "
            f"{flags} (0=failed, 1=proceed, 2=no-op)"
        )
    return flags[0]


def _publish_log(log_manager: IndexLogManager, log_id: int, entry) -> bool:
    """The OCC log write; on a job of several processes only the
    coordinator reaches it (``COLLECTIVE_SITES``, coordinator-gated)."""
    return log_manager.write_log(log_id, entry)


def _publish_latest_stable(log_manager: IndexLogManager, log_id: int) -> bool:
    """The latestStable publish, the same single-writer seam."""
    return log_manager.create_latest_stable_log(log_id)


class Action(abc.ABC):
    transient_state: str = ""
    final_state: str = ""

    def __init__(self, session, log_manager: IndexLogManager):
        self.session = session
        self.log_manager = log_manager
        self.base_id: int = log_manager.get_latest_id() or 0

    # -- protocol pieces ----------------------------------------------------
    def validate(self) -> None:
        """Raise HyperspaceException on an illegal state, or
        NoChangesException to make the action a no-op."""

    @abc.abstractmethod
    def op(self) -> None:
        """The data-plane work (device pipeline / file IO)."""

    @abc.abstractmethod
    def log_entry(self) -> IndexLogEntry:
        """The final log entry content (state is stamped by run())."""

    def begin_log_entry(self) -> IndexLogEntry:
        """Entry written at begin; defaults to log_entry(). Actions whose
        content only exists after op() (create) override this."""
        return self.log_entry()

    def event(self, success: bool, message: str = "") -> Optional[HyperspaceEvent]:
        """The action's telemetry event (each subclass names its own)."""
        return None

    def _resnapshot(self) -> None:
        """Re-read every log-derived member off the CURRENT tip (an action
        may run long after construction)."""
        self.base_id = self.log_manager.get_latest_id() or 0

    # -- driver (Action.run:84-105 + recovery and retry) ----------------------
    def run(self) -> None:
        """One root span ``action.<Class>`` around the protocol, finished
        whatever the outcome; the build's stage hooks and ``log_commit``
        attach to it (the reference's ``Action.run``)."""
        obs_trace.configure(self.session.conf)
        index_name = getattr(self, "index_name", "") or getattr(
            getattr(self, "index_config", None), "index_name", ""
        )
        root = obs_trace.root(f"action.{type(self).__name__}", index=str(index_name))
        with obs_trace.activate(root):
            try:
                self._run_protocol()
                root.set("status", "ok")
            except BaseException:
                root.set("status", "failed")
                raise
            finally:
                root.finish()

    def _run_protocol(self) -> None:
        """The reference's protocol (an action that writes no begin entry,
        cancel, overrides it): on a job of several processes the
        coordinated one, else the single-process one with recovery and
        retries."""
        from hyperspace_tpu_torch.metadata import recovery

        if _multiprocess():
            if self.session.runtime.is_coordinator:
                self._run_coordinated()
            else:
                self._run_data_plane()
            return

        conf = self.session.conf
        recovery_on = conf.recovery_enabled
        attempts = conf.recovery_retry_max_attempts if recovery_on else 1
        backoff = conf.recovery_retry_backoff_ms / 1000.0
        lease_ms = conf.recovery_lease_ms
        owner = recovery.new_owner_id()
        begin = None
        for attempt in range(1, attempts + 1):
            if attempt > 1 and backoff > 0:
                time.sleep(backoff * (1 << (attempt - 2)))
            # repair a dead writer's leavings BEFORE the snapshot, so the
            # snapshot sees the repaired log
            if recovery_on:
                recovery.ensure_recovered(self.log_manager, lease_ms)
            self._resnapshot()
            try:
                self.validate()
            except NoChangesException:
                self._log_event(True, "No-op action")
                return
            begin = self.begin_log_entry().with_state(self.transient_state)
            if recovery_on:
                recovery.stamp_lease(begin, owner, lease_ms)
            begin.id = self.base_id + 1
            if _publish_log(self.log_manager, self.base_id + 1, begin):
                break
            if attempt >= attempts:
                raise ConcurrentWriteException(
                    f"Another operation is in progress (log id "
                    f"{self.base_id + 1} already exists after {attempts} "
                    f"attempts)"
                )
        faults.crash("after_begin_log", type(self).__name__)
        heartbeat = None
        if recovery_on:
            heartbeat = recovery.LeaseHeartbeat(
                self.log_manager, self.base_id + 1, begin, owner, lease_ms
            ).start()
        try:
            self.op()
            faults.crash("after_data_write", type(self).__name__)
            with obs_trace.span("log_commit"):
                final = self.log_entry().with_state(self.final_state)
                final.id = self.base_id + 2
                if not _publish_log(self.log_manager, self.base_id + 2, final):
                    # the end id exists already: a cancel or a recovery
                    # rolled our transient entry back, and the data work
                    # must not be published over their write
                    raise ConcurrentWriteException(
                        f"Concurrent write at log id {self.base_id + 2}"
                    )
                faults.crash("after_end_log", type(self).__name__)
                _publish_latest_stable(self.log_manager, self.base_id + 2)
        except Exception as e:
            self._log_event(False, str(e))
            raise
        finally:
            # stopped on every in-process exit, SimulatedCrash included: in
            # a real death the thread dies with the process and the lease
            # starts aging all the same
            if heartbeat is not None:
                heartbeat.stop()
        self._publish_fleet_event(final)
        self._log_event(True)

    # -- jobs of several processes (reference base.py:259-364) ---------------
    def _rendezvous_step(self, step: str, fn) -> int:
        """Run one protocol step here, then meet the peers on its verdict.
        A local exception wins over the collective abort, so the failing
        process reports its own cause while its peers get the typed
        ``ConcurrentWriteException`` instead of blocking."""
        verdict, err = _STEP_PROCEED, None
        try:
            fn()
        except NoChangesException:
            verdict = _STEP_NOOP
        # every exception: the verdict must reach the peers (they are
        # entering the same all_gather) before this process unwinds
        except Exception as e:
            verdict, err = _STEP_FAIL, e
        try:
            return _action_rendezvous(step, verdict)
        except ConcurrentWriteException:
            if err is not None:
                raise err
            raise

    def _run_coordinated(self) -> None:
        """The coordinator of a job of several processes: the single-writer
        metadata plane and the shared data plane, with a rendezvous at each
        step. One begin-write attempt: an OCC loss aborts every process at
        the ``begin`` rendezvous."""
        from hyperspace_tpu_torch.metadata import recovery

        conf = self.session.conf
        recovery_on = conf.recovery_enabled
        lease_ms = conf.recovery_lease_ms
        owner = recovery.new_owner_id()

        def repair():
            # a dead writer's leavings are repaired before anyone snapshots
            if recovery_on:
                recovery.ensure_recovered(self.log_manager, lease_ms)

        self._rendezvous_step("recovered", repair)

        def snapshot_validate():
            self._resnapshot()
            self.validate()

        if self._rendezvous_step("validate", snapshot_validate) == _STEP_NOOP:
            self._log_event(True, "No-op action")
            return
        begin_box = []

        def begin_write():
            # every process has validated (the rendezvous above), so none
            # can take this begin entry for a concurrent writer's
            begin = self.begin_log_entry().with_state(self.transient_state)
            if recovery_on:
                recovery.stamp_lease(begin, owner, lease_ms)
            begin.id = self.base_id + 1
            if not _publish_log(self.log_manager, self.base_id + 1, begin):
                raise ConcurrentWriteException(
                    f"Another operation is in progress (log id {self.base_id + 1} "
                    f"already exists)"
                )
            begin_box.append(begin)

        self._rendezvous_step("begin", begin_write)
        heartbeat = None
        if recovery_on:
            heartbeat = recovery.LeaseHeartbeat(
                self.log_manager, self.base_id + 1, begin_box[0], owner, lease_ms
            ).start()
        try:
            self.op()
            with obs_trace.span("log_commit"):
                final = self.log_entry().with_state(self.final_state)
                final.id = self.base_id + 2
                if not _publish_log(self.log_manager, self.base_id + 2, final):
                    raise ConcurrentWriteException(f"Concurrent write at log id {self.base_id + 2}")
                _publish_latest_stable(self.log_manager, self.base_id + 2)
        except Exception as e:
            self._log_event(False, str(e))
            raise
        finally:
            if heartbeat is not None:
                heartbeat.stop()
        # coordinator-only, like every other metadata-plane write: one
        # publisher an action
        self._publish_fleet_event(final)
        self._log_event(True)

    def _run_data_plane(self) -> None:
        """A worker of a job of several processes: the coordinator's
        rendezvous and ``op()``, with no log writes, no recovery and no
        lease (the coordinator owns the metadata plane; this process gets
        the global file list through ``_global_written``)."""
        self._rendezvous_step("recovered", lambda: None)

        def snapshot_validate():
            # after the coordinator's recovery, by the rendezvous above
            self._resnapshot()
            self.validate()

        if self._rendezvous_step("validate", snapshot_validate) == _STEP_NOOP:
            self._log_event(True, "No-op action")
            return
        self._rendezvous_step("begin", lambda: None)
        try:
            self.op()
        except Exception as e:
            self._log_event(False, str(e))
            raise
        self._log_event(True)

    def _publish_fleet_event(self, entry) -> None:
        """Fan the committed action out to peer serve frontends
        (``serve/bus.py``; a no-op outside fleet mode, never raises: the
        commit already happened, a failed fanout only costs peers a lazy
        re-read)."""
        if not self.session.conf.fleet_enabled:
            return
        from hyperspace_tpu_torch.serve import bus

        bus.publish_action_event(
            self.session,
            getattr(self, "index_name", ""),
            self.log_manager.index_path,
            type(self).__name__,
            entry,
        )

    def _log_event(self, success: bool, message: str = "") -> None:
        ev = self.event(success, message)
        if ev is not None:
            self.session.event_logging.log_event(ev)
