"""Action protocol: validate / begin / op / end.

Reference: ``actions/Action.scala:34-108``. Counterpart of
``hyperspace_tpu/actions/base.py`` for a single process. The id
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

Not ported: multi-process coordination (ROADMAP A.9), fleet events and
tracing (A.10).
"""

from __future__ import annotations

import abc
import time

from hyperspace_tpu_torch.exceptions import (
    ConcurrentWriteException,
    NoChangesException,
)
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.testing import faults


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

    def _resnapshot(self) -> None:
        """Re-read every log-derived member off the CURRENT tip (an action
        may run long after construction)."""
        self.base_id = self.log_manager.get_latest_id() or 0

    # -- driver (Action.run:84-105 + recovery and retry) ----------------------
    def run(self) -> None:
        self._run_protocol()

    def _run_protocol(self) -> None:
        """The reference's single-process protocol (an action that writes
        no begin entry, cancel, overrides it)."""
        from hyperspace_tpu_torch.metadata import recovery

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
                return
            begin = self.begin_log_entry().with_state(self.transient_state)
            if recovery_on:
                recovery.stamp_lease(begin, owner, lease_ms)
            begin.id = self.base_id + 1
            if self.log_manager.write_log(self.base_id + 1, begin):
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
            final = self.log_entry().with_state(self.final_state)
            final.id = self.base_id + 2
            if not self.log_manager.write_log(self.base_id + 2, final):
                # the end id exists already: a cancel or a recovery rolled
                # our transient entry back, and the data work must not be
                # published over their write
                raise ConcurrentWriteException(
                    f"Concurrent write at log id {self.base_id + 2}"
                )
            faults.crash("after_end_log", type(self).__name__)
            self.log_manager.create_latest_stable_log(self.base_id + 2)
        finally:
            # stopped on every in-process exit, SimulatedCrash included: in
            # a real death the thread dies with the process and the lease
            # starts aging all the same
            if heartbeat is not None:
                heartbeat.stop()
