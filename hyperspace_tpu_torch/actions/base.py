"""Action protocol: validate / begin / op / end.

Reference: ``actions/Action.scala:34-108``. Counterpart of
``hyperspace_tpu/actions/base.py`` for a single process. The id
arithmetic (`:35-36`): ``baseId`` = latest existing log id (0 if none);
begin writes ``baseId+1`` (transient), end writes ``baseId+2`` (final)
and recreates the ``latestStable`` pointer. A concurrent writer loses the
``write_log`` create-if-absent race and the action raises
:class:`ConcurrentWriteException`. ``NoChangesException`` from
``validate`` makes the whole action a graceful no-op.

Not ported yet: crash recovery and writer leases, the OCC retry loop
(ROADMAP A.3b), multi-process coordination (A.9), fleet events and tracing
(A.10). Without recovery an action that fails after its begin entry
leaves that transient entry at the log tip, and every later action on
the index refuses to run until ``cancel`` rolls it back.
"""

from __future__ import annotations

import abc

from hyperspace_tpu_torch.exceptions import (
    ConcurrentWriteException,
    NoChangesException,
)
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager


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

    # -- protocol run (Action.run:84-105) -----------------------------------
    def run(self) -> None:
        self._run_protocol()

    def _run_protocol(self) -> None:
        """validate, begin entry, op, final entry and latestStable: the
        reference's single-process protocol without recovery and retries
        (an action that writes no begin entry, cancel, overrides it)."""
        self._resnapshot()
        try:
            self.validate()
        except NoChangesException:
            return
        begin = self.begin_log_entry().with_state(self.transient_state)
        begin.id = self.base_id + 1
        if not self.log_manager.write_log(self.base_id + 1, begin):
            raise ConcurrentWriteException(
                f"Another operation is in progress (log id "
                f"{self.base_id + 1} already exists)"
            )
        self.op()
        final = self.log_entry().with_state(self.final_state)
        final.id = self.base_id + 2
        if not self.log_manager.write_log(self.base_id + 2, final):
            raise ConcurrentWriteException(
                f"Concurrent write at log id {self.base_id + 2}"
            )
        self.log_manager.create_latest_stable_log(self.base_id + 2)
