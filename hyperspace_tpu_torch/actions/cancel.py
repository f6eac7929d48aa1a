"""CancelAction — roll an interrupted operation back to the last stable
state.

Reference: ``actions/CancelAction.scala`` (validates the index is stuck in
a transient state, then appends a copy of the last stable entry so every
operation sees the pre-failure state again; ``Hyperspace.scala:139-151``).
Counterpart of ``hyperspace_tpu/actions/cancel.py``. It writes exactly one
log entry, so it overrides ``_run_protocol``. The write is
``metadata/recovery.rollback``, shared with the automatic recovery; cancel
is the manual override on top of it and does not consult the writer lease
(a live writer racing a cancel loses its end commit at ``base_id + 2``,
the id the rollback takes, and aborts).
"""

from __future__ import annotations

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import (
    ConcurrentWriteException,
    HyperspaceException,
    LogCorruptedError,
)
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.telemetry import CancelActionEvent


class CancelAction(Action):
    transient_state = ""  # unused; _run_protocol() is overridden
    final_state = ""

    def __init__(self, session, index_name: str, log_manager):
        super().__init__(session, log_manager)
        self.index_name = index_name

    def validate(self) -> None:
        try:
            latest = self.log_manager.get_latest_log()
        except LogCorruptedError:
            # a torn tip is a crashed writer's leavings, which cancel
            # exists to clear: rollback() rolls past (or clears) it
            return
        if latest is None:
            raise HyperspaceException(f"Index not found: {self.index_name!r}")
        if latest.state in States.STABLE_STATES:
            raise HyperspaceException(
                f"Cancel is only supported for transient states; index "
                f"{self.index_name!r} is {latest.state}"
            )

    def op(self) -> None:  # pragma: no cover - not used
        pass

    def event(self, success, message=""):
        return CancelActionEvent(index_name=self.index_name, message=message)

    def log_entry(self) -> IndexLogEntry:  # pragma: no cover - not used
        raise NotImplementedError

    def _run_protocol(self) -> None:
        from hyperspace_tpu_torch.metadata import recovery

        self._resnapshot()
        self.validate()
        _tip, we_wrote = recovery.rollback(self.log_manager, self.base_id)
        if not we_wrote:
            # our rollback write lost the race (perhaps to the writer's
            # own end commit): a cancel that did not cancel says so
            raise ConcurrentWriteException(
                f"Concurrent write at log id {self.base_id + 1}"
            )
        self._log_event(True)

