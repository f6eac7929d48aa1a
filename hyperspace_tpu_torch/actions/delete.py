"""Delete (soft) and Restore actions.

Reference: ``actions/DeleteAction.scala`` (ACTIVE → DELETING → DELETED; no
data touched, queries just stop seeing the index) and
``actions/RestoreAction.scala`` (DELETED → RESTORING → ACTIVE).
Counterpart of ``hyperspace_tpu/actions/delete.py``.
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.telemetry import DeleteActionEvent, RestoreActionEvent


class _StateFlipAction(Action):
    """Shared shape: require a state, rewrite the same entry with a new
    state; op() touches no data."""

    required_state = ""

    def __init__(self, session, index_name: str, log_manager):
        super().__init__(session, log_manager)
        self.index_name = index_name
        self._previous: Optional[IndexLogEntry] = None
        self._resnapshot()

    def _resnapshot(self) -> None:
        super()._resnapshot()
        # the LATEST entry, stable or not: a dangling transient state (a
        # failed action) blocks every operation until cancel()
        self._previous = self.log_manager.get_latest_log()

    def validate(self) -> None:
        if self._previous is None:
            raise HyperspaceException(f"Index not found: {self.index_name!r}")
        if self._previous.state != self.required_state:
            raise HyperspaceException(
                f"{type(self).__name__} requires state {self.required_state}; "
                f"index {self.index_name!r} is {self._previous.state}"
            )

    def op(self) -> None:
        pass

    def log_entry(self) -> IndexLogEntry:
        return self._previous.copy()


class DeleteAction(_StateFlipAction):
    transient_state = States.DELETING
    final_state = States.DELETED
    required_state = States.ACTIVE

    def event(self, success, message=""):
        return DeleteActionEvent(index_name=self.index_name, message=message)


class RestoreAction(_StateFlipAction):
    transient_state = States.RESTORING
    final_state = States.ACTIVE
    required_state = States.DELETED

    def event(self, success, message=""):
        return RestoreActionEvent(index_name=self.index_name, message=message)
