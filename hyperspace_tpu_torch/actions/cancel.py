"""CancelAction — roll an interrupted operation back to the last stable
state.

Reference: ``actions/CancelAction.scala`` (validates the index is stuck in
a transient state, then appends a copy of the last stable entry so every
operation sees the pre-failure state again; ``Hyperspace.scala:139-151``).
Counterpart of ``hyperspace_tpu/actions/cancel.py``, whose rollback write
(``metadata/recovery.rollback`` there) is inlined here: the rest of the
recovery plane comes with ROADMAP A.3b. It writes exactly one log entry,
so it overrides ``_run_protocol``.
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import (
    ConcurrentWriteException,
    HyperspaceException,
    LogCorruptedError,
)
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.utils import files as file_utils


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

    def log_entry(self) -> IndexLogEntry:  # pragma: no cover - not used
        raise NotImplementedError

    def _run_protocol(self) -> None:
        self._resnapshot()
        self.validate()
        _tip, we_wrote = rollback(self.log_manager, self.base_id)
        if not we_wrote:
            # our rollback write lost the race (perhaps to the writer's
            # own end commit): a cancel that did not cancel says so
            raise ConcurrentWriteException(
                f"Concurrent write at log id {self.base_id + 1}"
            )


def _latest_stable_by_scan(
    log_manager: IndexLogManager, below_id: int
) -> Optional[IndexLogEntry]:
    """Newest parseable stable entry with id < ``below_id``, from the
    numbered entries (never the pointer, which may be stale or torn)."""
    for log_id in range(below_id - 1, -1, -1):
        try:
            entry = log_manager.get_log(log_id)
        except LogCorruptedError:
            continue
        if entry is not None and entry.state in States.STABLE_STATES:
            return entry
    return None


def rollback(log_manager: IndexLogManager, latest_id: Optional[int] = None):
    """Roll the log back from a transient or torn latest entry to its
    stable predecessor along ``States.ROLLBACK``: append a copy of the
    last stable entry (or, when none ever existed, the transient entry
    restamped with its rollback state) at ``latest_id + 1`` and republish
    latestStable. Returns ``(tip_entry, we_wrote)``; ``we_wrote`` is False
    when another write took the id first (reference
    ``metadata/recovery.py:206-262``)."""
    if latest_id is None:
        latest_id = log_manager.get_latest_id()
    if latest_id is None:
        return None, False
    try:
        latest = log_manager.get_log(latest_id)
    except LogCorruptedError:
        latest = None
    if latest is not None and latest.state in States.STABLE_STATES:
        return latest, False
    stable = _latest_stable_by_scan(log_manager, latest_id)
    if stable is not None:
        entry = stable.copy()
    elif latest is not None:
        entry = latest.with_state(States.ROLLBACK.get(latest.state, States.DOESNOTEXIST))
    else:
        # one torn entry and no stable history: clear it so the name is
        # reusable
        file_utils.delete(log_manager._path_for(latest_id))
        log_manager.delete_latest_stable_log()
        return None, True
    if not log_manager.write_log(latest_id + 1, entry):
        try:
            return log_manager.get_log(log_manager.get_latest_id()), False
        except LogCorruptedError:
            return None, False
    log_manager.create_latest_stable_log(latest_id + 1)
    return entry, True
