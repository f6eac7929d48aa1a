"""Operation-log manager with optimistic concurrency.

Reference: ``index/IndexLogManager.scala:57-195``. Layout under the index
root::

    <index>/_hyperspace_log/0, 1, 2, ...   numbered JSON log entries
    <index>/_hyperspace_log/latestStable   pointer file (copy of the entry)

Concurrency contract (writeLog:178-194): writing id N succeeds iff no file
named N exists — temp file + atomic link (create-if-absent). Two concurrent
actions conflict at their ``begin()`` write and exactly one proceeds.
"""

from __future__ import annotations

import os
from typing import List, Optional

from hyperspace_tpu_torch.constants import (
    HYPERSPACE_LOG_DIR,
    LATEST_STABLE_LOG_NAME,
    States,
)
from hyperspace_tpu_torch.exceptions import LogCorruptedError
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.testing import faults
from hyperspace_tpu_torch.utils import files as file_utils
from hyperspace_tpu_torch.utils import json_utils


def _parse_entry(path: str) -> IndexLogEntry:
    """Parse one on-disk log entry; typed LogCorruptedError on torn or
    unparseable JSON (a crash artifact, not a caller bug; the recovery
    plane treats it as a stranded entry)."""
    text = file_utils.read_text(path)
    try:
        return IndexLogEntry.from_dict(json_utils.from_json(text))
    except (ValueError, KeyError, TypeError) as exc:
        raise LogCorruptedError(path, f"{type(exc).__name__}: {exc}") from exc


class IndexLogManager:
    """IndexLogManagerImpl equivalent."""

    def __init__(self, index_path: str):
        self.index_path = index_path
        self.log_dir = os.path.join(index_path, HYPERSPACE_LOG_DIR)

    # -- paths --------------------------------------------------------------
    def _path_for(self, log_id: int) -> str:
        return os.path.join(self.log_dir, str(log_id))

    @property
    def _latest_stable_path(self) -> str:
        return os.path.join(self.log_dir, LATEST_STABLE_LOG_NAME)

    # -- reads --------------------------------------------------------------
    def get_log(self, log_id: int) -> Optional[IndexLogEntry]:
        p = self._path_for(log_id)
        # fault-injection seam (testing/faults.py, "log_read")
        faults.check("log_read", p)
        if not os.path.isfile(p):
            return None
        return _parse_entry(p)

    def get_latest_id(self) -> Optional[int]:
        """Highest numeric log file present (getLatestId)."""
        if not os.path.isdir(self.log_dir):
            return None
        ids = [int(n) for n in os.listdir(self.log_dir) if n.isdigit()]
        return max(ids) if ids else None

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        latest = self.get_latest_id()
        return self.get_log(latest) if latest is not None else None

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        """latestStable pointer, else scan ids backwards for a stable state
        (getLatestStableLog:102-127)."""
        p = self._latest_stable_path
        faults.check("log_read", p)
        if os.path.isfile(p):
            try:
                entry = _parse_entry(p)
            except LogCorruptedError:
                # torn pointer (crash mid-publish on a no-atomic-rename
                # mount): fall through to the backward scan — the
                # numbered entries are the source of truth
                entry = None
            if entry is not None and entry.state in States.STABLE_STATES:
                return entry
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            try:
                entry = self.get_log(log_id)
            except LogCorruptedError:
                # a torn entry is a stranded WRITE, not a reason the
                # index has no stable history: keep scanning past it
                continue
            if entry is not None and entry.state in States.STABLE_STATES:
                return entry
        return None

    def get_index_versions(self, states: List[str]) -> List[int]:
        """Log ids whose entry state is in ``states``
        (getIndexVersions:129-142), newest first."""
        latest = self.get_latest_id()
        if latest is None:
            return []
        out = []
        for log_id in range(latest, -1, -1):
            try:
                entry = self.get_log(log_id)
            except LogCorruptedError:
                continue
            if entry is not None and entry.state in states:
                out.append(log_id)
        return out

    def get_latest_stable_pointer_id(self) -> Optional[int]:
        """The id the latestStable POINTER file records, without the
        backward-scan fallback: None when the pointer is missing, torn, or
        names a non-stable entry."""
        p = self._latest_stable_path
        if not os.path.isfile(p):
            return None
        try:
            entry = _parse_entry(p)
        except LogCorruptedError:
            return None
        return entry.id if entry.state in States.STABLE_STATES else None

    # -- writes -------------------------------------------------------------
    def write_log(self, log_id: int, entry: IndexLogEntry) -> bool:
        """Create log file ``log_id``; False on OCC conflict (writeLog:178-194).

        ``entry.id`` is only stamped after the write wins the race, so a
        losing writer's in-memory entry is left untouched.
        """
        payload = entry.to_dict()
        payload["id"] = log_id
        ok = file_utils.atomic_write_if_absent(
            self._path_for(log_id), json_utils.to_json(payload, indent=2)
        )
        if ok:
            entry.id = log_id
        return ok

    def create_latest_stable_log(self, log_id: int) -> bool:
        """Copy entry ``log_id`` onto the latestStable pointer
        (createLatestStableLog:144-162)."""
        entry = self.get_log(log_id)
        if entry is None or entry.state not in States.STABLE_STATES:
            return False
        file_utils.atomic_overwrite(
            self._latest_stable_path, json_utils.to_json(entry.to_dict(), indent=2)
        )
        return True

    def delete_latest_stable_log(self) -> None:
        file_utils.delete(self._latest_stable_path)

    def delete_log(self) -> None:
        """Remove the whole log dir (vacuum)."""
        file_utils.delete(self.log_dir)

    def overwrite_log(self, log_id: int, entry: IndexLogEntry) -> None:
        """Atomically REPLACE log file ``log_id``, outside the OCC
        create-if-absent protocol. Its one use is a live writer's lease
        heartbeat re-stamping its own transient entry
        (``metadata/recovery.LeaseHeartbeat``); final entries are only ever
        created through :meth:`write_log`."""
        payload = entry.to_dict()
        payload["id"] = log_id
        file_utils.atomic_overwrite(
            self._path_for(log_id), json_utils.to_json(payload, indent=2)
        )
