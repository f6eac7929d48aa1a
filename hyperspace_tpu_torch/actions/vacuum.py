"""Vacuum actions: hard-delete a DELETED index, or garbage-collect outdated
versions of an ACTIVE one.

Reference: ``actions/VacuumAction.scala`` (DELETED → VACUUMING →
DOESNOTEXIST: delete all index files; a later create may reuse the name)
and ``actions/VacuumOutdatedAction.scala:34-144`` (ACTIVE →
VACUUMINGOUTDATED → ACTIVE: delete every ``v__=N`` dir the live content
does not reference and every data file of a retained dir it does not
list). Counterpart of ``hyperspace_tpu/actions/vacuum.py`` without its
pins (a serve in another process pinning a snapshot comes with the serve
tier, ROADMAP A.10, so no file is held back) and without the reset of a
Delta source's version history (`:56-67`; Delta sources come with A.6).
"""

from __future__ import annotations

import os

from hyperspace_tpu_torch.actions.delete import _StateFlipAction
from hyperspace_tpu_torch.constants import (
    HYPERSPACE_LOG_DIR,
    HYPERSPACE_PINS_DIR,
    States,
)
from hyperspace_tpu_torch.metadata.data_manager import version_from_path
from hyperspace_tpu_torch.metadata.entry import Content, IndexLogEntry
from hyperspace_tpu_torch.utils import files as file_utils
from hyperspace_tpu_torch.utils import paths as path_utils


class VacuumAction(_StateFlipAction):
    transient_state = States.VACUUMING
    final_state = States.DOESNOTEXIST
    required_state = States.DELETED

    def op(self) -> None:
        """Delete all index data: every version dir, referenced or not."""
        index_path = self.log_manager.index_path
        for name in sorted(os.listdir(index_path)):
            if name not in (HYPERSPACE_LOG_DIR, HYPERSPACE_PINS_DIR):
                file_utils.delete(os.path.join(index_path, name))

    def log_entry(self) -> IndexLogEntry:
        entry = self._previous.copy()
        entry.content = Content.from_leaf_files([])
        return entry


class VacuumOutdatedAction(_StateFlipAction):
    transient_state = States.VACUUMINGOUTDATED
    final_state = States.ACTIVE
    required_state = States.ACTIVE

    def __init__(self, session, index_name, log_manager, data_manager):
        super().__init__(session, index_name, log_manager)
        self.data_manager = data_manager

    def op(self) -> None:
        """Delete the version dirs the live content does not reference and
        the data files of retained dirs it does not list
        (VacuumOutdatedAction.op:86-120), then drop the deleted files from
        the retained dirs' aggregate sidecars."""
        from hyperspace_tpu_torch.indexes import aggindex

        live_files = set(self._previous.content.files)
        live_versions = {
            v for v in (version_from_path(f) for f in live_files) if v is not None
        }
        for version in self.data_manager.get_all_versions():
            if version not in live_versions:
                self.data_manager.delete(version)
                continue
            root = self.data_manager.get_path(version)
            for path, _s, _m in file_utils.list_leaf_files(root):
                # underscore sidecars (_zonemaps.json, _aggstate.json,
                # _aggsample.parquet) are never in the content, so they
                # stay with the dir they describe; a leaked publish temp
                # (.<name>.tmp.<pid>) is garbage, and vacuum its sweeper
                if not path_utils.is_data_path(path):
                    if ".tmp." in os.path.basename(path):
                        file_utils.delete(path)
                    continue
                if path not in live_files:
                    file_utils.delete(path)
            aggindex.prune_missing(root)
