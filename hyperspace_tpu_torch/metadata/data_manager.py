"""Versioned index-data directories ``<index>/v__=N/``.

Reference: ``index/IndexDataManager.scala`` (layout doc :24-37). Index data
for log version N lives under ``v__=N``; versions are immutable once
written (what later makes refresh, restore and time travel cheap).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from hyperspace_tpu_torch.constants import INDEX_VERSION_DIR_PREFIX
from hyperspace_tpu_torch.utils import files as file_utils

_VERSION_RE = re.compile(rf"{re.escape(INDEX_VERSION_DIR_PREFIX)}=(\d+)(?:/|$)")


def version_from_path(path: str) -> Optional[int]:
    """The ``N`` of the ``v__=N`` directory a path lies in, or None."""
    m = _VERSION_RE.search(path.replace("\\", "/"))
    return int(m.group(1)) if m else None


class IndexDataManager:
    def __init__(self, index_path: str):
        self.index_path = index_path

    def _version_dir_name(self, version: int) -> str:
        return f"{INDEX_VERSION_DIR_PREFIX}={version}"

    def get_path(self, version: int) -> str:
        return os.path.join(self.index_path, self._version_dir_name(version))

    def get_all_versions(self) -> List[int]:
        if not os.path.isdir(self.index_path):
            return []
        out = []
        for name in os.listdir(self.index_path):
            if name.startswith(INDEX_VERSION_DIR_PREFIX + "="):
                try:
                    out.append(int(name.split("=", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def get_latest_version_id(self) -> Optional[int]:
        versions = self.get_all_versions()
        return versions[-1] if versions else None

    def delete(self, version: int) -> None:
        file_utils.delete(self.get_path(version))
