"""Resolve index names to index root directories.

Reference: ``index/PathResolver.scala:30-70`` — root is the
``hyperspace.system.path`` conf (default ``<warehouse>/indexes``); lookup
is case-insensitive against existing directories.
"""

from __future__ import annotations

import os
from typing import List


class PathResolver:
    def __init__(self, conf):
        self._conf = conf

    @property
    def system_path(self) -> str:
        return self._conf.system_path

    def get_index_path(self, name: str) -> str:
        """Existing dir matching case-insensitively, else ``<root>/<name>``
        (getIndexPath:39-58)."""
        root = self.system_path
        if os.path.isdir(root):
            for existing in os.listdir(root):
                if existing.lower() == name.lower():
                    return os.path.join(root, existing)
        return os.path.join(root, name)

    def all_index_paths(self) -> List[str]:
        root = self.system_path
        if not os.path.isdir(root):
            return []
        return [
            os.path.join(root, n)
            for n in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, n))
            # lake-level service dirs (_hyperspace_*) are not indexes
            and not n.startswith("_hyperspace")
        ]
