"""Path normalization and data-path filtering.

Reference: ``util/PathUtils.scala`` (path normalization, ``DataPathFilter``
skipping hidden files — names starting with '_' or '.').
"""

from __future__ import annotations

import os


def normalize(path: str) -> str:
    """Absolute path with scheme-less local paths resolved.

    The reference normalizes to fully-qualified Hadoop paths
    (``PathUtils.makeAbsolute``); on a local/posix filesystem this is
    ``os.path.abspath`` with trailing separators stripped.
    """
    if "://" in path:
        return path.rstrip("/")
    return os.path.abspath(path)


def is_data_path(name: str) -> bool:
    """DataPathFilter: ignore metadata/hidden files (PathUtils.scala)."""
    base = os.path.basename(name)
    return not (base.startswith("_") or base.startswith("."))
