"""Path normalization and data-path filtering.

Reference: ``util/PathUtils.scala`` (path normalization, ``DataPathFilter``
skipping hidden files — names starting with '_' or '.').
"""

from __future__ import annotations

import os


def is_data_path(name: str) -> bool:
    """DataPathFilter: ignore metadata/hidden files (PathUtils.scala)."""
    base = os.path.basename(name)
    return not (base.startswith("_") or base.startswith("."))
