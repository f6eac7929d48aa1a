"""Dependency-injection seams for the metadata plane.

Reference: ``index/factories.scala:26-50``; counterpart of
``hyperspace_tpu/factories.py``. The collection manager builds every
per-index log and data manager through these module-level factories, so
tests can swap in failing managers (and restore them afterwards, e.g.
through pytest's ``monkeypatch.setattr``) to drive an action's failure
paths without real faults.
"""

from __future__ import annotations

from typing import Callable

from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager

# callable(index_path) -> log manager
log_manager_factory: Callable[[str], IndexLogManager] = IndexLogManager
# callable(index_path) -> data manager
data_manager_factory: Callable[[str], IndexDataManager] = IndexDataManager


def create_log_manager(index_path: str) -> IndexLogManager:
    return log_manager_factory(index_path)


def create_data_manager(index_path: str) -> IndexDataManager:
    return data_manager_factory(index_path)
