"""Index collection manager: dispatches lifecycle operations to Actions.

Reference: ``index/IndexCollectionManager.scala:28-206`` (per-index
log/data managers via PathResolver and the factories, action dispatch
with refresh-mode and vacuum-state branching) and
``index/CachingIndexCollectionManager.scala`` (TTL read-cache of all log
entries, invalidated on any mutation). Recovery (``recover``) comes with
ROADMAP A.3b.
"""

from __future__ import annotations

import time
from typing import List, Optional

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.path_resolver import PathResolver


class IndexCollectionManager:
    def __init__(self, session):
        self.session = session
        self.path_resolver = PathResolver(session.conf)

    def _managers(self, index_name: str):
        from hyperspace_tpu_torch import factories

        path = self.path_resolver.get_index_path(index_name)
        return (
            factories.create_log_manager(path),
            factories.create_data_manager(path),
        )

    # -- operations (IndexManager trait, index/IndexManager.scala:24-127) ---
    def create(self, df, index_config) -> None:
        from hyperspace_tpu_torch.actions.create import CreateAction

        log_mgr, data_mgr = self._managers(index_config.index_name)
        CreateAction(self.session, df, index_config, log_mgr, data_mgr).run()

    def delete(self, index_name: str) -> None:
        from hyperspace_tpu_torch.actions.delete import DeleteAction

        log_mgr, _ = self._managers(index_name)
        DeleteAction(self.session, index_name, log_mgr).run()

    def restore(self, index_name: str) -> None:
        from hyperspace_tpu_torch.actions.delete import RestoreAction

        log_mgr, _ = self._managers(index_name)
        RestoreAction(self.session, index_name, log_mgr).run()

    def vacuum(self, index_name: str) -> None:
        """State-dependent: DELETED -> hard delete everything; ACTIVE ->
        vacuum outdated versions (IndexCollectionManager.vacuum:62-81)."""
        from hyperspace_tpu_torch.actions.vacuum import (
            VacuumAction,
            VacuumOutdatedAction,
        )

        log_mgr, data_mgr = self._managers(index_name)
        entry = log_mgr.get_latest_log()
        if entry is None:
            raise HyperspaceException(f"Index not found: {index_name!r}")
        if entry.state == States.DELETED:
            VacuumAction(self.session, index_name, log_mgr).run()
        elif entry.state == States.ACTIVE:
            VacuumOutdatedAction(self.session, index_name, log_mgr, data_mgr).run()
        else:
            raise HyperspaceException(f"Cannot vacuum index in state {entry.state}")

    def refresh(self, index_name: str, mode: str) -> None:
        from hyperspace_tpu_torch.actions.refresh import (
            RefreshAction,
            RefreshIncrementalAction,
            RefreshQuickAction,
        )

        mode = (mode or C.REFRESH_MODE_FULL).lower()
        if mode not in C.REFRESH_MODES:
            raise HyperspaceException(f"Unsupported refresh mode: {mode!r}")
        log_mgr, data_mgr = self._managers(index_name)
        cls = {
            C.REFRESH_MODE_FULL: RefreshAction,
            C.REFRESH_MODE_INCREMENTAL: RefreshIncrementalAction,
            C.REFRESH_MODE_QUICK: RefreshQuickAction,
        }[mode]
        cls(self.session, index_name, log_mgr, data_mgr).run()

    def optimize(self, index_name: str, mode: str) -> None:
        from hyperspace_tpu_torch.actions.optimize import OptimizeAction

        mode = (mode or C.OPTIMIZE_MODE_QUICK).lower()
        if mode not in C.OPTIMIZE_MODES:
            raise HyperspaceException(f"Unsupported optimize mode: {mode!r}")
        log_mgr, data_mgr = self._managers(index_name)
        OptimizeAction(self.session, index_name, log_mgr, data_mgr, mode).run()

    def cancel(self, index_name: str) -> None:
        from hyperspace_tpu_torch.actions.cancel import CancelAction

        log_mgr, _ = self._managers(index_name)
        CancelAction(self.session, index_name, log_mgr).run()

    # -- introspection ------------------------------------------------------
    def get_index_log_entry(self, index_name: str) -> Optional[IndexLogEntry]:
        log_mgr, _ = self._managers(index_name)
        return log_mgr.get_latest_stable_log()

    def get_indexes(self, states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        from hyperspace_tpu_torch import factories

        out = []
        for path in self.path_resolver.all_index_paths():
            entry = factories.create_log_manager(path).get_latest_stable_log()
            if entry is None:
                continue
            if states is None or entry.state in states:
                out.append(entry)
        return sorted(out, key=lambda e: e.name)

    def get_index_versions(self, index_name: str, states: List[str]) -> List[int]:
        log_mgr, _ = self._managers(index_name)
        return log_mgr.get_index_versions(states)


class CachingIndexCollectionManager(IndexCollectionManager):
    """TTL cache over ``get_indexes`` (CachingIndexCollectionManager:38-108):
    the query-time rule fetches all ACTIVE entries on every optimization, so
    reads are cached for ``hyperspace.index.cache.expiryDurationInSeconds``
    and the cache is cleared on any mutating operation."""

    def __init__(self, session):
        super().__init__(session)
        self._cache: Optional[List[IndexLogEntry]] = None
        self._cached_at: float = 0.0

    def clear_cache(self) -> None:
        self._cache = None

    def get_indexes(self, states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        expiry = self.session.conf.cache_expiry_seconds
        now = time.time()
        # snapshot the cache slot ONCE: a concurrent clear_cache() sets
        # _cache = None, and re-reading it after the staleness check
        # could observe that None
        entries = self._cache
        if entries is None or now - self._cached_at > expiry:
            entries = super().get_indexes(None)
            self._cache = entries
            self._cached_at = now
        if states is None:
            return list(entries)
        return [e for e in entries if e.state in states]

    def _mutate(self, fn, *args) -> None:
        self.clear_cache()
        try:
            fn(*args)
        finally:
            self.clear_cache()

    def create(self, df, index_config) -> None:
        self._mutate(super().create, df, index_config)

    def delete(self, index_name: str) -> None:
        self._mutate(super().delete, index_name)

    def restore(self, index_name: str) -> None:
        self._mutate(super().restore, index_name)

    def vacuum(self, index_name: str) -> None:
        self._mutate(super().vacuum, index_name)

    def refresh(self, index_name: str, mode: str) -> None:
        self._mutate(super().refresh, index_name, mode)

    def optimize(self, index_name: str, mode: str) -> None:
        self._mutate(super().optimize, index_name, mode)

    def cancel(self, index_name: str) -> None:
        self._mutate(super().cancel, index_name)
