"""Index collection manager: dispatches lifecycle operations to Actions.

Reference: ``index/IndexCollectionManager.scala:28-206`` (per-index
log/data managers via PathResolver, action dispatch) and
``index/CachingIndexCollectionManager.scala`` (TTL read-cache of all log
entries, invalidated on any mutation). This slice dispatches create; the
other actions and recovery are ported with the lifecycle (ROADMAP queue A
item 6).
"""

from __future__ import annotations

import time
from typing import List, Optional

from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.metadata.path_resolver import PathResolver


class IndexCollectionManager:
    def __init__(self, session):
        self.session = session
        self.path_resolver = PathResolver(session.conf)

    def _managers(self, index_name: str):
        path = self.path_resolver.get_index_path(index_name)
        return IndexLogManager(path), IndexDataManager(path)

    # -- operations (IndexManager trait, index/IndexManager.scala:24-127) ---
    def create(self, df, index_config) -> None:
        from hyperspace_tpu_torch.actions.create import CreateAction

        log_mgr, data_mgr = self._managers(index_config.index_name)
        CreateAction(self.session, df, index_config, log_mgr, data_mgr).run()

    # -- introspection ------------------------------------------------------
    def get_index_log_entry(self, index_name: str) -> Optional[IndexLogEntry]:
        log_mgr, _ = self._managers(index_name)
        return log_mgr.get_latest_stable_log()

    def get_indexes(self, states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        out = []
        for path in self.path_resolver.all_index_paths():
            entry = IndexLogManager(path).get_latest_stable_log()
            if entry is None:
                continue
            if states is None or entry.state in states:
                out.append(entry)
        return sorted(out, key=lambda e: e.name)


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
