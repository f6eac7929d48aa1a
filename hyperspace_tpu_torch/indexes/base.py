"""Index trait + config trait.

Reference: ``index/Index.scala:31-168`` (the contract every index kind
implements; Jackson-polymorphic on a ``type`` property) and
``index/IndexConfigTrait.scala:32-59`` (user config whose ``createIndex``
returns the index object plus its data).
"""

from __future__ import annotations

import abc
import enum
from typing import Dict, List

from hyperspace_tpu_torch.constants import LINEAGE_PROPERTY


class UpdateMode(enum.Enum):
    """How refreshed index data combines with the previous version
    (Index.scala:162-168)."""

    MERGE = "merge"  # new version dir adds to previous content
    OVERWRITE = "overwrite"  # new version dir replaces previous content


class Index(abc.ABC):
    """A derived dataset. Subclasses must set ``kind`` and register in
    :mod:`hyperspace_tpu_torch.indexes.registry`."""

    kind: str = "Index"
    # Reference kindAbbr shown in plan strings, e.g. "CI" / "ZOCI" / "DS".
    kind_abbr: str = "IX"

    # -- serialization (polymorphic via "type") -----------------------------
    @abc.abstractmethod
    def to_dict(self) -> dict:
        ...

    @classmethod
    @abc.abstractmethod
    def from_dict(cls, d: dict) -> "Index":
        ...

    # -- schema surface -----------------------------------------------------
    @property
    @abc.abstractmethod
    def indexed_columns(self) -> List[str]:
        ...

    @property
    def included_columns(self) -> List[str]:
        return []

    def referenced_columns(self) -> List[str]:
        return list(self.indexed_columns) + list(self.included_columns)

    # -- data-plane operations (Index.scala write/optimize/refresh*) --------
    @abc.abstractmethod
    def write(self, ctx, index_data) -> None:
        """Write ``index_data`` into ``ctx.index_data_path``."""

    @abc.abstractmethod
    def optimize(self, ctx, files_to_optimize: List[str]) -> None:
        """Rewrite ``files_to_optimize`` (index files of the previous
        version) compacted into ``ctx.index_data_path``."""

    @abc.abstractmethod
    def refresh_incremental(
        self, ctx, appended_df, deleted_source_file_ids, previous_content
    ):
        """Index the appended source files (``appended_df``, or None) and
        drop the rows of the deleted ones (lineage ids) into
        ``ctx.index_data_path``; returns ``(index, UpdateMode)``."""

    @abc.abstractmethod
    def refresh_full(self, ctx, df) -> "Index":
        """Rebuild from the current source; returns the rebuilt Index (its
        schema may differ if source types changed)."""

    @property
    def lineage_enabled(self) -> bool:
        """Whether the index data carries the lineage column (the
        ``lineage`` property recorded at create)."""
        props = getattr(self, "properties", {})
        return str(props.get(LINEAGE_PROPERTY, "false")).lower() == "true"

    @property
    def can_handle_deleted_files(self) -> bool:
        """Whether an incremental refresh can drop a deleted source file's
        rows (Index.canHandleDeletedFiles)."""
        return False

    @abc.abstractmethod
    def statistics(self, extended: bool = False) -> dict:
        """String-valued statistics of the index (Index.statistics),
        read by ``plananalysis/statistics.py``."""


class IndexConfigTrait(abc.ABC):
    """User-supplied index definition (IndexConfigTrait.scala:32-59)."""

    @property
    @abc.abstractmethod
    def index_name(self) -> str:
        ...

    @property
    @abc.abstractmethod
    def referenced_columns(self) -> List[str]:
        ...

    @abc.abstractmethod
    def create_index(self, ctx, source_data, properties: Dict[str, str]):
        """Return ``(Index, index_data)`` — the index object and the data to
        write (IndexConfigTrait.createIndex)."""

    def describe_index(self, ctx, source_data, properties: Dict[str, str]):
        """The Index object alone, WITHOUT building index data — used for
        the begin-phase (transient-state) log entry, which is written
        before any data exists."""
        raise NotImplementedError
