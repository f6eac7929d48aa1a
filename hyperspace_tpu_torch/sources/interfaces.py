"""Source provider SPI.

Reference: ``index/sources/interfaces.scala:43-277`` (``SourceRelation`` /
``FileBasedRelation`` / ``FileBasedSourceProvider``). A provider
adapts one kind of lake layout to the operations the actions and rules
need: file snapshot, plan-fingerprint signature and metadata Relation
construction, refresh re-listing, and (for time-travel sources) picking
the closest index version.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.metadata.entry import Content, FileIdTracker
from hyperspace_tpu_torch.metadata.entry import Relation as MetaRelation
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation


class FileBasedRelation(abc.ABC):
    """Wraps one Scan relation for indexing/metadata purposes."""

    def __init__(self, session, plan_relation: PlanRelation):
        self.session = session
        self.plan_relation = plan_relation

    # -- identity / fingerprints -------------------------------------------
    @abc.abstractmethod
    def signature(self) -> str:
        """Deterministic fingerprint of the data snapshot this relation
        reads (DefaultFileBasedRelation.scala:45-53: md5 fold over
        (len, mtime, path); DeltaLakeRelation.scala:40-44: version+path)."""

    # -- file snapshot ------------------------------------------------------
    @abc.abstractmethod
    def all_file_infos(self) -> List[Tuple[str, int, int]]:
        """(path, size, mtime_ms) of every data file in the snapshot."""

    # -- metadata construction ---------------------------------------------
    @abc.abstractmethod
    def create_metadata_relation(self, tracker: FileIdTracker) -> MetaRelation:
        """Build the metadata Relation (source snapshot incl. tracked file
        ids) stored in the IndexLogEntry
        (DefaultFileBasedRelation.createRelationMetadata:129-191)."""

    # -- lifecycle hooks ----------------------------------------------------
    def refresh(self) -> "FileBasedRelation":
        """Re-list the current state of the source (used by the refresh
        actions; DeltaLakeRelationMetadata.refresh drops versionAsOf)."""
        return self

    def enrich_index_properties(
        self, properties: Dict[str, str], log_version: Optional[int] = None
    ) -> Dict[str, str]:
        """Provider-specific properties recorded on the index
        (DeltaLakeRelationMetadata.enrichIndexProperties:45-58).
        ``log_version`` is the log id the enclosing action will commit."""
        return dict(properties)

    def closest_index(self, entry):
        """For time-travel sources: the historical index log entry whose
        recorded source version is closest to this relation's queried
        version (DeltaLakeRelation.closestIndex:179-251). Default: the
        given (latest) entry."""
        return entry


class FileBasedSourceProvider(abc.ABC):
    """Answers whether it supports a given scan relation and builds the
    FileBasedRelation wrapper (FileBasedSourceProvider trait)."""

    name: str = "provider"

    @abc.abstractmethod
    def is_supported(self, session, plan_relation: PlanRelation) -> Optional[bool]:
        """True/False when this provider can decide; None to abstain."""

    @abc.abstractmethod
    def get_relation(self, session, plan_relation: PlanRelation) -> FileBasedRelation:
        ...


def content_from_file_infos(
    infos: List[Tuple[str, int, int]], tracker: Optional[FileIdTracker]
) -> Content:
    """Content tree from (path,size,mtime) triples, assigning tracked file
    ids (CreateActionBase.updateFileIdTracker:85-93)."""
    return Content.from_leaf_files(infos, tracker)
