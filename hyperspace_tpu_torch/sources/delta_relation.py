"""Delta Lake relation: snapshot-pinned scans, version signatures, index
version history + closest-index time travel.

Reference: ``sources/delta/DeltaLakeRelation.scala:34-252`` (signature =
table version + path `:40-44`; files from the Delta log `:49-56`;
``versionAsOf`` recorded in options `:96-99`; ``closestIndex`` picks the
index log version whose recorded Delta version is closest to the queried
one via the DELTA_VERSION_HISTORY property `:179-251`) and
``DeltaLakeRelationMetadata.scala:25-71`` (refresh drops versionAsOf;
enrichIndexProperties appends ``indexLogVersion:deltaVersion`` history).
Counterpart of ``hyperspace_tpu/sources/delta_relation.py``; sizes and
mtimes come from the log, never from ``os.stat``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.constants import DELTA_VERSION_HISTORY_PROPERTY
from hyperspace_tpu_torch.metadata.entry import FileIdTracker
from hyperspace_tpu_torch.metadata.entry import Relation as MetaRelation
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.sources import delta_log
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    content_from_file_infos,
)
from hyperspace_tpu_torch.utils.hashing import md5_hex


class DeltaLakeRelation(FileBasedRelation):
    def __init__(self, session, plan_relation: PlanRelation):
        super().__init__(session, plan_relation)
        self._snapshot: Optional[delta_log.DeltaSnapshot] = None

    # -- snapshot -----------------------------------------------------------
    @property
    def table_path(self) -> str:
        return self.plan_relation.root_paths[0]

    @property
    def version_as_of(self) -> Optional[int]:
        v = dict(self.plan_relation.options).get("versionAsOf")
        return int(v) if v is not None else None

    def snapshot(self) -> delta_log.DeltaSnapshot:
        if self._snapshot is None:
            self._snapshot = delta_log.read_snapshot(
                self.table_path, self.version_as_of
            )
        return self._snapshot

    # -- SPI ---------------------------------------------------------------
    def signature(self) -> str:
        """Table version + path (DeltaLakeRelation.scala:40-44)."""
        snap = self.snapshot()
        return md5_hex(f"{snap.version}{os.path.abspath(self.table_path)}")

    def all_file_infos(self) -> List[Tuple[str, int, int]]:
        snap = self.snapshot()
        return [
            (p, size, mtime) for p, (size, mtime) in sorted(snap.files.items())
        ]

    def create_metadata_relation(self, tracker: FileIdTracker) -> MetaRelation:
        snap = self.snapshot()
        content = content_from_file_infos(self.all_file_infos(), tracker)
        schema_json = json.dumps([[n, str(t)] for n, t in snap.schema_fields])
        options = {"deltaVersion": str(snap.version)}
        if self.version_as_of is not None:
            options["versionAsOf"] = str(self.version_as_of)
        return MetaRelation(
            root_paths=[os.path.abspath(self.table_path)],
            content=content,
            schema_json=schema_json,
            file_format="delta",
            options=options,
        )

    def refresh(self) -> "DeltaLakeRelation":
        """Latest snapshot, versionAsOf dropped
        (DeltaLakeRelationMetadata.refresh)."""
        snap = delta_log.read_snapshot(self.table_path, None)
        options = tuple(
            (k, v)
            for k, v in self.plan_relation.options
            if k not in ("versionAsOf", "deltaVersion")
        ) + (("deltaVersion", str(snap.version)),)
        rel = dataclasses.replace(
            self.plan_relation,
            files=tuple(snap.file_paths),
            options=options,
            schema_fields=tuple(snap.schema_fields),
        )
        return DeltaLakeRelation(self.session, rel)

    def enrich_index_properties(
        self, properties: Dict[str, str], log_version: Optional[int] = None
    ) -> Dict[str, str]:
        """Append ``indexLogVersion:deltaVersion`` to the history
        (DeltaLakeRelationMetadata.enrichIndexProperties:45-58)."""
        props = dict(properties)
        snap = self.snapshot()
        prev = props.get(DELTA_VERSION_HISTORY_PROPERTY, "")
        pair = f"{log_version if log_version is not None else ''}:{snap.version}"
        if prev.split(",")[-1] == pair:  # idempotent: entry built twice per action
            return props
        props[DELTA_VERSION_HISTORY_PROPERTY] = f"{prev},{pair}" if prev else pair
        return props

    def closest_index(self, entry):
        """For a versionAsOf query, the historical index log entry whose
        recorded Delta version is closest (DeltaLakeRelation.closestIndex
        :179-251); the current entry otherwise."""
        queried = self.version_as_of
        if queried is None:
            return entry
        history = entry.derived_dataset.properties.get(
            DELTA_VERSION_HISTORY_PROPERTY, ""
        )
        pairs: List[Tuple[int, int]] = []
        for piece in history.split(","):
            if ":" not in piece:
                continue
            log_v, delta_v = piece.split(":", 1)
            if log_v.strip().isdigit() and delta_v.strip().isdigit():
                pairs.append((int(log_v), int(delta_v)))
        if not pairs:
            return entry
        best_log, _best_delta = min(
            pairs, key=lambda lv_dv: (abs(lv_dv[1] - queried), -lv_dv[0])
        )
        if best_log == entry.id:
            return entry
        from hyperspace_tpu_torch import factories
        from hyperspace_tpu_torch.metadata.path_resolver import PathResolver

        path = PathResolver(self.session.conf).get_index_path(entry.name)
        hist = factories.create_log_manager(path).get_log(best_log)
        return hist if hist is not None else entry
