"""Iceberg relation: snapshot-id signatures, snapshot-pinned scans.

Reference: ``sources/iceberg/IcebergRelation.scala`` — signature = snapshot
id + location (`:65-66`), scans pinned to a snapshot (`:222-223`).
Counterpart of ``hyperspace_tpu/sources/iceberg_relation.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.metadata.entry import FileIdTracker
from hyperspace_tpu_torch.metadata.entry import Relation as MetaRelation
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.sources import iceberg_meta
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    content_from_file_infos,
)
from hyperspace_tpu_torch.utils.hashing import md5_hex


class IcebergRelation(FileBasedRelation):
    def __init__(self, session, plan_relation: PlanRelation):
        super().__init__(session, plan_relation)
        self._snapshot: Optional[iceberg_meta.IcebergSnapshot] = None

    @property
    def table_path(self) -> str:
        return self.plan_relation.root_paths[0]

    @property
    def snapshot_as_of(self) -> Optional[int]:
        v = dict(self.plan_relation.options).get("snapshotAsOf")
        return int(v) if v is not None else None

    def snapshot(self) -> iceberg_meta.IcebergSnapshot:
        if self._snapshot is None:
            self._snapshot = iceberg_meta.read_snapshot(
                self.table_path, self.snapshot_as_of
            )
        return self._snapshot

    def signature(self) -> str:
        """Snapshot id + location (IcebergRelation.scala:65-66)."""
        snap = self.snapshot()
        return md5_hex(f"{snap.snapshot_id}{os.path.abspath(self.table_path)}")

    def all_file_infos(self) -> List[Tuple[str, int, int]]:
        snap = self.snapshot()
        return [
            (p, size, mtime) for p, (size, mtime) in sorted(snap.files.items())
        ]

    def create_metadata_relation(self, tracker: FileIdTracker) -> MetaRelation:
        snap = self.snapshot()
        content = content_from_file_infos(self.all_file_infos(), tracker)
        schema_json = json.dumps([[n, str(t)] for n, t in snap.schema_fields])
        return MetaRelation(
            root_paths=[os.path.abspath(self.table_path)],
            content=content,
            schema_json=schema_json,
            file_format="iceberg",
            options={"snapshotId": str(snap.snapshot_id)},
        )

    def refresh(self) -> "IcebergRelation":
        snap = iceberg_meta.read_snapshot(self.table_path, None)
        options = tuple(
            (k, v)
            for k, v in self.plan_relation.options
            if k not in ("snapshotAsOf", "snapshotId")
        ) + (("snapshotId", str(snap.snapshot_id)),)
        rel = dataclasses.replace(
            self.plan_relation,
            files=tuple(snap.file_paths),
            options=options,
            schema_fields=tuple(snap.schema_fields),
        )
        return IcebergRelation(self.session, rel)
