"""Default file-based source provider: plain file-format directories.

Reference: ``sources/default/DefaultFileBasedSource.scala:37-124`` (formats
from conf, default avro,csv,json,orc,parquet,text — same set here),
``DefaultFileBasedRelation.scala:38-242`` (signature = md5 fold over
(len, mtime, path) of all files; globbed roots re-expanded on every
listing), ``DefaultFileBasedRelationMetadata.scala``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.metadata.entry import FileIdTracker
from hyperspace_tpu_torch.metadata.entry import Relation as MetaRelation
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
    content_from_file_infos,
)
from hyperspace_tpu_torch.utils.hashing import md5_hex


class DefaultFileBasedRelation(FileBasedRelation):
    def all_file_infos(self) -> List[Tuple[str, int, int]]:
        out = []
        for f in self.plan_relation.files:
            st = os.stat(f)
            out.append((f, st.st_size, int(st.st_mtime * 1000)))
        return out

    def signature(self) -> str:
        # md5 fold over (len, mtime, path) of all files, order-independent
        # sum like the reference's fold (DefaultFileBasedRelation.scala:45-53
        # concatenates per-file fingerprints; we sort for determinism).
        parts = [
            md5_hex(f"{size}{mtime}{path}")
            for path, size, mtime in sorted(self.all_file_infos())
        ]
        return md5_hex("".join(parts))

    def create_metadata_relation(self, tracker: FileIdTracker) -> MetaRelation:
        content = content_from_file_infos(self.all_file_infos(), tracker)
        schema_json = json.dumps(
            [[n, str(t)] for n, t in self.plan_relation.schema_fields]
        )
        return MetaRelation(
            root_paths=list(self.plan_relation.root_paths),
            content=content,
            schema_json=schema_json,
            file_format=self.plan_relation.fmt,
            options=dict(self.plan_relation.options),
        )

    def refresh(self) -> "DefaultFileBasedRelation":
        """The relation over the files its root paths hold now."""
        import dataclasses

        from hyperspace_tpu_torch.io.parquet import expand_path

        files: List[str] = []
        for p in self.plan_relation.root_paths:
            files.extend(expand_path(p, self.plan_relation.fmt))
        rel = dataclasses.replace(self.plan_relation, files=tuple(files))
        return DefaultFileBasedRelation(self.session, rel)


class DefaultFileBasedSource(FileBasedSourceProvider):
    name = "default"

    def is_supported(self, session, plan_relation: PlanRelation) -> Optional[bool]:
        if plan_relation.fmt in session.conf.default_supported_formats:
            return True
        return None

    def get_relation(self, session, plan_relation: PlanRelation) -> FileBasedRelation:
        return DefaultFileBasedRelation(session, plan_relation)


def DefaultFileBasedSourceBuilder():  # noqa: N802  (builder entry in conf list)
    return DefaultFileBasedSource()
