"""Iceberg source provider: answers for ``fmt == "iceberg"`` relations
(``session.read.iceberg``) and wraps them in ``IcebergRelation``.
Counterpart of ``hyperspace_tpu/sources/iceberg.py``.

Reference: ``sources/iceberg/IcebergFileBasedSource.scala``,
``IcebergRelation.scala`` (signature = snapshot id + location,
snapshot-pinned scans).
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.sources.interfaces import FileBasedSourceProvider


class IcebergSource(FileBasedSourceProvider):
    name = "iceberg"

    def is_supported(self, session, plan_relation: PlanRelation) -> Optional[bool]:
        if plan_relation.fmt == "iceberg":
            return True
        return None

    def get_relation(self, session, plan_relation: PlanRelation):
        from hyperspace_tpu_torch.sources.iceberg_relation import IcebergRelation

        return IcebergRelation(session, plan_relation)


def IcebergSourceBuilder():  # noqa: N802
    return IcebergSource()
