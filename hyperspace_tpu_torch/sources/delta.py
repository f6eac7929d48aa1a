"""Delta Lake source provider: answers for ``fmt == "delta"`` relations
(``session.read.delta``) and wraps them in ``DeltaLakeRelation``.
Counterpart of ``hyperspace_tpu/sources/delta.py``.

Reference: ``sources/delta/DeltaLakeFileBasedSource.scala``,
``DeltaLakeRelation.scala:34-252`` (signature = table version + path,
closest-index time travel), ``DeltaLakeRelationMetadata.scala:25-71``.
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.sources.interfaces import FileBasedSourceProvider


class DeltaLakeSource(FileBasedSourceProvider):
    name = "delta"

    def is_supported(self, session, plan_relation: PlanRelation) -> Optional[bool]:
        if plan_relation.fmt == "delta":
            return True
        return None

    def get_relation(self, session, plan_relation: PlanRelation):
        from hyperspace_tpu_torch.sources.delta_relation import DeltaLakeRelation

        return DeltaLakeRelation(session, plan_relation)


def DeltaLakeSourceBuilder():  # noqa: N802
    return DeltaLakeSource()
