"""Source provider manager.

Reference: ``index/sources/FileBasedSourceProviderManager.scala:38-174`` —
every dispatch requires **exactly one** provider to answer
(``runWithDefault:126-146``). This slice has the default Parquet provider
only; loading the provider list from ``hyperspace.index.sources.fileBasedBuilders``
comes with the Delta and Iceberg providers (ROADMAP queue A item 10).
"""

from __future__ import annotations

from typing import List

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
)


class SourceProviderManager:
    def __init__(self, session):
        from hyperspace_tpu_torch.sources.default import DefaultFileBasedSource

        self.session = session
        self.providers: List[FileBasedSourceProvider] = [DefaultFileBasedSource()]

    def is_supported(self, plan_relation: PlanRelation) -> bool:
        try:
            self._single(plan_relation)
            return True
        except HyperspaceException:
            return False

    def get_relation(self, plan_relation: PlanRelation) -> FileBasedRelation:
        return self._single(plan_relation).get_relation(self.session, plan_relation)

    def _single(self, plan_relation: PlanRelation) -> FileBasedSourceProvider:
        """Exactly one provider must answer True (manager `:126-146`)."""
        answered = [
            p
            for p in self.providers
            if p.is_supported(self.session, plan_relation) is True
        ]
        if len(answered) != 1:
            raise HyperspaceException(
                f"Expected exactly one source provider for relation "
                f"{plan_relation.root_paths} (format {plan_relation.fmt!r}); "
                f"got {[p.name for p in answered]}"
            )
        return answered[0]
