"""Source provider manager.

Reference: ``index/sources/FileBasedSourceProviderManager.scala:38-174`` —
builders are loaded from the config key
``hyperspace.index.sources.fileBasedBuilders`` (cached, invalidated when
the conf changes, via ``CacheWithTransform``), and every dispatch
requires **exactly one** provider to answer (``runWithDefault:126-146``).
The default list names the port's three providers: plain file formats,
Delta Lake and Iceberg.
"""

from __future__ import annotations

import importlib
from typing import List

from hyperspace_tpu_torch.config import CacheWithTransform
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
)


def _load_builders(conf) -> List[FileBasedSourceProvider]:
    providers = []
    for qualname in conf.source_provider_builders:
        qualname = qualname.strip()
        if not qualname:
            continue
        mod_name, _, attr = qualname.rpartition(".")
        builder = getattr(importlib.import_module(mod_name), attr)
        providers.append(builder())
    if not providers:
        raise HyperspaceException("No source providers configured")
    return providers


class SourceProviderManager:
    def __init__(self, session):
        self.session = session
        self._providers = CacheWithTransform(session.conf, _load_builders)

    @property
    def providers(self) -> List[FileBasedSourceProvider]:
        return self._providers.load()

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
