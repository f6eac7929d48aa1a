"""Logical-plan signature providers — index validity fingerprints.

Reference: ``index/FileBasedSignatureProvider.scala:30-62`` (md5 over
per-relation file fingerprints), ``index/PlanSignatureProvider.scala``
(operator-kind walk), ``index/IndexSignatureProvider.scala:33-51``
(combines both), ``index/LogicalPlanSignatureProvider.scala`` (factory by
provider name). At query time the candidate filter recomputes the
signature of the query's source and compares it to the one stored in the
log entry (``rules/FileSignatureFilter.scala:70-88``).
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.metadata.entry import LogicalPlanFingerprint, Signature
from hyperspace_tpu_torch.plan.nodes import LogicalPlan
from hyperspace_tpu_torch.utils.hashing import md5_hex


class FileBasedSignatureProvider:
    """Fingerprint of the *data*: fold of every leaf relation's file
    snapshot signature (delegated to its source provider)."""

    name = "FileBasedSignatureProvider"

    def __init__(self, source_manager):
        self._sources = source_manager

    def sign(self, plan: LogicalPlan) -> Optional[str]:
        parts = []
        for leaf in plan.collect_leaves():
            rel = self._sources.get_relation(leaf.relation)
            parts.append(rel.signature())
        if not parts:
            return None
        return md5_hex("".join(parts))


class PlanSignatureProvider:
    """Fingerprint of the *plan shape*: fold over operator kinds
    (PlanSignatureProvider.scala)."""

    name = "PlanSignatureProvider"

    def sign(self, plan: LogicalPlan) -> str:
        kinds: List[str] = []

        def walk(p: LogicalPlan):
            kinds.append(type(p).__name__)
            for c in p.children:
                walk(c)

        walk(plan)
        return md5_hex("".join(kinds))


class IndexSignatureProvider:
    """File-based + plan signatures combined
    (IndexSignatureProvider.scala:33-51)."""

    name = "IndexSignatureProvider"

    def __init__(self, source_manager):
        self._file = FileBasedSignatureProvider(source_manager)
        self._plan = PlanSignatureProvider()

    def fingerprint(self, plan: LogicalPlan) -> LogicalPlanFingerprint:
        file_sig = self._file.sign(plan)
        if file_sig is None:
            raise HyperspaceException("Plan has no file-based relations to sign")
        return LogicalPlanFingerprint(
            [
                Signature(self._file.name, file_sig),
                Signature(self._plan.name, self._plan.sign(plan)),
            ]
        )
