"""Candidate index collection: which ACTIVE indexes could serve each Scan.

Reference: ``rules/CandidateIndexCollector.scala:28-60`` — per source leaf
relation apply ``ColumnSchemaFilter`` (index's referenced cols ⊆ relation
cols, rules/ColumnSchemaFilter.scala:28-44) then ``FileSignatureFilter``
(exact signature equality, rules/FileSignatureFilter.scala:33-88).
"""

from __future__ import annotations

from typing import List

from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.plananalysis import filter_reasons as FR
from hyperspace_tpu_torch.rules.base import CandidateMap, tag_filter_reason
from hyperspace_tpu_torch.utils import resolver


def column_schema_filter(
    scan: Scan, entries: List[IndexLogEntry]
) -> List[IndexLogEntry]:
    """Index's referenced columns must all resolve against the relation
    (ColumnSchemaFilter.scala:28-44)."""
    out = []
    cols = scan.relation.column_names
    for e in entries:
        refs = e.derived_dataset.referenced_columns()
        if resolver.resolve(refs, cols) is not None:
            out.append(e)
        else:
            tag_filter_reason(
                e, scan, FR.col_schema_mismatch(",".join(refs), ",".join(cols))
            )
    return out


def file_signature_filter(
    session, scan: Scan, entries: List[IndexLogEntry]
) -> List[IndexLogEntry]:
    """Exact-signature mode (FileSignatureFilter.scala:49-88). Hybrid Scan
    candidacy, time travel and quick-refresh compensation are not ported
    yet (ROADMAP queue A items 5-6): an entry whose data does not cover
    the current source exactly is rejected, and the query reads the
    source."""
    out = []
    for e in entries:
        ok = _signature_valid(session, scan, e) and not e.has_source_update
        if ok:
            out.append(e)
        else:
            tag_filter_reason(e, scan, FR.source_data_changed())
    return out


def _signature_valid(session, scan: Scan, entry: IndexLogEntry) -> bool:
    """Stored file-based signature == recomputed one
    (FileSignatureFilter.signatureValid:70-88)."""
    from hyperspace_tpu_torch.signatures import FileBasedSignatureProvider

    provider = FileBasedSignatureProvider(session.source_manager)
    current = provider.sign(scan)
    for sig in entry.fingerprint.signatures:
        if sig.provider == FileBasedSignatureProvider.name:
            return sig.value == current
    return False


def collect_candidates(
    session, plan: LogicalPlan, entries: List[IndexLogEntry]
) -> CandidateMap:
    """CandidateIndexCollector.apply:49-59."""
    out: CandidateMap = {}
    for scan in plan.collect_leaves():
        step1 = column_schema_filter(scan, entries)
        step2 = file_signature_filter(session, scan, step1)
        if step2:
            out[scan] = step2
    return out
