"""Candidate index collection: which ACTIVE indexes could serve each Scan.

Reference: ``rules/CandidateIndexCollector.scala:28-60`` — per source leaf
relation apply ``ColumnSchemaFilter`` (index's referenced cols ⊆ relation
cols, rules/ColumnSchemaFilter.scala:28-44) then ``FileSignatureFilter``
(exact signature equality, or Hybrid Scan candidacy with appended/deleted
byte-ratio thresholds, rules/FileSignatureFilter.scala:33-192).
"""

from __future__ import annotations

import os
from typing import Dict, List

from hyperspace_tpu_torch.metadata.entry import FileInfo, IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.plananalysis import filter_reasons as FR
from hyperspace_tpu_torch.rules import tags
from hyperspace_tpu_torch.rules.base import CandidateMap, tag_filter_reason
from hyperspace_tpu_torch.utils import resolver


def _current_file_infos(session, scan: Scan) -> Dict[str, FileInfo]:
    """path -> FileInfo of the scan's snapshot, through the source
    provider SPI."""
    rel = session.source_manager.get_relation(scan.relation)
    return {
        path: FileInfo(os.path.basename(path), size, mtime, -1)
        for path, size, mtime in rel.all_file_infos()
    }


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
    """Exact-signature mode, or Hybrid Scan candidacy
    (FileSignatureFilter.scala:49-191). Time-travel sources first swap each
    entry for the historical index version closest to the queried source
    version (``closestIndex``, DeltaLakeRelation.scala:179-251)."""
    hybrid = session.conf.hybrid_scan_enabled
    provider_rel = session.source_manager.get_relation(scan.relation)
    entries = [provider_rel.closest_index(e) or e for e in entries]
    out = []
    for e in entries:
        if hybrid:
            ok = _hybrid_scan_candidate(session, scan, e)
        else:
            ok = _signature_valid(session, scan, e)
            if ok and e.has_source_update:
                # a quick-refreshed entry: its fingerprint matches the new
                # source but its data covers only the original snapshot;
                # accept it and compensate at rewrite time from the
                # recorded Update delta (the reference's exact-mode
                # quick-refresh path, CoveringIndexRuleUtils.scala:74-79,
                # 164-170)
                ok = _tag_update_compensation(scan, e)
            if not ok:
                tag_filter_reason(e, scan, FR.source_data_changed())
        if ok:
            out.append(e)
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


def _tag_update_compensation(scan: Scan, entry: IndexLogEntry) -> bool:
    """Set the Hybrid Scan compensation tags from a quick refresh's
    recorded Update delta (the delta is in the metadata: no file diff).
    False (reject) for recorded deletes on an index without lineage,
    which cannot exclude the dead rows."""
    upd = entry.relation.update
    appended = (
        [p for p, _ in upd.appended_files.file_infos] if upd.appended_files else []
    )
    deleted_ids = (
        [i.id for _, i in upd.deleted_files.file_infos if i.id != -1]
        if upd.deleted_files
        else []
    )
    has_deletes = upd.deleted_files is not None and bool(upd.deleted_files.files)
    if has_deletes and not entry.derived_dataset.can_handle_deleted_files:
        tag_filter_reason(entry, scan, FR.no_delete_support())
        return False
    entry.set_tag(
        scan, tags.COMMON_SOURCE_SIZE_IN_BYTES, entry.relation.content.size_in_bytes
    )
    entry.set_tag(scan, tags.HYBRIDSCAN_REQUIRED, True)
    entry.set_tag(scan, tags.HYBRIDSCAN_APPENDED, appended)
    entry.set_tag(scan, tags.HYBRIDSCAN_DELETED, deleted_ids)
    return True


def _hybrid_scan_candidate(session, scan: Scan, entry: IndexLogEntry) -> bool:
    """File-level diff against the indexed snapshot; tags the common bytes
    and the hybrid requirement that ranking and the rewrite read
    (FileSignatureFilter.getHybridScanCandidate:108-191)."""
    current = _current_file_infos(session, scan)
    # diff against what the index DATA covers (the build-time snapshot,
    # relation.content), not the update-adjusted metadata view: a quick
    # refresh moves the metadata forward while the data stays put, and
    # the compensation must cover exactly that gap
    indexed = dict(entry.relation.content.file_infos)

    common_paths = []
    appended = []
    for path, info in current.items():
        known = indexed.get(path)
        if known is not None and known.size == info.size and (
            known.modified_time == info.modified_time
        ):
            common_paths.append(path)
        else:
            appended.append((path, info))
    deleted = [
        (p, i)
        for p, i in indexed.items()
        if p not in current
        or current[p].size != i.size
        or current[p].modified_time != i.modified_time
    ]

    common_bytes = sum(indexed[p].size for p in common_paths)
    appended_bytes = sum(i.size for _, i in appended)
    deleted_bytes = sum(i.size for _, i in deleted)
    total_current = common_bytes + appended_bytes
    index_source_bytes = common_bytes + deleted_bytes

    if common_bytes == 0:
        tag_filter_reason(entry, scan, FR.source_data_changed())
        return False
    appended_ratio = appended_bytes / total_current if total_current else 0.0
    deleted_ratio = deleted_bytes / index_source_bytes if index_source_bytes else 0.0
    max_appended = session.conf.hybrid_scan_max_appended_ratio
    max_deleted = session.conf.hybrid_scan_max_deleted_ratio
    if appended_ratio > max_appended:
        tag_filter_reason(entry, scan, FR.too_much_appended(appended_ratio, max_appended))
        return False
    if deleted:
        if not entry.derived_dataset.can_handle_deleted_files:
            tag_filter_reason(entry, scan, FR.no_delete_support())
            return False
        if deleted_ratio > max_deleted:
            tag_filter_reason(entry, scan, FR.too_much_deleted(deleted_ratio, max_deleted))
            return False

    entry.set_tag(scan, tags.COMMON_SOURCE_SIZE_IN_BYTES, common_bytes)
    entry.set_tag(scan, tags.HYBRIDSCAN_REQUIRED, bool(appended or deleted))
    entry.set_tag(scan, tags.HYBRIDSCAN_APPENDED, [p for p, _ in appended])
    # the deleted files' ids come from the indexed snapshot's lineage ids
    entry.set_tag(scan, tags.HYBRIDSCAN_DELETED, [i.id for _, i in deleted if i.id != -1])
    return True


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
