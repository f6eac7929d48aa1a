"""Hybrid Scan: serve from a slightly stale index plus compensation.

Counterpart of ``hyperspace_tpu/rules/hybrid.py`` (reference:
``covering/CoveringIndexRuleUtils.scala:146-288``):

* appended source files are scanned raw and unioned with the index scan
  (the reference's ``BucketUnion`` merge, `:256-287`); on a bucketed
  layout the executor hashes the appended rows into the index's buckets
  with kernel B1 (``execution/executor.py``);
* rows of deleted source files are excluded through the lineage column,
  ``Filter(Not(In(_data_file_id, deletedIds)))`` (`:244-253`), pushed into
  the scan as ``Relation.excluded_file_ids``.

The appended relation carries ``("hybridDelta", "1")`` in its options so
tooling and tests can tell the delta scan apart.
"""

from __future__ import annotations

import dataclasses
from typing import List

from hyperspace_tpu_torch.constants import DATA_FILE_NAME_ID
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Project, Scan, Union
from hyperspace_tpu_torch.rules import tags
from hyperspace_tpu_torch.rules.rule_utils import index_scan_relation


def transform_plan_to_use_hybrid_scan(
    session, entry: IndexLogEntry, scan: Scan, use_bucket_spec: bool = False
):
    appended: List[str] = entry.get_tag(scan, tags.HYBRIDSCAN_APPENDED) or []
    deleted_ids: List[int] = entry.get_tag(scan, tags.HYBRIDSCAN_DELETED) or []
    index_rel = index_scan_relation(
        session,
        entry,
        # the layout survives the union: appended rows are bucketed at
        # execution time (the executor's Union branches)
        use_bucket_spec=use_bucket_spec,
        excluded_file_ids=tuple(deleted_ids) if deleted_ids else None,
    )
    index_scan = Scan(index_rel)
    data_cols = [n for n, _ in index_rel.schema_fields if n != DATA_FILE_NAME_ID]
    if not appended:
        return Project(data_cols, index_scan)
    appended_rel = dataclasses.replace(
        scan.relation,
        files=tuple(appended),
        index_info=None,
        options=scan.relation.options + (("hybridDelta", "1"),),
    )
    return Union(
        Project(data_cols, index_scan),
        Project(data_cols, Scan(appended_rel)),
    )
