"""Plan-transformation helpers shared by the covering-index rules.

Reference: ``covering/CoveringIndexRuleUtils.scala:35-418`` — swap a source
relation for the index's data (index-only scan), or build the Hybrid Scan
compensation plan (appended files merged bucket-aligned, deleted rows
excluded via lineage NOT-IN).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.rules import tags


def parse_arrow_type(s: str) -> pa.DataType:
    """Inverse of ``str(pa.DataType)`` for the types we persist in
    schemaJson (covering_build.create_covering_index)."""
    try:
        return pa.type_for_alias(s)
    except ValueError:
        pass
    if s.startswith("timestamp["):
        inner = s[len("timestamp[") : -1]
        if "," in inner:
            unit, tz = inner.split(",", 1)
            tz = tz.split("=", 1)[1].strip() if "=" in tz else tz.strip()
            return pa.timestamp(unit.strip(), tz)
        return pa.timestamp(inner.strip())
    if s.startswith("time32["):
        return pa.time32(s[len("time32[") : -1])
    if s.startswith("time64["):
        return pa.time64(s[len("time64[") : -1])
    if s.startswith("dictionary"):
        return pa.string()
    raise HyperspaceException(f"Cannot parse arrow type {s!r}")


def index_schema_fields(entry: IndexLogEntry) -> Tuple[Tuple[str, pa.DataType], ...]:
    pairs = json.loads(entry.derived_dataset.schema_json)
    return tuple((name, parse_arrow_type(t)) for name, t in pairs)


def index_scan_relation(
    session,
    entry: IndexLogEntry,
    use_bucket_spec: bool = False,
    excluded_file_ids: Optional[Tuple[int, ...]] = None,
) -> PlanRelation:
    """The relation that reads the index data instead of the source
    (transformPlanToUseIndexOnlyScan:98-130; display string mirrors
    ``IndexHadoopFsRelation`` ``Hyperspace(Type: CI, Name: …, LogVersion: …)``)."""
    index = entry.derived_dataset
    bucket_spec = None
    if use_bucket_spec and hasattr(index, "num_buckets"):
        bucket_spec = (index.num_buckets, tuple(index.indexed_columns))
    return PlanRelation(
        root_paths=tuple(sorted({_version_root(f) for f in entry.content.files})),
        files=tuple(entry.content.files),
        fmt="parquet",
        schema_fields=index_schema_fields(entry),
        index_info=(entry.name, entry.id, index.kind_abbr),
        bucket_spec=bucket_spec,
        excluded_file_ids=excluded_file_ids,
    )


def _version_root(path: str) -> str:
    return path.rsplit("/", 1)[0]


def transform_plan_to_use_index(
    session, entry: IndexLogEntry, scan: Scan, use_bucket_spec: bool = False
):
    """Replace `scan` with the index scan; Hybrid Scan compensation when the
    candidate filter tagged appended/deleted files
    (transformPlanToUseIndex:55-83 → index-only :98-130 / hybrid :146-288)."""
    if not entry.get_tag(scan, tags.HYBRIDSCAN_REQUIRED):
        return Scan(index_scan_relation(session, entry, use_bucket_spec))
    from hyperspace_tpu_torch.rules.hybrid import transform_plan_to_use_hybrid_scan

    return transform_plan_to_use_hybrid_scan(session, entry, scan, use_bucket_spec)
