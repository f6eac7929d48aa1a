"""Iceberg table metadata reader (no Iceberg library).

Reads ``metadata/v*.metadata.json`` (+ ``version-hint.text``) for the
snapshot catalog and schema, then follows the manifest list → manifest
Avro files (``utils/avro.py``) to the data-file set of a snapshot. This
replaces the reference's dependency on the Iceberg Spark runtime
(``sources/iceberg/IcebergShims``); the table format is an open spec.
Counterpart of ``hyperspace_tpu/sources/iceberg_meta.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.utils.avro import read_avro

_ICEBERG_TO_ARROW = {
    "boolean": pa.bool_(),
    "int": pa.int32(),
    "long": pa.int64(),
    "float": pa.float32(),
    "double": pa.float64(),
    "date": pa.date32(),
    "time": pa.time64("us"),
    "timestamp": pa.timestamp("us"),
    "timestamptz": pa.timestamp("us", "UTC"),
    "string": pa.string(),
    "uuid": pa.binary(16),
    "binary": pa.binary(),
}


def iceberg_type_to_arrow(t) -> pa.DataType:
    if isinstance(t, str):
        if t in _ICEBERG_TO_ARROW:
            return _ICEBERG_TO_ARROW[t]
        m = re.match(r"decimal\((\d+),\s*(\d+)\)", t)
        if m:
            return pa.decimal128(int(m.group(1)), int(m.group(2)))
        m = re.match(r"fixed\[(\d+)\]", t)
        if m:
            return pa.binary(int(m.group(1)))
    raise HyperspaceException(f"Unsupported Iceberg type: {t!r}")


@dataclasses.dataclass
class IcebergSnapshot:
    table_path: str
    snapshot_id: int
    # path -> (size, mtime_ms); mtime is always 0 — Iceberg data files are
    # immutable by contract, so (path, size) identifies content and a
    # stable mtime keeps file-diffing (refresh/Hybrid Scan) correct across
    # snapshots
    files: Dict[str, Tuple[int, int]]
    schema_fields: List[Tuple[str, pa.DataType]]
    location: str

    @property
    def file_paths(self) -> List[str]:
        return sorted(self.files)


def is_iceberg_table(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "metadata"))


def _latest_metadata_file(table_path: str) -> str:
    meta_dir = os.path.join(table_path, "metadata")
    hint = os.path.join(meta_dir, "version-hint.text")
    if os.path.isfile(hint):
        with open(hint) as f:
            v = f.read().strip()
        cand = os.path.join(meta_dir, f"v{v}.metadata.json")
        if os.path.isfile(cand):
            return cand
    best, best_v = None, -1
    for name in os.listdir(meta_dir):
        m = re.match(r"v(\d+)\.metadata\.json$", name)
        if m and int(m.group(1)) > best_v:
            best, best_v = os.path.join(meta_dir, name), int(m.group(1))
    if best is None:
        raise HyperspaceException(f"Not an Iceberg table: {table_path}")
    return best


def _resolve_path(table_path: str, location: str, p: str) -> str:
    if p.startswith("file:"):
        # Hadoop renders local URIs as file:/x, file:///x, or file://host/x
        p = re.sub(r"^file:/+", "/", p)
    if location.startswith("file:"):
        location = re.sub(r"^file:/+", "/", location)
    if os.path.isabs(p) and os.path.exists(p):
        return p
    if location and p.startswith(location):
        rel = p[len(location) :].lstrip("/")
        return os.path.join(table_path, rel)
    return os.path.join(table_path, p.lstrip("/"))


def _schema_fields(doc: dict) -> List[Tuple[str, pa.DataType]]:
    schema = None
    if "schemas" in doc and doc.get("current-schema-id") is not None:
        for s in doc["schemas"]:
            if s.get("schema-id") == doc["current-schema-id"]:
                schema = s
                break
    if schema is None:
        schema = doc.get("schema")
    if schema is None:
        raise HyperspaceException("Iceberg metadata has no schema")
    return [
        (f["name"], iceberg_type_to_arrow(f["type"]))
        for f in schema.get("fields", [])
    ]


def read_snapshot(
    table_path: str, snapshot_id: Optional[int] = None
) -> IcebergSnapshot:
    meta_file = _latest_metadata_file(table_path)
    with open(meta_file) as f:
        doc = json.load(f)
    location = doc.get("location", "")
    snapshots = doc.get("snapshots", [])
    if not snapshots:
        raise HyperspaceException(f"Iceberg table has no snapshots: {table_path}")
    if snapshot_id is None:
        snapshot_id = doc.get("current-snapshot-id")
        if snapshot_id in (None, -1):
            snapshot_id = snapshots[-1]["snapshot-id"]
    snap = next(
        (s for s in snapshots if s["snapshot-id"] == snapshot_id), None
    )
    if snap is None:
        raise HyperspaceException(
            f"Snapshot {snapshot_id} not found in {table_path}"
        )
    files: Dict[str, Tuple[int, int]] = {}
    manifests: List[str] = []
    if "manifest-list" in snap:  # format v2 (and v1 with manifest lists)
        mlist_path = _resolve_path(table_path, location, snap["manifest-list"])
        for entry in read_avro(mlist_path):
            # v2 manifest-list entries carry `content`: 0 = data manifest,
            # 1 = delete manifest (position/equality deletes, merge-on-read).
            # Row-level delete application is not implemented, so a snapshot
            # with LIVE delete files cannot be scanned correctly — refuse it
            # rather than silently reading delete files as data parquet.
            # (A delete manifest whose entries are all status=2/removed —
            # e.g. after compaction applied the deletes — is harmless.)
            if int(entry.get("content") or 0) != 0:
                dpath = _resolve_path(table_path, location, entry["manifest_path"])
                live = [
                    d for d in read_avro(dpath) if d.get("status", 1) != 2
                ]
                if live:
                    raise HyperspaceException(
                        f"Iceberg snapshot {snapshot_id} of {table_path} "
                        "contains live delete files (merge-on-read); "
                        "row-level deletes are not supported"
                    )
                continue
            manifests.append(
                _resolve_path(table_path, location, entry["manifest_path"])
            )
    else:  # format v1 inline manifests
        manifests = [
            _resolve_path(table_path, location, p) for p in snap.get("manifests", [])
        ]
    for mpath in manifests:
        for entry in read_avro(mpath):
            status = entry.get("status", 1)
            if status == 2:  # DELETED
                continue
            df = entry.get("data_file") or {}
            # data_file.content (v2): 0 = data, 1/2 = position/equality deletes
            if int(df.get("content") or 0) != 0:
                raise HyperspaceException(
                    f"Iceberg snapshot {snapshot_id} of {table_path} contains "
                    "row-level delete files; merge-on-read is not supported"
                )
            p = _resolve_path(table_path, location, df["file_path"])
            files[p] = (int(df.get("file_size_in_bytes", 0)), 0)
    return IcebergSnapshot(
        table_path=os.path.abspath(table_path),
        snapshot_id=int(snapshot_id),
        files=files,
        schema_fields=_schema_fields(doc),
        location=location,
    )
