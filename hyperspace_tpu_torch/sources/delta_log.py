"""Delta Lake transaction log reader (no Spark, no delta-rs).

Reads the ``_delta_log/`` protocol directly: numbered JSON commits with
``add``/``remove``/``metaData`` actions, plus parquet checkpoints (classic
single-part and multi-part) discovered by directory listing. Snapshot
reconstruction = latest readable checkpoint ≤ target version, then replay
JSON commits. v2 (uuid-named) checkpoints are detected and rejected with a
clear error when required. This replaces the reference's
dependency on the Delta Lake Spark library
(``sources/delta/DeltaLakeShims``); the log format itself is an open spec.
Counterpart of ``hyperspace_tpu/sources/delta_log.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import urllib.parse
from typing import Dict, List, Optional, Tuple

import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException

DELTA_LOG_DIR = "_delta_log"

_SPARK_TO_ARROW = {
    "string": pa.string(),
    "long": pa.int64(),
    "integer": pa.int32(),
    "short": pa.int16(),
    "byte": pa.int8(),
    "float": pa.float32(),
    "double": pa.float64(),
    "boolean": pa.bool_(),
    "binary": pa.binary(),
    "date": pa.date32(),
    "timestamp": pa.timestamp("us"),
}


def spark_type_to_arrow(t) -> pa.DataType:
    if isinstance(t, str):
        if t in _SPARK_TO_ARROW:
            return _SPARK_TO_ARROW[t]
        if t.startswith("decimal(") and t.endswith(")"):
            p, s = t[len("decimal(") : -1].split(",")
            return pa.decimal128(int(p), int(s))
    raise HyperspaceException(f"Unsupported Delta type: {t!r}")


def parse_schema_string(schema_string: str) -> List[Tuple[str, pa.DataType]]:
    """Spark StructType JSON -> [(name, arrow type)]."""
    doc = json.loads(schema_string)
    return [
        (f["name"], spark_type_to_arrow(f["type"])) for f in doc.get("fields", [])
    ]


@dataclasses.dataclass
class DeltaSnapshot:
    table_path: str
    version: int
    # path -> (size, modification_time_ms)
    files: Dict[str, Tuple[int, int]]
    schema_fields: List[Tuple[str, pa.DataType]]
    partition_columns: List[str]

    @property
    def file_paths(self) -> List[str]:
        return sorted(self.files)


def _log_dir(table_path: str) -> str:
    return os.path.join(table_path, DELTA_LOG_DIR)


def is_delta_table(path: str) -> bool:
    return os.path.isdir(_log_dir(path))


def _commit_versions(log_dir: str) -> List[int]:
    out = []
    for name in os.listdir(log_dir):
        stem, ext = os.path.splitext(name)
        if ext == ".json" and stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def _checkpoint_groups(log_dir: str) -> Tuple[Dict[int, List[str]], List[int]]:
    """Discover checkpoints: ``{version: [file names]}`` for readable ones
    (classic single-part ``NNN.checkpoint.parquet`` and complete multi-part
    ``NNN.checkpoint.MMM.PPP.parquet`` groups), plus versions that exist only
    as v2/uuid-named checkpoints we cannot read."""
    singles: Dict[int, List[str]] = {}
    multi: Dict[int, Dict[int, Dict[int, str]]] = {}
    v2_only: List[int] = []
    for name in os.listdir(log_dir):
        parts = name.split(".")
        if len(parts) < 3 or parts[1] != "checkpoint" or not parts[0].isdigit():
            continue
        version = int(parts[0])
        if len(parts) == 3 and parts[2] == "parquet":
            singles[version] = [name]
        elif (
            len(parts) == 5
            and parts[4] == "parquet"
            and parts[2].isdigit()
            and parts[3].isdigit()
        ):
            part, num_parts = int(parts[2]), int(parts[3])
            multi.setdefault(version, {}).setdefault(num_parts, {})[part] = name
        elif parts[-1] in ("parquet", "json"):
            # v2 checkpoint (uuid-named) — recognizable but unreadable here
            v2_only.append(version)
    groups = dict(singles)
    for version, by_n in multi.items():
        if version in groups:
            continue
        for num_parts, names in sorted(by_n.items()):
            if all(i in names for i in range(1, num_parts + 1)):
                groups[version] = [names[i] for i in range(1, num_parts + 1)]
                break
    v2_only = sorted(v for v in set(v2_only) if v not in groups)
    return groups, v2_only


def latest_version(table_path: str) -> int:
    log_dir = _log_dir(table_path)
    groups, v2_only = _checkpoint_groups(log_dir)
    # v2-only checkpoint versions count as existing state (read_snapshot will
    # then fail with the clear v2-unsupported error rather than "empty log").
    versions = _commit_versions(log_dir) + sorted(groups) + v2_only
    if not versions:
        raise HyperspaceException(f"Not a Delta table (empty log): {table_path}")
    return max(versions)


def _abs_data_path(table_path: str, rel: str) -> str:
    rel = urllib.parse.unquote(rel)
    if rel.startswith("file:"):
        # Hadoop renders local URIs as file:/x, file:///x, or file://host/x
        import re as _re

        return _re.sub(r"^file:/+", "/", rel)
    if rel.startswith("/") or "://" in rel:
        return rel
    return os.path.join(table_path, rel)


def _apply_action(state: dict, action: dict, table_path: str) -> None:
    if "add" in action and action["add"]:
        a = action["add"]
        p = _abs_data_path(table_path, a["path"])
        state["files"][p] = (
            int(a.get("size", 0)),
            int(a.get("modificationTime", 0)),
        )
    elif "remove" in action and action["remove"]:
        p = _abs_data_path(table_path, action["remove"]["path"])
        state["files"].pop(p, None)
    elif "metaData" in action and action["metaData"]:
        md = action["metaData"]
        if md.get("schemaString"):
            state["schema"] = parse_schema_string(md["schemaString"])
        state["partition_columns"] = list(md.get("partitionColumns", []))


def _read_checkpoint(
    state: dict, log_dir: str, names: List[str], table_path: str
):
    import pyarrow.parquet as pq

    for name in names:
        table = pq.read_table(os.path.join(log_dir, name))
        # The v2 checkpoint spec allows v2 content under classic naming:
        # data files then live in sidecar files which plain replay would
        # silently drop — detect and refuse rather than truncate the state.
        v2_cols = {"checkpointMetadata", "sidecar"} & set(table.column_names)
        for col in v2_cols:
            if table.column(col).null_count < table.num_rows:
                raise HyperspaceException(
                    f"Delta checkpoint {name} of {table_path} carries v2 "
                    f"checkpoint actions ({col}); v2 checkpoints are not "
                    "supported"
                )
        for row in table.to_pylist():
            _apply_action(
                state, {k: v for k, v in row.items() if v is not None}, table_path
            )


def read_snapshot(table_path: str, version: Optional[int] = None) -> DeltaSnapshot:
    log_dir = _log_dir(table_path)
    if not os.path.isdir(log_dir):
        raise HyperspaceException(f"Not a Delta table: {table_path}")
    target = latest_version(table_path) if version is None else int(version)
    commits = [v for v in _commit_versions(log_dir) if v <= target]
    groups, v2_only = _checkpoint_groups(log_dir)
    ckpts = [v for v in groups if v <= target]
    state = {"files": {}, "schema": None, "partition_columns": []}
    start = 0
    if ckpts:
        # Any complete checkpoint <= target is state-equivalent; the newest
        # one minimizes replay and tolerates stale `_last_checkpoint` hints.
        ckpt = max(ckpts)
        _read_checkpoint(state, log_dir, groups[ckpt], table_path)
        start = ckpt + 1
    replay = [v for v in commits if v >= start]
    expected = list(range(start, target + 1))
    if replay != expected and not (ckpts and max(ckpts) == target and not replay):
        missing = sorted(set(expected) - set(replay))
        if missing:
            newer_v2 = [v for v in v2_only if start <= v <= target]
            # only blame the v2 checkpoint when reading it would actually
            # cover the gap; otherwise the log is genuinely incomplete
            if newer_v2 and max(missing) <= max(newer_v2):
                raise HyperspaceException(
                    f"Delta log of {table_path} requires v2 (uuid-named) "
                    f"checkpoint at version {max(newer_v2)}, which is not "
                    "supported"
                )
            raise HyperspaceException(
                f"Delta log is missing commits {missing} for version {target} "
                f"of {table_path}"
            )
    for v in replay:
        with open(os.path.join(log_dir, f"{v:020d}.json")) as f:
            for line in f:
                line = line.strip()
                if line:
                    _apply_action(state, json.loads(line), table_path)
    if state["schema"] is None:
        raise HyperspaceException(
            f"Delta log has no metaData action up to version {target}"
        )
    return DeltaSnapshot(
        table_path=os.path.abspath(table_path),
        version=target,
        files=state["files"],
        schema_fields=state["schema"],
        partition_columns=state["partition_columns"],
    )
