"""Lake tables built on disk for the source differentials
(``tests/test_torch_sources.py``, ``tests/test_torch_formats.py``) and for
``chip_smoke.py``'s phase 15: Delta Lake logs (JSON commits, classic
single- and multi-part parquet checkpoints, ``_last_checkpoint``), Iceberg
metadata (format v2 manifest lists and format v1 inline manifests, in
Avro), and the plain formats' files (csv, json lines, orc, avro, text).

Imports neither JAX nor the JAX package. Avro goes through the port's
``hyperspace_tpu_torch.utils.avro.write_avro`` unless another writer with
its signature is given.
"""

import json
import os
import urllib.parse

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

DELTA_LOG = "_delta_log"

#: the reference tests' Delta schema (``tests/test_sources.py``)
DELTA_SCHEMA = json.dumps(
    {
        "type": "struct",
        "fields": [
            {"name": "k", "type": "long", "nullable": True, "metadata": {}},
            {"name": "v", "type": "double", "nullable": True, "metadata": {}},
            {"name": "s", "type": "string", "nullable": True, "metadata": {}},
        ],
    }
)

#: Arrow type -> Spark type name, the inverse of the Delta reader's map
_ARROW_TO_SPARK = (
    (pa.string(), "string"),
    (pa.int64(), "long"),
    (pa.int32(), "integer"),
    (pa.int16(), "short"),
    (pa.int8(), "byte"),
    (pa.float32(), "float"),
    (pa.float64(), "double"),
    (pa.bool_(), "boolean"),
    (pa.binary(), "binary"),
    (pa.date32(), "date"),
)

#: Arrow type -> Iceberg type name
_ARROW_TO_ICEBERG = (
    (pa.bool_(), "boolean"),
    (pa.int32(), "int"),
    (pa.int64(), "long"),
    (pa.float32(), "float"),
    (pa.float64(), "double"),
    (pa.date32(), "date"),
    (pa.string(), "string"),
    (pa.binary(), "binary"),
)


def _type_name(table, t: pa.DataType) -> str:
    for arrow, name in table:
        if t.equals(arrow):
            return name
    if pa.types.is_timestamp(t):
        return "timestamp"
    if pa.types.is_decimal(t):
        return f"decimal({t.precision},{t.scale})"
    raise ValueError(f"no lake type for {t}")


def delta_schema_string(schema: pa.Schema) -> str:
    """The Spark StructType JSON of a Delta ``metaData.schemaString`` for
    ``schema``'s fields."""
    return json.dumps({"type": "struct", "fields": [
        {"name": f.name, "type": _type_name(_ARROW_TO_SPARK, f.type), "nullable": True,
         "metadata": {}} for f in schema]})


def iceberg_schema(schema: pa.Schema) -> dict:
    return {"type": "struct", "schema-id": 0, "fields": [
        {"id": i + 1, "name": f.name, "type": _type_name(_ARROW_TO_ICEBERG, f.type),
         "required": False} for i, f in enumerate(schema)]}


def avro_writer(writer=None):
    if writer is not None:
        return writer
    from hyperspace_tpu_torch.utils.avro import write_avro

    return write_avro


def link_or_copy(src: str, dst: str) -> str:
    """``dst`` as a hard link to ``src``, or a copy where a link fails."""
    import shutil

    os.makedirs(os.path.dirname(dst), exist_ok=True)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)
    return dst


# ---------------------------------------------------------------------------
# Delta Lake
# ---------------------------------------------------------------------------


def add_action(table_path: str, file_path: str, style: str = "relative") -> dict:
    """An ``add`` action for ``file_path`` with its real size and mtime.
    ``style``: ``relative`` (the path under the table), ``encoded`` (the
    relative path URL-encoded, as Delta writers encode special
    characters) or ``file_uri`` (a ``file:///`` URI of the absolute
    path)."""
    st = os.stat(file_path)
    rel = os.path.relpath(file_path, table_path)
    if style == "encoded":
        path = urllib.parse.quote(rel)
    elif style == "file_uri":
        path = "file://" + os.path.abspath(file_path)
    else:
        path = rel
    return {"path": path, "size": st.st_size, "modificationTime": int(st.st_mtime * 1000),
            "dataChange": True}


def remove_action(table_path: str, file_path: str) -> dict:
    return {"path": os.path.relpath(file_path, table_path), "dataChange": True}


def delta_metadata(schema_string: str, partition_columns=()) -> list:
    """Commit 0's protocol and metaData actions."""
    return [
        {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
        {"metaData": {"id": "test", "schemaString": schema_string,
                      "partitionColumns": list(partition_columns),
                      "format": {"provider": "parquet"}}},
    ]


def write_commit(table_path: str, version: int, actions) -> str:
    """``_delta_log/<version>.json``, one action a line."""
    log_dir = os.path.join(table_path, DELTA_LOG)
    os.makedirs(log_dir, exist_ok=True)
    p = os.path.join(log_dir, f"{version:020d}.json")
    with open(p, "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")
    return p


def checkpoint_rows(table_path: str, schema_string: str, version=None) -> tuple:
    """(rows, version) of a classic checkpoint of the table's snapshot at
    ``version`` (the latest when None): a metaData row, then an add row a
    file, as ``tests/test_sources.py`` writes them."""
    from hyperspace_tpu_torch.sources import delta_log

    snap = delta_log.read_snapshot(table_path, version)
    rows = [{"metaData": {"schemaString": schema_string, "partitionColumns": []},
             "add": None}]
    for p, (size, mtime) in snap.files.items():
        rows.append({"metaData": None, "add": {
            "path": os.path.relpath(p, table_path), "size": size,
            "modificationTime": mtime}})
    return rows, snap.version


def write_checkpoint(table_path: str, schema_string: str, version=None, parts: int = 1,
                     write_parts=None, last_checkpoint: bool = True) -> int:
    """A classic checkpoint at ``version``: one ``NNN.checkpoint.parquet``,
    or ``parts`` files ``NNN.checkpoint.MMM.PPP.parquet`` of which
    ``write_parts`` (all by default) are written, each part the rows'
    consecutive share and a lone part all of them; ``_last_checkpoint``
    too. Returns the version."""
    rows, v = checkpoint_rows(table_path, schema_string, version)
    log_dir = os.path.join(table_path, DELTA_LOG)
    if parts == 1:
        pq.write_table(pa.Table.from_pylist(rows),
                       os.path.join(log_dir, f"{v:020d}.checkpoint.parquet"))
    else:
        write_parts = list(range(1, parts + 1) if write_parts is None else write_parts)
        for part in write_parts:
            lo = (part - 1) * len(rows) // parts
            hi = part * len(rows) // parts
            chunk = rows[lo:hi] if len(write_parts) > 1 else rows
            pq.write_table(pa.Table.from_pylist(chunk), os.path.join(
                log_dir, f"{v:020d}.checkpoint.{part:010d}.{parts:010d}.parquet"))
    if last_checkpoint:
        with open(os.path.join(log_dir, "_last_checkpoint"), "w") as f:
            json.dump({"version": v, "size": len(rows), "parts": parts}, f)
    return v


def write_v2_checkpoint(table_path: str, schema_string: str, version=None) -> int:
    """A uuid-named (v2) checkpoint, which both packages refuse."""
    rows, v = checkpoint_rows(table_path, schema_string, version)
    pq.write_table(pa.Table.from_pylist(rows), os.path.join(
        table_path, DELTA_LOG,
        f"{v:020d}.checkpoint.80a083e8-7026-4e79-81be-64bd76c43a11.parquet"))
    return v


def drop_commits(table_path: str, upto: int) -> None:
    """Remove the JSON commits 0..``upto``."""
    for j in range(upto + 1):
        os.remove(os.path.join(table_path, DELTA_LOG, f"{j:020d}.json"))


class DeltaBuilder:
    """``tests/test_sources.py``'s Delta table: files of 50 rows (k, v, s)
    committed one by one; ``style`` is the ``add`` paths' form
    (:func:`add_action`)."""

    def __init__(self, path, style: str = "relative", subdir: str = ""):
        self.path = str(path)
        self.style, self.subdir = style, subdir
        self.version = -1
        os.makedirs(os.path.join(self.path, DELTA_LOG), exist_ok=True)

    def _commit(self, actions):
        self.version += 1
        write_commit(self.path, self.version, actions)

    def file_path(self, name: str) -> str:
        return os.path.join(self.path, self.subdir, name)

    def _write_file(self, name, k0):
        t = pa.table(
            {
                "k": pa.array(range(k0, k0 + 50), type=pa.int64()),
                "v": pa.array(np.linspace(0, 1, 50)),
                "s": [f"s{i%5}" for i in range(50)],
            }
        )
        fp = self.file_path(name)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        pq.write_table(t, fp)
        return add_action(self.path, fp, self.style)

    def init(self, name: str = "part-0.parquet"):
        self._commit(delta_metadata(DELTA_SCHEMA) + [{"add": self._write_file(name, 0)}])
        return self

    def append(self, name, k0):
        self._commit([{"add": self._write_file(name, k0)}])
        return self

    def remove(self, name):
        self._commit([{"remove": remove_action(self.path, self.file_path(name))}])
        return self

    def checkpoint(self, **kw) -> int:
        return write_checkpoint(self.path, DELTA_SCHEMA, **kw)


# ---------------------------------------------------------------------------
# Iceberg
# ---------------------------------------------------------------------------

MANIFEST_ENTRY_SCHEMA = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int"},
        {
            "name": "data_file",
            "type": {
                "type": "record",
                "name": "r2",
                "fields": [
                    {"name": "file_path", "type": "string"},
                    {"name": "file_size_in_bytes", "type": "long"},
                ],
            },
        },
    ],
}

MANIFEST_FILE_SCHEMA = {
    "type": "record",
    "name": "manifest_file",
    "fields": [{"name": "manifest_path", "type": "string"}],
}

#: a manifest list entry with its ``content`` (0 data, 1 deletes)
MANIFEST_FILE_CONTENT_SCHEMA = {
    "type": "record",
    "name": "manifest_file",
    "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "content", "type": "int"},
    ],
}

#: a manifest entry whose data file carries its ``content`` (v2)
MANIFEST_ENTRY_CONTENT_SCHEMA = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int"},
        {
            "name": "data_file",
            "type": {
                "type": "record",
                "name": "r2",
                "fields": [
                    {"name": "content", "type": "int"},
                    {"name": "file_path", "type": "string"},
                    {"name": "file_size_in_bytes", "type": "long"},
                ],
            },
        },
    ],
}

#: ``tests/test_sources.py``'s Iceberg schema (k long, v double)
ICEBERG_SCHEMA = iceberg_schema(pa.schema([("k", pa.int64()), ("v", pa.float64())]))


class IcebergBuilder:
    """``tests/test_sources.py``'s Iceberg table: metadata JSON, a
    manifest and (format 2) a manifest list a snapshot, each snapshot
    listing every file added so far. ``format_version`` 1 writes the
    manifests inline in the snapshot instead of a manifest list.
    ``writer`` is the Avro writer (the port's by default)."""

    def __init__(self, path, writer=None, format_version: int = 2, schema=None):
        self.path = str(path)
        self.write_avro = avro_writer(writer)
        self.format_version = format_version
        self.schema = ICEBERG_SCHEMA if schema is None else schema
        self.snapshots = []
        self.files = []
        os.makedirs(os.path.join(self.path, "metadata"), exist_ok=True)
        os.makedirs(os.path.join(self.path, "data"), exist_ok=True)

    def add_file(self, name, k0):
        t = pa.table(
            {
                "k": pa.array(range(k0, k0 + 40), type=pa.int64()),
                "v": pa.array(np.linspace(0, 1, 40)),
            }
        )
        fp = os.path.join(self.path, "data", name)
        pq.write_table(t, fp)
        return self.add_existing(fp)

    def add_existing(self, fp: str):
        """Record a data file already under the table."""
        self.files.append((fp, os.stat(fp).st_size))
        return self

    def commit(self):
        sid = len(self.snapshots) + 1
        manifest = os.path.join(self.path, "metadata", f"manifest-{sid}.avro")
        self.write_avro(
            manifest,
            MANIFEST_ENTRY_SCHEMA,
            [
                {
                    "status": 1,
                    "data_file": {"file_path": p, "file_size_in_bytes": size},
                }
                for p, size in self.files
            ],
        )
        snap = {"snapshot-id": sid, "timestamp-ms": 1700000000000 + sid}
        if self.format_version >= 2:
            mlist = os.path.join(self.path, "metadata", f"snap-{sid}.avro")
            self.write_avro(mlist, MANIFEST_FILE_SCHEMA, [{"manifest_path": manifest}])
            snap["manifest-list"] = mlist
        else:
            snap["manifests"] = [manifest]
        self.snapshots.append(snap)
        doc = {
            "format-version": self.format_version,
            "location": self.path,
            "current-snapshot-id": sid,
            "snapshots": self.snapshots,
            "schema": self.schema,
        }
        mf = os.path.join(self.path, "metadata", f"v{sid}.metadata.json")
        with open(mf, "w") as f:
            json.dump(doc, f)
        with open(
            os.path.join(self.path, "metadata", "version-hint.text"), "w"
        ) as f:
            f.write(str(sid))
        return self

    @property
    def snapshot_id(self) -> int:
        return len(self.snapshots)

    def write_delete_manifest_list(self):
        """The current snapshot's manifest list rewritten to hold a data
        manifest and a delete manifest (``content`` 1)."""
        sid = self.snapshot_id
        mlist = os.path.join(self.path, "metadata", f"snap-{sid}.avro")
        manifest = os.path.join(self.path, "metadata", f"manifest-{sid}.avro")
        self.write_avro(mlist, MANIFEST_FILE_CONTENT_SCHEMA, [
            {"manifest_path": manifest, "content": 0},
            {"manifest_path": manifest, "content": 1},
        ])

    def write_delete_data_file(self):
        """The current snapshot's manifest rewritten to list its first file
        as an equality-delete file (``data_file.content`` 2)."""
        sid = self.snapshot_id
        manifest = os.path.join(self.path, "metadata", f"manifest-{sid}.avro")
        self.write_avro(manifest, MANIFEST_ENTRY_CONTENT_SCHEMA, [{
            "status": 1,
            "data_file": {"content": 2, "file_path": self.files[0][0],
                          "file_size_in_bytes": self.files[0][1]},
        }])


# ---------------------------------------------------------------------------
# Plain formats
# ---------------------------------------------------------------------------


def write_csv(table: pa.Table, path: str) -> str:
    import pyarrow.csv as pacsv

    pacsv.write_csv(table, path)
    return path


def write_json_lines(table: pa.Table, path: str) -> str:
    """One JSON object a line; dates and timestamps as ISO strings."""
    cols = {n: table.column(n).to_pylist() for n in table.column_names}
    with open(path, "w") as f:
        for i in range(table.num_rows):
            f.write(json.dumps({n: _json_value(cols[n][i]) for n in cols}) + "\n")
    return path


def _json_value(v):
    if hasattr(v, "isoformat"):
        return v.isoformat()
    return v


def write_orc(table: pa.Table, path: str) -> str:
    from pyarrow import orc as paorc

    paorc.write_table(table, path)
    return path


_AVRO_TYPES = ((pa.int64(), "long"), (pa.int32(), "int"), (pa.float64(), "double"),
               (pa.float32(), "float"), (pa.string(), "string"), (pa.bool_(), "boolean"))


def avro_schema_of(table: pa.Table, name: str = "row") -> dict:
    """An Avro record schema for ``table``'s primitive columns; dates and
    timestamps become strings (:func:`write_avro_table`)."""
    fields = []
    for f in table.schema:
        t = next((n for a, n in _AVRO_TYPES if f.type.equals(a)), None)
        if t is None and (pa.types.is_date(f.type) or pa.types.is_timestamp(f.type)):
            t = "string"
        if t is None:
            raise ValueError(f"no Avro type for {f.type}")
        fields.append({"name": f.name, "type": t})
    return {"type": "record", "name": name, "fields": fields}


def write_avro_table(table: pa.Table, path: str, writer=None) -> str:
    """``table`` as one Avro container file (the null codec), dates and
    timestamps as ISO strings."""
    schema = avro_schema_of(table)
    cols = {n: table.column(n).to_pylist() for n in table.column_names}
    records = [{n: _json_value(cols[n][i]) for n in cols} for i in range(table.num_rows)]
    avro_writer(writer)(path, schema, records)
    return path


def write_text_lines(lines, path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(line + "\n")
    return path
