"""Minimal Apache Avro object-container codec (reader + writer).

Iceberg manifest lists and manifest files are Avro; the port depends on
no Avro library, so this implements the (small, stable) spec directly,
as ``hyperspace_tpu/utils/avro.py`` does (the writers' bytes are
identical): header magic ``Obj\\x01`` + metadata map (``avro.schema``
JSON, ``avro.codec``) + sync marker, then blocks of ``(count, size,
data)``.
Binary encoding: zigzag varints for int/long, little-endian IEEE for
float/double, length-prefixed bytes/string, index-prefixed unions,
block-encoded arrays/maps. Codecs: ``null`` and ``deflate``.

Reader is schema-driven and generic; the writer exists for synthesizing
test fixtures and writing manifests of our own (the reference leans on the
Iceberg library for this; ``sources/iceberg/``).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, Iterable, List, Tuple

from hyperspace_tpu_torch.exceptions import HyperspaceException

MAGIC = b"Obj\x01"
SYNC = b"\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x0a\x0b\x0c\x0d\x0e\x0f"


# ---------------------------------------------------------------------------
# primitive binary encoding
# ---------------------------------------------------------------------------


def _read_long(buf: io.BytesIO) -> int:
    shift, acc = 0, 0
    while True:
        b = buf.read(1)
        if not b:
            raise HyperspaceException("Truncated Avro varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag


def _write_long(out: io.BytesIO, value: int) -> None:
    u = (value << 1) ^ (value >> 63)  # zigzag (python ints are unbounded)
    u &= (1 << 70) - 1
    while True:
        if u < 0x80:
            out.write(bytes([u]))
            return
        out.write(bytes([(u & 0x7F) | 0x80]))
        u >>= 7


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise HyperspaceException("Truncated Avro bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# schema-driven value codec
# ---------------------------------------------------------------------------


def _decode(schema, buf: io.BytesIO):
    if isinstance(schema, str):
        t = schema
    elif isinstance(schema, list):  # union: index then value
        idx = _read_long(buf)
        return _decode(schema[idx], buf)
    else:
        t = schema["type"]
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) != b"\x00"
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return _read_bytes(buf)
    if t == "string":
        return _read_bytes(buf).decode("utf-8")
    if t == "fixed":
        return buf.read(schema["size"])
    if t == "enum":
        return schema["symbols"][_read_long(buf)]
    if t == "array":
        out = []
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:
                _read_long(buf)  # block byte size, unused
                count = -count
            for _ in range(count):
                out.append(_decode(schema["items"], buf))
        return out
    if t == "map":
        out = {}
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:
                _read_long(buf)
                count = -count
            for _ in range(count):
                k = _read_bytes(buf).decode("utf-8")
                out[k] = _decode(schema["values"], buf)
        return out
    if t == "record":
        return {
            f["name"]: _decode(f["type"], buf) for f in schema["fields"]
        }
    if isinstance(schema, dict) and t not in (
        "null", "boolean", "int", "long", "float", "double", "bytes",
        "string", "fixed", "enum", "array", "map", "record",
    ):
        # named-type reference or logical type wrapper
        return _decode(t, buf)
    raise HyperspaceException(f"Unsupported Avro type: {t!r}")


def _encode(schema, value, out: io.BytesIO) -> None:
    if isinstance(schema, str):
        t = schema
    elif isinstance(schema, list):  # union: pick the branch by value
        for i, branch in enumerate(schema):
            bt = branch if isinstance(branch, str) else branch.get("type")
            if value is None and bt == "null":
                _write_long(out, i)
                return
            if value is not None and bt != "null":
                _write_long(out, i)
                _encode(branch, value, out)
                return
        raise HyperspaceException(f"No union branch for {value!r} in {schema}")
    else:
        t = schema["type"]
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        _write_long(out, int(value))
    elif t == "float":
        out.write(struct.pack("<f", value))
    elif t == "double":
        out.write(struct.pack("<d", value))
    elif t == "bytes":
        _write_bytes(out, value)
    elif t == "string":
        _write_bytes(out, value.encode("utf-8"))
    elif t == "fixed":
        out.write(value)
    elif t == "enum":
        _write_long(out, schema["symbols"].index(value))
    elif t == "array":
        if value:
            _write_long(out, len(value))
            for v in value:
                _encode(schema["items"], v, out)
        _write_long(out, 0)
    elif t == "map":
        if value:
            _write_long(out, len(value))
            for k, v in value.items():
                _write_bytes(out, k.encode("utf-8"))
                _encode(schema["values"], v, out)
        _write_long(out, 0)
    elif t == "record":
        for f in schema["fields"]:
            _encode(f["type"], value.get(f["name"]), out)
    else:
        raise HyperspaceException(f"Unsupported Avro type: {t!r}")


# ---------------------------------------------------------------------------
# container files
# ---------------------------------------------------------------------------


def read_avro(path: str) -> List[Any]:
    """All records of an Avro object-container file."""
    return read_avro_with_schema(path)[1]


def read_avro_with_schema(path: str):
    """(avro_schema_dict, records) of an Avro object-container file —
    the embedded schema drives Arrow typing for empty/all-null files
    where value inference has nothing to go on."""
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise HyperspaceException(f"Not an Avro file: {path}")
    meta_schema = {"type": "map", "values": "bytes"}
    meta = _decode(meta_schema, buf)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = buf.read(16)
    records: List[Any] = []
    while buf.tell() < len(data):
        count = _read_long(buf)
        size = _read_long(buf)
        block = buf.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise HyperspaceException(f"Unsupported Avro codec: {codec!r}")
        bbuf = io.BytesIO(block)
        for _ in range(count):
            records.append(_decode(schema, bbuf))
        if buf.read(16) != sync:
            raise HyperspaceException(f"Avro sync marker mismatch in {path}")
    return schema, records


def write_avro(path: str, schema: dict, records: Iterable[Any]) -> None:
    records = list(records)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {
        "avro.schema": json.dumps(schema).encode("utf-8"),
        "avro.codec": b"null",
    }
    _encode({"type": "map", "values": "bytes"}, meta, out)
    out.write(SYNC)
    block = io.BytesIO()
    for r in records:
        _encode(schema, r, block)
    _write_long(out, len(records))
    _write_long(out, block.tell())
    out.write(block.getvalue())
    out.write(SYNC)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(out.getvalue())
