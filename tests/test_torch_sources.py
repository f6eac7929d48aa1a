"""The port's lake sources against the JAX package: Delta Lake (the log
reader, checkpoints, time travel through ``closest_index``, the version
history and its reset by a vacuum) and Iceberg (manifest lists and inline
manifests in Avro, snapshot pinning), and the configured providers.

Each case of ``tests/test_sources.py`` has a counterpart here that builds
the same table (``tests/torch_lake.py``) and runs it through both
packages (``tests/torch_source_twin.py``): snapshots, relations and
signatures, log entries apart from ids and timestamps, bucket files byte
for byte, the explain text (and with it a time-travel query's
LogVersion), rows in order, and each refusal's exception and message.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os
import zlib

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_lake import (
    DELTA_SCHEMA,
    DeltaBuilder,
    IcebergBuilder,
    add_action,
    delta_metadata,
    drop_commits,
    write_commit,
    write_v2_checkpoint,
)
from torch_source_twin import Lake, served, snapshot_view

import hyperspace_tpu_torch as T
from hyperspace_tpu.exceptions import HyperspaceException as JHyperspaceException
from hyperspace_tpu.sources import delta_log as jdelta_log
from hyperspace_tpu.sources import iceberg_meta as jiceberg_meta
from hyperspace_tpu.utils import avro as javro
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.sources import delta_log as tdelta_log
from hyperspace_tpu_torch.sources import iceberg_meta as ticeberg_meta
from hyperspace_tpu_torch.utils import avro as tavro

HISTORY = TC.DELTA_VERSION_HISTORY_PROPERTY


def delta_snapshot(path, version=None) -> dict:
    """Both packages' Delta snapshot of ``path``, equal; the port's view."""
    got = [snapshot_view(m.read_snapshot(path, version)) for m in (tdelta_log, jdelta_log)]
    assert got[0] == got[1]
    return got[0]


def iceberg_snapshot(path, snapshot_id=None) -> dict:
    got = [snapshot_view(m.read_snapshot(path, snapshot_id))
           for m in (ticeberg_meta, jiceberg_meta)]
    assert got[0] == got[1]
    return got[0]


def both_raise(match: str, fn_port, fn_jax) -> str:
    """Each package raises its HyperspaceException with ``match`` in it,
    and the two messages are equal."""
    msgs = []
    for fn, exc in ((fn_port, HyperspaceException), (fn_jax, JHyperspaceException)):
        with pytest.raises(exc, match=match) as info:
            fn()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def k_v(d):
    return d.filter(d["k"] >= 100).select("k", "v")


# -- TestDeltaLog (tests/test_sources.py:115) ----------------------------------


def test_snapshot_versions(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    snap = delta_snapshot(b.path)
    assert snap["version"] == 1 and len(snap["files"]) == 2
    snap0 = delta_snapshot(b.path, 0)
    assert snap0["version"] == 0 and len(snap0["files"]) == 1
    b.remove("part-0.parquet")
    snap2 = delta_snapshot(b.path)
    assert len(snap2["files"]) == 1
    assert [n for n, _ in snap["schema_fields"]] == ["k", "v", "s"]
    # sizes and mtimes come from the log, not from the files
    for p, (size, mtime) in snap["files"].items():
        assert size == os.path.getsize(p)
        assert mtime == int(os.stat(p).st_mtime * 1000)


def test_checkpoint_replay(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    b.checkpoint(last_checkpoint=False)
    drop_commits(b.path, 1)  # the checkpoint alone holds versions 0-1
    b.append("part-2.parquet", 200)
    snap = delta_snapshot(b.path)
    assert snap["version"] == 2 and len(snap["files"]) == 3


def test_read_delta_dataframe(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    lake = Lake(tmp_path)
    for version, rows in ((None, 100), (0, 50)):
        kw = {} if version is None else {"version_as_of": version}
        rel = lake.relations("delta", b.path, **kw)
        want = [("deltaVersion", "1" if version is None else "0")]
        if version is not None:
            want.append(("versionAsOf", "0"))
        assert rel["options"] == tuple(want) and rel["fmt"] == "delta"
        got = [lake.read(pkg, "delta", b.path, **kw).collect() for pkg in ("port", "jax")]
        assert got[0].num_rows == rows and got[0].equals(got[1])
        assert lake.read("port", "delta", b.path, **kw).count() == rows


# -- TestDeltaIndexing (tests/test_sources.py:167) -----------------------------


def test_delta_create_and_serve(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    lake = Lake(tmp_path)
    lake.create("didx", "delta", b.path, ["k"], ["v"])
    lake.assert_index_equal("didx")
    _rows, text = lake.query("delta", b.path, k_v)
    assert "Hyperspace(Type: CI, Name: didx" in served(text)
    assert lake.properties("didx")[HISTORY] == "2:1"  # log version 2 at delta version 1


def test_delta_new_commit_invalidates_then_refresh(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init()
    lake = Lake(tmp_path)
    lake.create("didx", "delta", b.path, ["k"], ["v"])
    b.append("part-1.parquet", 100)
    _rows, text = lake.query("delta", b.path, lambda d: d.filter(d["k"] > 0).select("k", "v"))
    assert "Hyperspace" not in served(text)
    lake.run("refresh_index", "didx", "incremental")
    lake.clear()
    lake.assert_index_equal("didx")
    _rows, text = lake.query("delta", b.path, k_v)
    assert "Hyperspace(Type: CI, Name: didx" in served(text)
    assert lake.properties("didx")[HISTORY] == "2:0,4:1"


def test_delta_closest_index_time_travel(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init()
    lake = Lake(tmp_path)
    lake.create("didx", "delta", b.path, ["k"], ["v"])
    b.append("part-1.parquet", 100)
    lake.run("refresh_index", "didx", "full")
    lake.assert_index_equal("didx")
    # a query pinned at delta version 0 is served by the ORIGINAL index
    # version (log 2), not the refreshed one (log 4)
    rows, text = lake.query("delta", b.path, lambda d: d.filter(d["k"] >= 0).select("k", "v"),
                            version_as_of=0)
    assert "Name: didx, LogVersion: 2" in served(text), text
    assert rows.num_rows == 50
    rows, text = lake.query("delta", b.path, lambda d: d.filter(d["k"] >= 0).select("k", "v"))
    assert "Name: didx, LogVersion: 4" in served(text)
    assert rows.num_rows == 100


# -- TestAvro (tests/test_sources.py:311) --------------------------------------

AVRO_SCHEMA = {
    "type": "record",
    "name": "r",
    "fields": [
        {"name": "a", "type": "long"},
        {"name": "b", "type": ["null", "string"]},
        {"name": "c", "type": {"type": "array", "items": "int"}},
        {"name": "d", "type": {"type": "map", "values": "double"}},
        {"name": "e", "type": "boolean"},
    ],
}
AVRO_RECORDS = [
    {"a": -1, "b": "x", "c": [1, 2, 3], "d": {"p": 0.5}, "e": True},
    {"a": 2**40, "b": None, "c": [], "d": {}, "e": False},
]


def test_avro_roundtrip(tmp_path):
    p, q = str(tmp_path / "t.avro"), str(tmp_path / "j.avro")
    tavro.write_avro(p, AVRO_SCHEMA, AVRO_RECORDS)
    javro.write_avro(q, AVRO_SCHEMA, AVRO_RECORDS)
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()  # the two writers' bytes are identical
    for path in (p, q):
        assert tavro.read_avro(path) == AVRO_RECORDS == javro.read_avro(path)
        assert tavro.read_avro_with_schema(path) == javro.read_avro_with_schema(path)


@pytest.mark.parametrize("value", [0, -1, 1, 63, -64, 64, 2**31, -(2**63), 2**63 - 1])
def test_avro_zigzag_varints(value):
    import io

    out = [io.BytesIO(), io.BytesIO()]
    tavro._write_long(out[0], value)
    javro._write_long(out[1], value)
    assert out[0].getvalue() == out[1].getvalue()
    assert tavro._read_long(io.BytesIO(out[0].getvalue())) == value


def _deflated(path, codec: bytes):
    """Rewrite a null-codec container ``path`` with ``codec`` named in its
    header and its one block deflated (raw, as Avro's deflate codec)."""
    import io

    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    buf.read(4)
    meta = tavro._decode({"type": "map", "values": "bytes"}, buf)
    sync = buf.read(16)
    count, size = tavro._read_long(buf), tavro._read_long(buf)
    block = buf.read(size)
    meta["avro.codec"] = codec
    comp = zlib.compressobj(wbits=-15)
    packed = comp.compress(block) + comp.flush()
    out = io.BytesIO()
    out.write(tavro.MAGIC)
    tavro._encode({"type": "map", "values": "bytes"}, meta, out)
    out.write(sync)
    tavro._write_long(out, count)
    tavro._write_long(out, len(packed))
    out.write(packed)
    out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


def test_avro_deflate_codec_and_refusal(tmp_path):
    p = str(tmp_path / "d.avro")
    tavro.write_avro(p, AVRO_SCHEMA, AVRO_RECORDS)
    _deflated(p, b"deflate")
    assert tavro.read_avro(p) == javro.read_avro(p) == AVRO_RECORDS
    q = str(tmp_path / "s.avro")
    tavro.write_avro(q, AVRO_SCHEMA, AVRO_RECORDS)
    _deflated(q, b"snappy")
    both_raise("Unsupported Avro codec", lambda: tavro.read_avro(q),
               lambda: javro.read_avro(q))


# -- TestIceberg (tests/test_sources.py:336) -----------------------------------


@pytest.mark.parametrize("format_version", [2, 1])
def test_iceberg_read_and_snapshot_pinning(tmp_path, format_version):
    b = IcebergBuilder(tmp_path / "it", format_version=format_version)
    b.add_file("f0.parquet", 0).commit()
    b.add_file("f1.parquet", 100).commit()
    snap = iceberg_snapshot(b.path)
    assert snap["snapshot_id"] == 2 and len(snap["files"]) == 2
    assert all(mtime == 0 for _size, mtime in snap["files"].values())  # as the reference
    assert iceberg_snapshot(b.path, 1)["snapshot_id"] == 1
    lake = Lake(tmp_path)
    for sid, rows in ((None, 80), (1, 40)):
        kw = {} if sid is None else {"snapshot_id": sid}
        lake.relations("iceberg", b.path, **kw)
        got = [lake.read(pkg, "iceberg", b.path, **kw).collect() for pkg in ("port", "jax")]
        assert got[0].num_rows == rows and got[0].equals(got[1])


def test_iceberg_create_and_serve(tmp_path):
    b = IcebergBuilder(tmp_path / "it").add_file("f0.parquet", 0).commit()
    lake = Lake(tmp_path)
    lake.create("iidx", "iceberg", b.path, ["k"], ["v"])
    lake.assert_index_equal("iidx")
    _rows, text = lake.query("iceberg", b.path,
                             lambda d: d.filter(d["k"] >= 10).select("k", "v"))
    assert "Hyperspace(Type: CI, Name: iidx" in served(text)


def test_iceberg_new_snapshot_invalidates(tmp_path):
    b = IcebergBuilder(tmp_path / "it").add_file("f0.parquet", 0).commit()
    lake = Lake(tmp_path)
    lake.create("iidx", "iceberg", b.path, ["k"], ["v"])
    b.add_file("f1.parquet", 100).commit()
    q = lambda d: d.filter(d["k"] > 0).select("k", "v")  # noqa: E731
    _rows, text = lake.query("iceberg", b.path, q)
    assert "Hyperspace" not in served(text)
    # a read pinned to the indexed snapshot is still served
    _rows, text = lake.query("iceberg", b.path, q, snapshot_id=1)
    assert "Hyperspace(Type: CI, Name: iidx" in served(text)
    lake.run("refresh_index", "iidx", "incremental")
    lake.clear()
    lake.assert_index_equal("iidx")
    _rows, text = lake.query("iceberg", b.path, q)
    assert "Hyperspace(Type: CI, Name: iidx" in served(text)


# -- TestDeltaCheckpointFormats (tests/test_sources.py:385) --------------------


def test_multipart_checkpoint(tmp_path):
    b = (DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
         .append("part-2.parquet", 200))
    v = b.checkpoint(parts=2)
    drop_commits(b.path, v)
    b.append("part-3.parquet", 300)
    snap = delta_snapshot(b.path)
    assert snap["version"] == v + 1 and len(snap["files"]) == 4


def test_incomplete_multipart_checkpoint_ignored(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    b.checkpoint(parts=2, write_parts=[1], last_checkpoint=False)  # part 1 of 2 only
    assert len(delta_snapshot(b.path)["files"]) == 2  # replays the JSON instead
    os.remove(os.path.join(b.path, "_delta_log", f"{0:020d}.json"))
    both_raise("missing commits", lambda: tdelta_log.read_snapshot(b.path),
               lambda: jdelta_log.read_snapshot(b.path))


def test_v2_checkpoint_rejected_clearly(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    v = write_v2_checkpoint(b.path, DELTA_SCHEMA)
    drop_commits(b.path, v)
    both_raise("uuid-named", lambda: tdelta_log.read_snapshot(b.path),
               lambda: jdelta_log.read_snapshot(b.path))


def test_v2_actions_in_classic_checkpoint_rejected(tmp_path):
    """A classically named checkpoint carrying v2 ``sidecar`` actions."""
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    log_dir = os.path.join(b.path, "_delta_log")
    pq.write_table(pa.Table.from_pylist([
        {"metaData": {"schemaString": DELTA_SCHEMA, "partitionColumns": []}, "sidecar": None},
        {"metaData": None, "sidecar": {"path": "x.parquet", "sizeInBytes": 1}},
    ]), os.path.join(log_dir, f"{1:020d}.checkpoint.parquet"))
    drop_commits(b.path, 1)
    both_raise("v2 checkpoint actions", lambda: tdelta_log.read_snapshot(b.path),
               lambda: jdelta_log.read_snapshot(b.path))


def test_missing_commit_rejected(tmp_path):
    b = (DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
         .append("part-2.parquet", 200))
    os.remove(os.path.join(b.path, "_delta_log", f"{1:020d}.json"))
    both_raise(r"missing commits \[1\]", lambda: tdelta_log.read_snapshot(b.path),
               lambda: jdelta_log.read_snapshot(b.path))
    assert delta_snapshot(b.path, 0)["version"] == 0


# -- TestIcebergDeleteManifests (tests/test_sources.py:467) --------------------


def test_iceberg_delete_manifest_rejected(tmp_path):
    b = IcebergBuilder(tmp_path / "t").add_file("f0.parquet", 0).commit()
    b.write_delete_manifest_list()
    both_raise("live delete files", lambda: ticeberg_meta.read_snapshot(b.path),
               lambda: jiceberg_meta.read_snapshot(b.path))


def test_iceberg_delete_data_file_rejected(tmp_path):
    b = IcebergBuilder(tmp_path / "t").add_file("f0.parquet", 0).commit()
    b.write_delete_data_file()
    both_raise("row-level delete", lambda: ticeberg_meta.read_snapshot(b.path),
               lambda: jiceberg_meta.read_snapshot(b.path))


def test_iceberg_manifests_identical_from_both_writers(tmp_path):
    """The same table written once through each package's Avro writer: the
    metadata files are byte-identical and read back alike."""
    paths = {}
    for pkg, writer in (("port", tavro.write_avro), ("jax", javro.write_avro)):
        b = IcebergBuilder(tmp_path / pkg[0] / "t", writer=writer)  # paths of one length
        b.add_file("f0.parquet", 0).commit().add_file("f1.parquet", 100).commit()
        paths[pkg] = b.path
    for name in ("manifest-1.avro", "manifest-2.avro", "snap-2.avro"):
        blobs = []
        for pkg in ("port", "jax"):
            with open(os.path.join(paths[pkg], "metadata", name), "rb") as f:
                blobs.append(f.read().replace(paths[pkg].encode(), b"<table>"))
        assert blobs[0] == blobs[1], name


# -- the add paths' forms: URL-encoded and file: URIs (delta_log.py:140-149) ---


@pytest.mark.parametrize("style,subdir", [("encoded", "date=2024-01-01 x%y"),
                                          ("file_uri", "")])
def test_delta_add_path_forms(tmp_path, style, subdir):
    b = DeltaBuilder(tmp_path / "t", style=style, subdir=subdir)
    b.init().append("part-1.parquet", 100)
    snap = delta_snapshot(b.path)
    assert snap["file_paths"] == sorted(b.file_path(f"part-{i}.parquet") for i in (0, 1))
    lake = Lake(tmp_path)
    lake.create("didx", "delta", b.path, ["k"], ["v"])
    lake.assert_index_equal("didx")
    rows, text = lake.query("delta", b.path, k_v)
    assert "Hyperspace(Type: CI, Name: didx" in served(text) and rows.num_rows == 50


# -- the version history: vacuum's reset, the tie rule (delta_relation.py) -----


def test_delta_history_reset_by_vacuum(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init()
    lake = Lake(tmp_path)
    lake.create("didx", "delta", b.path, ["k"], ["v"])
    b.append("part-1.parquet", 100)
    lake.run("refresh_index", "didx", "incremental")
    b.remove("part-0.parquet")
    lake.run("refresh_index", "didx", "full")
    lake.clear()
    assert lake.properties("didx")[HISTORY] == "2:0,4:1,6:2"
    q = lambda d: d.filter(d["k"] >= 0).select("k", "v")  # noqa: E731
    # version 1 lies between: the entry recorded at delta 1 (log 4) serves
    _rows, text = lake.query("delta", b.path, q, version_as_of=1)
    assert "Name: didx, LogVersion: 4" in served(text)
    lake.run("vacuum_index", "didx")
    lake.clear()
    lake.assert_index_equal("didx")
    assert lake.properties("didx")[HISTORY] == "6:2"
    # the history names only the last version now: a query at version 0
    # picks log 6, whose signature (delta version 2) does not match
    rows, text = lake.query("delta", b.path, q, version_as_of=0)
    assert "Hyperspace" not in served(text) and rows.num_rows == 50


def test_delta_closest_index_ties_prefer_later_log(tmp_path):
    """Two index versions at equal distance from the queried version: the
    tie rule ``(|delta|, -log)`` picks the later log entry."""
    b = DeltaBuilder(tmp_path / "t").init()
    lake = Lake(tmp_path)
    lake.create("didx", "delta", b.path, ["k"], ["v"])  # log 2 at delta 0
    b.append("part-1.parquet", 100).append("part-2.parquet", 200)
    lake.run("refresh_index", "didx", "full")  # log 4 at delta 2
    lake.clear()
    assert lake.properties("didx")[HISTORY] == "2:0,4:2"
    q = lambda d: d.filter(d["k"] >= 0).select("k", "v")  # noqa: E731
    rows, text = lake.query("delta", b.path, q, version_as_of=1)
    # log 4 wins the tie; its signature is delta version 2's, so version 1
    # is read from the source
    assert "Hyperspace" not in served(text) and rows.num_rows == 100
    for pkg, s in lake.sides():
        rel = lake.read(pkg, "delta", b.path, version_as_of=1).logical_plan.collect_leaves()[0]
        entry = s.index_manager.get_index_log_entry("didx")
        assert s.source_manager.get_relation(rel.relation).closest_index(entry).id == 4


# -- Hybrid Scan, z-order and data skipping over a Delta table -----------------


def test_delta_hybrid_scan_appended_commit(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
    lake = Lake(tmp_path, lineage=True)
    lake.create("didx", "delta", b.path, ["k"], ["v"])
    b.append("part-2.parquet", 120)
    lake.set("hyperspace.index.hybridscan.enabled", True)
    lake.set("hyperspace.index.hybridscan.maxAppendedRatio", 0.9)
    rows, text = lake.query("delta", b.path, k_v)
    assert "Union" in served(text) and "Name: didx" in served(text)
    assert rows.num_rows == 100


def test_delta_zorder_and_dataskipping(tmp_path):
    from hyperspace_tpu.indexes import dataskipping as jds
    from hyperspace_tpu.indexes import sketches as jsk
    from hyperspace_tpu.indexes import zorder as jz
    from hyperspace_tpu_torch.indexes import dataskipping as tds
    from hyperspace_tpu_torch.indexes import sketches as tsk
    from hyperspace_tpu_torch.indexes import zorder as tz

    b = (DeltaBuilder(tmp_path / "t").init().append("part-1.parquet", 100)
         .append("part-2.parquet", 200))
    lake = Lake(tmp_path)
    for pkg, (z, ds, sk) in (("port", (tz, tds, tsk)), ("jax", (jz, jds, jsk))):
        df = lake.read(pkg, "delta", b.path)
        lake.hs[pkg].create_index(df, z.ZOrderCoveringIndexConfig("dz", ["k", "v"], ["s"]))
    lake.assert_index_equal("dz")
    rows, text = lake.query("delta", b.path,
                            lambda d: d.filter(d["v"] <= 0.2).select("k", "v", "s"))
    assert "Name: dz" in served(text) and rows.num_rows > 0
    lake.run("delete_index", "dz")
    for pkg, (z, ds, sk) in (("port", (tz, tds, tsk)), ("jax", (jz, jds, jsk))):
        df = lake.read(pkg, "delta", b.path)
        lake.hs[pkg].create_index(df, ds.DataSkippingIndexConfig(
            "dds", sk.MinMaxSketch("k"), sk.BloomFilterSketch("s", 0.01, 10)))
    lake.assert_index_equal("dds")
    rows, text = lake.query("delta", b.path, lambda d: d.filter(d["k"] >= 210).select("k"))
    assert "Type: DS" in served(text) and rows.num_rows == 40


# -- partitioned Delta tables (ROADMAP C.15) -----------------------------------


def test_partitioned_delta_table_as_the_reference(tmp_path):
    """The snapshot records ``partitionColumns``, but neither package
    injects the partition values (``Relation.file_partition_values`` stays
    empty): the data columns read, the partition column raises pyarrow's
    ArrowInvalid in both."""
    t = str(tmp_path / "pt")
    os.makedirs(os.path.join(t, "p=a"))
    f = os.path.join(t, "p=a", "f0.parquet")
    pq.write_table(pa.table({"k": pa.array([1, 2], pa.int64())}), f)
    schema = json.dumps({"type": "struct", "fields": [
        {"name": "k", "type": "long"}, {"name": "p", "type": "string"}]})
    add = add_action(t, f)
    add["partitionValues"] = {"p": "a"}
    write_commit(t, 0, delta_metadata(schema, ["p"]) + [{"add": add}])
    assert delta_snapshot(t)["partition_columns"] == ["p"]
    lake = Lake(tmp_path)
    lake.relations("delta", t)
    for pkg in ("port", "jax"):
        df = lake.read(pkg, "delta", t)
        assert df.logical_plan.collect_leaves()[0].relation.file_partition_values == ()
        assert df.select("k").collect().column("k").to_pylist() == [1, 2]
        with pytest.raises(pa.ArrowInvalid, match="No match for FieldRef.Name"):
            df.collect()


def test_read_relation_files_injects_partition_values(tmp_path):
    """``io/scan.read_relation_files`` as the reference has it: constants
    injected where the relation carries them (no reader fills the field)."""
    import dataclasses

    from hyperspace_tpu.io import scan as jscan
    from hyperspace_tpu.plan.nodes import Relation as JRelation
    from hyperspace_tpu_torch.io import scan as tscan
    from hyperspace_tpu_torch.plan.nodes import Relation as TRelation

    files = []
    for i, p in enumerate(("a", "b")):
        f = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"k": pa.array([i, i + 10], pa.int64())}), f)
        files.append(f)
    fields = (("k", pa.int64()), ("p", pa.string()))
    pv = tuple((f, (("p", p),)) for f, p in zip(files, ("a", "b")))
    got = []
    for rel_cls, scan in ((TRelation, tscan), (JRelation, jscan)):
        rel = rel_cls(root_paths=(str(tmp_path),), files=tuple(files), fmt="parquet",
                      schema_fields=fields, file_partition_values=pv)
        got.append([scan.read_relation_files(rel, files, cols)
                    for cols in (None, ["p"], ["k"])])
        plain = dataclasses.replace(rel, file_partition_values=())
        assert scan.read_relation_files(plain, files, ["k"]).equals(got[-1][2])
    for a, b in zip(*got):
        assert a.equals(b)
    assert got[0][0].column("p").to_pylist() == ["a", "a", "b", "b"]


# -- the configured providers (sources/manager.py) -----------------------------


def test_default_builders_name_only_the_port():
    names = TC.INDEX_SOURCES_PROVIDERS_DEFAULT.split(",")
    assert len(names) == 3 and all(n.startswith("hyperspace_tpu_torch.sources.") for n in names)
    s = T.HyperspaceSession(device="cpu")
    assert [p.name for p in s.source_manager.providers] == ["default", "delta", "iceberg"]
    assert all(type(p).__module__.startswith("hyperspace_tpu_torch.")
               for p in s.source_manager.providers)


def test_providers_reload_on_conf_change(tmp_path):
    b = DeltaBuilder(tmp_path / "t").init()
    lake = Lake(tmp_path)
    for pkg, s in lake.sides():
        rel = lake.read(pkg, "delta", b.path).logical_plan.collect_leaves()[0].relation
        assert s.source_manager.is_supported(rel)
        first = s.source_manager.providers
        assert s.source_manager.providers is first  # cached while the conf holds
        mod = "hyperspace_tpu_torch" if pkg == "port" else "hyperspace_tpu"
        s.conf.set(TC.INDEX_SOURCES_PROVIDERS,
                   f"{mod}.sources.default.DefaultFileBasedSourceBuilder")
        assert [p.name for p in s.source_manager.providers] == ["default"]
        assert not s.source_manager.is_supported(rel)
        s.conf.set(TC.INDEX_SOURCES_PROVIDERS,
                   f"{mod}.sources.default.DefaultFileBasedSourceBuilder,"
                   f"{mod}.sources.delta.DeltaLakeSourceBuilder,"
                   f"{mod}.sources.delta.DeltaLakeSourceBuilder")
        assert not s.source_manager.is_supported(rel)  # two providers answer
        s.conf.set(TC.INDEX_SOURCES_PROVIDERS, "")
        with pytest.raises((HyperspaceException, JHyperspaceException),
                           match="No source providers configured"):
            s.source_manager.providers


def test_default_supported_formats_conf(tmp_path):
    d = tmp_path / "csv"
    d.mkdir()
    (d / "a.csv").write_text("k,v\n1,2.5\n2,3.5\n")
    lake = Lake(tmp_path)
    for pkg, s in lake.sides():
        rel = lake.read(pkg, "csv", str(d)).logical_plan.collect_leaves()[0].relation
        assert s.source_manager.is_supported(rel)
        s.conf.set(TC.DEFAULT_SUPPORTED_FORMATS, "parquet, JSON")
        assert not s.source_manager.is_supported(rel)
        assert s.conf.default_supported_formats == {"parquet", "json"}


def test_closest_index_default_is_the_entry(tmp_path):
    from hyperspace_tpu_torch.sources.default import DefaultFileBasedRelation

    b = IcebergBuilder(tmp_path / "it").add_file("f0.parquet", 0).commit()
    lake = Lake(tmp_path)
    rel = lake.read("port", "iceberg", b.path).logical_plan.collect_leaves()[0].relation
    marker = object()
    assert lake.t.source_manager.get_relation(rel).closest_index(marker) is marker
    assert DefaultFileBasedRelation(lake.t, rel).closest_index(marker) is marker


def test_closest_index_entry_left_alone_by_recovery(tmp_path):
    """A refresh crashes after its begin entry (crash recovery on, a short
    lease): a query pinned to version 0 still reads log 2 through
    ``closest_index`` while the transient tip stands, ``hs.recover`` rolls
    the tip back without touching log 2, and the pinned query is served by
    it again, in both packages alike."""
    import time

    from hyperspace_tpu.testing import faults as jfaults
    from hyperspace_tpu_torch.testing import faults as tfaults

    b = DeltaBuilder(tmp_path / "t").init()
    lake = Lake(tmp_path)
    lake.set("hyperspace.recovery.leaseMs", 40)
    lake.create("didx", "delta", b.path, ["k"], ["v"])
    b.append("part-1.parquet", 100)
    lake.run("refresh_index", "didx", "full")
    b.append("part-2.parquet", 200)
    log2 = {}
    for pkg, faults in (("port", tfaults), ("jax", jfaults)):
        path = os.path.join(lake.sys[pkg], "didx", "_hyperspace_log", "2")
        with open(path, "rb") as f:
            log2[pkg] = (path, f.read())
        faults.set_crash("after_begin_log", "raise")
        try:
            with pytest.raises(faults.SimulatedCrash):
                lake.hs[pkg].refresh_index("didx", "full")
        finally:
            faults.reset()
    time.sleep(0.1)  # the lease expires
    q = lambda d: d.filter(d["k"] >= 0).select("k", "v")  # noqa: E731
    _rows, text = lake.query("delta", b.path, q, version_as_of=0)
    assert "Name: didx, LogVersion: 2" in served(text)
    reports = [lake.hs[pkg].recover("didx") for pkg in ("port", "jax")]
    assert reports[0]["rolled_back"] and reports[1]["rolled_back"]
    lake.clear()
    rows, text = lake.query("delta", b.path, q, version_as_of=0)
    assert "Name: didx, LogVersion: 2" in served(text) and rows.num_rows == 50
    for path, data in log2.values():
        with open(path, "rb") as f:
            assert f.read() == data
    lake.assert_index_equal("didx")
