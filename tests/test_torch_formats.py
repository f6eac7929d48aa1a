"""The port's default-source formats (avro, csv, json, orc, parquet, text)
and glob roots against the JAX package.

Each case of ``tests/test_formats.py`` has a counterpart here that writes
the same files once and reads them through both packages
(``tests/torch_source_twin.py``): the reader's relation (files, inferred
schema) and the provider's signature, log entries and index files, the
explain text and the rows in order. Added: a covering index served over
csv and json lines (types inferred by pyarrow's readers in both), over
avro written by the port's writer, and over each format the same rows as
the parquet copy of the data.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_lake import write_avro_table, write_csv, write_json_lines, write_orc
from torch_source_twin import Lake, served, sorted_table

from hyperspace_tpu.utils import avro as javro
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.io import parquet as tpio
from hyperspace_tpu_torch.utils import avro as tavro


def kv_table(rng, n: int) -> pa.Table:
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n), type=pa.int64()),
        "v": pa.array(rng.normal(size=n)),
    })


# -- TestOrc (tests/test_formats.py:24) ----------------------------------------


def test_orc_read_index_serve(tmp_path):
    rng = np.random.default_rng(3)
    d = tmp_path / "orcsrc"
    d.mkdir()
    for i in range(2):
        write_orc(kv_table(rng, 300), str(d / f"f{i}.orc"))
    lake = Lake(tmp_path)
    lake.relations("orc", str(d))
    assert lake.read("port", "orc", str(d)).count() == 600
    lake.create("oidx", "orc", str(d), ["k"], ["v"])
    lake.assert_index_equal("oidx")
    _rows, text = lake.query("orc", str(d), lambda dd: dd.filter(dd["k"] == 7).select("k", "v"))
    assert "Hyperspace(Type: CI, Name: oidx" in served(text)


# -- TestText (tests/test_formats.py:55) ---------------------------------------


def test_text_read_filter(tmp_path):
    d = tmp_path / "txt"
    d.mkdir()
    (d / "a.txt").write_text("alpha\nbeta\ngamma\n")
    (d / "b.txt").write_text("delta\nbeta\n")
    lake = Lake(tmp_path)
    lake.relations("text", str(d))
    got = []
    for pkg in ("port", "jax"):
        df = lake.read(pkg, "text", str(d))
        assert df.columns == ["value"] and df.count() == 5
        got.append(df.filter(df["value"] == "beta").collect())
    assert got[0].num_rows == 2 and got[0].equals(got[1])


# -- TestAvro (tests/test_formats.py:68) ---------------------------------------

ROW_SCHEMA = {
    "type": "record",
    "name": "row",
    "fields": [
        {"name": "k", "type": "long"},
        {"name": "s", "type": "string"},
    ],
}


def test_avro_read_filter(tmp_path):
    d = tmp_path / "av"
    d.mkdir()
    tavro.write_avro(str(d / "a.avro"), ROW_SCHEMA,
                     [{"k": i, "s": f"v{i % 3}"} for i in range(30)])
    lake = Lake(tmp_path)
    lake.relations("avro", str(d))
    got = []
    for pkg in ("port", "jax"):
        df = lake.read(pkg, "avro", str(d))
        assert df.count() == 30
        got.append(df.filter(df["s"] == "v1").collect())
    assert got[0].num_rows == 10 and got[0].equals(got[1])


def test_empty_avro_file_concats(tmp_path):
    """An empty container file has no values to infer types from; the
    embedded schema drives the Arrow types in both packages."""
    d = tmp_path / "av2"
    d.mkdir()
    schema = {
        "type": "record",
        "name": "row",
        "fields": [
            {"name": "k", "type": "long"},
            {"name": "s", "type": ["null", "string"]},
        ],
    }
    javro.write_avro(str(d / "a.avro"), schema, [{"k": 1, "s": "x"}])
    tavro.write_avro(str(d / "b.avro"), schema, [])
    javro.write_avro(str(d / "c.avro"), schema, [{"k": 2, "s": None}])
    lake = Lake(tmp_path)
    lake.relations("avro", str(d))
    got = [lake.read(pkg, "avro", str(d)).collect() for pkg in ("port", "jax")]
    assert got[0].num_rows == 2 and got[0].equals(got[1])
    assert str(got[0].schema.field("k").type) == "int64"


def test_avro_exotic_schema_inferred_from_values(tmp_path):
    """A field beyond the primitive/union-with-null set: both packages fall
    back to value inference."""
    d = tmp_path / "av3"
    d.mkdir()
    schema = {"type": "record", "name": "row", "fields": [
        {"name": "k", "type": "long"},
        {"name": "a", "type": {"type": "array", "items": "int"}},
    ]}
    tavro.write_avro(str(d / "a.avro"), schema, [{"k": i, "a": [i, i + 1]} for i in range(5)])
    assert tpio._avro_to_arrow_schema(schema) is None
    lake = Lake(tmp_path)
    got = [lake.read(pkg, "avro", str(d)).collect() for pkg in ("port", "jax")]
    assert got[0].equals(got[1]) and got[0].num_rows == 5


# -- TestGlobRoots (tests/test_formats.py:124) ---------------------------------


def test_glob_read_and_refresh(tmp_path):
    d = tmp_path / "g"
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        pq.write_table(kv_table(rng, 100), d / f"part-{i}.parquet")
    # decoy NOT matching the pattern
    pq.write_table(pa.table({"k": pa.array([999] * 5, pa.int64()), "v": pa.array([0.0] * 5)}),
                   d / "other.parquet")
    pattern = str(d / "part-*.parquet")
    lake = Lake(tmp_path)
    lake.set(TC.INDEX_LINEAGE_ENABLED, True)
    lake.relations("parquet", pattern)
    assert lake.read("port", "parquet", pattern).count() == 200  # decoy excluded
    lake.create("gidx", "parquet", pattern, ["k"], ["v"])
    for _pkg, s in lake.sides():
        assert s.index_manager.get_index_log_entry("gidx").relation.root_paths == [pattern]
    # append a file MATCHING the pattern; refresh must pick it up
    pq.write_table(pa.table({"k": pa.array([5] * 7, pa.int64()), "v": pa.array([1.0] * 7)}),
                   d / "part-9.parquet")
    lake.run("refresh_index", "gidx", TC.REFRESH_MODE_INCREMENTAL)
    lake.clear()
    lake.assert_index_equal("gidx")
    rows, text = lake.query("parquet", pattern,
                            lambda dd: dd.filter(dd["k"] == 5).select("k", "v"))
    assert "Hyperspace(Type: CI, Name: gidx" in served(text)
    assert rows.num_rows >= 7


# -- every format: a covering index, and the rows of the parquet copy ----------


def lineitem_like(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "l_orderkey": pa.array(rng.integers(0, 400, n), type=pa.int64()),
        "l_shipdate": pa.array(np.datetime64("1994-01-01")
                               + rng.integers(0, 2400, n).astype("timedelta64[D]")),
        "l_quantity": pa.array(rng.integers(1, 51, n), type=pa.int64()),
        "l_extendedprice": pa.array(rng.normal(30000, 8000, n)),
    })


WRITERS = {
    "csv": lambda t, p: write_csv(t, p + ".csv"),
    "json": lambda t, p: write_json_lines(t, p + ".json"),
    "orc": lambda t, p: write_orc(t, p + ".orc"),
    "avro": lambda t, p: write_avro_table(t, p + ".avro"),
}


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_format_index_serve_equals_parquet(tmp_path, fmt):
    """Two files of lineitem-like rows in ``fmt`` and as parquet: the
    covering index over ``fmt`` is held to the JAX package's (entries,
    files), serves 4 point filters and an IN list bucket-pruned with rows
    equal in order to the JAX package's, and the key and quantity columns
    equal the parquet copy's rows."""
    src, pq_src = tmp_path / fmt, tmp_path / "pq"
    src.mkdir()
    pq_src.mkdir()
    for i in range(2):
        t = lineitem_like(600, 40 + i)
        WRITERS[fmt](t, str(src / f"part{i}"))
        pq.write_table(t, pq_src / f"part{i}.parquet")
    lake = Lake(tmp_path)
    lake.set("hyperspace.index.filterRule.useBucketSpec", True)
    rel = lake.relations(fmt, str(src))
    assert rel["fmt"] == fmt
    lake.create("fidx", fmt, str(src), ["l_orderkey"], ["l_shipdate", "l_quantity"])
    lake.assert_index_equal("fidx")
    cols = ("l_orderkey", "l_quantity")
    keys = [int(k) for k in np.random.default_rng(5).integers(0, 400, 4)]
    for cond in [lambda d, k=k: d["l_orderkey"] == k for k in keys] + [
            lambda d: d["l_orderkey"].isin(keys)]:
        rows, text = lake.query(fmt, str(src), lambda d, c=cond: d.filter(c(d)).select(*cols))
        assert "Hyperspace(Type: CI, Name: fidx" in served(text)
        df = lake.read("port", "parquet", str(pq_src))
        want = df.filter(cond(df)).select(*cols).collect()
        assert sorted_table(rows).equals(sorted_table(want))


def test_text_index_serve(tmp_path):
    d = tmp_path / "txt"
    d.mkdir()
    rng = np.random.default_rng(8)
    for i in range(2):
        words = [f"w{k}" for k in rng.integers(0, 40, 200)]
        (d / f"p{i}.txt").write_text("\n".join(words) + "\n")
    lake = Lake(tmp_path)
    lake.create("tidx", "text", str(d), ["value"], [])
    lake.assert_index_equal("tidx")
    rows, text = lake.query("text", str(d), lambda dd: dd.filter(dd["value"] == "w7"))
    assert "Hyperspace(Type: CI, Name: tidx" in served(text)
    assert rows.num_rows == sum(
        line == "w7" for f in sorted(os.listdir(d)) for line in (d / f).read_text().split())


def test_json_timestamp_seconds_come_back_as_milliseconds(tmp_path):
    """pyarrow's json reader infers ``timestamp[s]`` for ISO dates; parquet
    stores no second unit, so both packages serve the column from the index
    as ``timestamp[ms]`` with equal values (ROADMAP C.16)."""
    d = tmp_path / "j"
    d.mkdir()
    (d / "a.json").write_text('{"k": 1, "t": "1994-10-27"}\n{"k": 2, "t": "1995-01-02"}\n'
                              '{"k": 1, "t": "1996-03-04"}\n')
    lake = Lake(tmp_path)
    lake.create("jidx", "json", str(d), ["k"], ["t"])
    lake.assert_index_equal("jidx")
    got = {}
    for pkg, s in lake.sides():
        df = lake.read(pkg, "json", str(d))
        q = df.filter(df["k"] == 1).select("k", "t")
        s.enable_hyperspace()
        served_rows = q.collect()
        s.disable_hyperspace()
        source_rows = q.collect()
        assert str(served_rows.schema.field("t").type) == "timestamp[ms]"
        assert str(source_rows.schema.field("t").type) == "timestamp[s]"
        assert served_rows.cast(source_rows.schema).equals(source_rows)
        got[pkg] = served_rows
    assert got["port"].equals(got["jax"])
