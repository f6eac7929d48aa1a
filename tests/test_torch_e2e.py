"""The port's build and filter-serve slice against the JAX package, end to
end, on one seeded lineitem-shaped Parquet set (the bench.py shape, with
some NULL keys and quantities): bucket files byte-identical, log entries
equal apart from timestamps and ids, the same query rows in the same
order with and without the index, and each package serving the index
the other built."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig

N_ITEMS, N_ORDERS, N_FILES, N_BUCKETS = 40_000, 5_000, 4, 8
INDEX = ("li_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"])


def _gen(src: str) -> None:
    rng = np.random.default_rng(7)
    l_orderkey = rng.integers(0, N_ORDERS, N_ITEMS, dtype=np.int64)
    l_shipdate = np.datetime64("1994-01-01") + rng.integers(0, 2400, N_ITEMS).astype(
        "timedelta64[D]"
    )
    l_quantity = rng.integers(1, 51, N_ITEMS, dtype=np.int64)
    l_extendedprice = rng.normal(30000, 8000, N_ITEMS)
    order = np.argsort(l_shipdate, kind="stable")
    items = pa.table(
        {
            "l_orderkey": pa.array(l_orderkey[order], mask=rng.random(N_ITEMS) < 0.002),
            "l_shipdate": pa.array(l_shipdate[order].astype("datetime64[D]")),
            "l_quantity": pa.array(l_quantity[order], mask=rng.random(N_ITEMS) < 0.01),
            "l_extendedprice": l_extendedprice[order],
        }
    )
    os.makedirs(src)
    for i in range(N_FILES):
        lo, hi = i * N_ITEMS // N_FILES, (i + 1) * N_ITEMS // N_FILES
        pq.write_table(items.slice(lo, hi - lo), os.path.join(src, f"part{i}.parquet"))


def _port_session(system_path):
    s = T.HyperspaceSession(device="cpu")
    s.conf.set("hyperspace.system.path", system_path)
    s.conf.set("hyperspace.index.num_buckets", N_BUCKETS)
    s.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    return s


def _jax_session(system_path):
    s = JSession()
    s.conf.set(JC.INDEX_SYSTEM_PATH, system_path)
    s.conf.set(JC.INDEX_NUM_BUCKETS, N_BUCKETS)
    s.conf.set(JC.INDEX_FILTER_RULE_USE_BUCKET_SPEC, True)
    s.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
    return s


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    src = str(root / "lineitem")
    _gen(src)
    w = {"src": src, "tsys": str(root / "port"), "jsys": str(root / "jax")}
    w["t"] = _port_session(w["tsys"])
    w["j"] = _jax_session(w["jsys"])
    T.Hyperspace(w["t"]).create_index(w["t"].read.parquet(src), TConfig(*INDEX))
    JHyperspace(w["j"]).create_index(w["j"].read.parquet(src), JConfig(*INDEX))
    return w


def _data_dir(system_path):
    return os.path.join(system_path, INDEX[0], "v__=1")


@pytest.mark.parametrize("bucket", range(N_BUCKETS))
def test_bucket_files_byte_identical(world, bucket):
    name = f"part-{bucket:05d}-bucket_{bucket:05d}.parquet"
    with open(os.path.join(_data_dir(world["tsys"]), name), "rb") as f:
        got = f.read()
    with open(os.path.join(_data_dir(world["jsys"]), name), "rb") as f:
        want = f.read()
    assert got == want
    ported = sorted(f for f in os.listdir(_data_dir(world["tsys"])) if f.startswith("part"))
    assert ported == sorted(
        f for f in os.listdir(_data_dir(world["jsys"])) if f.startswith("part")
    )


def _normalized_entry(system_path):
    """The final log entry with timestamps and ids dropped and the system
    path (which differs between the two builds) replaced."""
    with open(os.path.join(system_path, INDEX[0], "_hyperspace_log", "2")) as f:
        text = f.read()

    def scrub(x):
        if isinstance(x, dict):
            return {
                k: scrub(v)
                for k, v in x.items()
                if k not in ("timestamp", "modifiedTime", "id")
            }
        if isinstance(x, list):
            return [scrub(v) for v in x]
        return x

    entry = json.loads(text)
    # the index dir's path components differ; compare them by role
    text = json.dumps(scrub(entry), sort_keys=True)
    for part in system_path.strip("/").split("/"):
        text = text.replace(f'"name": "{part}"', '"name": "<sys>"')
    return json.loads(text)


def test_log_entries_equal_apart_from_timestamps_and_ids(world):
    got = _normalized_entry(world["tsys"])
    want = _normalized_entry(world["jsys"])
    assert got["state"] == "ACTIVE"
    assert got == want


QUERIES = {
    "point": lambda df: df["l_orderkey"] == 1234,
    "point_miss": lambda df: df["l_orderkey"] == N_ORDERS + 5,
    "in_list": lambda df: df["l_orderkey"].isin(7, 99, 1234, 4321, 17),
    "in_with_null": lambda df: df["l_orderkey"].isin(7, None, 4321),
    "range": lambda df: (df["l_orderkey"] >= 100) & (df["l_orderkey"] < 140),
    "key_and_date": lambda df: (df["l_orderkey"] < 300)
    & (df["l_shipdate"] > np.datetime64("1996-01-01")),
    "key_is_null": lambda df: df["l_orderkey"].is_null(),
    "quantity_null": lambda df: df["l_orderkey"].isin(7, 99, 1234)
    | (df["l_orderkey"].is_not_null() & df["l_quantity"].is_null()),
}


def _run(session, src, query, enabled):
    df = session.read.parquet(src)
    q = df.filter(QUERIES[query](df)).select("l_orderkey", "l_shipdate", "l_quantity")
    if enabled:
        session.enable_hyperspace()
    else:
        session.disable_hyperspace()
    try:
        return q.collect(), q
    finally:
        session.disable_hyperspace()


def _explain(hs, q, system_path):
    """The whole explain text, the system path (which differs between the
    two builds) replaced."""
    return hs.explain(q).replace(system_path, "<sys>")


@pytest.mark.parametrize("enabled", [True, False], ids=["indexed", "unindexed"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_rows_match_reference(world, query, enabled):
    got, tq = _run(world["t"], world["src"], query, enabled)
    want, jq = _run(world["j"], world["src"], query, enabled)
    assert got.equals(want)
    if enabled:
        text = _explain(T.Hyperspace(world["t"]), tq, world["tsys"])
        assert text == _explain(JHyperspace(world["j"]), jq, world["jsys"])
        assert "Name: li_idx" in text


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_each_package_serves_the_other_index(world, query):
    port_on_jax = _port_session(world["jsys"])
    jax_on_port = _jax_session(world["tsys"])
    want, jq = _run(world["j"], world["src"], query, True)
    jax_text = JHyperspace(world["j"]).explain(jq)
    got, q = _run(port_on_jax, world["src"], query, True)
    assert T.Hyperspace(port_on_jax).explain(q) == jax_text
    assert "Name: li_idx" in jax_text
    assert got.equals(want)
    got, q = _run(jax_on_port, world["src"], query, True)
    assert _explain(JHyperspace(jax_on_port), q, world["tsys"]) == _explain(
        JHyperspace(world["j"]), jq, world["jsys"])
    assert got.equals(want)


def test_point_query_is_bucket_pruned_and_masked_on_the_device(world):
    s = world["t"]
    s.exec_stats.reset()
    got, _ = _run(s, world["src"], "point", True)
    assert got.num_rows > 0
    assert s.exec_stats.as_dict() == {
        "device_filter_evals": 0,
        "fused_range_masks": 1,
        "host_filter_evals": 0,
        "bucket_pruned_scans": 1,
        "co_bucketed_joins": 0,
        "unbucketed_joins": 0,
        "fused_selects": 0,
        "metadata_aggregates": 0,
        "fused_aggregates": 0,
    }


def _without_location(table):
    rows = table.to_pylist()
    for r in rows:
        r.pop("indexLocation")
    return rows


def test_indexes_lists_the_built_index(world):
    """``hs.indexes()`` is the JAX package's table, column for column and
    row for row, apart from ``indexLocation``: each package's own path."""
    got = T.Hyperspace(world["t"]).indexes()
    want = JHyperspace(world["j"]).indexes()
    assert got.schema == want.schema
    assert _without_location(got) == _without_location(want)
    assert got.column("indexLocation").to_pylist() == [
        os.path.join(world["tsys"], INDEX[0])
    ]
    assert want.column("indexLocation").to_pylist() == [
        os.path.join(world["jsys"], INDEX[0])
    ]
    row = _without_location(got)[0]
    assert (row["name"], row["numBuckets"], row["state"]) == ("li_idx", N_BUCKETS, "ACTIVE")
    df = world["t"].read.parquet(world["src"])
    assert df.count() == N_ITEMS


def test_index_statistics_equal_the_reference(tmp_path):
    """``hs.index(name)``: the reference's extended row for a covering and
    a z-order index (``numBuckets`` 0), apart from ``indexLocation``; a
    missing name raises in both packages. ``hs.indexes()`` lists both
    kinds as the reference does."""
    from hyperspace_tpu.exceptions import HyperspaceException as JHyperspaceException
    from hyperspace_tpu.indexes.zorder import ZOrderCoveringIndexConfig as JZConfig
    from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndexConfig as TZConfig

    src = str(tmp_path / "lineitem")
    _gen(src)
    t = _port_session(str(tmp_path / "port"))
    j = _jax_session(str(tmp_path / "jax"))
    ths, jhs = T.Hyperspace(t), JHyperspace(j)
    z = ("z_idx", ["l_shipdate", "l_quantity"], ["l_orderkey"])
    ths.create_index(t.read.parquet(src), TConfig(*INDEX))
    jhs.create_index(j.read.parquet(src), JConfig(*INDEX))
    ths.create_index(t.read.parquet(src), TZConfig(*z))
    jhs.create_index(j.read.parquet(src), JZConfig(*z))
    assert _without_location(ths.indexes()) == _without_location(jhs.indexes())
    for name in (INDEX[0], z[0]):
        got, want = ths.index(name), jhs.index(name)
        assert got.schema == want.schema
        assert _without_location(got) == _without_location(want)
        assert got.column("indexLocation").to_pylist() == [str(tmp_path / "port" / name)]
    zrow = _without_location(ths.index(z[0]))[0]
    assert zrow["numBuckets"] == 0 and "targetBytesPerPartition" in zrow["additionalStats"]
    with pytest.raises(T.HyperspaceException, match="Index not found"):
        ths.index("no_such_index")
    with pytest.raises(JHyperspaceException, match="Index not found"):
        jhs.index("no_such_index")


def test_nested_struct_field_index_matches_reference(tmp_path):
    """A struct leaf surfaces as a flat ``__hs_nested.`` column in both
    packages: the same bucket bytes and the same served rows."""
    rng = np.random.default_rng(3)
    src = tmp_path / "nested"
    src.mkdir()
    n = 2000
    t = pa.table(
        {
            "id": np.arange(n, dtype=np.int64),
            "nested": pa.StructArray.from_arrays(
                [pa.array(rng.integers(0, 50, n)), pa.array(rng.random(n))],
                names=["leaf", "val"],
            ),
        }
    )
    pq.write_table(t, str(src / "p0.parquet"))
    out = {}
    for name, make, hs_cls, cfg in (
        ("port", _port_session, T.Hyperspace, TConfig),
        ("jax", _jax_session, JHyperspace, JConfig),
    ):
        s = make(str(tmp_path / name))
        key = "hyperspace.index.supportNestedFields"
        s.conf.set(key, True)
        df = s.read.parquet(str(src))
        hs_cls(s).create_index(df, cfg("nidx", ["nested.leaf"], ["id"]))
        s.enable_hyperspace()
        q = df.filter(df["nested.leaf"] == 7).select("id", "nested.leaf")
        assert "Name: nidx" in hs_cls(s).explain(q)
        data = tmp_path / name / "nidx" / "v__=1"
        files = sorted(f for f in os.listdir(data) if f.startswith("part"))
        out[name] = (q.collect(), [(data / f).read_bytes() for f in files])
    assert out["port"][0].equals(out["jax"][0])
    assert out["port"][1] == out["jax"][1]


def _key_type_table(n=3000):
    """One column per key type of ROADMAP C.1's build probes, and the
    included-column types (list, decimal, binary) that ride along."""
    import decimal

    rng = np.random.default_rng(29)
    f = rng.normal(0, 5, n).round(1)
    f[::11], f[3::13], f[5::17] = np.nan, -0.0, 0.0
    words = np.array(["alpha", "beta", "", "gamma", "delta"])
    return pa.table(
        {
            "f64": pa.array(f, mask=rng.random(n) < 0.02),
            "f32": pa.array(rng.normal(0, 5, n).astype(np.float32)),
            "s": pa.array(words[rng.integers(0, 5, n)], mask=rng.random(n) < 0.03),
            "dict": pa.array(words[rng.integers(0, 5, n)]).dictionary_encode(),
            "d": pa.array(rng.integers(18000, 18500, n).astype(np.int32)).cast(pa.date32()),
            "ts": pa.array(rng.integers(1_600_000_000_000_000, 1_600_900_000_000_000, n),
                           type=pa.timestamp("us")),
            "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
            "i32": pa.array(rng.integers(-10_000, 10_000, n).astype(np.int32)),
            "u16": pa.array(rng.integers(0, 65_535, n).astype(np.uint16)),
            "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.05),
            "dec": pa.array([decimal.Decimal(int(x)) / 100 for x in rng.integers(0, 10**6, n)],
                            type=pa.decimal128(12, 2)),
            "lst": pa.array([[int(x), int(x) + 1] for x in rng.integers(0, 100, n)]),
            "bin": pa.array([bytes([int(x) % 256, 7]) for x in rng.integers(0, 1000, n)]),
            "v": np.arange(n, dtype=np.int64),
        }
    )


KEY_TYPE_INDEXES = {
    "float64": (["f64"], ["v"]),
    "float32": (["f32"], ["v"]),
    "string": (["s"], ["v"]),
    "dictionary": (["dict"], ["v"]),
    "date32": (["d"], ["v"]),
    "timestamp": (["ts"], ["v"]),
    "int8": (["i8"], ["v"]),
    "int32": (["i32"], ["v"]),
    "uint16": (["u16"], ["v"]),
    "bool": (["b"], ["v"]),
    "decimal": (["dec"], ["v"]),
    "multi_key": (["i32", "s", "d"], ["v"]),
    "list_decimal_binary_included": (["i32"], ["lst", "dec", "bin"]),
}


@pytest.mark.parametrize("config", sorted(KEY_TYPE_INDEXES))
def test_builds_over_key_types_write_identical_bytes(tmp_path, config):
    """Both packages build the same bucket files byte for byte, the same
    zone-map and aggregate-state sidecars apart from the files' mtimes,
    and the same sample sidecar byte for byte, over each key type of
    ROADMAP C.1's probes."""
    src = tmp_path / "src"
    src.mkdir()
    t = _key_type_table()
    for i in range(2):
        pq.write_table(t.slice(i * 1500, 1500), str(src / f"p{i}.parquet"))
    indexed, included = KEY_TYPE_INDEXES[config]
    files = {}
    for name, make, hs_cls, cfg in (
        ("port", _port_session, T.Hyperspace, TConfig),
        ("jax", _jax_session, JHyperspace, JConfig),
    ):
        s = make(str(tmp_path / name))
        hs_cls(s).create_index(s.read.parquet(str(src)), cfg("kidx", indexed, included))
        data = tmp_path / name / "kidx" / "v__=1"
        files[name] = {f: (data / f).read_bytes() for f in sorted(os.listdir(data))}
    assert sorted(files["port"]) == sorted(files["jax"])
    assert "_zonemaps.json" in files["port"]
    assert any(f.startswith("part") for f in files["port"])
    for f, got in files["port"].items():
        if f in ("_zonemaps.json", "_aggstate.json"):
            sides = [json.loads(files[p][f]) for p in ("port", "jax")]
            for doc in sides:
                for entry in doc["files"].values():
                    entry.pop("mtime_ns")
            assert sides[0] == sides[1], f
        else:
            assert got == files["jax"][f], f
