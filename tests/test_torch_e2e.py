"""The port's build and filter-serve slice against the JAX package, end to
end, on one seeded lineitem-shaped Parquet set (the bench.py shape, with
some NULL keys and quantities): bucket files byte-identical, log entries
equal apart from timestamps and ids, the same query rows in the same
order with and without the index, and each package serving the index
the other built."""

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


@pytest.mark.parametrize("enabled", [True, False], ids=["indexed", "unindexed"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_rows_match_reference(world, query, enabled):
    got, tq = _run(world["t"], world["src"], query, enabled)
    want, jq = _run(world["j"], world["src"], query, enabled)
    assert got.equals(want)
    if enabled:
        assert "Name: li_idx" in T.Hyperspace(world["t"]).explain(tq)
        assert "Name: li_idx" in JHyperspace(world["j"]).explain(jq)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_each_package_serves_the_other_index(world, query):
    port_on_jax = _port_session(world["jsys"])
    jax_on_port = _jax_session(world["tsys"])
    want, _ = _run(world["j"], world["src"], query, True)
    got, q = _run(port_on_jax, world["src"], query, True)
    assert "Name: li_idx" in T.Hyperspace(port_on_jax).explain(q)
    assert got.equals(want)
    got, q = _run(jax_on_port, world["src"], query, True)
    assert "Name: li_idx" in JHyperspace(jax_on_port).explain(q)
    assert got.equals(want)


def test_point_query_is_bucket_pruned_and_masked_on_the_device(world):
    s = world["t"]
    s.exec_stats.reset()
    got, _ = _run(s, world["src"], "point", True)
    assert got.num_rows > 0
    assert s.exec_stats.as_dict() == {
        "device_filter_evals": 1,
        "host_filter_evals": 0,
        "bucket_pruned_scans": 1,
        "co_bucketed_joins": 0,
        "unbucketed_joins": 0,
    }


def test_indexes_lists_the_built_index(world):
    got = T.Hyperspace(world["t"]).indexes().to_pylist()
    assert got == [
        {
            "name": "li_idx",
            "indexedColumns": ["l_orderkey"],
            "includedColumns": ["l_shipdate", "l_quantity"],
            "numBuckets": N_BUCKETS,
            "state": "ACTIVE",
            "logVersion": 2,
        }
    ]
    df = world["t"].read.parquet(world["src"])
    assert df.count() == N_ITEMS


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
