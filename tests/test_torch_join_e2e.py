"""The port's join-serve slice against the JAX package, end to end: the
same joins collected through both packages give identical rows in the
same order, with Hyperspace on (co-bucketed, shuffle-free, kernel B4's
plain version per bucket) and off (the unindexed join), and each package
serves joins over the indexes the other built. Seeded tables, 8 buckets;
the comparison is exact (``Table.equals``)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.ops.hash import bucket_ids_torch

N_BUCKETS = 8


def _write(root, name, table, n_files):
    d = root / name
    d.mkdir()
    step = -(-table.num_rows // n_files)
    for i in range(n_files):
        pq.write_table(table.slice(i * step, step), d / f"p{i}.parquet")
    return str(d)


def _keys_in_buckets(candidates, buckets):
    """The candidate int64 keys whose murmur3 bucket is in ``buckets``."""
    reps = torch.from_numpy(np.asarray(candidates, dtype=np.int64))[None]
    bid = bucket_ids_torch(reps, N_BUCKETS).numpy()
    return np.asarray(candidates)[np.isin(bid, list(buckets))]


def _sources(root):
    rng = np.random.default_rng(31)
    n_o, n_l = 3000, 9000
    orders = pa.table(
        {
            "o_key": pa.array(rng.integers(0, 1500, n_o), type=pa.int64()),
            "o_amount": rng.normal(100, 20, n_o),
            "o_tag": [f"t{x}" for x in rng.integers(0, 7, n_o)],
        }
    )
    items = pa.table(
        {
            "l_key": pa.array(rng.integers(0, 1500, n_l), type=pa.int64()),
            "l_qty": pa.array(rng.integers(1, 50, n_l), type=pa.int64()),
            "l_price": rng.normal(30, 8, n_l),
        }
    )
    words = np.array([f"w{i:03d}" for i in range(400)])
    sa = pa.table({"s_a": words[rng.integers(0, 400, 2500)], "va": np.arange(2500)})
    sb = pa.table({"s_b": words[rng.integers(0, 400, 3500)], "vb": np.arange(3500)})

    def null_keyed(n, names, seed):
        r = np.random.default_rng(seed)
        return pa.table(
            {
                names[0]: pa.array(r.integers(0, 60, n), mask=r.random(n) < 0.05),
                names[1]: pa.array(r.integers(0, 4, n), mask=r.random(n) < 0.05),
                names[2]: r.integers(0, 1000, n),
            }
        )

    keys = np.arange(4000)
    left_keys = _keys_in_buckets(keys, {0, 1, 2, 3})
    right_keys = _keys_in_buckets(keys, {3, 4, 5})
    other_keys = _keys_in_buckets(keys, {6, 7})
    da = pa.table({"d_a": rng.choice(left_keys, 2000), "va": np.arange(2000)})
    db = pa.table({"d_b": rng.choice(right_keys, 2000), "vb": np.arange(2000)})
    dc = pa.table({"d_c": rng.choice(other_keys, 500), "vc": np.arange(500)})
    # the key types of ROADMAP C.1's probes: float64 with NaN, -0.0 and
    # 0.0; int32 against int64; date32; strings with nulls and ""
    def floats(n, seed):
        r = np.random.default_rng(seed)
        f = r.integers(-20, 20, n).astype(np.float64) / 4
        f[::13], f[5::17], f[7::19] = np.nan, -0.0, 0.0
        return pa.array(f, mask=r.random(n) < 0.02)

    days = lambda n, seed: pa.array(  # noqa: E731
        np.random.default_rng(seed).integers(18000, 18300, n).astype(np.int32)).cast(pa.date32())
    texts = np.array([f"s{i:02d}" for i in range(40)] + [""])

    def strings(n, seed):
        r = np.random.default_rng(seed)
        return pa.array(texts[r.integers(0, len(texts), n)], mask=r.random(n) < 0.05)

    extra = {
        "fa": pa.table({"f_a": floats(1500, 3), "va": np.arange(1500)}),
        "fb": pa.table({"f_b": floats(1800, 4), "vb": np.arange(1800)}),
        "i32": pa.table({"i_a": pa.array(rng.integers(-300, 300, 2000).astype(np.int32)),
                         "va": np.arange(2000)}),
        "i64": pa.table({"i_b": pa.array(rng.integers(-300, 300, 2500), type=pa.int64()),
                         "vb": np.arange(2500)}),
        "dta": pa.table({"d_a": days(2000, 5), "va": np.arange(2000)}),
        "dtb": pa.table({"d_b": days(1500, 6), "vb": np.arange(1500)}),
        "sna": pa.table({"sn_a": strings(2000, 7), "va": np.arange(2000)}),
        "snb": pa.table({"sn_b": strings(1200, 8), "vb": np.arange(1200)}),
    }
    return {
        **{name: _write(root, name, table, 2) for name, table in extra.items()},
        "orders": _write(root, "orders", orders, 3),
        "items": _write(root, "items", items, 4),
        "lin_orders": _write(root, "lin_orders", orders, 3),
        "lin_items": _write(root, "lin_items", items, 4),
        "sa": _write(root, "sa", sa, 2),
        "sb": _write(root, "sb", sb, 2),
        "na": _write(root, "na", null_keyed(4000, ("k1", "k2", "va"), 1), 2),
        "nb": _write(root, "nb", null_keyed(5000, ("j1", "j2", "vb"), 2), 3),
        "da": _write(root, "da", da, 2),
        "db": _write(root, "db", db, 2),
        "dc": _write(root, "dc", dc, 1),
    }


# source -> (index name, indexed columns, included columns)
INDEXES = {
    "orders": ("o_idx", ["o_key"], ["o_amount", "o_tag"]),
    "items": ("l_idx", ["l_key"], ["l_qty"]),
    "lin_orders": ("lin_o_idx", ["o_key"], ["o_amount", "o_tag"]),
    "lin_items": ("lin_l_idx", ["l_key"], ["l_qty", "l_price"]),
    "sa": ("sa_idx", ["s_a"], ["va"]),
    "sb": ("sb_idx", ["s_b"], ["vb"]),
    "na": ("na_idx", ["k1", "k2"], ["va"]),
    "nb": ("nb_idx", ["j1", "j2"], ["vb"]),
    "da": ("da_idx", ["d_a"], ["va"]),
    "db": ("db_idx", ["d_b"], ["vb"]),
    "dc": ("dc_idx", ["d_c"], ["vc"]),
    "fa": ("fa_idx", ["f_a"], ["va"]),
    "fb": ("fb_idx", ["f_b"], ["vb"]),
    "i32": ("i32_idx", ["i_a"], ["va"]),
    "i64": ("i64_idx", ["i_b"], ["vb"]),
    "dta": ("dta_idx", ["d_a"], ["va"]),
    "dtb": ("dtb_idx", ["d_b"], ["vb"]),
    "sna": ("sna_idx", ["sn_a"], ["va"]),
    "snb": ("snb_idx", ["sn_b"], ["vb"]),
}
LINEAGE = {"lin_orders", "lin_items"}


def _port_session(system_path):
    s = T.HyperspaceSession(device="cpu")
    s.conf.set("hyperspace.system.path", system_path)
    s.conf.set("hyperspace.index.num_buckets", N_BUCKETS)
    return s


def _jax_session(system_path):
    s = JSession()
    s.conf.set(JC.INDEX_SYSTEM_PATH, system_path)
    s.conf.set(JC.INDEX_NUM_BUCKETS, N_BUCKETS)
    s.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
    return s


def _build(session, hs, cfg_cls, src):
    for name, (idx, indexed, included) in INDEXES.items():
        session.conf.set("hyperspace.index.lineage.enabled", name in LINEAGE)
        hs.create_index(session.read.parquet(src[name]), cfg_cls(idx, indexed, included))
    session.conf.set("hyperspace.index.lineage.enabled", False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_join_e2e")
    src = _sources(root)
    w = {"src": src, "tsys": str(root / "port"), "jsys": str(root / "jax")}
    w["t"] = _port_session(w["tsys"])
    w["j"] = _jax_session(w["jsys"])
    _build(w["t"], T.Hyperspace(w["t"]), TConfig, src)
    _build(w["j"], JHyperspace(w["j"]), JConfig, src)
    return w


def _single(r):
    o, i = r("orders"), r("items")
    return o.join(i, on=o["o_key"] == i["l_key"]).select("o_key", "o_amount", "l_qty")


def _swapped_condition(r):
    o, i = r("orders"), r("items")
    return o.join(i, on=i["l_key"] == o["o_key"]).select("l_qty", "o_tag", "o_key")


def _string_key(r):
    a, b = r("sa"), r("sb")
    return a.join(b, on=a["s_a"] == b["s_b"]).select("s_a", "va", "vb")


def _two_keys_with_nulls(r):
    a, b = r("na"), r("nb")
    return a.join(b, on=(a["k1"] == b["j1"]) & (a["k2"] == b["j2"])).select(
        "k1", "k2", "va", "vb")


def _filters_on_both_sides(r):
    o, i = r("orders"), r("items")
    return (
        o.filter((o["o_key"] > 200) & (o["o_tag"] != "t3"))
        .join(i.filter(i["l_qty"] < 20), on=o["o_key"] == i["l_key"])
        .select("o_key", "o_tag", "l_qty")
    )


def _lineage(r):
    o, i = r("lin_orders"), r("lin_items")
    return o.join(i, on=o["o_key"] == i["l_key"])


def _partly_disjoint_buckets(r):
    a, b = r("da"), r("db")
    return a.join(b, on=a["d_a"] == b["d_b"]).select("d_a", "va", "vb")


def _disjoint_buckets(r):
    a, c = r("da"), r("dc")
    return a.join(c, on=a["d_a"] == c["d_c"]).select("d_a", "va", "vc")


def _key_pair(left, right, lkey, rkey):
    def build(r):
        a, b = r(left), r(right)
        return a.join(b, on=a[lkey] == b[rkey]).select(lkey, rkey, "va", "vb")

    return build


QUERIES = {
    "float64_keys_nan_and_signed_zero": _key_pair("fa", "fb", "f_a", "f_b"),
    "int32_with_int64_keys": _key_pair("i32", "i64", "i_a", "i_b"),
    "date32_keys": _key_pair("dta", "dtb", "d_a", "d_b"),
    "string_keys_with_nulls": _key_pair("sna", "snb", "sn_a", "sn_b"),
    "single_key": _single,
    "swapped_condition": _swapped_condition,
    "string_key": _string_key,
    "two_keys_with_nulls": _two_keys_with_nulls,
    "filters_on_both_sides": _filters_on_both_sides,
    "lineage": _lineage,
    "partly_disjoint_buckets": _partly_disjoint_buckets,
    "disjoint_buckets": _disjoint_buckets,
}


def _run(session, src, query, enabled):
    q = QUERIES[query](lambda name: session.read.parquet(src[name]))
    if enabled:
        session.enable_hyperspace()
    else:
        session.disable_hyperspace()
    try:
        return q.collect(), q
    finally:
        session.disable_hyperspace()


def _same_rows(a: pa.Table, b: pa.Table) -> bool:
    """Rows equal in order, float columns compared bit for bit: NaN equals
    NaN and -0.0 differs from 0.0, where ``Table.equals`` fails on any
    NaN (ROADMAP C.4)."""
    if a.schema != b.schema or a.num_rows != b.num_rows:
        return False
    for name in a.column_names:
        x, y = a.column(name).combine_chunks(), b.column(name).combine_chunks()
        if pa.types.is_floating(x.type):
            if not np.array_equal(np.asarray(x.is_null()), np.asarray(y.is_null())):
                return False
            bits = [c.fill_null(0).to_numpy(zero_copy_only=False).view(np.int64)
                    for c in (x, y)]
            if not np.array_equal(*bits):
                return False
        elif not x.equals(y):
            return False
    return True


def _index_scans(text):
    return text.split("Plan without indexes:")[0].count("Hyperspace(Type: CI")


@pytest.mark.parametrize("enabled", [True, False], ids=["indexed", "unindexed"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_join_rows_match_reference_in_order(world, query, enabled):
    s = world["t"]
    s.exec_stats.reset()
    got, tq = _run(s, world["src"], query, enabled)
    want, jq = _run(world["j"], world["src"], query, enabled)
    assert _same_rows(got, want)
    stats = s.exec_stats.as_dict()
    assert stats["co_bucketed_joins"] == (1 if enabled else 0)
    assert stats["unbucketed_joins"] == (0 if enabled else 1)
    if enabled:
        text = T.Hyperspace(s).explain(tq).replace(world["tsys"], "<sys>")
        assert text == JHyperspace(world["j"]).explain(jq).replace(world["jsys"], "<sys>")
        assert _index_scans(text) == 2
    if query == "disjoint_buckets":
        assert got.num_rows == 0 and got.column_names == ["d_a", "va", "vc"]
    elif query == "lineage":
        assert "_data_file_id" not in got.column_names and got.num_rows > 0
    else:
        assert got.num_rows > 0


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_each_package_serves_joins_over_the_other_index(world, query):
    port_on_jax = _port_session(world["jsys"])
    jax_on_port = _jax_session(world["tsys"])
    want, _ = _run(world["j"], world["src"], query, True)
    got, q = _run(port_on_jax, world["src"], query, True)
    assert _index_scans(T.Hyperspace(port_on_jax).explain(q)) == 2
    assert _same_rows(got, want)
    got, q = _run(jax_on_port, world["src"], query, True)
    assert _index_scans(JHyperspace(jax_on_port).explain(q)) == 2
    assert _same_rows(got, want)


def test_join_stages_are_recorded_per_join(world):
    s = world["t"]
    _run(s, world["src"], "two_keys_with_nulls", True)
    assert set(s.join_stats) == {"scan", "prepare", "match", "to_host", "verify", "assemble"}
    _run(s, world["src"], "single_key", False)
    assert set(s.join_stats) == {"scan", "match", "to_host", "verify", "assemble"}
    assert all(v >= 0 for v in s.join_stats.values())


def test_same_name_join_keys_are_refused(world):
    s = world["t"]
    o = s.read.parquet(world["src"]["orders"])
    with pytest.raises(T.HyperspaceException, match="Same-name join keys"):
        o.join(o, on="o_key")
    with pytest.raises(T.HyperspaceException, match="Ambiguous join output"):
        o.join(o, on=o["o_key"] == o["o_key"])
