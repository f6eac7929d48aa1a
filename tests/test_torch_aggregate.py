"""The port's aggregates against the JAX package: the same queries over
the same seeded tables, collected through both packages, give identical
rows in the same order, floats compared bit for bit (signed zeros, NaN,
null, float32, uint8 and int64-wrap cases included); kernel B5's plain
versions equal the reference's ``segment_*`` functions on its host route
and, for integers, counts and the NaN rules, on its jitted route; and
each package serves aggregates over the indexes the other built."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.ops import aggregate as JA
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.ops import aggregate as A
import torch_b5_cases
from torch_b5_cases import B5_CASES as CASES
from torch_b5_cases import NAN_PAYLOAD, NEG_NAN, b5_layouts, groups, layout_gid, same_rows

N_BUCKETS = 4


def _write(root, name, table, n_files=2):
    d = root / name
    d.mkdir()
    step = max(-(-table.num_rows // n_files), 1)
    for i in range(n_files):
        pq.write_table(table.slice(i * step, step), d / f"p{i}.parquet")
    return str(d)


def _sources(root):
    rng = np.random.default_rng(5)
    n = 500
    agg = pa.table(  # tests/test_aggregates.py's agg_data
        {
            "g": pa.array([f"k{int(x)}" for x in rng.integers(0, 7, n)]),
            "h": pa.array(rng.integers(0, 3, n), type=pa.int64()),
            "x": pa.array(rng.integers(-50, 50, n), type=pa.int64()),
            "y": pa.array(rng.normal(0, 10, n)),
            "s": pa.array(
                [["apple", "pear", "fig", None][int(x)] for x in rng.integers(0, 4, n)]
            ),
            "z": pa.array([None if i % 11 == 0 else float(i % 13) for i in range(n)]),
        }
    )
    # per group: signed-zero ties in both orders, NaN-only, all-null, NaN
    # with a payload, inf + -inf, and values around them
    special = pa.table(
        {
            "g": ["a", "a", "b", "b", "c", "c", "d", "d", "e", "e", "e", "f", "f", "f",
                  "h", "h", "h"],
            "v": pa.array(
                [0.0, -0.0, -0.0, 0.0, np.nan, np.nan, None, None, 1.0, NAN_PAYLOAD, 2.0,
                 np.inf, -np.inf, NAN_PAYLOAD, NEG_NAN, NAN_PAYLOAD, 3.0],
                type=pa.float64(),
            ),
            "f": pa.array(
                [0.0, -0.0, -0.0, 0.0, np.nan, 1.0, None, 2.0, 1e-8, 1.0, 3.0,
                 np.inf, 1.0, -np.inf, 2.5, 1e7, 0.1],
                type=pa.float32(),
            ),
            "b": pa.array([True, False, None, None, True, True, None, False, False, False,
                           True, True, None, False, False, True, True]),
        }
    )
    ints = pa.table(
        {
            "g": np.array([0, 0, 1, 1, 1, 2, 2, 3], dtype=np.int64),
            "u8": pa.array([200, 200, 255, 1, None, 7, 9, None], type=pa.uint8()),
            "u64": pa.array([2**64 - 1, 2**63, 5, None, 2**63 + 7, 1, 2, None],
                            type=pa.uint64()),
            "i64": pa.array([2**62, 2**62, 2**62, 2**62, -(2**63), -1, 5, None],
                            type=pa.int64()),
            "i32": pa.array([-7, 3, None, 2**31 - 1, -(2**31), 4, 4, None], type=pa.int32()),
            "d": pa.array(np.array([18000, 18300, 17000, 19000, 18000, 1, 2, 3],
                                   dtype=np.int32)).cast(pa.date32()),
        }
    )
    big_n = 100_000
    r2 = np.random.default_rng(11)
    big = pa.table(
        {
            "k": r2.integers(0, 10_000, big_n),
            "f": r2.normal(0, 1e3, big_n),
            "f32": r2.normal(0, 1e3, big_n).astype(np.float32),
            "q": r2.integers(-(2**40), 2**40, big_n),
        }
    )
    empty = pa.table({"v": pa.array([], type=pa.int64()), "w": pa.array([], type=pa.float64())})
    r3 = np.random.default_rng(3)
    orders = pa.table({"o_key": np.arange(500),
                       "o_tag": [f"t{x}" for x in r3.integers(0, 5, 500)]})
    items = pa.table({"l_key": r3.integers(0, 500, 3000), "l_q": r3.integers(1, 50, 3000),
                      "l_p": r3.normal(10, 3, 3000)})
    return {
        "orders": _write(root, "orders", orders),
        "items": _write(root, "items", items),
        "agg": _write(root, "agg", agg),
        "special": _write(root, "special", special),
        "ints": _write(root, "ints", ints),
        "big": _write(root, "big", big, 3),
        "empty": _write(root, "empty", empty, 1),
    }


# source -> (index name, indexed columns, included columns)
INDEXES = {
    "agg": ("x_idx", ["x"], ["g", "y", "h"]),
    "big": ("k_idx", ["k"], ["q"]),
    "orders": ("o_idx", ["o_key"], ["o_tag"]),
    "items": ("l_idx", ["l_key"], ["l_q", "l_p"]),
}


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
        hs.create_index(session.read.parquet(src[name]), cfg_cls(idx, indexed, included))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_aggregate")
    src = _sources(root)
    w = {"src": src, "tsys": str(root / "port"), "jsys": str(root / "jax")}
    w["t"] = _port_session(w["tsys"])
    w["j"] = _jax_session(w["jsys"])
    _build(w["t"], T.Hyperspace(w["t"]), TConfig, src)
    _build(w["j"], JHyperspace(w["j"]), JConfig, src)
    return w


# Each query takes (read, F): ``read(name)`` gives the source DataFrame of
# the package under test and ``F`` its functions module.
QUERIES = {
    "grouped_sum_count_min_max_avg": lambda r, F: r("agg").group_by("g").agg(
        F.sum("x").alias("sx"), F.count().alias("n"), F.count("z").alias("nz"),
        F.min("x").alias("mnx"), F.max("y").alias("mxy"), F.avg("x").alias("ax")),
    "multi_key_group": lambda r, F: r("agg").group_by("g", "h").agg(F.sum("x").alias("sx")),
    "global_aggregate": lambda r, F: r("agg").agg(
        F.count().alias("n"), F.sum("x").alias("sx"), F.avg("y").alias("ay")),
    "null_group_and_null_aggs": lambda r, F: r("agg").group_by("s").agg(
        F.count().alias("n"), F.sum("x").alias("sx"), F.sum("z"), F.min("z"), F.max("z")),
    "string_min_max": lambda r, F: r("agg").group_by("h").agg(
        F.min("s").alias("mn"), F.max("s").alias("mx")),
    "float_group_key_and_string_keys": lambda r, F: r("agg").group_by("z", "s").agg(
        F.count(), F.sum("y"), F.min("g")),
    "agg_over_filter": lambda r, F: r("agg").filter(r("agg")["x"] > 0).group_by("g").agg(
        F.sum("x").alias("sx")),
    "index_served_filter_then_aggregate": lambda r, F: r("agg").filter(r("agg")["x"] > 10)
    .group_by("g").agg(F.count().alias("n"), F.avg("y").alias("ay")),
    "bare_aggregate_rewritten_onto_the_index": lambda r, F: r("agg").group_by("h").agg(
        F.count().alias("n"), F.sum("x"), F.min("g"), F.max("x")),
    "float_sum_stays_on_the_source": lambda r, F: r("agg").group_by("h").agg(
        F.sum("y"), F.min("x")),
    "signed_zero_nan_null_groups": lambda r, F: r("special").group_by("g").agg(
        F.min("v"), F.max("v"), F.sum("v"), F.avg("v"), F.count("v"), F.count()),
    "float32_folded_in_float32": lambda r, F: r("special").group_by("g").agg(
        F.sum("f"), F.min("f"), F.max("f"), F.avg("f")),
    "bool_min_max_count": lambda r, F: r("special").group_by("g").agg(
        F.min("b"), F.max("b"), F.count("b")),
    "bool_group_key": lambda r, F: r("special").group_by("b").agg(F.count(), F.sum("v")),
    "uint8_sums_and_int64_wrap": lambda r, F: r("ints").group_by("g").agg(
        F.sum("u8"), F.avg("u8"), F.min("u8"), F.max("u8"), F.sum("i64"), F.avg("i64"),
        F.min("i64"), F.max("i64")),
    "uint64_and_int32_and_dates": lambda r, F: r("ints").group_by("g").agg(
        F.sum("u64"), F.avg("u64"), F.min("u64"), F.max("u64"), F.sum("i32"), F.min("i32"),
        F.max("i32"), F.min("d"), F.max("d")),
    "global_over_signed_zeros_and_nans": lambda r, F: r("special").agg(
        F.sum("v"), F.min("v"), F.max("v"), F.sum("f")),
    "one_group_of_100000_rows": lambda r, F: r("big").agg(
        F.sum("f"), F.sum("f32"), F.avg("f"), F.sum("q"), F.min("f"), F.max("f32")),
    "ten_thousand_groups": lambda r, F: r("big").group_by("k").agg(
        F.sum("f"), F.sum("f32"), F.count(), F.sum("q"), F.min("q"), F.max("f")),
    "bare_int_aggregate_over_ten_thousand_groups": lambda r, F: r("big").group_by("k").agg(
        F.sum("q"), F.count(), F.max("q")),
    "aggregate_over_an_indexed_join": lambda r, F: r("orders").join(
        r("items"), on=r("orders")["o_key"] == r("items")["l_key"]).group_by("o_tag").agg(
        F.sum("l_q"), F.sum("l_p"), F.count(), F.max("l_p")),
    "empty_input_global_agg": lambda r, F: r("empty").agg(
        F.count().alias("n"), F.sum("v").alias("sv"), F.min("w"), F.max("v")),
    "empty_input_grouped_agg": lambda r, F: r("empty").group_by("v").agg(F.sum("w")),
}
INDEXED = {"agg_over_filter", "index_served_filter_then_aggregate", "multi_key_group",
           "aggregate_over_an_indexed_join",
           "bare_aggregate_rewritten_onto_the_index",
           "bare_int_aggregate_over_ten_thousand_groups"}


def _run(session, src, query, enabled, functions):
    q = QUERIES[query](lambda name: session.read.parquet(src[name]), functions)
    if enabled:
        session.enable_hyperspace()
    else:
        session.disable_hyperspace()
    try:
        return q.collect(), q
    finally:
        session.disable_hyperspace()


def _index_used(text):
    return "Hyperspace(Type: CI" in text.split("Plan without indexes:")[0]


@pytest.mark.parametrize("enabled", [True, False], ids=["hyperspace_on", "hyperspace_off"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_aggregate_rows_match_reference_in_order(world, query, enabled):
    got, tq = _run(world["t"], world["src"], query, enabled, TF)
    want, jq = _run(world["j"], world["src"], query, enabled, JF)
    assert same_rows(got, want), (got.to_pylist()[:5], want.to_pylist()[:5])
    if enabled:
        port_text = T.Hyperspace(world["t"]).explain(tq)
        assert port_text == JHyperspace(world["j"]).explain(jq).replace(
            world["jsys"], world["tsys"])
        assert _index_used(port_text) == (query in INDEXED)


def test_each_package_serves_aggregates_over_the_other_index(world):
    port_on_jax = _port_session(world["jsys"])
    jax_on_port = _jax_session(world["tsys"])
    for query in sorted(INDEXED):
        want, _ = _run(world["j"], world["src"], query, True, JF)
        got, q = _run(port_on_jax, world["src"], query, True, TF)
        assert _index_used(T.Hyperspace(port_on_jax).explain(q))
        assert same_rows(got, want)
        got, q = _run(jax_on_port, world["src"], query, True, JF)
        assert _index_used(JHyperspace(jax_on_port).explain(q))
        assert same_rows(got, want)


def test_aggregate_stages_are_recorded(world):
    s = world["t"]
    _run(s, world["src"], "grouped_sum_count_min_max_avg", False, TF)
    assert set(s.agg_stats) == {"scan", "factorize", "reduce", "finalize"}
    assert all(v >= 0 for v in s.agg_stats.values())


def test_plan_time_type_validation(world):
    df = world["t"].read.parquet(world["src"]["agg"])
    with pytest.raises(HyperspaceException, match="avg"):
        df.group_by("g").agg(TF.avg("s")).schema()
    with pytest.raises(HyperspaceException, match="sum"):
        df.group_by("g").agg(TF.sum("s")).schema()
    with pytest.raises(HyperspaceException, match="Duplicate"):
        df.agg(TF.count(), TF.count())


def test_the_agg_rule_switch_gates_the_rewrite(world):
    s = world["t"]
    q = QUERIES["bare_aggregate_rewritten_onto_the_index"](
        lambda name: s.read.parquet(world["src"][name]), TF)
    s.conf.set("hyperspace.index.agg.enabled", False)
    try:
        assert not _index_used(T.Hyperspace(s).explain(q))
    finally:
        s.conf.set("hyperspace.index.agg.enabled", True)
    assert _index_used(T.Hyperspace(s).explain(q))


# -- B5's plain versions against the reference's segment functions --------------


def _port_sum_count(gid, vals, valid, num):
    perm, offs = groups(gid, num)
    v, _ = A.device_values(vals, "cpu")
    ok = None if valid is None else torch.from_numpy(valid)
    s, c = A.segment_sum_count(perm, offs, v, ok)
    s = s.numpy()
    return (s.view(np.uint64) if vals.dtype.kind == "u" else s), c.numpy()


def _port_minmax(gid, vals, valid, num, mode):
    perm, offs = groups(gid, num)
    v, unsigned = A.device_values(vals, "cpu")
    ok = None if valid is None else torch.from_numpy(valid)
    fill = None
    if vals.dtype.kind in "iu":
        info = np.iinfo(vals.dtype)
        fill = int(info.max if mode == "min" else info.min)
    elif vals.dtype.kind == "b":
        fill = mode == "min"
    out = A.segment_minmax(perm, offs, v, ok, mode, fill, unsigned).numpy()
    return (out.view(np.uint64) if unsigned else out).astype(vals.dtype)


def _port_count(gid, valid, n, num):
    perm, offs = groups(gid, num)
    ok = None if valid is None else torch.from_numpy(valid)
    return A.segment_count(perm, offs, ok).numpy()


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        width = np.int64 if a.dtype.itemsize == 8 else np.int32
        return np.array_equal(a.view(width), b.view(width))
    return np.array_equal(a, b)




@pytest.mark.parametrize("case", sorted(CASES))
def test_b5_plain_versions_equal_the_host_route(case):
    gid, vals, valid, num = CASES[case]
    if vals.dtype.kind != "b":
        ws, wc = JA.segment_sum_count(gid, vals, valid, num)
        gs, gc = _port_sum_count(gid, vals, valid, num)
        assert _bits_equal(gs, ws) and _bits_equal(gc, wc)
    for mode in ("min", "max"):
        want = JA.segment_minmax(gid, vals, valid, num, mode)
        assert _bits_equal(_port_minmax(gid, vals, valid, num, mode), want), mode
    assert _bits_equal(_port_count(gid, valid, len(vals), num),
                       JA.segment_count(gid, valid, len(vals), num))


LAYOUTS = b5_layouts()


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "uint64"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_b5_plain_versions_over_the_kernel_layouts(layout, dtype):
    """The group layouts that test B5's ranges, lane path and fold tiles
    (groups across ranges, on their edges, empty ones, no rows, Q18's
    groups of 1-7 rows, groups around the lane path's longest, a late NaN
    in a long fold), plain versions against the host route, with and
    without nulls."""
    perm, offs, vals = LAYOUTS[layout]
    gid, num = layout_gid(perm, offs), len(offs) - 1
    for valid in (None, vals["valid"]):
        ws, wc = JA.segment_sum_count(gid, vals[dtype], valid, num)
        gs, gc = _port_sum_count(gid, vals[dtype], valid, num)
        assert _bits_equal(gs, ws) and _bits_equal(gc, wc)
        for mode in ("min", "max"):
            want = JA.segment_minmax(gid, vals[dtype], valid, num, mode)
            assert _bits_equal(_port_minmax(gid, vals[dtype], valid, num, mode), want), mode


@pytest.mark.parametrize("name, value", [("kRange", "RANGE"), ("kShortGroup", "SHORT_GROUP"),
                                         ("kTile", "FOLD_TILE")])
def test_b5_layouts_sit_at_the_kernels_widths(name, value):
    """The layouts' widths are the kernel's own (``csrc/segment_reduce.cu``):
    the groups placed on and across range edges, at the lane path's
    longest group and around the fold's tile stay there if one changes."""
    from hyperspace_tpu_torch import kernels as port_kernels

    with open(os.path.join(port_kernels.CSRC_DIR, "segment_reduce.cu")) as fh:
        found = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", fh.read())
    assert found and int(found.group(1)) == getattr(torch_b5_cases, value)


@pytest.mark.parametrize("case", ["int64", "int64_wrap", "float64", "float32",
                                  "all_null_and_nan_only_groups"])
def test_b5_plain_versions_equal_the_jitted_route(case, monkeypatch):
    """int64 sums and counts, int64 min and max, and the float NaN rules
    on the jitted route (float min and max compared as values, NaN equal
    to NaN: the jitted route orders -0.0 below 0.0). Narrower integers
    are left out: that route sums int32 in 32 bits and cannot take uint8
    min and max (ROADMAP C.3)."""
    gid, vals, valid, num = CASES[case]
    monkeypatch.setattr(JA, "_HOST_AGG_MAX_ROWS", 0)
    if vals.dtype.kind in "iu":
        ws, wc = JA.segment_sum_count(gid, vals, valid, num)
        gs, gc = _port_sum_count(gid, vals, valid, num)
        assert _bits_equal(gs, ws.astype(gs.dtype)) and _bits_equal(gc, wc)
    for mode in ("min", "max"):
        want = JA.segment_minmax(gid, vals, valid, num, mode)
        got = _port_minmax(gid, vals, valid, num, mode)
        if vals.dtype.kind == "f":
            assert np.array_equal(got, want.astype(got.dtype), equal_nan=True), mode
        else:
            assert _bits_equal(got, want.astype(got.dtype)), mode
    assert _bits_equal(_port_count(gid, valid, len(vals), num),
                       JA.segment_count(gid, valid, len(vals), num))


@pytest.mark.parametrize("values", [[0.0, -0.0], [-0.0, 0.0]], ids=["zero_first", "minus_first"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_b5_signed_zero_ties_keep_the_later_row(values, dtype):
    vals = np.array(values, dtype=dtype)
    gid = np.zeros(2, dtype=np.int64)
    for mode in ("min", "max"):
        got = _port_minmax(gid, vals, None, 1, mode)
        assert _bits_equal(got, JA.segment_minmax(gid, vals, None, 1, mode))
        assert np.signbit(got[0]) == np.signbit(vals[1])


def test_reference_routes_disagree_on_signed_zero_ties(monkeypatch):
    """The fault recorded in ROADMAP C.3: the JAX package's jitted route
    orders -0.0 below 0.0 (MIN -0.0 and MAX 0.0 in both orders), its host
    route keeps the later row. The port follows the host route."""
    gid = np.zeros(2, dtype=np.int64)
    vals = np.array([0.0, -0.0])
    host = [JA.segment_minmax(gid, vals, None, 1, m)[0] for m in ("min", "max")]
    monkeypatch.setattr(JA, "_HOST_AGG_MAX_ROWS", 0)
    jitted = [JA.segment_minmax(gid, vals, None, 1, m)[0] for m in ("min", "max")]
    assert [np.signbit(x) for x in host] == [True, True]
    assert [np.signbit(x) for x in jitted] == [True, False]


def test_b5_float32_sums_fold_in_float32():
    vals = np.array([1e8, 1.0, 1.0, 1.0, 1.0], dtype=np.float32)
    gid = np.zeros(5, dtype=np.int64)
    got, _ = _port_sum_count(gid, vals, None, 1)
    assert got.dtype == np.float32 and got[0] == np.float32(1e8)  # each 1.0 rounds away
    assert _bits_equal(got, JA.segment_sum_count(gid, vals, None, 1)[0])


def test_b5_uint8_sums_do_not_wrap_and_int64_sums_do():
    gid = np.zeros(2, dtype=np.int64)
    s, c = _port_sum_count(gid, np.array([200, 200], dtype=np.uint8), None, 1)
    assert int(s[0]) == 400 and int(c[0]) == 2
    s, _ = _port_sum_count(gid, np.array([2**62, 2**62], dtype=np.int64), None, 1)
    assert int(s[0]) == -(2**63)


def test_b5_empty_groups_and_no_rows():
    perm = torch.zeros(0, dtype=torch.int64)
    offs = torch.zeros(3, dtype=torch.int64)  # two empty groups
    vals = torch.zeros(0, dtype=torch.float64)
    s, c = A.segment_sum_count(perm, offs, vals, None)
    assert s.tolist() == [0.0, 0.0] and c.tolist() == [0, 0]
    mn = A.segment_minmax(perm, offs, vals, None, "min")
    mx = A.segment_minmax(perm, offs, vals, None, "max")
    assert np.isnan(mn.numpy()).all() and mx.tolist() == [-np.inf, -np.inf]
    iv = torch.zeros(0, dtype=torch.int64)
    assert A.segment_minmax(perm, offs, iv, None, "min", 7).tolist() == [7, 7]


def test_b5_wrappers_refuse_other_devices_and_shapes():
    offs = torch.tensor([0, 2], dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        A.segment_sum_count_kernel(None, offs, torch.zeros(2, dtype=torch.int64), None)
    with pytest.raises(ValueError, match="vals"):
        A.segment_minmax_kernel(None, offs, torch.zeros(3, dtype=torch.int16), None, "min", 0)
    with pytest.raises(ValueError, match="float32 and float64"):
        A.device_values(np.zeros(2, dtype=np.float16), "cpu")


@pytest.mark.parametrize("case", sorted(torch_b5_cases.B5_START_CASES))
def test_b5_fold_from_a_start_equals_np_add_at(case):
    """The float fold from a carried start (the fused filter-aggregate's
    chunk carry): group g folds its rows onto ``start[g]`` in row order,
    bit for bit ``np.add.at`` onto the start, as the reference's sweep
    carries ``acc_f``: -0.0 starts under +0.0 rows, NaN payload and
    signalling NaN starts (quieted once the group has a row), infinite
    starts, and empty groups that keep their start's bits."""
    gid, vals, valid, num, start = torch_b5_cases.B5_START_CASES[case]
    perm, offs = groups(gid, num)
    ok = None if valid is None else torch.from_numpy(valid)
    got, counts = A.segment_sum_count(perm, offs, torch.from_numpy(vals), ok,
                                      torch.from_numpy(np.asarray(start, dtype=vals.dtype)))
    want = torch_b5_cases.fold_from_start_numpy(gid, vals, valid, num, start)
    width = np.int64 if vals.dtype == np.float64 else np.int32
    assert np.array_equal(got.numpy().view(width), want.view(width))
    valid_rows = np.ones(len(gid), bool) if valid is None else valid
    assert counts.tolist() == np.bincount(gid[valid_rows], minlength=num).tolist()
    # without a start the fold is the one from +0.0, as before
    plain, _ = A.segment_sum_count(perm, offs, torch.from_numpy(vals), ok)
    zero = torch_b5_cases.fold_from_start_numpy(gid, vals, valid, num, np.zeros(num))
    assert np.array_equal(plain.numpy().view(width), zero.view(width))


def test_b5_start_is_for_the_float_fold_only():
    offs = torch.tensor([0, 2], dtype=torch.int64)
    with pytest.raises(ValueError, match="float fold"):
        A.segment_sum_count(None, offs, torch.zeros(2, dtype=torch.int64), None,
                            torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="start"):
        A.segment_sum_count(None, offs, torch.zeros(2), None, torch.zeros(2))
