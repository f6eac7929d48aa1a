"""The port's twin of ``tests/test_plan_stability.py``: the TPC-H-mini
plan-stability goldens, held for both packages at the reference's mesh
sizes (``torch_corpus_twin.twin``).

The reference's deterministic dataset (``_gen_tpch_mini``), its index
inventory (three covering indexes and a min/max data-skipping index) and
its 8 queries (``_queries``) run through each package. For each query:

* the simplified optimized plan equals the checked-in golden
  (``tests/goldstandard/<query>.txt``), read only: this test never writes
  a golden, whatever ``HS_GENERATE_GOLDEN_FILES`` says;
* the indexed rows equal the unindexed rows (for the top-n, its sort
  column, as the reference holds ties);
* the port's rows, plan text, bucket files and log entries equal the JAX
  package's, and each package serves the other's indexes.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import pytest
from golden_utils import simplify_plan
from test_plan_stability import GOLDEN_DIR, QUERY_NAMES, _gen_tpch_mini
from torch_corpus_twin import pin_mtimes, shards, sorted_table, twin  # noqa: F401


def _queries(P, s, root):
    """``test_plan_stability._queries`` in package ``P``."""
    read = lambda t: s.read.parquet(os.path.join(root, t))  # noqa: E731
    li, od, cu = read("lineitem"), read("orders"), read("customer")
    import numpy as np

    return {
        "q01_point_filter": li.filter(li["l_orderkey"] == 42).select("l_orderkey", "l_quantity"),
        "q02_range_skip": li.filter(li["l_shipdate"] >= np.datetime64("1996-06-01")).select(
            "l_shipdate", "l_quantity"),
        "q03_join": od.join(li, on=od["o_orderkey"] == li["l_orderkey"]).select(
            "o_orderkey", "o_custkey", "l_quantity"),
        "q04_join_filter": od.join(li, on=od["o_orderkey"] == li["l_orderkey"])
        .filter(od["o_custkey"] == 7).select("o_orderkey", "l_extendedprice"),
        "q05_filter_agg": li.filter(li["l_orderkey"] == 42).group_by("l_orderkey")
        .agg(P.F.sum("l_quantity").alias("qty")),
        "q06_dim_join": cu.join(od, on=cu["c_custkey"] == od["o_custkey"]).select(
            "c_custkey", "c_mktsegment", "o_totalprice"),
        "q07_topn": li.select("l_orderkey", "l_extendedprice").sort(("l_extendedprice", False)).limit(5),
        "q08_no_index": li.filter(li["l_quantity"] == 1).select("l_quantity", "l_extendedprice"),
    }


def _tpch(P, ctx):
    """The reference fixture: the dataset, its four indexes, Hyperspace on
    with the bucket spec."""
    root = ctx.path("tpch")
    os.makedirs(root)
    _gen_tpch_mini(root)
    pin_mtimes(root)
    s, hs = ctx.session, ctx.hs
    read = lambda t: s.read.parquet(os.path.join(root, t))  # noqa: E731
    li, od, cu = read("lineitem"), read("orders"), read("customer")
    hs.create_index(li, P.CoveringIndexConfig("li_okey", ["l_orderkey"], ["l_quantity", "l_extendedprice"]))
    hs.create_index(od, P.CoveringIndexConfig("od_okey", ["o_orderkey"], ["o_custkey"]))
    hs.create_index(cu, P.CoveringIndexConfig("cu_ckey", ["c_custkey"], ["c_mktsegment"]))
    hs.create_index(li, P.DataSkippingIndexConfig("li_ship_sk", P.MinMaxSketch("l_shipdate")))
    s.enable_hyperspace()
    s.conf.set(P.C.INDEX_FILTER_RULE_USE_BUCKET_SPEC, True)
    return root


@pytest.mark.parametrize("qname", QUERY_NAMES)
def test_plan_stability(qname, tmp_path, shards):
    def scenario(P, ctx):
        root = _tpch(P, ctx)
        s = ctx.session
        df = _queries(P, s, root)[qname]
        got = simplify_plan(s.optimize(df.logical_plan).pretty(), root)
        with open(os.path.join(GOLDEN_DIR, f"{qname}.txt")) as f:
            assert got == f.read(), f"plan of {qname} differs from its golden file"
        with_idx = df.collect()
        s.disable_hyperspace()
        base = df.collect()
        s.enable_hyperspace()
        if qname == "q07_topn":
            assert with_idx.column("l_extendedprice").to_pylist() == base.column("l_extendedprice").to_pylist()
        else:
            assert sorted_table(with_idx).equals(sorted_table(base))
        ctx.cross(lambda P, s: _queries(P, s, root)[qname])
        return {"plan": got, "with": with_idx, "without": base}

    twin(tmp_path, scenario, shards)


def test_corpus_is_the_reference_corpus():
    assert QUERY_NAMES == sorted(QUERY_NAMES) and len(QUERY_NAMES) == 8
    for q in QUERY_NAMES:
        assert os.path.isfile(os.path.join(GOLDEN_DIR, f"{q}.txt"))
