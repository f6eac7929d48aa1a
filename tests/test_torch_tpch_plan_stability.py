"""The 22 TPC-H queries through the port's SQL, against the goldens.

The port's twin of ``tests/test_tpch_plan_stability.py``: the same
deterministic TPC-H-shaped dataset (``_gen_tpch``), the same index
inventory and the same 22 SQL strings (``QUERIES``), imported from the
reference's test module. For each query:

* the port's simplified plans, with and without indexes, equal the
  checked-in golden file (read only: this test never writes goldens,
  whatever ``HS_GENERATE_GOLDEN_FILES`` says);
* the port's indexed rows equal its unindexed rows (float aggregates with
  the reference test's tolerance, since the index feeds the reduction
  in another row order);
* both equal the JAX package's rows on the same query, in order and bit
  for bit.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pytest
from golden_utils import simplify_plan
from test_tpch_plan_stability import GOLDEN_DIR, QUERIES, _gen_tpch
from torch_b5_cases import same_rows

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes import covering as JCov
from hyperspace_tpu.indexes import dataskipping as JDs
from hyperspace_tpu.indexes import sketches as JSk
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch.indexes import sketches as TSk

VIEWS = (
    "region", "nation", "nation2", "supplier", "customer",
    "part", "partsupp", "orders", "lineitem",
)

#: the reference fixture's index inventory: (name, view, indexed, included)
COVERING = (
    ("li_okey", "lineitem", ["l_orderkey"],
     ["l_quantity", "l_extendedprice", "l_shipdate", "l_commitdate",
      "l_receiptdate", "l_shipmode", "l_returnflag"]),
    ("li_pkey", "lineitem", ["l_partkey"], ["l_quantity", "l_extendedprice", "l_shipdate"]),
    ("li_skey", "lineitem", ["l_suppkey"],
     ["l_orderkey", "l_extendedprice", "l_shipdate", "l_receiptdate", "l_commitdate"]),
    ("od_okey", "orders", ["o_orderkey"],
     ["o_custkey", "o_orderdate", "o_totalprice", "o_orderpriority", "o_orderstatus"]),
    ("od_ckey", "orders", ["o_custkey"], ["o_orderkey", "o_orderdate", "o_totalprice"]),
    ("cu_ckey", "customer", ["c_custkey"], ["c_name", "c_nationkey", "c_mktsegment", "c_acctbal"]),
    ("pt_pkey", "part", ["p_partkey"], ["p_brand", "p_type", "p_size", "p_container"]),
    ("ps_pkey", "partsupp", ["ps_partkey"], ["ps_suppkey", "ps_supplycost"]),
    ("ps_skey", "partsupp", ["ps_suppkey"], ["ps_partkey", "ps_supplycost"]),
    ("sp_skey", "supplier", ["s_suppkey"], ["s_name", "s_nationkey", "s_acctbal"]),
)
SKETCHES = (("li_ship_sk", "lineitem", "l_shipdate"), ("od_date_sk", "orders", "o_orderdate"))


def _setup(session, hs, root, covering_cls, ds_cls, minmax_cls):
    views = {}
    for name in VIEWS:
        df = session.read.parquet(os.path.join(root, name))
        session.register_view(name, df)
        views[name] = df
    for name, view, indexed, included in COVERING:
        hs.create_index(views[view], covering_cls(name, indexed, included))
    for name, view, col in SKETCHES:
        hs.create_index(views[view], ds_cls(name, minmax_cls(col)))
    session.enable_hyperspace()


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch"))
    _gen_tpch(root)
    t = T.HyperspaceSession(device="cpu")
    j = JSession()
    for s, C in ((t, T.constants), (j, JC)):
        s.conf.set(C.INDEX_SYSTEM_PATH, os.path.join(root, "_indexes"))
        s.conf.set(C.INDEX_NUM_BUCKETS, 4)
        s.conf.set(C.INDEX_FILTER_RULE_USE_BUCKET_SPEC, True)
    # the JAX package on its own system path, built on one shard as the port
    j.conf.set(JC.INDEX_SYSTEM_PATH, os.path.join(root, "jax", "_indexes"))
    j.conf.set(JC.BUILD_NUM_SHARDS, 1)
    _setup(t, T.Hyperspace(t), root, T.CoveringIndexConfig, T.DataSkippingIndexConfig,
           TSk.MinMaxSketch)
    _setup(j, JHyperspace(j), root, JCov.CoveringIndexConfig, JDs.DataSkippingIndexConfig,
           JSk.MinMaxSketch)
    return {"t": t, "j": j, "root": root}


def _with_and_without(session, fn):
    out = fn()
    session.disable_hyperspace()
    try:
        return out, fn()
    finally:
        session.enable_hyperspace()


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_tpch_plan_stability(qname, tpch):
    t, j, root = tpch["t"], tpch["j"], tpch["root"]
    df = t.sql(QUERIES[qname])
    with_idx_plan, raw_plan = _with_and_without(
        t, lambda: simplify_plan(t.optimize(df.logical_plan).pretty(), root)
    )
    got = (
        "=== with indexes ===\n" + with_idx_plan + "\n"
        "=== without indexes ===\n" + raw_plan + "\n"
    )
    with open(os.path.join(GOLDEN_DIR, f"{qname}.txt")) as f:
        assert got == f.read(), f"plan of {qname} differs from its golden file"
    with_idx, base = _with_and_without(t, df.collect)
    key = lambda tb: tb.sort_by([(c, "ascending") for c in tb.column_names])
    a, b = key(with_idx), key(base)
    assert a.num_rows == b.num_rows and a.column_names == b.column_names, qname
    for col in a.column_names:
        av, bv = a.column(col), b.column(col)
        if pa.types.is_floating(av.type):
            assert np.allclose(
                av.to_numpy(zero_copy_only=False),
                bv.to_numpy(zero_copy_only=False),
                rtol=1e-9,
                equal_nan=True,
            ), (qname, col)
        else:
            assert av.equals(bv), (qname, col)
    jdf = j.sql(QUERIES[qname])
    assert df.logical_plan.pretty() == jdf.logical_plan.pretty()
    j_idx, j_base = _with_and_without(j, jdf.collect)
    assert same_rows(with_idx, j_idx), qname
    assert same_rows(base, j_base), qname


def test_corpus_is_the_reference_corpus():
    assert sorted(QUERIES) == [f"q{i:02d}" for i in range(1, 23)]
    assert sorted(os.listdir(GOLDEN_DIR)) == [f"q{i:02d}.txt" for i in range(1, 23)]
