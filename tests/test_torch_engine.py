"""The port's twin of ``tests/test_engine.py``: expressions, the device
filter and the executor, each case through both packages on the same
input.

The expression cases evaluate each predicate with both packages' host
evaluators over one batch; the device-filter cases hold the port's
device mask (on the CPU) to its host evaluator and to the JAX package's
device mask; the executor cases run scans, filters, joins and csv
through both packages' sessions (``torch_corpus_twin.twin``, at the
reference's mesh sizes) and keep the reference's pyarrow and Python
oracles. Rows are compared in order, floats bit for bit.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import collections
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
from torch_corpus_twin import JAX, PORT, rows_of, sample_parquet, shards, twin, write  # noqa: F401

TABLE = pa.table({
    "k": pa.array([1, 2, None, 4, 5], type=pa.int64()),
    "v": pa.array([10.0, 20.0, 30.0, None, 50.0]),
    "s": pa.array(["b", "a", "c", None, "b"]),
})


def _both(build):
    """``build(E)`` evaluated by each package's host evaluator over TABLE:
    the port's kept rows, held equal to the JAX package's."""
    out = []
    for P in (PORT, JAX):
        batch = P.ColumnarBatch.from_arrow(TABLE)
        out.append(rows_of(P.E.filter_mask(build(P.E), batch)))
    assert out[0] == out[1], out
    return out[0]


# -- TestExpressions ----------------------------------------------------------------


def test_numeric_comparisons():
    assert _both(lambda E: E.Col("k") > 1) == [1, 3, 4]
    assert _both(lambda E: E.Col("k") == 4) == [3]
    assert _both(lambda E: E.Col("k") <= 2) == [0, 1]
    assert _both(lambda E: E.Col("k") != 2) == [0, 3, 4]


def test_null_semantics():
    assert _both(lambda E: ~(E.Col("k") > 1)) == [0]
    assert _both(lambda E: E.IsNull(E.Col("k"))) == [2]
    assert _both(lambda E: E.Col("k").is_not_null()) == [0, 1, 3, 4]
    assert _both(lambda E: (E.Col("k") > 1) | (E.Col("v") > 0.0)) == [0, 1, 2, 3, 4]
    assert _both(lambda E: (E.Col("k") > 1) & (E.Col("v") > 0.0)) == [1, 4]


def test_string_comparisons():
    assert _both(lambda E: E.Col("s") == "b") == [0, 4]
    assert _both(lambda E: E.Col("s") != "b") == [1, 2]
    assert _both(lambda E: E.Col("s") < "b") == [1]
    assert _both(lambda E: E.Col("s") >= "b") == [0, 2, 4]
    assert _both(lambda E: E.Col("s") == "zz") == []
    assert _both(lambda E: E.Col("s") <= "aa") == [1]


def test_in():
    assert _both(lambda E: E.Col("k").isin(1, 5, 99)) == [0, 4]
    assert _both(lambda E: E.Col("s").isin("a", "c", "zz")) == [1, 2]


def test_references_and_conjuncts():
    for P in (PORT, JAX):
        E = P.E
        e = (E.Col("a") > 1) & (E.Col("b") == E.Col("c"))
        assert E.references(e) == {"a", "b", "c"}
        assert len(E.split_conjuncts(e)) == 2
        assert E.equi_join_pairs(E.Col("x") == E.Col("y")) == [("x", "y")]
        assert E.equi_join_pairs(E.Col("x") > E.Col("y")) is None
    mine = (PORT.E.Col("a") > 1) & (PORT.E.Col("b") == PORT.E.Col("c"))
    ref = (JAX.E.Col("a") > 1) & (JAX.E.Col("b") == JAX.E.Col("c"))
    assert repr(mine) == repr(ref)


def test_expr_bool_raises():
    for P in (PORT, JAX):
        with pytest.raises(TypeError):
            bool(P.E.Col("a") == P.E.Col("b"))


# -- TestDeviceFilter ----------------------------------------------------------------

EXPRS = [
    lambda E: E.Col("k") > 1,
    lambda E: E.Col("k") == 4,
    lambda E: ~(E.Col("k") > 1),
    lambda E: (E.Col("k") > 1) | (E.Col("v") > 0.0),
    lambda E: (E.Col("k") > 1) & (E.Col("v") > 0.0),
    lambda E: E.Col("s") == "b",
    lambda E: E.Col("s") < "b",
    lambda E: E.Col("s") >= "b",
    lambda E: E.Col("s") == "zz",
    lambda E: E.Col("k").isin(1, 5, 99),
    lambda E: E.Col("s").isin("a", "c", "zz"),
    lambda E: E.IsNull(E.Col("k")),
    lambda E: E.Col("k").is_not_null() & (E.Col("s") != "b"),
    lambda E: E.Col("k") == E.Col("k"),
]


@pytest.mark.parametrize("mk", EXPRS, ids=[f"expr{i}" for i in range(len(EXPRS))])
def test_device_matches_host(mk):
    masks = {}
    for P in (PORT, JAX):
        batch = P.ColumnarBatch.from_arrow(TABLE)
        e = mk(P.E)
        host = np.asarray(P.E.filter_mask(e, batch))
        dev = P.device_mask(e, batch)
        np.testing.assert_array_equal(dev, host)
        masks[P.name] = dev
    assert masks["port"].tolist() == masks["jax"].tolist()


# -- TestExecutor ----------------------------------------------------------------------


def two_tables(root):
    rng = np.random.default_rng(7)
    n1, n2 = 500, 300
    orders = pa.table({
        "o_key": pa.array(rng.integers(0, 100, n1), type=pa.int64()),
        "o_val": pa.array(rng.normal(size=n1)),
        "o_tag": pa.array([f"t{int(x) % 5}" for x in rng.integers(0, 100, n1)]),
    })
    items = pa.table({
        "l_key": pa.array(rng.integers(0, 100, n2), type=pa.int64()),
        "l_qty": pa.array(rng.integers(1, 50, n2), type=pa.int64()),
    })
    d1, d2 = os.path.join(root, "orders"), os.path.join(root, "items")
    write(os.path.join(d1, "part-0.parquet"), orders)
    write(os.path.join(d2, "part-0.parquet"), items)
    return d1, d2, orders, items


def test_scan_collect(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(sample_parquet(ctx.root))
        out = df.collect()
        assert out.num_rows == 300
        assert set(df.columns) == {"date", "rguid", "clicks", "query", "imprs"}
        return {"columns": list(df.columns), "rows": out}

    twin(tmp_path, scenario, shards)


def test_filter_project_differential(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(sample_parquet(ctx.root))
        got = df.filter((df["clicks"] > 500) & (df["query"] == "banana")).select("clicks", "imprs").collect()
        raw = df.collect()
        want = raw.filter(pc.and_(pc.greater(raw.column("clicks"), 500),
                                  pc.equal(raw.column("query"), "banana"))).select(["clicks", "imprs"])
        assert got.sort_by("clicks").equals(want.sort_by("clicks")) and got.num_rows > 0
        return got

    twin(tmp_path, scenario, shards)


def test_join_differential(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2, orders, items = two_tables(ctx.root)
        dfo, dfi = ctx.session.read.parquet(d1), ctx.session.read.parquet(d2)
        got = dfo.join(dfi, on=dfo["o_key"] == dfi["l_key"]).select("o_key", "l_qty").collect()
        right = collections.defaultdict(list)
        for k, q in zip(items.column("l_key").to_pylist(), items.column("l_qty").to_pylist()):
            right[k].append(q)
        want = [(k, q) for k in orders.column("o_key").to_pylist() for q in right.get(k, [])]
        pairs = sorted(zip(got.column("o_key").to_pylist(), got.column("l_qty").to_pylist()))
        assert pairs == sorted(want) and len(pairs) > 0
        return got

    twin(tmp_path, scenario, shards)


def test_string_filter_differential(tmp_path, shards):
    def scenario(P, ctx):
        d1, _d2, orders, _items = two_tables(ctx.root)
        dfo = ctx.session.read.parquet(d1)
        got = dfo.filter(dfo["o_tag"] == "t3").count()
        assert got == orders.filter(pc.equal(orders.column("o_tag"), "t3")).num_rows
        return got

    twin(tmp_path, scenario, shards)


def test_string_key_join(tmp_path, shards):
    def scenario(P, ctx):
        write(ctx.path("a", "p.parquet"), pa.table({"tag_a": ["x", "y", "z", "x"], "va": [1, 2, 3, 4]}))
        write(ctx.path("b", "p.parquet"), pa.table({"tag_b": ["x", "x", "q"], "vb": [10, 20, 30]}))
        dfa, dfb = ctx.session.read.parquet(ctx.path("a")), ctx.session.read.parquet(ctx.path("b"))
        got = dfa.join(dfb, on=dfa["tag_a"] == dfb["tag_b"]).collect()
        pairs = sorted(zip(got.column("va").to_pylist(), got.column("vb").to_pylist()))
        assert pairs == [(1, 10), (1, 20), (4, 10), (4, 20)]
        return got

    twin(tmp_path, scenario, shards)


def test_csv_scan(tmp_path, shards):
    def scenario(P, ctx):
        os.makedirs(ctx.path("c"))
        with open(ctx.path("c", "a.csv"), "w") as f:
            f.write("x,y\n1,a\n2,b\n3,a\n")
        df = ctx.session.read.csv(ctx.path("c"))
        filtered = df.filter(df["y"] == "a")
        assert filtered.count() == 2
        return filtered.collect()

    twin(tmp_path, scenario, shards)


def test_empty_result(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(sample_parquet(ctx.root))
        out = df.filter(df["clicks"] > 10**9).select("clicks").collect()
        assert out.num_rows == 0
        return out

    twin(tmp_path, scenario, shards)
