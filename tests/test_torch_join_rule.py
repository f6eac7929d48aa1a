"""The port's twin of ``tests/test_join_rule.py``: the join index rule's
rewrites and eligibility, each case through both packages
(``torch_corpus_twin.twin``) at the reference's mesh sizes.

Each case keeps the reference's asserts (both sides rewritten, or none;
indexed rows equal the unindexed run's; a Hybrid Scan side; string and
composite keys with nulls; no lineage column leaked; a real INT64_MAX key
not taken for padding) and holds the port to the JAX package: plans,
rows in order (B4's plain version on the CPU), bucket files byte for
byte, log entries, and each package serving the other's indexes.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
from torch_corpus_twin import JAX, PORT, shards, sorted_table, twin, write  # noqa: F401


def join_tables(ctx):
    rng = np.random.default_rng(11)
    n1, n2 = 400, 600
    orders = pa.table({
        "o_key": pa.array(rng.integers(0, 80, n1), type=pa.int64()),
        "o_amount": pa.array(rng.normal(100, 20, n1)),
        "o_tag": pa.array([f"t{int(x) % 4}" for x in rng.integers(0, 99, n1)]),
    })
    items = pa.table({
        "l_key": pa.array(rng.integers(0, 80, n2), type=pa.int64()),
        "l_qty": pa.array(rng.integers(1, 9, n2), type=pa.int64()),
    })
    d1, d2 = ctx.path("orders"), ctx.path("items")
    for i in range(2):
        write(os.path.join(d1, f"p{i}.parquet"), orders.slice(i * 200, 200))
    for i in range(3):
        write(os.path.join(d2, f"p{i}.parquet"), items.slice(i * 200, 200))
    return d1, d2


def _mk_indexes(P, ctx, d1, d2):
    s = ctx.session
    dfo, dfi = s.read.parquet(d1), s.read.parquet(d2)
    ctx.hs.create_index(dfo, P.CoveringIndexConfig("o_idx", ["o_key"], ["o_amount"]))
    ctx.hs.create_index(dfi, P.CoveringIndexConfig("l_idx", ["l_key"], ["l_qty"]))
    return dfo, dfi


def _differential(P, ctx, q, n_indexed=2):
    """q's plan with Hyperspace on, its rows on and off (equal as sets);
    q is registered for the other package to serve."""
    s = ctx.session
    s.disable_hyperspace()
    base = q(P, s).collect()
    s.enable_hyperspace()
    plan = q(P, s).explain()
    assert plan.count("Hyperspace(Type: CI") == n_indexed, plan
    got = q(P, s).collect()
    assert sorted_table(got).equals(sorted_table(base))
    ctx.cross(q)
    return {"plan": plan, "got": got, "base": base}


def test_join_rewritten_both_sides_and_matches(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2 = join_tables(ctx)
        _mk_indexes(P, ctx, d1, d2)

        def q(P, s):
            o, i = s.read.parquet(d1), s.read.parquet(d2)
            return o.join(i, on=o["o_key"] == i["l_key"]).select("o_key", "o_amount", "l_qty")

        out = _differential(P, ctx, q)
        assert "o_idx" in out["plan"] and "l_idx" in out["plan"] and out["got"].num_rows > 0
        return out

    twin(tmp_path, scenario, shards)


def test_join_with_filter_sides(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2 = join_tables(ctx)
        _mk_indexes(P, ctx, d1, d2)

        def q(P, s):
            o, i = s.read.parquet(d1), s.read.parquet(d2)
            return o.filter(o["o_key"] > 10).join(i, on=o["o_key"] == i["l_key"]).select("o_key", "l_qty")

        return _differential(P, ctx, q)

    twin(tmp_path, scenario, shards)


def test_join_not_rewritten_when_columns_uncovered(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2 = join_tables(ctx)
        dfo, dfi = _mk_indexes(P, ctx, d1, d2)
        ctx.session.enable_hyperspace()
        q = dfo.join(dfi, on=dfo["o_key"] == dfi["l_key"]).select("o_key", "o_tag", "l_qty")
        plan = q.explain()
        assert "Hyperspace" not in plan
        return {"plan": plan, "rows": q.collect()}

    twin(tmp_path, scenario, shards)


def test_join_not_rewritten_when_index_on_wrong_column(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2 = join_tables(ctx)
        s, hs = ctx.session, ctx.hs
        dfo, dfi = s.read.parquet(d1), s.read.parquet(d2)
        hs.create_index(dfo, P.CoveringIndexConfig("o_bad", ["o_amount"], ["o_key"]))
        hs.create_index(dfi, P.CoveringIndexConfig("l_idx", ["l_key"], ["l_qty"]))
        s.enable_hyperspace()
        q = dfo.join(dfi, on=dfo["o_key"] == dfi["l_key"]).select("o_key", "o_amount", "l_qty")
        plan = q.explain()
        assert "Hyperspace" not in plan
        return {"plan": plan, "rows": q.collect()}

    twin(tmp_path, scenario, shards)


def test_join_beats_filter_rule_on_score(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2 = join_tables(ctx)
        _mk_indexes(P, ctx, d1, d2)

        def q(P, s):
            o, i = s.read.parquet(d1), s.read.parquet(d2)
            return o.filter(o["o_key"] > 0).join(i, on=o["o_key"] == i["l_key"]).select("o_key", "l_qty")

        return _differential(P, ctx, q)

    twin(tmp_path, scenario, shards)


def test_join_hybrid_appended_rows(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2 = join_tables(ctx)
        _mk_indexes(P, ctx, d1, d2)
        write(os.path.join(d2, "extra.parquet"), pa.table({
            "l_key": pa.array([5, 7, 7], type=pa.int64()), "l_qty": pa.array([100, 200, 300], type=pa.int64())}))
        ctx.session.conf.set(P.C.INDEX_HYBRID_SCAN_ENABLED, True)
        ctx.session.index_manager.clear_cache()

        def q(P, s):
            o, i = s.read.parquet(d1), s.read.parquet(d2)
            return o.join(i, on=o["o_key"] == i["l_key"]).select("o_key", "l_qty")

        out = _differential(P, ctx, q)
        assert "Union" in out["plan"] and 300 in out["got"].column("l_qty").to_pylist()
        return out

    twin(tmp_path, scenario, shards)


def test_string_key_join_with_index(tmp_path, shards):
    def scenario(P, ctx):
        write(ctx.path("a", "p.parquet"), pa.table({"tag_a": ["x", "y", "z", "x", "w"], "va": [1, 2, 3, 4, 5]}))
        write(ctx.path("b", "p.parquet"), pa.table({"tag_b": ["x", "x", "q", "z"], "vb": [10, 20, 30, 40]}))
        s, hs = ctx.session, ctx.hs
        hs.create_index(s.read.parquet(ctx.path("a")), P.CoveringIndexConfig("a_idx", ["tag_a"], ["va"]))
        hs.create_index(s.read.parquet(ctx.path("b")), P.CoveringIndexConfig("b_idx", ["tag_b"], ["vb"]))

        def q(P, s):
            a, b = s.read.parquet(ctx.path("a")), s.read.parquet(ctx.path("b"))
            return a.join(b, on=a["tag_a"] == b["tag_b"]).select("va", "vb")

        out = _differential(P, ctx, q)
        pairs = sorted(zip(out["got"].column("va").to_pylist(), out["got"].column("vb").to_pylist()))
        assert pairs == [(1, 10), (1, 20), (3, 40), (4, 10), (4, 20)]
        return out

    twin(tmp_path, scenario, shards)


def test_join_with_lineage_does_not_leak_lineage_column(tmp_path, shards):
    def scenario(P, ctx):
        d1, d2 = join_tables(ctx)
        s, hs = ctx.session, ctx.hs
        s.conf.set(P.C.INDEX_LINEAGE_ENABLED, True)
        hs.create_index(s.read.parquet(d1), P.CoveringIndexConfig("o_idx", ["o_key"], ["o_amount", "o_tag"]))
        hs.create_index(s.read.parquet(d2), P.CoveringIndexConfig("l_idx", ["l_key"], ["l_qty"]))

        def q(P, s):
            o, i = s.read.parquet(d1), s.read.parquet(d2)
            return o.join(i, on=o["o_key"] == i["l_key"])

        out = _differential(P, ctx, q)
        assert P.C.DATA_FILE_NAME_ID not in out["got"].column_names
        assert set(out["got"].column_names) == {"o_key", "o_amount", "o_tag", "l_key", "l_qty"}
        return out

    twin(tmp_path, scenario, shards)


def test_multi_key_join_with_nulls_device_path(tmp_path, shards):
    def scenario(P, ctx):
        s, hs = ctx.session, ctx.hs
        s.conf.set(P.C.EXECUTION_DEVICE_JOIN_MIN_ROWS, 0)
        rng = np.random.default_rng(23)
        n1, n2 = 300, 500
        write(ctx.path("a", "p.parquet"), pa.table({
            "k1": pa.array([None if i % 17 == 0 else int(x) for i, x in enumerate(rng.integers(0, 12, n1))],
                           type=pa.int64()),
            "k2": pa.array(rng.integers(0, 5, n1), type=pa.int64()),
            "va": pa.array(rng.normal(size=n1))}))
        write(ctx.path("b", "p.parquet"), pa.table({
            "j1": pa.array([None if i % 13 == 0 else int(x) for i, x in enumerate(rng.integers(0, 12, n2))],
                           type=pa.int64()),
            "j2": pa.array(rng.integers(0, 5, n2), type=pa.int64()),
            "vb": pa.array(rng.integers(0, 100, n2), type=pa.int64())}))
        hs.create_index(s.read.parquet(ctx.path("a")), P.CoveringIndexConfig("ab_idx", ["k1", "k2"], ["va"]))
        hs.create_index(s.read.parquet(ctx.path("b")), P.CoveringIndexConfig("bb_idx", ["j1", "j2"], ["vb"]))

        def q(P, s):
            l, r = s.read.parquet(ctx.path("a")), s.read.parquet(ctx.path("b"))
            return l.join(r, on=(l["k1"] == r["j1"]) & (l["k2"] == r["j2"])).select("k1", "k2", "va", "vb")

        out = _differential(P, ctx, q)
        assert not any(v is None for v in out["got"].column("k1").to_pylist())
        return out

    twin(tmp_path, scenario, shards)


def test_join_key_equal_to_pad_sentinel():
    MAX = (1 << 63) - 1
    out = []
    for P in (PORT, JAX):
        left = P.ColumnarBatch.from_arrow(pa.table({"k": pa.array([1, MAX, 5], type=pa.int64()), "a": [10, 20, 30]}))
        right = P.ColumnarBatch.from_arrow(pa.table({"j": pa.array([MAX, 5, MAX], type=pa.int64()), "b": [1, 2, 3]}))
        got = P.co_bucketed_join({0: left}, {0: right}, [("k", "j")]).to_arrow()
        rows = sorted(zip(got.column("k").to_pylist(), got.column("b").to_pylist()))
        assert rows == [(5, 2), (MAX, 1), (MAX, 3)]
        out.append(got)
    assert out[0].equals(out[1])
