"""The port's twin of ``tests/test_e2e_covering.py``: the covering index
end to end (create, plan rewrite, serve), each case through both packages
(``torch_corpus_twin.twin``) at the reference's mesh sizes.

Each case keeps the reference's asserts (the listing, bucketed and sorted
files, the create's errors, rewrites taken and refused, the bucket-pruned
point and IN filters, Hybrid Scan and its appended-ratio limit, the
maintenance guard) and holds the port to the JAX package: listings,
plans, rows, error messages, the files the pruned scan keeps, bucket
files byte for byte and log entries; where an index serves, each package
serves the other's. The bucket-pruned scan takes the session in the port
(``_bucket_pruned_scan(scan, cond, session)``); the twin passes it.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_corpus_twin import sample_parquet, shards, sorted_table, twin, write  # noqa: F401


def _idx1(P, ctx, indexed=("clicks",), included=("query",), name="idx1"):
    src = sample_parquet(ctx.root)
    df = ctx.session.read.parquet(src)
    ctx.hs.create_index(df, P.CoveringIndexConfig(name, list(indexed), list(included)))
    return src, df


def _served(P, ctx, q, name):
    """q served with the index (the plan names it) equals q without; q is
    registered for the other package to serve."""
    s = ctx.session
    s.disable_hyperspace()
    without = q(P, s).collect()
    s.enable_hyperspace()
    plan = q(P, s).explain()
    assert f"Hyperspace(Type: CI, Name: {name}" in plan, plan
    got = q(P, s).collect()
    assert sorted_table(got).equals(sorted_table(without))
    ctx.cross(q)
    return {"plan": plan, "got": got, "without": without}


# -- TestCreateIndex ---------------------------------------------------------------


def test_create_and_list(tmp_path, shards):
    def scenario(P, ctx):
        _idx1(P, ctx)
        listing = ctx.hs.indexes()
        assert listing.num_rows == 1
        assert listing.column("name").to_pylist() == ["idx1"]
        assert listing.column("state").to_pylist() == [P.States.ACTIVE]
        assert listing.column("indexedColumns").to_pylist() == ["clicks"]
        return listing

    twin(tmp_path, scenario, shards)


def test_create_writes_bucketed_sorted_files(tmp_path, shards):
    def scenario(P, ctx):
        _idx1(P, ctx)
        files = ctx.session.index_manager.get_index_log_entry("idx1").content.files
        assert files
        total, buckets = 0, []
        for f in sorted(files):
            b = P.pio.bucket_id_of_file(f)
            assert b is not None and 0 <= b < 8
            t = pq.read_table(f)
            total += t.num_rows
            clicks = t.column("clicks").to_pylist()
            assert clicks == sorted(clicks)
            buckets.append((os.path.relpath(f, ctx.root), b, t.num_rows))
        assert total == 300
        return buckets

    twin(tmp_path, scenario, shards)


def test_create_duplicate_fails(tmp_path, shards):
    def scenario(P, ctx):
        src, df = _idx1(P, ctx, included=())
        with pytest.raises(P.HyperspaceException, match="already exists") as e:
            ctx.hs.create_index(df, P.CoveringIndexConfig("idx1", ["clicks"]))
        return str(e.value)

    twin(tmp_path, scenario, shards)


def test_create_case_insensitive_columns(tmp_path, shards):
    def scenario(P, ctx):
        _idx1(P, ctx, indexed=("CLICKS",), included=("Query",))
        entry = ctx.session.index_manager.get_index_log_entry("idx1")
        assert entry.derived_dataset.indexed_columns == ["clicks"]
        return [entry.derived_dataset.indexed_columns, entry.derived_dataset.included_columns]

    twin(tmp_path, scenario, shards)


def test_create_unresolvable_column_fails(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(sample_parquet(ctx.root))
        with pytest.raises(P.HyperspaceException, match="resolved") as e:
            ctx.hs.create_index(df, P.CoveringIndexConfig("idx1", ["nope"]))
        return str(e.value)

    twin(tmp_path, scenario, shards)


# -- TestFilterIndexServe -----------------------------------------------------------


def test_filter_query_uses_index_and_matches(tmp_path, shards):
    def scenario(P, ctx):
        src, _df = _idx1(P, ctx)

        def q(P, s):
            d = s.read.parquet(src)
            return d.filter(d["clicks"] >= 500).select("clicks", "query")

        out = _served(P, ctx, q, "idx1")
        assert out["got"].num_rows > 0
        return out

    twin(tmp_path, scenario, shards)


def test_filter_not_rewritten_when_first_col_missing(tmp_path, shards):
    def scenario(P, ctx):
        _src, df = _idx1(P, ctx)
        ctx.session.enable_hyperspace()
        plan = df.filter(df["query"] == "banana").select("query", "clicks").explain()
        assert "Hyperspace" not in plan
        return plan

    twin(tmp_path, scenario, shards)


def test_filter_not_rewritten_when_columns_uncovered(tmp_path, shards):
    def scenario(P, ctx):
        _src, df = _idx1(P, ctx)
        ctx.session.enable_hyperspace()
        plan = df.filter(df["clicks"] == 5).select("clicks", "imprs").explain()
        assert "Hyperspace" not in plan
        return plan

    twin(tmp_path, scenario, shards)


def test_source_change_invalidates_index(tmp_path, shards):
    def scenario(P, ctx):
        src, _df = _idx1(P, ctx)
        write(os.path.join(src, "part-new.parquet"), pa.table({
            "date": ["2018-01-01"] * 5, "rguid": [f"g{i}" for i in range(5)],
            "clicks": pa.array([9991, 9992, 9993, 9994, 9995], pa.int64()), "query": ["new"] * 5,
            "imprs": pa.array([1, 2, 3, 4, 5], pa.int64())}))
        s = ctx.session
        s.enable_hyperspace()
        s.index_manager.clear_cache()
        df2 = s.read.parquet(src)
        q = df2.filter(df2["clicks"] >= 9000).select("clicks", "query")
        plan = q.explain()
        assert "Hyperspace" not in plan
        out = q.collect()
        assert out.num_rows == 5
        return {"plan": plan, "rows": out}

    twin(tmp_path, scenario, shards)


def test_rewrite_disabled_flag(tmp_path, shards):
    def scenario(P, ctx):
        _src, df = _idx1(P, ctx)
        ctx.session.enable_hyperspace()
        ctx.session.conf.set(P.C.HYPERSPACE_APPLY_ENABLED, False)
        plan = df.filter(df["clicks"] > 1).select("clicks").explain()
        assert "Hyperspace" not in plan
        return plan

    twin(tmp_path, scenario, shards)


def _pruned(P, ctx, q):
    """The optimized plan's Filter over the index Scan, and the files the
    bucket-pruned scan keeps (fewer than the index has)."""
    s = ctx.session
    node = s.optimize(q(P, s).logical_plan)
    while not isinstance(node, P.nodes.Filter):
        node = node.child
    assert isinstance(node.child, P.nodes.Scan)
    assert node.child.relation.bucket_spec is not None
    pruned = P.bucket_pruned_scan(node.child, node.condition, s)
    assert len(pruned.relation.files) < len(node.child.relation.files)
    return [os.path.relpath(f, ctx.root) for f in pruned.relation.files]


def test_bucket_pruned_point_filter(tmp_path, shards):
    def scenario(P, ctx):
        src, df = _idx1(P, ctx)
        s = ctx.session
        s.conf.set(P.C.INDEX_FILTER_RULE_USE_BUCKET_SPEC, True)
        s.enable_hyperspace()
        key = int(df.collect().column("clicks")[0].as_py())

        def q(P, s):
            d = s.read.parquet(src)
            return d.filter(d["clicks"] == key).select("clicks", "query")

        kept = _pruned(P, ctx, q)
        out = _served(P, ctx, q, "idx1")
        assert out["got"].num_rows > 0
        return {"kept": kept, **out}

    twin(tmp_path, scenario, shards)


def test_bucket_pruned_in_filter(tmp_path, shards):
    def scenario(P, ctx):
        src, _df = _idx1(P, ctx, indexed=("query",), included=("clicks",), name="idx_s")
        s = ctx.session
        s.conf.set(P.C.INDEX_FILTER_RULE_USE_BUCKET_SPEC, True)
        s.enable_hyperspace()

        def q(P, s):
            d = s.read.parquet(src)
            return d.filter(d["query"].isin("banana", "donde")).select("query", "clicks")

        kept = _pruned(P, ctx, q)
        out = _served(P, ctx, q, "idx_s")
        assert out["got"].num_rows > 0
        return {"kept": kept, **out}

    twin(tmp_path, scenario, shards)


def test_string_indexed_column(tmp_path, shards):
    def scenario(P, ctx):
        src, _df = _idx1(P, ctx, indexed=("query",), included=("clicks",), name="idx_s")

        def q(P, s):
            d = s.read.parquet(src)
            return d.filter(d["query"] == "banana").select("query", "clicks")

        return _served(P, ctx, q, "idx_s")

    twin(tmp_path, scenario, shards)


# -- TestHybridScan -------------------------------------------------------------------


def test_appended_files_served_hybrid(tmp_path, shards):
    def scenario(P, ctx):
        src, _df = _idx1(P, ctx)
        write(os.path.join(src, "part-extra.parquet"), pa.table({
            "date": ["2018-01-01"] * 3, "rguid": ["a", "b", "c"],
            "clicks": pa.array([700, 701, 702], pa.int64()), "query": ["hybrid"] * 3,
            "imprs": pa.array([1, 2, 3], pa.int64())}))
        s = ctx.session
        s.conf.set(P.C.INDEX_HYBRID_SCAN_ENABLED, True)
        s.enable_hyperspace()
        s.index_manager.clear_cache()

        def q(P, s):
            d = s.read.parquet(src)
            return d.filter(d["clicks"] >= 500).select("clicks", "query")

        out = _served(P, ctx, q, "idx1")
        assert "Union" in out["plan"] and "hybrid" in out["got"].column("query").to_pylist()
        return out

    twin(tmp_path, scenario, shards)


def test_too_much_appended_rejected(tmp_path, shards):
    def scenario(P, ctx):
        src, df = _idx1(P, ctx)
        raw = df.collect()
        for i in range(9):
            write(os.path.join(src, f"big-{i}.parquet"), raw)
        s = ctx.session
        s.conf.set(P.C.INDEX_HYBRID_SCAN_ENABLED, True)
        s.enable_hyperspace()
        s.index_manager.clear_cache()
        df2 = s.read.parquet(src)
        plan = df2.filter(df2["clicks"] >= 500).select("clicks", "query").explain()
        assert "Hyperspace" not in plan
        return plan

    twin(tmp_path, scenario, shards)


# -- TestMaintenanceGuard -------------------------------------------------------------


def test_create_index_not_rewritten_by_own_index(tmp_path, shards):
    def scenario(P, ctx):
        src, df = _idx1(P, ctx)
        ctx.session.enable_hyperspace()
        ctx.hs.create_index(df, P.CoveringIndexConfig("idx2", ["clicks"], ["query"]))
        roots = ctx.session.index_manager.get_index_log_entry("idx2").relation.root_paths
        assert any(src in p for p in roots)
        return list(roots)

    twin(tmp_path, scenario, shards)
