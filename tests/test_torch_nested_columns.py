"""The port's twin of ``tests/test_nested_columns.py``: its 14 cases, each
through both packages on the same seeded input (``torch_corpus_twin``).

Struct columns surface as flat ``__hs_nested.``-prefixed leaf columns
(``io/columnar.flatten_schema_fields``); dotted access resolves to them; an
index on a struct leaf is gated by ``supportNestedFields``, serves filters
and joins through the leaf, and refreshes incrementally. The port's
flattened schemas, rows in order, plans, bucket files (byte for byte) and
log entries equal the JAX package's, each package serves the other's
nested index, and the reference test's pyarrow oracle holds.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest
from torch_corpus_twin import JAX, PORT, shards, sorted_table, twin, write  # noqa: F401

PREFIX = "__hs_nested."
STRUCT = pa.struct([("leaf", pa.struct([("cnt", pa.int64())])), ("id", pa.string())])


def test_the_nested_prefix_is_the_references():
    assert PORT.C.NESTED_FIELD_PREFIX == JAX.C.NESTED_FIELD_PREFIX == PREFIX


# -- TestFlattenSchema -------------------------------------------------------------


@pytest.mark.parametrize("fields,want", [
    ((("k", pa.int64()), ("nested", STRUCT)),
     (("k", pa.int64()), (PREFIX + "nested.leaf.cnt", pa.int64()), (PREFIX + "nested.id", pa.string()))),
    ((("s", pa.struct([("xs", pa.list_(pa.int64())), ("v", pa.float64())])),),
     ((PREFIX + "s.v", pa.float64()),)),
    ((("a", pa.int64()), ("b", pa.string())), (("a", pa.int64()), ("b", pa.string()))),
    ((("s", pa.struct([("fs", pa.list_(pa.int64(), 2)), ("v", pa.int64())])),),
     ((PREFIX + "s.v", pa.int64()),)),
    ((("s", pa.struct([("a.b", pa.int64()), ("v", pa.int64())])),), ((PREFIX + "s.v", pa.int64()),)),
    ((("x.y", pa.struct([("a.b", pa.int64()), ("v", pa.int64())])),),
     (("x.y", pa.struct([("a.b", pa.int64()), ("v", pa.int64())])),)),
], ids=["struct_flattened_depth_first", "list_leaves_dropped", "plain_fields_untouched",
        "fixed_size_list_leaf_dropped", "dotted_field_names_dropped", "dotted_struct_root_kept"])
def test_flatten_schema_fields(fields, want):
    mine, ref = (P.columnar.flatten_schema_fields(fields) for P in (PORT, JAX))
    assert mine == ref == want


# -- the dataset -------------------------------------------------------------------


def nested_dataset(root, n=600, n_files=3):
    """The reference's rows with a struct column nested = {leaf: {cnt}, id},
    null struct rows included."""
    d = os.path.join(root, "nested_tbl")
    rng = np.random.default_rng(21)
    per = n // n_files
    for i in range(n_files):
        cnt = rng.integers(0, 40, per)
        rows = [None if (i * per + j) % 97 == 0
                else {"leaf": {"cnt": int(cnt[j])}, "id": f"id{(i * per + j) % 9}"}
                for j in range(per)]
        write(os.path.join(d, f"p{i}.parquet"), pa.table({
            "k": pa.array(rng.integers(0, 50, per).astype(np.int64)),
            "v": pa.array(rng.normal(0, 1, per)),
            "nested": pa.array(rows, type=STRUCT),
        }))
    return d


# -- TestNestedScan ------------------------------------------------------------------


def test_scan_surfaces_flattened_columns(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(nested_dataset(ctx.root))
        assert PREFIX + "nested.leaf.cnt" in df.columns and PREFIX + "nested.id" in df.columns
        assert "nested" not in df.columns
        return {"columns": list(df.columns), "rows": df.collect()}

    twin(tmp_path, scenario, shards)


def test_dotted_access_resolves(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(nested_dataset(ctx.root))
        col = df["nested.leaf.cnt"]
        assert col.name == PREFIX + "nested.leaf.cnt"
        return col.name

    twin(tmp_path, scenario, shards)


def test_unindexed_select_and_filter(tmp_path, shards):
    def scenario(P, ctx):
        src = nested_dataset(ctx.root)
        df = ctx.session.read.parquet(src)
        out = df.filter(df["nested.leaf.cnt"] == 7).select("k", "nested.leaf.cnt").collect()
        raw = pq.read_table(sorted(os.path.join(src, f) for f in os.listdir(src)))
        cnt = pc.struct_field(raw.column("nested"), ["leaf", "cnt"])
        expected = pc.sum(pc.fill_null(pc.equal(cnt, 7), False).cast(pa.int64())).as_py()
        assert out.num_rows == expected > 0
        assert set(out.column_names) == {"k", PREFIX + "nested.leaf.cnt"}
        return out

    twin(tmp_path, scenario, shards)


def test_group_by_sort_agg_resolve_dotted(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(nested_dataset(ctx.root))
        agg = df.group_by("nested.id").agg(P.F.count(), P.F.max("nested.leaf.cnt").alias("m")).collect()
        assert agg.num_rows > 0
        srt = df.select("k", "nested.leaf.cnt").sort("nested.leaf.cnt").collect()
        non_null = [v for v in srt.column(PREFIX + "nested.leaf.cnt").to_pylist() if v is not None]
        assert non_null == sorted(non_null)
        return {"agg": agg, "sorted": srt}

    twin(tmp_path, scenario, shards)


def test_null_struct_rows_are_null_leaves(tmp_path, shards):
    def scenario(P, ctx):
        t = ctx.session.read.parquet(nested_dataset(ctx.root)).select("nested.id").collect()
        assert t.column(0).null_count > 0
        return t

    twin(tmp_path, scenario, shards)


# -- TestNestedIndexing ------------------------------------------------------------


def test_create_gate_requires_conf(tmp_path, shards):
    def scenario(P, ctx):
        df = ctx.session.read.parquet(nested_dataset(ctx.root))
        with pytest.raises(P.HyperspaceException, match="supportNestedFields") as e:
            ctx.hs.create_index(df, P.CoveringIndexConfig("nix", ["nested.leaf.cnt"], ["v"]))
        return str(e.value)

    twin(tmp_path, scenario, shards)


def _leaf_filter(src):
    def q(P, s):
        d = s.read.parquet(src)
        return d.filter(d["nested.leaf.cnt"] == 7).select("k", "nested.id")
    return q


def test_filter_served_and_differential(tmp_path, shards):
    def scenario(P, ctx):
        src = nested_dataset(ctx.root)
        s, hs = ctx.session, ctx.hs
        df = s.read.parquet(src)
        s.conf.set(P.C.INDEX_SUPPORT_NESTED_FIELDS, True)
        hs.create_index(df, P.CoveringIndexConfig("nix", ["nested.leaf.cnt"], ["k", "nested.id"]))
        entry = s.index_manager.get_index_log_entry("nix")
        assert entry.derived_dataset.indexed_columns == [PREFIX + "nested.leaf.cnt"]
        q = _leaf_filter(src)
        s.enable_hyperspace()
        plan = q(P, s).explain()
        assert "Hyperspace(Type: CI, Name: nix" in plan
        with_index = q(P, s).collect()
        s.disable_hyperspace()
        without = q(P, s).collect()
        assert sorted_table(with_index).equals(sorted_table(without)) and with_index.num_rows > 0
        ctx.cross(q)
        return {"plan": plan, "with": with_index, "without": without}

    twin(tmp_path, scenario, shards)


def test_join_on_nested_key_differential(tmp_path, shards):
    def scenario(P, ctx):
        src = nested_dataset(ctx.root)
        dim = ctx.path("dim")
        write(os.path.join(dim, "d.parquet"), pa.table({
            "cnt_key": np.arange(40, dtype=np.int64), "label": pa.array([f"L{v}" for v in range(40)])}))
        s, hs = ctx.session, ctx.hs
        s.conf.set(P.C.INDEX_SUPPORT_NESTED_FIELDS, True)
        hs.create_index(s.read.parquet(src), P.CoveringIndexConfig("nj", ["nested.leaf.cnt"], ["k"]))
        hs.create_index(s.read.parquet(dim), P.CoveringIndexConfig("dj", ["cnt_key"], ["label"]))

        def q(P, s):
            df, dfd = s.read.parquet(src), s.read.parquet(dim)
            return dfd.join(df, on=dfd["cnt_key"] == df["nested.leaf.cnt"]).select("cnt_key", "label", "k")

        s.enable_hyperspace()
        plan = q(P, s).explain()
        assert plan.count("Hyperspace(Type: CI") == 2
        with_index = q(P, s).collect()
        s.disable_hyperspace()
        without = q(P, s).collect()
        assert sorted_table(with_index).equals(sorted_table(without)) and with_index.num_rows > 0
        ctx.cross(q)
        return {"plan": plan, "with": with_index, "without": without}

    twin(tmp_path, scenario, shards)


def test_incremental_refresh_with_nested(tmp_path, shards):
    def scenario(P, ctx):
        src = nested_dataset(ctx.root)
        s, hs = ctx.session, ctx.hs
        s.conf.set(P.C.INDEX_SUPPORT_NESTED_FIELDS, True)
        s.conf.set(P.C.INDEX_LINEAGE_ENABLED, True)
        hs.create_index(s.read.parquet(src), P.CoveringIndexConfig("nr", ["nested.leaf.cnt"], ["k"]))
        s.enable_hyperspace()

        def q(P, s):
            d = s.read.parquet(src)
            return d.filter(d["nested.leaf.cnt"] == 7).select("k")

        before = q(P, s).collect()
        write(os.path.join(src, "extra.parquet"), pa.table({
            "k": pa.array([999, 998], type=pa.int64()), "v": pa.array([0.0, 0.0]),
            "nested": pa.array([{"leaf": {"cnt": 7}, "id": "new"}, {"leaf": {"cnt": 8}, "id": "new"}],
                               type=STRUCT)}))
        hs.refresh_index("nr", P.C.REFRESH_MODE_INCREMENTAL)
        s.index_manager.clear_cache()
        plan = q(P, s).explain()
        assert "Hyperspace(Type: CI, Name: nr" in plan
        with_index = q(P, s).collect()
        ctx.cross(q)
        s.disable_hyperspace()
        without = q(P, s).collect()
        assert without.num_rows == with_index.num_rows == before.num_rows + 1
        return {"before": before, "plan": plan, "with": with_index, "without": without}

    twin(tmp_path, scenario, shards)
