"""The port's twin of ``tests/test_aggregates.py``: aggregates, sorts and
limits, each case through both packages (``torch_corpus_twin.twin``) at
the reference's mesh sizes, against pyarrow as the reference test holds
them.

Each case keeps the reference's pyarrow oracle and holds the port's rows
to the JAX package's in order, floats bit for bit (B5's and the sort's
plain versions on the CPU); the index-served case also holds the bucket
files and log entries and has each package serve the other's index. The
reference's two module-level cases drive JAX-only segment helpers
(``ops/aggregate.segment_sum_count`` and its host/device routes): their
twins hold the port's B5 plain versions (``ops/aggregate.segment_*`` on CPU tensors)
to those helpers on the same input.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch
from torch_b5_cases import groups
from torch_corpus_twin import shards, twin, write_parts  # noqa: F401


def agg_data(ctx):
    rng = np.random.default_rng(5)
    n = 500
    t = pa.table({
        "g": pa.array([f"k{int(x)}" for x in rng.integers(0, 7, n)]),
        "h": pa.array(rng.integers(0, 3, n), type=pa.int64()),
        "x": pa.array(rng.integers(-50, 50, n), type=pa.int64()),
        "y": pa.array(rng.normal(0, 10, n)),
        "s": pa.array([["apple", "pear", "fig", None][int(x)] for x in rng.integers(0, 4, n)]),
        "z": pa.array([None if i % 11 == 0 else float(i % 13) for i in range(n)]),
    })
    return write_parts(ctx.path("agg"), t, 2), t


def arrow_groupby(t, keys, aggs):
    return t.group_by(keys).aggregate(aggs).sort_by([(k, "ascending") for k in keys])


def _one_file(ctx, name, t):
    return ctx.session.read.parquet(write_parts(ctx.path(name), t, name="p.parquet"))


# -- TestAggregates ------------------------------------------------------------------


def test_grouped_sum_count_min_max_avg(tmp_path, shards):
    def scenario(P, ctx):
        F = P.F
        d, t = agg_data(ctx)
        got = (ctx.session.read.parquet(d).group_by("g")
               .agg(F.sum("x").alias("sx"), F.count().alias("n"), F.count("z").alias("nz"),
                    F.min("x").alias("mnx"), F.max("y").alias("mxy"), F.avg("x").alias("ax"))
               .collect().sort_by([("g", "ascending")]))
        ref = arrow_groupby(t, ["g"], [("x", "sum"), ("g", "count"), ("z", "count"), ("x", "min"),
                                       ("y", "max"), ("x", "mean")])
        for mine, theirs in (("sx", "x_sum"), ("n", "g_count"), ("nz", "z_count"), ("mnx", "x_min")):
            assert got.column(mine).to_pylist() == ref.column(theirs).to_pylist()
        assert got.column("mxy").to_pylist() == pytest.approx(ref.column("y_max").to_pylist())
        assert got.column("ax").to_pylist() == pytest.approx(ref.column("x_mean").to_pylist())
        return got

    twin(tmp_path, scenario, shards)


def test_multi_key_group(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        order = [("g", "ascending"), ("h", "ascending")]
        got = ctx.session.read.parquet(d).group_by("g", "h").agg(P.F.sum("x").alias("sx")).collect().sort_by(order)
        ref = arrow_groupby(t, ["g", "h"], [("x", "sum")]).sort_by(order)
        assert got.column("g").to_pylist() == ref.column("g").to_pylist()
        assert got.column("h").to_pylist() == ref.column("h").to_pylist()
        assert got.column("sx").to_pylist() == ref.column("x_sum").to_pylist()
        return got

    twin(tmp_path, scenario, shards)


def test_global_aggregate(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        got = ctx.session.read.parquet(d).agg(P.F.count().alias("n"), P.F.sum("x").alias("sx"),
                                              P.F.avg("y").alias("ay")).collect()
        assert got.num_rows == 1 and got.column("n")[0].as_py() == t.num_rows
        assert got.column("sx")[0].as_py() == pc.sum(t.column("x")).as_py()
        assert got.column("ay")[0].as_py() == pytest.approx(pc.mean(t.column("y")).as_py())
        return got

    twin(tmp_path, scenario, shards)


def test_null_group_and_null_aggs(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        got = ctx.session.read.parquet(d).group_by("s").agg(P.F.count().alias("n"), P.F.sum("x").alias("sx")).collect()
        got_by_key = {r["s"]: (r["n"], r["sx"]) for r in got.to_pylist()}
        ref = t.group_by("s").aggregate([([], "count_all"), ("x", "sum")])
        assert got_by_key == {r["s"]: (r["count_all"], r["x_sum"]) for r in ref.to_pylist()}
        assert None in got_by_key
        return got

    twin(tmp_path, scenario, shards)


def test_string_min_max(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        got = (ctx.session.read.parquet(d).group_by("h").agg(P.F.min("s").alias("mn"), P.F.max("s").alias("mx"))
               .collect().sort_by([("h", "ascending")]))
        ref = arrow_groupby(t, ["h"], [("s", "min"), ("s", "max")])
        assert got.column("mn").to_pylist() == ref.column("s_min").to_pylist()
        assert got.column("mx").to_pylist() == ref.column("s_max").to_pylist()
        return got

    twin(tmp_path, scenario, shards)


def test_all_null_group_sum_is_null(tmp_path, shards):
    def scenario(P, ctx):
        df = _one_file(ctx, "n", pa.table({"g": ["a", "a", "b"], "v": pa.array([None, None, 1.5], pa.float64())}))
        got = (df.group_by("g").agg(P.F.sum("v").alias("sv"), P.F.min("v").alias("mv"))
               .collect().sort_by([("g", "ascending")]))
        assert got.column("sv").to_pylist() == [None, 1.5] and got.column("mv").to_pylist() == [None, 1.5]
        return got

    twin(tmp_path, scenario, shards)


def test_empty_input_global_agg(tmp_path, shards):
    def scenario(P, ctx):
        df = _one_file(ctx, "e", pa.table({"v": pa.array([], type=pa.int64())}))
        got = df.agg(P.F.count().alias("n"), P.F.sum("v").alias("sv")).collect()
        assert got.column("n").to_pylist() == [0] and got.column("sv").to_pylist() == [None]
        return got

    twin(tmp_path, scenario, shards)


def test_agg_over_filter(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        df = ctx.session.read.parquet(d)
        got = (df.filter(df["x"] > 0).group_by("g").agg(P.F.sum("x").alias("sx"))
               .collect().sort_by([("g", "ascending")]))
        ref = arrow_groupby(t.filter(pc.greater(t.column("x"), 0)), ["g"], [("x", "sum")])
        assert got.column("sx").to_pylist() == ref.column("x_sum").to_pylist()
        return got

    twin(tmp_path, scenario, shards)


# -- TestSortLimit --------------------------------------------------------------------


def test_sort_single_key(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        got = ctx.session.read.parquet(d).sort("x").collect()
        assert got.column("x").to_pylist() == t.sort_by([("x", "ascending")]).column("x").to_pylist()
        return got

    twin(tmp_path, scenario, shards)


def test_sort_descending_and_multi_key(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        got = ctx.session.read.parquet(d).sort("g", ("x", False)).collect()
        ref = t.sort_by([("g", "ascending"), ("x", "descending")])
        assert got.column("g").to_pylist() == ref.column("g").to_pylist()
        assert got.column("x").to_pylist() == ref.column("x").to_pylist()
        return got

    twin(tmp_path, scenario, shards)


def test_sort_string_and_float_with_nulls(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        got = ctx.session.read.parquet(d).sort("s", "z").collect()
        ref = t.sort_by([("s", "ascending"), ("z", "ascending")])
        assert got.column("s").to_pylist() == ref.column("s").to_pylist()
        assert got.column("z").to_pylist() == ref.column("z").to_pylist()
        return got

    twin(tmp_path, scenario, shards)


def test_sort_floats_negative(tmp_path, shards):
    def scenario(P, ctx):
        vals = [3.5, -1.25, 0.0, -0.0, float("inf"), -float("inf"), 2.0, -7.5]
        df = _one_file(ctx, "f", pa.table({"v": pa.array(vals, type=pa.float64())}))
        asc, desc = df.sort("v").collect(), df.sort(("v", False)).collect()
        assert asc.column("v").to_pylist() == sorted(vals)
        assert desc.column("v").to_pylist() == sorted(vals, reverse=True)
        return [asc, desc]

    twin(tmp_path, scenario, shards)


def test_limit(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        df = ctx.session.read.parquet(d)
        got = df.sort("x").limit(7).collect()
        assert got.num_rows == 7
        assert got.column("x").to_pylist() == t.sort_by([("x", "ascending")]).slice(0, 7).column("x").to_pylist()
        everything = df.limit(10**9).collect()
        assert everything.num_rows == t.num_rows
        return [got, everything]

    twin(tmp_path, scenario, shards)


def test_index_served_filter_then_aggregate(tmp_path, shards):
    def scenario(P, ctx):
        d, t = agg_data(ctx)
        s, hs = ctx.session, ctx.hs
        hs.create_index(s.read.parquet(d), P.CoveringIndexConfig("x_idx", ["x"], ["g", "y"]))

        def q(P, s):
            f = s.read.parquet(d)
            return f.filter(f["x"] > 10).group_by("g").agg(P.F.count().alias("n"), P.F.avg("y").alias("ay"))

        s.disable_hyperspace()
        base = q(P, s).collect().sort_by([("g", "ascending")])
        s.enable_hyperspace()
        plan = q(P, s).explain()
        assert "Hyperspace(Type: CI, Name: x_idx" in plan, plan
        got = q(P, s).collect().sort_by([("g", "ascending")])
        assert got.column("g").to_pylist() == base.column("g").to_pylist()
        assert got.column("n").to_pylist() == base.column("n").to_pylist()
        assert got.column("ay").to_pylist() == pytest.approx(base.column("ay").to_pylist())
        ctx.cross(q)
        return {"plan": plan, "got": got, "base": base}

    twin(tmp_path, scenario, shards)


def test_nan_min_max_spark_semantics(tmp_path, shards):
    def scenario(P, ctx):
        df = _one_file(ctx, "nan", pa.table({
            "g": ["a", "a", "b", "b", "c"],
            "v": pa.array([1.0, float("nan"), float("nan"), float("nan"), 2.0], type=pa.float64())}))
        got = (df.group_by("g").agg(P.F.min("v").alias("mn"), P.F.max("v").alias("mx"))
               .collect().sort_by([("g", "ascending")]))
        mn, mx = got.column("mn").to_pylist(), got.column("mx").to_pylist()
        assert mn[0] == 1.0 and np.isnan(mx[0])
        assert np.isnan(mn[1]) and np.isnan(mx[1])
        assert mn[2] == 2.0 and mx[2] == 2.0
        return got

    twin(tmp_path, scenario, shards)


def test_plan_time_type_validation(tmp_path, shards):
    def scenario(P, ctx):
        d, _t = agg_data(ctx)
        df = ctx.session.read.parquet(d)
        msgs = []
        for fn, word in ((P.F.avg, "avg"), (P.F.sum, "sum")):
            with pytest.raises(P.HyperspaceException, match=word) as e:
                df.group_by("g").agg(fn("s")).schema()
            msgs.append(str(e.value))
        return msgs

    twin(tmp_path, scenario, shards)


# -- the module-level cases: the segment reductions ---------------------------------


def _seg_inputs():
    rng = np.random.default_rng(1)
    n, g = 5000, 37
    gid = rng.integers(0, g, n)
    ints = rng.integers(-(2**40), 2**40, n, dtype=np.int64)
    flts = rng.normal(size=n)
    flts[rng.random(n) < 0.05] = np.nan
    valid = rng.random(n) > 0.1
    return gid, ints, flts, valid, g


def _host_and_device(fn, *args):
    """The reference's two routes of one segment helper (host below
    ``_HOST_AGG_MAX_ROWS``, device above)."""
    from hyperspace_tpu.ops import aggregate as A

    host = fn(*args)
    old = A._HOST_AGG_MAX_ROWS
    try:
        A._HOST_AGG_MAX_ROWS = 0
        dev = fn(*args)
    finally:
        A._HOST_AGG_MAX_ROWS = old
    return host, dev


def test_segment_ops_host_device_equivalent():
    """The reference's host and device segment routes agree (its case), and
    the port's B5 plain versions give the same sums, counts, MIN and MAX
    (MIN/MAX over floats as the reference's host route: NaN greatest)."""
    from hyperspace_tpu.ops import aggregate as A
    from hyperspace_tpu_torch.ops import aggregate as TA

    gid, ints, flts, valid, g = _seg_inputs()
    (hs, hc), (ds, dc) = _host_and_device(A.segment_sum_count, gid, ints, valid, g)
    assert np.array_equal(hs, ds) and np.array_equal(hc, dc)
    perm, offs = groups(gid, g)
    tvalid = torch.from_numpy(valid)
    s, c = TA.segment_sum_count(perm, offs, TA.device_values(ints, "cpu")[0], tvalid)
    assert np.array_equal(s.numpy(), hs) and np.array_equal(c.numpy(), hc)
    for mode in ("min", "max"):
        for vals in (ints, flts):
            h, d = _host_and_device(A.segment_minmax, gid, vals, valid, g, mode)
            assert np.array_equal(h, d, equal_nan=True), mode
            fill = None if vals.dtype.kind == "f" else 0  # the executor's int fill; floats fill NaN
            mine = TA.segment_minmax(perm, offs, TA.device_values(vals, "cpu")[0], tvalid, mode, fill)
            has = np.asarray(hc) > 0  # a group with no valid row: each package's own fill
            assert np.array_equal(mine.numpy()[has], np.asarray(h)[has], equal_nan=True), mode
    h, d = _host_and_device(A.segment_count, gid, valid, len(gid), g)
    assert np.array_equal(h, d) and np.array_equal(h, hc)
    assert np.array_equal(TA.segment_count(perm, offs, tvalid).numpy(), h)


def test_uint8_sum_does_not_wrap():
    from hyperspace_tpu.ops import aggregate as A
    from hyperspace_tpu_torch.ops import aggregate as TA

    gid = np.zeros(2, dtype=np.int64)
    vals = np.array([200, 200], dtype=np.uint8)
    s, c = A.segment_sum_count(gid, vals, None, 1)
    assert int(s[0]) == 400 and int(c[0]) == 2
    perm, offs = groups(gid, 1)
    ms, mc = TA.segment_sum_count(perm, offs, TA.device_values(vals, "cpu")[0], None)
    assert (int(ms[0]), int(mc[0])) == (400, 2)
