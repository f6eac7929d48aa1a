"""The port's twin of ``tests/test_regressions.py``: all 36 of its cases,
each through both packages (``torch_corpus_twin.twin``) on the same seeded
input, at the reference's mesh sizes where its case takes a session.

The cases pin: the in-band null key rep against a real key equal to it in
joins and group-by (B4's and B5's plain versions on the CPU); NaN under a
descending sort; boolean aggregates refused at plan time; row-group and
row-level pushdown; the NaN-proof min/max sketch; date, timestamp,
duration and time literals; limit pushdown; the parquet dictionary gate.
Each keeps the reference's own oracle, and the port's observations equal
the JAX package's: rows in order (floats bit for bit), masks, pushed
filters, files read, error messages, index files byte for byte and log
entries. Where an index is built, each package serves the other's.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import datetime
import os

import numpy as np
import pyarrow as pa
import pytest
from torch_corpus_twin import JAX, PORT, shards, sorted_table, twin, write_parts  # noqa: F401


def _sentinel(P):
    return int(P.columnar.NULL_KEY_REP)


def test_the_null_key_rep_is_the_references():
    assert _sentinel(PORT) == _sentinel(JAX)


# -- TestNullSentinelCollision -------------------------------------------------


def test_join_matches_real_key_equal_to_sentinel(tmp_path, shards):
    def scenario(P, ctx):
        S = _sentinel(P)
        left = pa.table({"k": pa.array([S, 1, None], pa.int64()), "lv": pa.array([10, 11, 12], pa.int64())})
        right = pa.table({"j": pa.array([S, None, 2], pa.int64()), "rv": pa.array([20, 21, 22], pa.int64())})
        s = ctx.session
        dl = s.read.parquet(write_parts(ctx.path("l"), left))
        dr = s.read.parquet(write_parts(ctx.path("r"), right))
        out = dl.join(dr, on=dl["k"] == dr["j"]).select("k", "lv", "rv").collect()
        assert out.num_rows == 1
        assert out.column("k").to_pylist() == [S]
        assert out.column("lv").to_pylist() == [10] and out.column("rv").to_pylist() == [20]
        return out

    twin(tmp_path, scenario, shards)


def test_cobucketed_join_sentinel_and_null(tmp_path, shards):
    def scenario(P, ctx):
        S = _sentinel(P)
        left = pa.table({"k": pa.array([S, 1, None, 5], pa.int64()),
                         "lv": pa.array([10, 11, 12, 13], pa.int64())})
        right = pa.table({"j": pa.array([S, None, 5, 5], pa.int64()),
                          "rv": pa.array([20, 21, 22, 23], pa.int64())})
        s, hs = ctx.session, ctx.hs
        write_parts(ctx.path("l"), left, 2)
        write_parts(ctx.path("r"), right, 2)
        dl, dr = s.read.parquet(ctx.path("l")), s.read.parquet(ctx.path("r"))
        hs.create_index(dl, P.CoveringIndexConfig("li", ["k"], ["lv"]))
        hs.create_index(dr, P.CoveringIndexConfig("ri", ["j"], ["rv"]))
        s.enable_hyperspace()

        def q(P, s):
            dl, dr = s.read.parquet(ctx.path("l")), s.read.parquet(ctx.path("r"))
            return dl.join(dr, on=dl["k"] == dr["j"]).select("k", "lv", "rv")

        plan = q(P, s).explain()
        assert plan.count("Hyperspace(Type: CI") == 2
        got = q(P, s).collect()
        out = got.sort_by([("rv", "ascending")])
        assert out.column("k").to_pylist() == [S, 5, 5]
        assert out.column("rv").to_pylist() == [20, 22, 23]
        ctx.cross(q)
        return {"plan": plan, "rows": got}

    twin(tmp_path, scenario, shards)


def test_groupby_separates_sentinel_from_null(tmp_path, shards):
    def scenario(P, ctx):
        S = _sentinel(P)
        t = pa.table({"g": pa.array([S, S, None, None, 1], pa.int64()),
                      "v": pa.array([1, 2, 4, 8, 16], pa.int64())})
        df = ctx.session.read.parquet(write_parts(ctx.path("g"), t))
        out = df.group_by("g").agg(P.F.sum("v").alias("s")).collect()
        got = {(g if g is None else int(g)): s
               for g, s in zip(out.column("g").to_pylist(), out.column("s").to_pylist())}
        assert got == {S: 3, None: 12, 1: 16}
        return out

    twin(tmp_path, scenario, shards)


# -- TestNaNDescending, TestBooleanAggregates ----------------------------------


def test_nan_sort_matches_pyarrow_both_directions(tmp_path, shards):
    def scenario(P, ctx):
        t = pa.table({"x": pa.array([1.0, float("nan"), -2.0, None, 5.0, float("nan")])})
        df = ctx.session.read.parquet(write_parts(ctx.path("n"), t))
        outs = []
        for asc, order in ((True, "ascending"), (False, "descending")):
            got = df.sort(("x", asc)).collect()
            want = t.sort_by([("x", order)]).column("x").to_pylist()
            assert str(got.column("x").to_pylist()) == str(want), (asc, got, want)
            outs.append(got)
        return outs

    twin(tmp_path, scenario, shards)


def test_sum_avg_bool_rejected_min_max_ok(tmp_path, shards):
    def scenario(P, ctx):
        t = pa.table({"b": pa.array([True, False, True]), "g": pa.array([1, 1, 2], pa.int64())})
        df = ctx.session.read.parquet(write_parts(ctx.path("b"), t))
        with pytest.raises(P.HyperspaceException, match="sum") as e1:
            df.agg(P.F.sum("b")).collect()
        with pytest.raises(P.HyperspaceException, match="avg") as e2:
            df.group_by("g").agg(P.F.avg("b")).collect()
        out = df.agg(P.F.min("b").alias("lo"), P.F.max("b").alias("hi")).collect()
        assert out.column("lo").to_pylist() == [False] and out.column("hi").to_pylist() == [True]
        return {"errors": [str(e1.value), str(e2.value)], "rows": out}

    twin(tmp_path, scenario, shards)


# -- TestRowGroupPushdown --------------------------------------------------------


def _capture_reads(P, ctx, seen, what="filters"):
    real = P.pio.read_table

    def capture(paths, columns=None, fmt="parquet", filters=None, **kw):
        seen.append(filters if what == "filters" else [str(p) for p in paths])
        return real(paths, columns, fmt, filters, **kw)

    ctx.monkeypatch.setattr(P.pio, "read_table", capture)


def test_point_filter_pushes_and_matches(tmp_path, shards, monkeypatch):
    def scenario(P, ctx):
        rng = np.random.default_rng(6)
        d = ctx.path("push")
        write_parts(d, pa.table({"k": pa.array(rng.integers(0, 100, 2000), pa.int64()),
                                 "v": pa.array(rng.normal(size=2000))}), name="a.parquet")
        s, hs = ctx.session, ctx.hs
        df = s.read.parquet(d)
        hs.create_index(df, P.CoveringIndexConfig("pidx", ["k"], ["v"]))
        s.enable_hyperspace()
        captured = []
        _capture_reads(P, ctx, captured)
        q = df.filter(df["k"] == 42).select("k", "v")
        got = q.collect()
        assert any(f is not None and ("k", "==", 42) in f for f in captured), captured
        s.disable_hyperspace()
        base = q.collect()
        assert sorted_table(got).equals(sorted_table(base)) and got.num_rows > 0
        ctx.monkeypatch.undo()
        ctx.cross(lambda P, s: s.read.parquet(d).filter(s.read.parquet(d)["k"] == 42).select("k", "v"))
        return {"got": got, "base": base, "pushed": captured}

    twin(tmp_path, scenario, shards, monkeypatch)


def test_unsafe_literals_not_pushed(tmp_path, shards):
    def scenario(P, ctx):
        E = P.E
        d = ctx.path("np2")
        write_parts(d, pa.table({"s": pa.array(["a", "b"]), "x": pa.array([1, 2])}), name="a.parquet")
        rel = ctx.session.read.parquet(d).logical_plan.relation
        push = P.executor._pushdown_filters
        out = [push(E.Col("s") == 5, rel), push(E.Col("x") == None, rel),  # noqa: E711
               push(E.Col("s") == "a", rel), push(E.Col("x") == 2**70, rel),
               push(E.Col("x") == True, rel)]  # noqa: E712
        assert out == [None, None, [("s", "==", "a")], None, [("x", "==", 1)]]
        return out

    twin(tmp_path, scenario, shards)


def test_overflow_bool_and_tz_literals_end_to_end(tmp_path, shards):
    def scenario(P, ctx):
        ts = pa.array([datetime.datetime(2020, 1, 1), datetime.datetime(2021, 1, 1)],
                      type=pa.timestamp("us", tz="UTC"))
        d = write_parts(ctx.path("np3"), pa.table({"k": pa.array([0, 1], pa.int64()), "t": ts}))
        df = ctx.session.read.parquet(d)
        a = df.filter(df["k"] == 2**70).collect()
        b = df.filter(df["k"] == True).collect()  # noqa: E712
        c = df.filter(df["t"] == datetime.datetime(2020, 1, 1)).collect()
        assert (a.num_rows, b.num_rows, c.num_rows) == (0, 1, 1)
        return [a, b, c]

    twin(tmp_path, scenario, shards)


def test_nan_does_not_skip_matching_file(tmp_path, shards):
    def scenario(P, ctx):
        d = ctx.path("nansketch")
        write_parts(d, pa.table({"x": pa.array([1.0, 2.0, float("nan")])}), name="a.parquet")
        write_parts(d, pa.table({"x": pa.array([100.0, 200.0])}), name="b.parquet")
        s, hs = ctx.session, ctx.hs
        df = s.read.parquet(d)
        hs.create_index(df, P.DataSkippingIndexConfig("nsk", P.MinMaxSketch("x")))
        s.enable_hyperspace()

        def q(P, s):
            df = s.read.parquet(d)
            return df.filter(df["x"] <= 2.0).select("x")

        out = q(P, s).collect()
        assert sorted(out.column("x").to_pylist()) == [1.0, 2.0]
        ctx.cross(q)
        return {"plan": q(P, s).explain(), "rows": out}

    twin(tmp_path, scenario, shards)


# -- TestTemporalLiterals --------------------------------------------------------


def _dated(ctx):
    base = np.datetime64("1994-01-01")
    dates = (base + np.arange(1000).astype("timedelta64[D]")).astype("datetime64[D]")
    d = write_parts(ctx.path("dated"), pa.table({
        "d": pa.array(dates), "ts": pa.array(dates.astype("datetime64[us]")),
        "v": pa.array(np.arange(1000), pa.int64())}), name="a.parquet")
    return ctx.session.read.parquet(d)


def test_date_range_filter(tmp_path, shards):
    def scenario(P, ctx):
        dated = _dated(ctx)
        got = dated.filter(dated["d"] >= np.datetime64("1996-01-01")).select("d", "v").collect()
        assert got.num_rows == 270
        assert min(got.column("d").to_pylist()) == datetime.date(1996, 1, 1)
        return got

    twin(tmp_path, scenario, shards)


def test_date_literal_spellings_agree(tmp_path, shards):
    def scenario(P, ctx):
        dated = _dated(ctx)
        outs = []
        for lit in (np.datetime64("1995-03-01"), datetime.date(1995, 3, 1), "1995-03-01"):
            got = dated.filter(dated["d"] == lit).collect()
            assert got.num_rows == 1, lit
            outs.append(got)
        return outs

    twin(tmp_path, scenario, shards)


def test_date_literal_on_timestamp_column(tmp_path, shards):
    def scenario(P, ctx):
        dated = _dated(ctx)
        got = dated.filter(dated["ts"] == datetime.date(1995, 3, 1)).collect()
        assert got.num_rows == 1
        return got

    twin(tmp_path, scenario, shards)


def test_date_in_list(tmp_path, shards):
    def scenario(P, ctx):
        dated = _dated(ctx)
        got = dated.filter(dated["d"].isin(np.datetime64("1994-02-01"),
                                           np.datetime64("1994-03-01"))).collect()
        assert got.num_rows == 2
        return got

    twin(tmp_path, scenario, shards)


def test_unrepresentable_literal(tmp_path, shards):
    def scenario(P, ctx):
        dated = _dated(ctx)
        eq = dated.filter(dated["d"] == "not-a-date").collect()
        ne = dated.filter(dated["d"] != "not-a-date").collect()
        assert (eq.num_rows, ne.num_rows) == (0, 1000)
        return [eq, ne]

    twin(tmp_path, scenario, shards)


def test_out_of_range_literal_orders_correctly(tmp_path, shards):
    def scenario(P, ctx):
        ts = np.array(["2020-01-01T00:00:00", "2021-01-01T00:00:00"], dtype="datetime64[ns]")
        df = ctx.session.read.parquet(write_parts(ctx.path("ns"), pa.table({"ts": pa.array(ts)})))
        lit = np.datetime64("2300-01-01")
        outs = [df.filter(df["ts"] < lit).collect(), df.filter(df["ts"] > lit).collect(),
                df.filter(df["ts"] == lit).collect()]
        assert [o.num_rows for o in outs] == [2, 0, 0]
        return outs

    twin(tmp_path, scenario, shards)


def test_sub_tick_literal_orders_correctly(tmp_path, shards):
    def scenario(P, ctx):
        ts = np.array(["2020-01-01T00:00:00.000001", "2020-01-01T00:00:00.000002"],
                      dtype="datetime64[us]")
        df = ctx.session.read.parquet(write_parts(ctx.path("us"), pa.table({"ts": pa.array(ts)})))
        mid = np.datetime64("2020-01-01T00:00:00.000001500", "ns")
        outs = [df.filter(df["ts"] < mid).collect(), df.filter(df["ts"] > mid).collect(),
                df.filter(df["ts"] == mid).collect(), df.filter(df["ts"].isin(mid)).collect()]
        assert [o.num_rows for o in outs] == [1, 1, 0, 0]
        return outs

    twin(tmp_path, scenario, shards)


def test_time_columns_roundtrip_and_filter(tmp_path, shards):
    def scenario(P, ctx):
        t64 = pa.array([datetime.time(9, 0), datetime.time(12, 30), datetime.time(18, 45)],
                       type=pa.time64("us"))
        t32 = pa.array([datetime.time(1, 0), None, datetime.time(23, 59)], type=pa.time32("s"))
        d = write_parts(ctx.path("times"), pa.table({"a": t64, "b": t32,
                                                      "v": pa.array([1, 2, 3], pa.int64())}),
                        name="x.parquet")
        df = ctx.session.read.parquet(d)
        out = df.collect()
        assert out.column("a").to_pylist() == t64.to_pylist()
        assert out.column("b").to_pylist() == t32.to_pylist()
        zoned = datetime.time(12, 30, tzinfo=datetime.timezone.utc)
        filtered = [df.filter(c).collect() for c in (
            df["a"] == datetime.time(12, 30), df["a"] > datetime.time(10, 0), df["a"] <= "12:30:00",
            df["b"] < datetime.time(2, 0), df["b"] <= datetime.time(1, 0, 0, 500000),
            df["b"] == datetime.time(1, 0, 0, 500000), df["a"] == zoned)]
        assert [f.num_rows for f in filtered] == [1, 2, 2, 1, 1, 0, 0]
        res = P.m("plananalysis.minmax_analysis").analyze_min_max(df, ["a", "b"])
        assert all(r.max_files_per_lookup == 1 for r in res)
        return {"rows": out, "filtered": filtered,
                "layout": [(r.max_files_per_lookup, str(r)) for r in res]}

    twin(tmp_path, scenario, shards)


def test_numpy_scalar_in_list(tmp_path, shards):
    def scenario(P, ctx):
        d = write_parts(ctx.path("npscalar"), pa.table({"k": pa.array([3, 5, 7], pa.int64())}))
        df = ctx.session.read.parquet(d)
        lit = np.int64(5)
        outs = [df.filter(df["k"].isin(lit)).collect(), df.filter(df["k"] == lit).collect()]
        assert [o.num_rows for o in outs] == [1, 1]
        return outs

    twin(tmp_path, scenario, shards)


def test_between_tick_ordering_far_future(tmp_path, shards):
    def scenario(P, ctx):
        ts = np.array(["2260-01-01T00:00:00", "2262-01-01T00:00:00"], dtype="datetime64[us]")
        df = ctx.session.read.parquet(write_parts(ctx.path("far"), pa.table({"ts": pa.array(ts)})))
        mid = np.datetime64("2261-01-01T00:00:00.000000500", "ns")
        outs = [df.filter(df["ts"] < mid).collect(), df.filter(df["ts"] >= mid).collect(),
                df.filter(df["ts"] == mid).collect()]
        assert [o.num_rows for o in outs] == [1, 1, 0]
        return outs

    twin(tmp_path, scenario, shards)


def test_not_unrepresentable_excludes_nulls_both_paths(tmp_path, shards):
    def scenario(P, ctx):
        d = write_parts(ctx.path("nn"), pa.table(
            {"d": pa.array([datetime.date(2020, 1, 1), None], type=pa.date32())}))
        df = ctx.session.read.parquet(d)
        cond = ~(P.E.Col("d") == "not-a-date")
        batch = P.ColumnarBatch.from_arrow(df.collect())
        host = np.asarray(P.E.filter_mask(cond, batch))
        dev = P.device_mask(cond, batch)
        assert host.tolist() == [True, False] and dev.tolist() == host.tolist()
        return {"host": host, "device": dev}

    twin(tmp_path, scenario, shards)


# -- TestLimitPushdown -------------------------------------------------------------


def test_limit_reads_only_needed_files(tmp_path, shards, monkeypatch):
    def scenario(P, ctx):
        d = write_parts(ctx.path("lim"), pa.table({"x": pa.array(np.arange(1000), pa.int64())}), 10)
        df = ctx.session.read.parquet(d)
        seen = []
        _capture_reads(P, ctx, seen, what="paths")
        out = df.limit(5).collect()
        assert out.num_rows == 5
        assert len(seen) == 1 and len(seen[0]) == 1, seen
        assert out.column("x").to_pylist() == list(range(5))
        return {"rows": out, "read": seen}

    twin(tmp_path, scenario, shards, monkeypatch)


def test_limit_through_filter_and_project(tmp_path, shards):
    def scenario(P, ctx):
        d = write_parts(ctx.path("limf"), pa.table({"x": pa.array(np.arange(100), pa.int64())}), 5)
        df = ctx.session.read.parquet(d)
        out = df.filter(df["x"] >= 50).select("x").limit(3).collect()
        assert out.column("x").to_pylist() == [50, 51, 52]
        return out

    twin(tmp_path, scenario, shards)


def test_limit_over_sort_is_topn(tmp_path, shards):
    def scenario(P, ctx):
        rng = np.random.default_rng(3)
        d = write_parts(ctx.path("lims"), pa.table({"x": pa.array(rng.permutation(200), pa.int64())}), 4)
        out = ctx.session.read.parquet(d).sort(("x", False)).limit(4).collect()
        assert out.column("x").to_pylist() == [199, 198, 197, 196]
        return out

    twin(tmp_path, scenario, shards)


# -- TestRowLevelPushdownSuperset ------------------------------------------------


def _roundtrip(P, ctx, table, q):
    """collect() with the normal pushdown and with it forced off: equal."""
    d = write_parts(ctx.path("rl"), table, name="a.parquet")
    df = ctx.session.read.parquet(d)
    with_push = q(df).collect()
    real = P.executor._pushdown_filters
    P.executor._pushdown_filters = lambda cond, rel: None
    try:
        without = q(df).collect()
    finally:
        P.executor._pushdown_filters = real
    assert sorted_table(with_push).equals(sorted_table(without))
    return with_push


def test_between_tick_timestamp_not_pushed(tmp_path, shards):
    def scenario(P, ctx):
        lit = np.datetime64("2020-01-01T00:00:00.5", "us")
        assert P.executor._pushable_literal(lit, pa.timestamp("s")) is None
        t = pa.table({"ts": pa.array(np.array(["2020-01-01T00:00:00", "2020-01-01T00:00:01"],
                                              dtype="datetime64[s]")),
                      "v": pa.array([1, 2], pa.int64())})
        out = _roundtrip(P, ctx, t, lambda df: df.filter(df["ts"] == lit).select("v"))
        assert out.num_rows == 0
        return out

    twin(tmp_path, scenario, shards)


def test_negative_zero_and_nan_equality(tmp_path, shards):
    def scenario(P, ctx):
        t = pa.table({"x": pa.array([0.0, -0.0, float("nan"), 1.0]), "v": pa.array([1, 2, 3, 4], pa.int64())})
        out = _roundtrip(P, ctx, t, lambda df: df.filter(df["x"] == 0.0).select("v"))
        assert sorted(out.column("v").to_pylist()) == [1, 2]
        return out

    twin(tmp_path, scenario, shards)


def test_out_of_int64_range_literal_not_pushed(tmp_path, shards):
    def scenario(P, ctx):
        assert P.executor._pushable_literal(2**63, pa.int64()) is None
        t = pa.table({"k": pa.array([1, 2], pa.int64())})
        out = _roundtrip(P, ctx, t, lambda df: df.filter(df["k"] == 2**63).select("k"))
        assert out.num_rows == 0
        return out

    twin(tmp_path, scenario, shards)


# -- TestDurationLiterals -----------------------------------------------------------


def _durations():
    return pa.table({"d": pa.array(np.array([1000, 2500, -3000, 0], dtype="timedelta64[ms]")),
                     "v": pa.array([1, 2, 3, 4], pa.int64())})


def _dur(ctx, q):
    d = ctx.path("dur")
    if not os.path.isdir(d):
        write_parts(d, _durations(), name="a.parquet")
    return q(ctx.session.read.parquet(d)).collect()


def test_matching_unit_equality(tmp_path, shards):
    def scenario(P, ctx):
        out = _dur(ctx, lambda df: df.filter(df["d"] == np.timedelta64(2500, "ms")).select("v"))
        assert out.column("v").to_pylist() == [2]
        return out

    twin(tmp_path, scenario, shards)


def test_finer_unit_between_ticks(tmp_path, shards):
    def scenario(P, ctx):
        lit = np.timedelta64(2_500_500, "us")
        eq = _dur(ctx, lambda df: df.filter(df["d"] == lit).select("v"))
        lt = _dur(ctx, lambda df: df.filter(df["d"] < lit).select("v"))
        assert eq.num_rows == 0 and sorted(lt.column("v").to_pylist()) == [1, 2, 3, 4]
        return [eq, lt]

    twin(tmp_path, scenario, shards)


def test_python_timedelta_and_negative(tmp_path, shards):
    def scenario(P, ctx):
        out = _dur(ctx, lambda df: df.filter(df["d"] < datetime.timedelta(seconds=0)).select("v"))
        assert out.column("v").to_pylist() == [3]
        return out

    twin(tmp_path, scenario, shards)


def test_calendar_units_never_match(tmp_path, shards):
    def scenario(P, ctx):
        out = _dur(ctx, lambda df: df.filter(df["d"] == np.timedelta64(1, "M")).select("v"))
        assert out.num_rows == 0
        return out

    twin(tmp_path, scenario, shards)


def test_overflow_clamps_not_wraps(tmp_path, shards):
    def scenario(P, ctx):
        big = np.timedelta64(9_000_000_000_000_000, "D")
        out = _dur(ctx, lambda df: df.filter(df["d"] < big).select("v"))
        assert out.num_rows == 4
        return out

    twin(tmp_path, scenario, shards)


def test_duration_roundtrip_to_arrow():
    t = _durations()
    outs = [P.ColumnarBatch.from_arrow(t).to_arrow() for P in (PORT, JAX)]
    assert outs[0].equals(t) and outs[1].equals(t)


def test_duration_filters_not_pushed():
    for P in (PORT, JAX):
        assert P.executor._pushable_literal(np.timedelta64(1, "s"), pa.duration("ms")) is None


def test_nat_duration_never_matches(tmp_path, shards):
    def scenario(P, ctx):
        nat = np.timedelta64("NaT", "ms")
        outs = [_dur(ctx, q) for q in (
            lambda df: df.filter(df["d"] >= nat).select("v"),
            lambda df: df.filter(df["d"] == nat).select("v"),
            lambda df: df.filter(df["d"] < nat).select("v"))]
        assert [o.num_rows for o in outs] == [0, 0, 0]
        return outs

    twin(tmp_path, scenario, shards)


# -- TestParquetDictionaryGate ----------------------------------------------------


def test_sorted_key_column_skips_dictionary():
    n = 400_000
    key = np.repeat(np.arange(n // 8, dtype=np.int64), 8)
    low = np.tile(np.arange(30, dtype=np.int64), n // 30 + 1)[:n]
    t = pa.table({"key": key, "day": low, "s": pa.array(["x"] * n)})
    mine, ref = (P.pio._dictionary_columns(t) for P in (PORT, JAX))
    assert mine == ref
    assert "key" not in mine and "day" in mine and "s" in mine


def test_empty_and_small_tables():
    empty = pa.table({"a": pa.array([], pa.int64())})
    small = pa.table({"a": np.zeros(100, dtype=np.int64)})
    for P in (PORT, JAX):
        assert P.pio._dictionary_columns(empty) is False
        assert P.pio._dictionary_columns(small) == ["a"]


def test_the_dictionary_gate_writes_the_references_bytes(tmp_path):
    """The gate's decision reaches the file: a key-sorted index file with a
    high-cardinality key and a low-cardinality column is written byte for
    byte as the JAX package writes it."""
    n = 100_000
    t = pa.table({"key": np.repeat(np.arange(n // 8, dtype=np.int64), 8),
                  "day": np.tile(np.arange(30, dtype=np.int64), n // 30 + 1)[:n]})
    out = {}
    for P in (PORT, JAX):
        path = str(tmp_path / f"{P.name}.parquet")
        P.pio.write_table(path, t)
        with open(path, "rb") as f:
            out[P.name] = f.read()
    assert out["port"] == out["jax"]
