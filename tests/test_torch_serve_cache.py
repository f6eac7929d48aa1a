"""The port's serve cache against the JAX package's.

Every case of the reference's ``tests/test_serve_cache.py`` (its 14
classes), run through both packages: the unit cases drive the two
``ServeCache`` / ``ScanCacheEntry`` / sizing implementations with the same
calls and hold every observation equal (``both``); the end-to-end cases
build the same numpy-seeded tables and indexes in both packages
(``torch_serve_twin.Twin``: the port on the CPU, the JAX package on one CPU
device with 8 buckets) and run the same query sequence, holding the rows
equal in order (floats bit for bit) and ``ServeCache.stats()``'s counters
(hits, misses, evictions, spill demotes, restores and drops, entries)
equal after each step. The tolerance is exact.

Sizes: a ``PreparedJoinSide``'s charge differs by its offsets' layout
(the port keeps [B + 1] offsets where the reference keeps [B] sizes and
[B] offsets, ROADMAP C.17), so the join cases compare counters, not
bytes; every other entry's bytes are compared too.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import gc
import os
import sys
import threading
import time
import types

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pyarrow.parquet as pq
import pytest

from hyperspace_tpu.execution import executor as JX
from hyperspace_tpu.execution import join_exec as JJ
from hyperspace_tpu.execution import pipeline_compiler as JPC
from hyperspace_tpu.execution import serve_cache as JSC
from hyperspace_tpu.io import columnar as JCOL
from hyperspace_tpu.testing import faults as JF_
from hyperspace_tpu_torch.execution import executor as TX
from hyperspace_tpu_torch.execution import join_exec as TJ
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.execution import serve_cache as TSC
from hyperspace_tpu_torch.io import columnar as TCOL
from hyperspace_tpu_torch.testing import faults as TF_
from torch_b5_cases import same_rows
from torch_lifecycle_twin import sorted_table
from torch_serve_twin import Twin, kinds

import torch

CACHE = "hyperspace.serve.cache.enabled"
BUCKET_SPEC = "hyperspace.index.filterRule.useBucketSpec"
LINEAGE = "hyperspace.index.lineage.enabled"
HYBRID = "hyperspace.index.hybridscan.enabled"

PKGS = {
    "port": types.SimpleNamespace(sc=TSC, col=TCOL, faults=TF_, X=TX),
    "jax": types.SimpleNamespace(sc=JSC, col=JCOL, faults=JF_, X=JX),
}


def both(scenario):
    """``scenario(M)`` over each package's namespace; the two results must
    be equal. Returns the port's."""
    out = {pkg: scenario(M) for pkg, M in PKGS.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


def batch_of(M, table):
    return M.col.ColumnarBatch.from_arrow(table)


# ---------------------------------------------------------------------------
# TestServeCacheUnit


class TestServeCacheUnit:
    def test_lru_eviction_by_bytes(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=100)
            c.put("a", 1, 40)
            c.put("b", 2, 40)
            touched = c.get("a")  # b becomes LRU
            c.put("c", 3, 40)  # evicts b
            return touched, c.get("b"), c.get("a"), c.get("c"), c.resident_bytes

        assert both(run) == (1, None, 1, 3, 80)

    def test_oversized_value_not_cached(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=10)
            c.put("big", 1, 11)
            return c.get("big"), len(c)

        assert both(run) == (None, 0)

    def test_replace_updates_bytes(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=100)
            c.put("a", 1, 60)
            c.put("a", 2, 30)
            return c.resident_bytes, c.get("a")

        assert both(run) == (30, 2)

    def test_hit_miss_counters(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=100)
            c.get("x")
            c.put("x", 1, 1)
            c.get("x")
            return c.hits, c.misses

        assert both(run) == (1, 1)

    def test_clear(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=100)
            c.put("a", 1, 10)
            c.clear()
            return c.get("a"), c.resident_bytes

        assert both(run) == (None, 0)


# ---------------------------------------------------------------------------
# TestEstimateNbytes: the one sizing ruler, equal on equal values


class TestEstimateNbytes:
    def test_numpy_view_charges_owner(self):
        def run(M):
            a = np.arange(1000, dtype=np.int64)
            return [M.sc.estimate_nbytes(x) for x in (a, a[:10], a[:100][5:10])]

        assert both(run) == [8000, 8000, 8000]

    def test_owning_copy_charges_its_own_extent(self):
        def run(M):
            return M.sc.estimate_nbytes(np.arange(1000, dtype=np.int64)[:10].copy())

        assert both(run) == 80

    def test_arrow_backed_column_charges_buffer(self):
        def run(M):
            t = pa.table({"k": pa.array(range(100_000), type=pa.int64())})
            col = batch_of(M, t).column("k")
            return M.sc.estimate_nbytes(col), M.sc.batch_nbytes(batch_of(M, t))

        col, batch = both(run)
        assert col >= 100_000 * 8 and batch >= 100_000 * 8

    def test_string_column_charges_dictionary(self):
        def run(M):
            t = pa.table({"s": pa.array(["aa", "bb", "aa", "cc"])})
            return M.sc.estimate_nbytes(batch_of(M, t).column("s"))

        assert both(run) >= 4 * 4 + 3 * (2 + 49)

    def test_pyarrow_table_uses_buffer_size(self):
        t = pa.table({"k": pa.array(range(100), type=pa.int64())})
        assert both(lambda M: M.sc.estimate_nbytes(t)) == t.get_total_buffer_size()

    def test_entry_budget_charges_pinned_bytes(self):
        def run(M):
            big = np.arange(10_000, dtype=np.int64)
            sub = M.col.Column("numeric", pa.int64(), values=big[:5])
            return M.sc.ScanCacheEntry([(0, 5)]).with_new_columns({"k": sub}).budget_nbytes

        assert both(run) >= 10_000 * 8

    def test_cache_accounting_matches_estimate(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=1 << 30)
            batch = batch_of(M, pa.table({"k": pa.array(range(1000), type=pa.int64())}))
            a = np.arange(1000, dtype=np.float64)
            c.put("b", batch, M.sc.estimate_nbytes(batch))
            c.put("a", a[:10], M.sc.estimate_nbytes(a[:10]))
            assert c.resident_bytes == M.sc.estimate_nbytes(batch) + a.nbytes
            return c.resident_bytes

        both(run)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_equal_batches_equal_estimates(self, seed):
        """Seeded batches of every column kind (ints, floats, dates, strings
        with nulls, bools, a pyarrow slice's zero-copy view) decode to the
        same buffers in both packages, and so to the same charge."""
        rng = np.random.default_rng(seed)
        n = 5000
        t = pa.table({
            "i": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.1),
            "f": rng.normal(0, 1, n),
            "d": pa.array(rng.integers(0, 900, n).astype(np.int32)).cast(pa.date32()),
            "s": pa.array(rng.choice(["x", "yy", "zzz"], n), mask=rng.random(n) < 0.1),
            "b": pa.array(rng.random(n) < 0.5),
        })

        def run(M):
            return [M.sc.batch_nbytes(batch_of(M, x)) for x in (t, t.slice(100, 900))]

        both(run)


# ---------------------------------------------------------------------------
# TestFingerprint


class TestFingerprint:
    def test_changes_with_content(self, tmp_path):
        p = str(tmp_path / "f.parquet")
        pq.write_table(pa.table({"a": [1, 2]}), p)
        fp1 = both(lambda M: M.sc.file_fingerprint([p]))
        os.utime(p, ns=(1, 1))  # an mtime change: a new fingerprint
        fp2 = both(lambda M: M.sc.file_fingerprint([p]))
        assert fp1 != fp2

    def test_missing_file_returns_none(self, tmp_path):
        assert both(lambda M: M.sc.file_fingerprint([str(tmp_path / "nope")])) is None


# ---------------------------------------------------------------------------
# TestScanCacheEntry


def _entry(M, values, segments):
    batch = batch_of(M, pa.table({"k": pa.array(values, type=pa.int64())}))
    return M.sc.ScanCacheEntry(segments).with_new_columns({"k": batch.column("k")})


class TestScanCacheEntry:
    def test_sorted_segments_detected(self):
        def run(M):
            rep, ok = _entry(M, [1, 5, 9, 2, 3], [(0, 3), (3, 5)]).column_state("k")
            return ok, rep.tolist()

        assert both(run) == (True, [1, 5, 9, 2, 3])

    def test_unsorted_segment_detected(self):
        assert both(lambda M: _entry(M, [1, 5, 3], [(0, 3)]).column_state("k")[1]) is False

    def test_memoized(self):
        def run(M):
            st = _entry(M, [1, 2], [(0, 2)])
            return st.column_state("k") is st.column_state("k")

        assert both(run) is True

    def test_columns_accrue_copy_on_write(self):
        def run(M):
            st = _entry(M, [1, 2], [(0, 2)])
            missing = st.batch_for(["k", "v"])  # v not cached yet
            b1 = st.budget_nbytes
            v = batch_of(M, pa.table({"v": pa.array([1.0, 2.0])})).column("v")
            st2 = st.with_new_columns({"v": v})
            return (missing, st2.batch_for(["k", "v"]).num_rows, st2.budget_nbytes > b1,
                    st.batch_for(["k", "v"]), st2.columns["k"] is st.columns["k"])

        assert both(run) == (None, 2, True, None, True)

    def test_budget_charges_rep_memo(self):
        assert both(lambda M: _entry(M, [1, 2], [(0, 2)]).budget_nbytes) == 2 * 8 + 2 * 8


# ---------------------------------------------------------------------------
# end-to-end worlds (the reference's _lineitem and orders tables)


def _lineitem(tmp_path, n=4000, n_files=4):
    rng = np.random.default_rng(11)
    d = tmp_path / "tbl"
    d.mkdir()
    t = pa.table({
        "k": rng.integers(0, 500, n).astype(np.int64),
        "d": pa.array((np.datetime64("1994-01-01")
                       + rng.integers(0, 900, n).astype("timedelta64[D]")).astype("datetime64[D]")),
        "q": rng.integers(1, 51, n).astype(np.int64),
        "p": rng.normal(100.0, 30.0, n),
        "s": pa.array([f"s{v % 7}" for v in range(n)]),
    })
    per = n // n_files
    for i in range(n_files):
        pq.write_table(t.slice(i * per, per if i < n_files - 1 else n - i * per),
                       str(d / f"part{i}.parquet"))
    return str(d)


def _extra(ks, q=7, tag="sX"):
    n = len(ks)
    return pa.table({
        "k": pa.array(ks, type=pa.int64()),
        "d": pa.array(np.full(n, np.datetime64("1998-01-01"), dtype="datetime64[D]")),
        "q": pa.array([q] * n, type=pa.int64()),
        "p": pa.array([1.0] * n),
        "s": pa.array([tag] * n),
    })


FILTERS = [
    lambda df: df.filter(df["k"] == 123).select("k", "q"),
    lambda df: df.filter(df["k"] == -1).select("k"),  # empty result
    lambda df: df.filter(df["k"] < 30).select("k", "q", "p"),
    lambda df: df.filter(df["k"] >= 480).select("k", "d"),
    lambda df: df.filter(df["k"].isin(3, 490, 77)).select("k", "q"),
    lambda df: df.filter((df["k"] == 123) & (df["q"] > 25)).select("k", "q"),
    # float predicate column: the narrowing refuses range-by-rep
    lambda df: df.filter((df["k"] == 123) & (df["p"] < 100.0)).select("k", "p"),
    # string equality
    lambda df: df.filter((df["k"] == 123) & (df["s"] == "s3")).select("k", "s"),
]


def on_src(src, shape):
    """A query closure ``(session, F)`` over ``read.parquet(src)``."""
    return lambda s, F: shape(s.read.parquet(src))


class TestCachedFilterDifferential:
    def test_filter_shapes(self, tmp_path):
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", src, "ix", ["k"], ["d", "q", "p", "s"])
        tw.set(BUCKET_SPEC, True)
        tw.enable()
        expected = [tw.run(on_src(src, q)) for q in FILTERS]
        tw.set(CACHE, True)
        for _ in range(2):  # first populates, second must hit
            for q, exp in zip(FILTERS, expected):
                got = tw.run(on_src(src, q))
                assert same_rows(got, exp)
                tw.stats_equal(bytes_too=True)
        assert tw.t.serve_cache.hits > 0

    def test_refresh_invalidates_by_fingerprint(self, tmp_path):
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.set(LINEAGE, True)
        tw.create("covering", src, "ix", ["k"], ["q"])
        tw.set(CACHE, True)
        tw.enable()
        q = on_src(src, lambda d: d.filter(d["k"] == 123).select("k", "q"))
        before = tw.run(q).num_rows
        assert tw.run(q).num_rows == before  # cache populated
        # appended rows with k=123 and an incremental refresh: the new
        # version's files are new fingerprints, so nothing stale is served
        pq.write_table(_extra([123] * 5), os.path.join(src, "extra.parquet"))
        tw.refresh("ix", "incremental")
        tw.clear()
        assert tw.run(q).num_rows == before + 5


def _orders(tmp_path):
    o = tmp_path / "orders"
    o.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        pq.write_table(pa.table({"ok": np.arange(i * 250, (i + 1) * 250, dtype=np.int64),
                                 "v": rng.normal(0, 1, 250)}), str(o / f"p{i}.parquet"))
    return str(o)


def _join_q(osrc, isrc):
    def q(s, F):
        o, i = s.read.parquet(osrc), s.read.parquet(isrc)
        return o.join(i, on=o["ok"] == i["k"]).select("ok", "v", "q")

    return q


class TestCachedJoinDifferential:
    def _mk(self, tmp_path):
        src = _lineitem(tmp_path)
        osrc = _orders(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", src, "ix_i", ["k"], ["q"])
        tw.create("covering", osrc, "ix_o", ["ok"], ["v"])
        return tw, osrc, src

    def test_join_cached_equals_uncached(self, tmp_path):
        tw, osrc, src = self._mk(tmp_path)
        tw.enable()
        q = _join_q(osrc, src)
        for text in tw.explain(q).values():
            assert text.count("Hyperspace(Type: CI") == 2
        expected = tw.run(q)
        tw.set(CACHE, True)
        for _ in range(2):
            assert same_rows(tw.run(q), expected)
        assert tw.t.serve_cache.hits > 0

    def test_hybrid_joinside_cached_and_invalidated(self, tmp_path):
        """Repeated hybrid joins on a stable appended state hit the joinside
        entry (keyed on index and appended file fingerprints); a further
        append changes the fingerprint and serves fresh."""
        tw, osrc, src = self._mk(tmp_path)
        tw.set(HYBRID, True)
        tw.set(CACHE, True)
        tw.enable()
        pq.write_table(_extra([3, 490], tag="sH"), os.path.join(src, "hybrid-a.parquet"))
        tw.clear()
        q = _join_q(osrc, src)
        for text in tw.explain(q).values():
            assert text.count("Hyperspace(Type: CI") == 2, text
        first = tw.run(q)
        hits0 = tw.t.serve_cache.hits
        assert same_rows(tw.run(q), first)
        assert tw.t.serve_cache.hits > hits0  # joinside served from RAM
        for cache in tw.caches():  # the Union-shaped side is itself cached
            with cache._lock:
                assert [k for k in cache._entries if k[0] == "joinside" and len(k[1]) == 2]
        tw.enable(False)
        assert sorted_table(tw.run(q)).equals(sorted_table(first))
        tw.enable()
        pq.write_table(_extra([3], tag="sH"), os.path.join(src, "hybrid-b.parquet"))
        tw.clear()
        more = tw.run(q)
        assert more.num_rows == first.num_rows + 1
        tw.enable(False)
        assert sorted_table(tw.run(q)).equals(sorted_table(more))

    def test_hybrid_scan_after_cache_populated(self, tmp_path):
        tw, osrc, src = self._mk(tmp_path)
        tw.set(CACHE, True)
        tw.enable()
        q = _join_q(osrc, src)
        first = tw.run(q)
        assert same_rows(tw.run(q), first)
        pq.write_table(_extra([3, 3, 490], q=9), os.path.join(src, "appended.parquet"))
        tw.set(HYBRID, True)
        tw.clear()
        hybrid = tw.run(q)
        tw.enable(False)
        assert sorted_table(hybrid).equals(sorted_table(tw.run(q)))
        assert hybrid.num_rows == first.num_rows + 3


# ---------------------------------------------------------------------------
# TestPreparedJoinSide: the prepared co-bucketed join of each package


def _bs(M, data):
    return {b: batch_of(M, pa.table(t)) for b, t in data.items()}


def _co_bucketed_join(M, lbs, rbs, on):
    """The reference's ``co_bucketed_join``; in the port its two prepares
    and ``co_bucketed_join_prepared`` on the CPU."""
    if M.sc is JSC:
        return JJ.co_bucketed_join(lbs, rbs, on)
    if not lbs or not rbs:
        return None
    lp = TJ.prepare_join_side(lbs, [l for l, _ in on])
    rp = TJ.prepare_join_side(rbs, [r for _, r in on])
    return TJ.co_bucketed_join_prepared(lp, rp, on, torch.device("cpu"))


def _empty(M):
    return batch_of(M, pa.table({"k": pa.array([], type=pa.int64())}))


class TestPreparedJoinSide:
    def test_subset_and_mismatched_buckets(self):
        def run(M):
            lbs = _bs(M, {0: {"k": pa.array([1, 2], type=pa.int64())},
                          1: {"k": pa.array([5], type=pa.int64())}})
            rbs = _bs(M, {1: {"rk": pa.array([5, 5], type=pa.int64())},
                          2: {"rk": pa.array([9], type=pa.int64())}})
            return _co_bucketed_join(M, lbs, rbs, [("k", "rk")]).to_arrow()

        out = both(run)
        assert out.num_rows == 2 and out.column("k").to_pylist() == [5, 5]

    def test_null_keys_never_match(self):
        def run(M):
            lbs = _bs(M, {0: {"k": pa.array([1, None, 3], type=pa.int64())}})
            rbs = _bs(M, {0: {"rk": pa.array([None, 3], type=pa.int64())}})
            return _co_bucketed_join(M, lbs, rbs, [("k", "rk")]).to_arrow()

        assert both(run).column("k").to_pylist() == [3]

    def test_multi_key_verified(self):
        def run(M):
            lbs = _bs(M, {0: {"a": pa.array([1, 1, 2], type=pa.int64()),
                              "b": pa.array([10, 11, 10], type=pa.int64())}})
            rbs = _bs(M, {0: {"ra": pa.array([1, 2], type=pa.int64()),
                              "rb": pa.array([11, 10], type=pa.int64())}})
            return _co_bucketed_join(M, lbs, rbs, [("a", "ra"), ("b", "rb")]).to_arrow()

        out = both(run)
        assert sorted(zip(out.column("a").to_pylist(), out.column("b").to_pylist())) == [
            (1, 11), (2, 10)]

    def test_empty_side(self):
        def run(M):
            return _co_bucketed_join(M, _bs(M, {0: {"k": pa.array([1], type=pa.int64())}}), {},
                                     [("k", "rk")])

        assert both(run) is None

    def test_trailing_empty_bucket(self):
        # an empty last bucket must not index past the sortedness array
        def run(M):
            lbs = _bs(M, {0: {"k": pa.array([1, 2, 3], type=pa.int64())}})
            lbs[1] = _empty(M)
            prep = (JJ if M.sc is JSC else TJ).prepare_join_side(lbs, ["k"])
            return prep.sorted_buckets, prep.sizes.tolist()

        assert both(run) == (True, [3, 0])

    def test_empty_middle_bucket_join(self):
        def run(M):
            lbs = _bs(M, {0: {"k": pa.array([7, 8], type=pa.int64())},
                          2: {"k": pa.array([9], type=pa.int64())}})
            lbs[1] = _empty(M)
            rbs = _bs(M, {0: {"rk": pa.array([8], type=pa.int64())},
                          1: {"rk": pa.array([], type=pa.int64())},
                          2: {"rk": pa.array([9, 9], type=pa.int64())}})
            return _co_bucketed_join(M, lbs, rbs, [("k", "rk")]).to_arrow()

        assert sorted(both(run).column("k").to_pylist()) == [8, 9, 9]

    def test_sort_memo_of_a_cached_side(self):
        """A side with null keys sorts its buckets on the device; with the
        memo the serve cache gives it, a second join gathers through the
        kept permutation and gives the first join's rows."""
        rng = np.random.default_rng(3)
        lk = pa.array(rng.integers(0, 20, 300), mask=rng.random(300) < 0.1)
        rk = pa.array(rng.integers(0, 20, 200), mask=rng.random(200) < 0.1)
        lbs = _bs(PKGS["port"], {0: {"k": lk.slice(0, 150)}, 1: {"k": lk.slice(150)}})
        rbs = _bs(PKGS["port"], {0: {"rk": rk.slice(0, 90)}, 1: {"rk": rk.slice(90)}})
        lp = TJ.prepare_join_side(lbs, ["k"])
        rp = TJ.prepare_join_side(rbs, ["rk"])
        lp.sort_perms, rp.sort_perms = {}, {}
        cpu = torch.device("cpu")
        first = TJ.co_bucketed_join_prepared(lp, rp, [("k", "rk")], cpu).to_arrow()
        assert set(lp.sort_perms) == {0} and set(rp.sort_perms) == {1}
        again = TJ.co_bucketed_join_prepared(lp, rp, [("k", "rk")], cpu).to_arrow()
        assert same_rows(first, again)
        ref = JJ.co_bucketed_join(_bs(PKGS["jax"], {0: {"k": lk.slice(0, 150)},
                                                    1: {"k": lk.slice(150)}}),
                                  _bs(PKGS["jax"], {0: {"rk": rk.slice(0, 90)},
                                                    1: {"rk": rk.slice(90)}}),
                                  [("k", "rk")]).to_arrow()
        assert same_rows(first, ref)


# ---------------------------------------------------------------------------
# TestCachedFilteredAggregate


@pytest.fixture
def fused_at_test_size(monkeypatch):
    """The fused routes dispatched at test sizes in both packages."""
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)


class TestCachedFilteredAggregate:
    @pytest.mark.parametrize("fused_on", [True, False])
    def test_aggregate_over_cached_filter_scan(self, tmp_path, fused_at_test_size, fused_on):
        """An aggregate above an index-served filter runs off the cached
        scan entry: the fused pass over the cached batch (B5f's plain
        version in the port), or the interpreted chain over the cached
        filter."""
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.set("hyperspace.serve.fusedpipeline.enabled", fused_on)
        tw.create("covering", src, "agix", ["k"], ["q", "p"])
        tw.enable()

        def q(s, F):
            df = s.read.parquet(src)
            return df.filter(df["k"] < 200).group_by("k").agg(
                F.sum("q").alias("sq"), F.count().alias("n"))

        for text in tw.explain(q).values():
            assert "Hyperspace(Type: CI" in text
        expected = tw.run(q)
        tw.set(CACHE, True)
        first = tw.run(q)  # populates
        second = tw.run(q)  # hits
        assert same_rows(first, expected) and same_rows(second, expected)
        assert tw.t.serve_cache.hits > 0
        if fused_on:
            assert {"fusedplan", "scan"} <= set(kinds(tw.t.serve_cache))
            assert TPC.last_fused_stats["rows_scanned"] == 4000

    def test_filter_queries_share_column_entries(self, tmp_path):
        """The per-file-set entry accrues columns: two filters over
        overlapping projections decode each column once (one ("scan", fp)
        key in all)."""
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", src, "shix", ["k"], ["q", "p"])
        tw.set(CACHE, True)
        tw.enable()
        tw.run(on_src(src, lambda df: df.filter(df["k"] > 100).select("k", "q")))
        tw.run(on_src(src, lambda df: df.filter(df["k"] > 300).select("k", "p")))
        assert len(tw.t.serve_cache) == 1
        tw.stats_equal(bytes_too=True)


# ---------------------------------------------------------------------------
# TestServeCacheConcurrency


def _race(fn, n_threads):
    """``fn(i)`` on ``n_threads`` threads with a short switch interval;
    returns the errors."""
    errors = []

    def worker(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001 - collected and asserted empty
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return errors


def ledger_exact(cache) -> None:
    with cache._lock:
        assert cache._bytes == sum(nb for _v, nb in cache._entries.values())
    assert cache.resident_bytes <= cache.max_bytes
    assert cache.high_water_bytes <= cache.max_bytes


class TestServeCacheConcurrency:
    def test_racing_first_touch_queries_agree(self, tmp_path):
        """Concurrent first-touch queries (the cache empty when the threads
        start) in each package all give the answer computed before the cache
        existed, and leave the cache consistent."""
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", src, "rcix", ["k"], ["q"])
        tw.enable()
        q = on_src(src, lambda df: df.filter(df["k"] == 123).select("k", "q"))
        expected = tw.run(q)
        tw.set(CACHE, True)
        for pkg, s in tw.sides():
            F = None
            results = []
            errors = _race(lambda _i: results.append(q(s, F).collect()), 8)
            assert not errors, errors
            assert len(results) == 8 and all(same_rows(r, expected) for r in results), pkg
            ledger_exact(s.serve_cache)
            s.serve_cache.hits = 0
            q(s, F).collect()
            assert s.serve_cache.hits > 0  # later queries hit the one entry

    def test_racing_different_projections_copy_on_write(self, tmp_path):
        """Racing queries with different column sets add columns to the same
        ("scan", fp) entry at once: the copy-on-write publication never
        exposes a torn entry."""
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", src, "cwix", ["k"], ["q", "p", "s", "d"])
        tw.enable()
        shapes = [
            lambda df: df.filter(df["k"] == 123).select("k", "q"),
            lambda df: df.filter(df["k"] == 200).select("k", "p"),
            lambda df: df.filter(df["k"] == 300).select("k", "s"),
            lambda df: df.filter(df["k"] == 400).select("k", "d"),
        ]
        expected = [tw.run(on_src(src, q)) for q in shapes]
        tw.set(CACHE, True)
        for pkg, s in tw.sides():
            results = {i: [] for i in range(len(shapes))}

            def work(i):
                for _ in range(4):
                    results[i % 4].append(on_src(src, shapes[i % 4])(s, None).collect())

            errors = _race(work, 8)
            assert not errors, errors
            for i, exp in enumerate(expected):
                assert results[i] and all(same_rows(r, exp) for r in results[i]), (pkg, i)
            ledger_exact(s.serve_cache)


# ---------------------------------------------------------------------------
# TestCachedZOrderServe


class TestCachedZOrderServe:
    def test_zorder_filter_cached_differential(self, tmp_path):
        """Z-order index scans cache too; their files are z-address sorted,
        not column sorted, so the narrowing detects the unsorted column and
        masks the whole cached batch."""
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.create("zorder", src, "zc", ["k", "q"], ["p"])
        tw.enable()
        q = on_src(src, lambda df: df.filter(
            (df["k"] >= 100) & (df["k"] < 150) & (df["q"] > 10)).select("k", "q", "p"))
        for text in tw.explain(q).values():
            assert "Hyperspace(Type: ZOCI" in text
        expected = tw.run(q)
        tw.set(CACHE, True)
        assert same_rows(tw.run(q), expected) and same_rows(tw.run(q), expected)
        tw.stats_equal(bytes_too=True)
        assert tw.t.serve_cache.hits > 0


# ---------------------------------------------------------------------------
# TestPublicationMerge


class TestPublicationMerge:
    def test_peek_does_not_count(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=100)
            c.put("a", 1, 10)
            return c.peek("a"), c.peek("b"), c.hits, c.misses

        assert both(run) == (1, None, 0, 0)

    def test_evict_recreate_race_keeps_needed_columns(self, tmp_path):
        """An entry evicted and re-created with another projection between
        a query's get and its publication: the published union still covers
        the query's columns (the stale-extra merge), in both packages."""
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", src, "evix", ["k"], ["q", "p"])
        tw.set(CACHE, True)
        tw.enable()
        q_kq = on_src(src, lambda df: df.filter(df["k"] == 123).select("k", "q"))
        expected = tw.run(q_kq)
        for pkg, s in tw.sides():
            M = PKGS[pkg]
            cache = s.serve_cache
            (key,) = [k for k in cache._entries if k[0] == "scan"]
            real_peek = cache.peek
            swapped = {"done": False}

            def racing_peek(k, cache=cache, key=key, real_peek=real_peek, M=M,
                            swapped=swapped):
                if not swapped["done"] and k == key:
                    swapped["done"] = True
                    entry = real_peek(k)
                    other = M.sc.ScanCacheEntry(entry.segments).with_new_columns(
                        {"p": entry.columns["p"]} if "p" in entry.columns else {})
                    cache.put(k, other, 1)
                    return other
                return real_peek(k)

            cache.peek = racing_peek
            try:
                df = s.read.parquet(src)
                got = df.filter(df["k"] == 123).select("k", "d").collect()
                assert got.num_rows == expected.num_rows, pkg
                assert same_rows(df.filter(df["k"] == 123).select("k", "q").collect(), expected)
            finally:
                cache.peek = real_peek
        tw.stats_equal()


# ---------------------------------------------------------------------------
# TestMemoryGovernor


class TestMemoryGovernor:
    def test_high_water_and_eviction_telemetry(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=100)
            c.put(("scan", "a"), 1, 60)
            c.put(("joinside", "b"), 2, 40)
            hw = c.high_water_bytes
            c.put(("scan", "c"), 3, 30)  # evicts ("scan", "a")
            st = c.stats()
            return (hw, c.get(("scan", "a")), st["evictions"], st["evicted_bytes"],
                    st["high_water_bytes"], st["resident_bytes"], c.bytes_by_kind())

        assert both(run) == (100, None, 1, 60, 100, 70, {"joinside": 40, "scan": 30})

    def test_put_never_overshoots_budget(self):
        def run(M):
            c = M.sc.ServeCache(max_bytes=100)
            c.put(("scan", 1), "x", 90)
            c.put(("scan", 2), "y", 90)
            return c.resident_bytes, c.high_water_bytes <= 100

        assert both(run) == (90, True)

    def test_insert_failures_counted_under_fault(self):
        def run(M):
            M.faults.reset()
            try:
                c = M.sc.ServeCache(max_bytes=100)
                M.faults.set_fault("cache_insert", "transient:1")
                c.put(("scan", 1), "x", 10)  # dropped
                dropped = c.get(("scan", 1)), c.insert_failures
                c.put(("scan", 1), "x", 10)  # recovered
                return dropped, c.get(("scan", 1)), M.faults.stats()
            finally:
                M.faults.reset()

        assert both(run) == ((None, 1), "x", {"cache_insert": 1})

    def test_insert_fault_armed_by_config_keeps_queries_answering(self, tmp_path):
        """``hyperspace.faults.cache_insert`` armed through the session's
        config: every insert is dropped (counted), every query still
        answers, in both packages."""
        src = _lineitem(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", src, "fx", ["k"], ["q"])
        tw.enable()
        q = on_src(src, lambda df: df.filter(df["k"] < 40).select("k", "q"))
        expected = tw.run(q)
        tw.set(CACHE, True)
        tw.set("hyperspace.faults.cache_insert", "persistent")
        try:
            for pkg, s in tw.sides():
                assert PKGS[pkg].faults.configure(s.conf) == 1
            for _ in range(2):
                assert same_rows(tw.run(q), expected)
            st = tw.stats_equal()
            assert st["entries"] == 0 and st["insert_failures"] == 2
        finally:
            for M in PKGS.values():
                M.faults.reset()

    def test_evict_kind_racing_get_put(self):
        """Two writers and a reader hammer both packages' caches (each
        operation applied to the port's cache, then the reference's) while
        the main thread evicts kinds; the byte ledger stays exact, the
        budget holds at every unsynchronized probe, and nothing errors."""
        caches = [M.sc.ServeCache(max_bytes=5_000) for M in PKGS.values()]
        stop = threading.Event()
        errors = []

        def writer(tag):
            try:
                i = 0
                while not stop.is_set():
                    kind = ("scan", "joinside", "delta", "aggstate")[i % 4]
                    for c in caches:
                        c.put((kind, tag, i % 11), ("v", tag, i), 100 + (i % 7))
                        c.get((kind, tag, (i + 5) % 11))
                        c.peek((kind, tag, (i + 2) % 11))
                    i += 1
            except Exception as e:  # noqa: BLE001 - collected and asserted empty
                errors.append(e)

        def prober():
            try:
                while not stop.is_set():
                    for c in caches:
                        assert c.resident_bytes <= c.max_bytes
                        st = c.stats()
                        assert st["resident_bytes"] <= st["max_bytes"]
                        c.bytes_by_kind()
            except Exception as e:  # noqa: BLE001 - collected and asserted empty
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=writer, args=(t,)) for t in range(2)]
        threads.append(threading.Thread(target=prober))
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 1.0
            evicted = [0, 0]
            while time.monotonic() < deadline:
                for j, c in enumerate(caches):
                    evicted[j] += c.evict_kind("scan")
                    c.evict_kind("delta")
                    c.evict_kind("aggstate")
        finally:
            stop.set()
            for t in threads:
                t.join(30)
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert all(n > 0 for n in evicted)  # the race was real in both
        for c in caches:
            ledger_exact(c)
            c.evict_kind("scan")  # drain what landed after the storm
            assert c.evict_kind("scan") == 0


# ---------------------------------------------------------------------------
# TestSpillTier


def _spill_batch(M, seed=5, n=4_000):
    rng = np.random.default_rng(seed)
    return batch_of(M, pa.table({
        "k": rng.integers(0, 100, n).astype(np.int64),
        "v": rng.normal(0, 1, n),
        "tag": pa.array(rng.choice(["x", "y", "z"], n)),
    }))


def _spilled_cache(M, root, batch):
    """A cache sized so that a second entry demotes the first."""
    nb = M.sc.batch_nbytes(batch)
    c = M.sc.ServeCache(max_bytes=nb + 16, spill_dir=str(root / "_hyperspace_spill"),
                        spill_max_bytes=1 << 30)
    c.put(("scan", "fp-a", ("k",)), batch, nb)
    # zonemap is no spill kind: restoring fp-a displaces it for good
    c.put(("zonemap", "fp-b"), "displacer", nb)
    return c


def _spill_counters(c):
    st = c.stats()
    return {k: st[k] for k in ("spill_demotes", "spill_restores", "spill_drops", "spill_entries",
                               "spill_bytes", "spill_resident_bytes")}


class TestSpillTier:
    def test_demote_restore_bit_identical(self, tmp_path):
        def run(M):
            root = tmp_path / M.sc.__name__.split(".")[0]
            batch = _spill_batch(M)
            c = _spilled_cache(M, root, batch)
            demotes = c.spill_demotes
            paths = c.spill_paths()
            assert len(paths) == 1 and all(os.path.exists(p) for p in paths)
            restored = c.get(("scan", "fp-a", ("k",)))
            assert restored.to_arrow().equals(batch.to_arrow())
            # the restore unlinks the file; the live mapping keeps its pages
            assert not any(os.path.exists(p) for p in paths)
            # the mmap-aware ruler charges views, not decoded heap bytes
            assert M.sc.estimate_nbytes(restored) < M.sc.batch_nbytes(batch) / 4
            return demotes, c.spill_restores, _spill_counters(c)

        demotes, restores, counters = both(run)
        assert (demotes, restores) == (1, 1) and counters["spill_bytes"] > 0

    def test_torn_spill_file_degrades_to_miss(self, tmp_path):
        def run(M):
            c = _spilled_cache(M, tmp_path / M.sc.__name__.split(".")[0], _spill_batch(M))
            (path,) = c.spill_paths()
            with open(path, "wb") as f:
                f.write(b"HSSP1\0garbage")  # torn: magic ok, body junk
            return c.get(("scan", "fp-a", ("k",))), c.spill_drops, os.path.exists(path)

        assert both(run) == (None, 1, False)

    def test_spill_tier_byte_cap_reaps_oldest(self, tmp_path):
        def run(M):
            batch = _spill_batch(M)
            nb = M.sc.batch_nbytes(batch)
            cap = int(len(M.sc._spill_encode(batch)) * 1.5)  # room for ONE blob
            c = M.sc.ServeCache(max_bytes=nb + 16,
                                spill_dir=str(tmp_path / M.sc.__name__.split(".")[0]),
                                spill_max_bytes=cap)
            for i in range(3):
                c.put(("scan", f"fp-{i}", ("k",)), _spill_batch(M, seed=i), nb)
            assert c.stats()["spill_resident_bytes"] <= cap
            return c.spill_demotes, len(c.spill_paths())

        assert both(run) == (2, 1)

    def test_unspillable_value_dropped_not_crashed(self, tmp_path):
        def run(M):
            c = M.sc.ServeCache(max_bytes=1_016,
                                spill_dir=str(tmp_path / M.sc.__name__.split(".")[0]),
                                spill_max_bytes=1 << 30)
            c.put(("scan", "fp-a"), lambda: None, 1_000)  # refuses to pickle
            c.put(("scan", "fp-b"), "displacer", 1_000)
            return c.spill_drops, c.get(("scan", "fp-a")), c.spill_paths()

        assert both(run) == (1, None, set())

    def test_metadata_kinds_evict_to_oblivion(self, tmp_path):
        def run(M):
            c = M.sc.ServeCache(max_bytes=1_016,
                                spill_dir=str(tmp_path / M.sc.__name__.split(".")[0]),
                                spill_max_bytes=1 << 30)
            c.put(("zonemap", "fp-a"), {"z": 1}, 1_000)
            c.put(("scan", "fp-b"), "displacer", 1_000)
            return c.spill_demotes, c.get(("zonemap", "fp-a"))

        assert both(run) == (0, None)

    def test_clear_empties_spill_tier(self, tmp_path):
        def run(M):
            c = _spilled_cache(M, tmp_path / M.sc.__name__.split(".")[0], _spill_batch(M))
            paths = c.spill_paths()
            assert paths
            c.clear()
            return c.spill_paths(), any(os.path.exists(p) for p in paths)

        assert both(run) == (set(), False)

    def test_spill_payload_buffers_are_equal(self):
        """A spilled batch's out-of-band segments (pickle protocol 5, each
        numpy buffer written raw) are the reference's bytes for the same
        seeded batch: the two decodes hold the same column buffers."""
        import pickle

        def run(M):
            bufs = []
            pickle.dumps(_spill_batch(M), protocol=5, buffer_callback=bufs.append)
            return [bytes(b.raw()) for b in bufs]

        assert len(both(run)) >= 3


# ---------------------------------------------------------------------------
# TestMmapEstimate


def _ipc_file(path, n):
    t = pa.table({"k": pa.array(range(n), type=pa.int64())})
    with ipc.new_file(path, t.schema) as w:
        w.write_table(t)
    return t


class TestMmapEstimate:
    def test_open_mmap_table_charges_tokens(self, tmp_path):
        n = 200_000
        path = str(tmp_path / "t.arrow")
        heap = _ipc_file(path, n)

        def run(M):
            assert M.sc.estimate_nbytes(heap) >= n * 8
            mapped = M.col.open_mmap_table(path)
            assert mapped.equals(heap)
            return (M.sc.estimate_nbytes(mapped) < n,
                    M.sc.estimate_nbytes(M.col.ColumnarBatch.from_arrow(mapped)) < n)

        assert both(run) == (True, True)

    def test_mapped_region_retires_with_owner(self, tmp_path):
        path = str(tmp_path / "t.arrow")
        _ipc_file(path, 50_000)

        def run(M):
            gc.collect()
            before = set(M.sc._mmap_regions)
            mapped = M.col.open_mmap_table(path)
            new = set(M.sc._mmap_regions) - before
            del mapped
            gc.collect()
            return len(new), bool(new & set(M.sc._mmap_regions))

        assert both(run) == (1, False)


# ---------------------------------------------------------------------------
# keys, defaults and the session's cache


def test_keys_and_defaults_match_the_reference(tmp_path):
    from hyperspace_tpu import constants as JC
    from hyperspace_tpu_torch import constants as TC

    for name in ("SERVE_CACHE_ENABLED", "SERVE_CACHE_MAX_BYTES", "SERVE_STREAM_ENABLED",
                 "SERVE_STREAM_MAX_BYTES", "SERVE_SPILL_MAX_BYTES", "SERVE_SPILL_ORPHAN_TTL_MS",
                 "IO_MMAP_ENABLED"):
        assert getattr(TC, name) == getattr(JC, name)
        assert getattr(TC, name + "_DEFAULT") == getattr(JC, name + "_DEFAULT")
    assert TC.HYPERSPACE_SPILL_DIR == JC.HYPERSPACE_SPILL_DIR
    tw = Twin(tmp_path)
    props = ("serve_cache_enabled", "serve_cache_max_bytes", "serve_stream_enabled",
             "serve_stream_max_bytes", "serve_spill_max_bytes", "io_mmap_enabled")
    for values in ({}, {TC.SERVE_STREAM_MAX_BYTES: 0, TC.SERVE_SPILL_MAX_BYTES: -5,
                        TC.SERVE_CACHE_ENABLED: "true", TC.IO_MMAP_ENABLED: True}):
        for k, v in values.items():
            tw.set(k, v)
        assert [getattr(tw.t.conf, p) for p in props] == [getattr(tw.j.conf, p) for p in props]


def test_session_cache_is_rebuilt_when_its_caps_change(tmp_path):
    """``session.serve_cache`` is None with the switch off, the same cache
    while its caps hold, and a new empty cache when ``maxBytes`` or the
    spill cap changes (its spill directory under the system path), in both
    packages."""
    tw = Twin(tmp_path)

    def observe(pkg, s):
        assert s.serve_cache is None
        s.conf.set(CACHE, True)
        first = s.serve_cache
        first.put(("scan", 1), "x", 10)
        same = s.serve_cache is first
        s.conf.set("hyperspace.serve.cache.maxBytes", 1 << 20)
        second = s.serve_cache
        s.conf.set("hyperspace.serve.spill.maxBytes", 1 << 20)
        third = s.serve_cache
        spill = os.path.relpath(third.spill_dir, tw.sys[pkg])
        s.clear_serve_cache()
        return (same, second is not first, len(second), first.spill_dir, spill,
                third.max_bytes, third.spill_enabled)

    assert observe("port", tw.t) == observe("jax", tw.j) == (
        True, True, 0, None, "_hyperspace_spill", 1 << 20, True)


def test_evict_paths_under_drops_every_key_naming_the_root(tmp_path):
    """``evict_paths_under`` drops resident and spilled entries whose keys
    name a file under an index directory, whatever the key's shape."""

    def run(M):
        c = M.sc.ServeCache(max_bytes=1_000, spill_dir=str(tmp_path / M.sc.__name__),
                            spill_max_bytes=1 << 20)
        fp = (("/lake/ix/v__=1/a.parquet", 1, 2),)
        c.put(("scan", fp), np.arange(10), 400)
        c.put(("joinside", (fp, (("/src/b.parquet", 3, 4),)), ("k",), ("k",)), np.arange(5), 400)
        c.put(("scan", (("/lake/other/c.parquet", 1, 2),)), np.arange(3), 400)  # demotes one
        dropped = c.evict_paths_under("/lake/ix")
        return dropped, len(c), len(c.spill_paths()), c.resident_bytes

    assert both(run) == (1, 1, 0, 400)


def test_aggstate_fanout_payload_installs_in_both_packages(tmp_path):
    """A committed index version's ``_aggstate.json`` entries as a fan-out
    payload: equal in both packages, installed under ``("aggstate", fp)``
    in a serve cache, and refused once a file changes."""
    src = _lineitem(tmp_path)
    tw = Twin(tmp_path)
    tw.create("covering", src, "fo", ["k"], ["q"])
    out = {}
    for pkg, s in tw.sides():
        files = sorted(tw.hs[pkg].get_index("fo").content.files) if pkg == "port" else sorted(
            s.index_manager.get_index_log_entry("fo").content.files)
        agg = __import__(("hyperspace_tpu_torch" if pkg == "port" else "hyperspace_tpu")
                         + ".indexes.aggindex", fromlist=["x"])
        payload = agg.fanout_payload(files)
        cache = PKGS[pkg].sc.ServeCache(1 << 20)
        ok = agg.install_fanout_payload(payload, cache)
        kinds_after = kinds(cache)
        os.utime(files[0], ns=(1, 1))
        stale = agg.install_fanout_payload(payload, PKGS[pkg].sc.ServeCache(1 << 20))
        out[pkg] = (len(payload["entries"]), ok, kinds_after, stale,
                    sorted(os.path.basename(f) for f in payload["files"]))
        agg.invalidate_local_cache()
    assert out["port"] == out["jax"]
    assert out["port"][1:4] == (True, ["aggstate"], False)
