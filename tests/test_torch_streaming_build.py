"""The port's out-of-core build against the JAX package, on the CPU.

Every case of ``tests/test_streaming_build.py`` runs through both packages
at the same ``hyperspace.index.build.memoryBudgetBytes`` over the same
seeded sources (``torch_lifecycle_twin.Twin``: one source directory, a
system path each): the wave planner, budgeted covering builds (waves of
2 files, one file a wave), the wave-by-wave reads, the streamed index
serving queries, the two-pass z-order write over numeric (min/max and
quantile specs), string and constant keys, and the incremental refreshes
whose appended and previous-data sides stream, for the covering and the
z-order index; and ``CompositeScan``'s order. Each build's bucket and
z-order files and sidecars equal the JAX package's byte for byte, its log
entries apart from ids and timestamps, and no ``_spill_`` directory is
left. The reference's own assertions (streamed rows equal the in-memory
build's after sorting, the quantile layout as a multiset) are held on
the port too. The streaming-spill case of ``tests/test_partition_build.py``
runs with the port's pipelined writer on and off.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_lifecycle_twin import Twin, sorted_table

from hyperspace_tpu.indexes import covering_build as JB
from hyperspace_tpu_torch.indexes import covering_build as TB

BUDGET = "hyperspace.index.build.memoryBudgetBytes"
ZBYTES = "hyperspace.index.zorder.targetSourceBytesPerPartition"
QUANTILE = "hyperspace.index.zorder.quantile.enabled"
PF = "hyperspace.index.build.partitionFirst"


@pytest.fixture
def wide_parquet(tmp_path):
    """``tests/test_streaming_build.py::wide_parquet``: 8 files of 4,000
    rows, about 64 KB materialized each."""
    rng = np.random.default_rng(5)
    d = tmp_path / "wide"
    d.mkdir()
    for i in range(8):
        n = 4000
        t = pa.table(
            {
                "k": pa.array(rng.integers(0, 500, n), type=pa.int64()),
                "v": pa.array(rng.normal(size=n)),
            }
        )
        pq.write_table(t, d / f"part-{i}.parquet")
    return str(d)


def _files(src):
    return sorted(os.path.join(src, f) for f in os.listdir(src))


def _per_file(src):
    return TB.estimated_materialized_bytes(_files(src)[:1], "parquet")


def _entry_files(twin, name, pkg="port"):
    s = twin.t if pkg == "port" else twin.j
    return sorted(s.index_manager.get_index_log_entry(name).content.files)


def _no_spill(twin):
    for root in (twin.tsys, twin.jsys):
        for _d, dirs, _f in os.walk(root):
            assert not [d for d in dirs if d.startswith("_spill_")], root


def _track(monkeypatch):
    """Each package's ``SourceScan.materialize`` records how many files a
    call reads; returns {"port": [...], "jax": [...]}."""
    calls = {"port": [], "jax": []}
    for pkg, mod in (("port", TB), ("jax", JB)):
        real = mod.SourceScan.materialize

        def tracking(self, files=None, real=real, out=calls[pkg]):
            out.append(len(files if files is not None else self.files))
            return real(self, files)

        monkeypatch.setattr(mod.SourceScan, "materialize", tracking)
    return calls


def _served_equal(twin, q):
    """``q`` index-served in both packages: rows equal in order across the
    packages and as a multiset to the plan without Hyperspace."""
    twin.clear_cache()
    twin.query(q)


class TestWavePlanner:
    def test_waves_respect_budget(self, wide_parquet):
        files = _files(wide_parquet)
        assert TB.per_file_materialized_bytes(files, "parquet") == \
            JB.per_file_materialized_bytes(files, "parquet")
        per_file = _per_file(wide_parquet)
        waves = TB.plan_waves(files, "parquet", per_file * 3)
        assert waves == JB.plan_waves(files, "parquet", per_file * 3)
        assert len(waves) >= 3
        assert [f for w in waves for f in w] == files
        for w in waves[:-1]:
            assert len(w) <= 3

    def test_single_oversized_file_still_one_wave(self, wide_parquet):
        files = _files(wide_parquet)
        waves = TB.plan_waves(files, "parquet", 1)  # every file over budget
        assert waves == JB.plan_waves(files, "parquet", 1)
        assert [len(w) for w in waves] == [1] * len(files)

    def test_other_formats_estimate_twice_the_file(self, tmp_path):
        p = tmp_path / "a.csv"
        p.write_text("k,v\n1,2\n3,4\n")
        assert TB.per_file_materialized_bytes([str(p)], "csv") == \
            JB.per_file_materialized_bytes([str(p)], "csv") == [2 * os.path.getsize(p)]


class TestStreamingBuild:
    def _build(self, twin, src, name, budget, kind="covering", cols=(["k"], ["v"])):
        twin.set(BUDGET, budget)
        twin.create(kind, name, *cols)
        twin.assert_equal(name)
        return _entry_files(twin, name)

    def test_streamed_equals_in_memory_build(self, tmp_path, wide_parquet):
        twin = Twin(tmp_path, wide_parquet)
        files_mem = self._build(twin, wide_parquet, "mem", 0)
        files_stream = self._build(twin, wide_parquet, "stream", int(_per_file(wide_parquet) * 2.5))
        assert twin.t.build_stats["waves"] == 4
        assert twin.t.build_stats["spill_files"] == 32
        assert len(files_mem) == len(files_stream)
        for fm, fs in zip(files_mem, files_stream):
            assert os.path.basename(fm) == os.path.basename(fs)
            tm, ts = pq.read_table(fm), pq.read_table(fs)
            # same rows; bucket files key-sorted in both layouts
            key = lambda t: t.sort_by([("k", "ascending"), ("v", "ascending")])  # noqa: E731
            assert key(tm).equals(key(ts))
            ks = ts.column("k").to_pylist()
            assert ks == sorted(ks)
        _no_spill(twin)

    def test_streaming_never_materializes_more_than_wave(self, tmp_path, wide_parquet,
                                                         monkeypatch):
        """The scan is materialized wave by wave, never all files at once,
        in the same calls as the JAX package."""
        twin = Twin(tmp_path, wide_parquet)
        calls = _track(monkeypatch)
        self._build(twin, wide_parquet, "waves", int(_per_file(wide_parquet) * 2.5))
        assert calls["port"] == calls["jax"]
        assert max(calls["port"]) <= 2  # budget 2.5 files -> at most 2 per wave
        assert len(calls["port"]) >= 4

    def test_streamed_index_serves_queries(self, tmp_path, wide_parquet):
        twin = Twin(tmp_path, wide_parquet)
        self._build(twin, wide_parquet, "serveidx", int(_per_file(wide_parquet) * 2.5))
        _served_equal(twin, lambda d: d.filter(d["k"] == 42).select("k", "v"))
        t = twin.t
        df = t.read.parquet(wide_parquet)
        t.enable_hyperspace()
        assert "Hyperspace(Type: CI, Name: serveidx" in df.filter(df["k"] == 42).select(
            "k", "v").explain()

    @pytest.mark.parametrize("quantile", [False, True], ids=["minmax", "qt"])
    def test_zorder_streamed_equals_in_memory(self, tmp_path, wide_parquet, quantile,
                                              monkeypatch):
        """The two-pass streamed z-order write gives the JAX package's files
        at either budget, never reads more than a wave, and (min/max spec)
        the in-memory build's global row order."""
        twin = Twin(tmp_path, wide_parquet)
        twin.set(QUANTILE, quantile)
        twin.set(ZBYTES, 30_000)
        calls = _track(monkeypatch)
        files_mem = self._build(twin, wide_parquet, "zmem", 0, "zorder")
        assert not calls["port"] or max(calls["port"]) == 8  # in-memory: one full read
        calls["port"].clear()
        calls["jax"].clear()
        files_stream = self._build(twin, wide_parquet, "zstr", int(_per_file(wide_parquet) * 2.5),
                                   "zorder")
        assert calls["port"] == calls["jax"]
        assert calls["port"] and max(calls["port"]) <= 2  # streamed: never > one wave
        stats = twin.t.build_stats
        assert stats["waves"] == 4 and stats["ranges_merged"] >= 1
        flat = lambda files: [  # noqa: E731
            (k, v) for f in files for k, v in zip(*pq.read_table(f).to_pydict().values())
        ]
        if quantile:
            assert sorted(flat(files_mem)) == sorted(flat(files_stream))
        else:
            assert flat(files_mem) == flat(files_stream)
        _no_spill(twin)

    def test_zorder_streamed_string_keys_global_order(self, tmp_path):
        """String z-order keys use the global dictionary union: the streamed
        output equals the in-memory build's global order."""
        rng = np.random.default_rng(11)
        d = tmp_path / "zs"
        d.mkdir()
        # disjoint string ranges per file: the wave-local-rank failure mode
        for i, prefix in enumerate(["a", "k", "t", "z"]):
            t = pa.table({
                "s": pa.array([f"{prefix}{v:04d}" for v in rng.integers(0, 500, 2000)]),
                "v": pa.array(rng.normal(size=2000)),
            })
            pq.write_table(t, d / f"f{i}.parquet")
        twin = Twin(tmp_path / "sys", str(d))
        twin.set(ZBYTES, 20_000)
        mem = self._build(twin, str(d), "zs_mem", 0, "zorder", (["s"], ["v"]))
        per_file = TB.estimated_materialized_bytes([str(d / "f0.parquet")], "parquet")
        stream = self._build(twin, str(d), "zs_str", int(per_file * 1.5), "zorder",
                             (["s"], ["v"]))
        seq = lambda files: [  # noqa: E731
            s for f in files for s in pq.read_table(f).column("s").to_pylist()
        ]
        assert seq(stream) == seq(mem)
        assert seq(stream) == sorted(seq(stream))

    def test_zorder_streamed_constant_key_bounded(self, tmp_path):
        """A constant key funnels every row into one z-range; the merge
        splits through every plane, then writes each part alone."""
        d = tmp_path / "zc"
        d.mkdir()
        for i in range(4):
            pq.write_table(pa.table({
                "k": pa.array([7] * 2000, type=pa.int64()),
                "v": pa.array(np.arange(2000)),
            }), d / f"f{i}.parquet")
        twin = Twin(tmp_path / "sys", str(d))
        twin.set(ZBYTES, 20_000)
        files = self._build(twin, str(d), "zc", 1, "zorder")  # a pathological budget
        assert sum(pq.read_table(f).num_rows for f in files) == 8000
        assert twin.t.build_stats["ranges_split"] >= 1
        _no_spill(twin)

    def test_incremental_refresh_streams_appended(self, tmp_path, wide_parquet):
        twin = Twin(tmp_path, wide_parquet, lineage=True)
        self._build(twin, wide_parquet, "incr", 0)
        rng = np.random.default_rng(9)
        for i in range(2):
            pq.write_table(pa.table({
                "k": pa.array(rng.integers(0, 500, 4000), type=pa.int64()),
                "v": pa.array(rng.normal(size=4000)),
            }), os.path.join(wide_parquet, f"extra-{i}.parquet"))
        twin.set(BUDGET, 1)
        twin.clear_cache()
        twin.run("refresh_index", "incr", "incremental")
        twin.assert_equal("incr")
        assert twin.t.build_stats["waves"] == 2
        _no_spill(twin)
        _served_equal(twin, lambda d: d.filter(d["k"] == 7).select("k", "v"))


class TestStreamingIncrementalRefresh:
    """Both incremental-refresh inputs stream (the appended source files and,
    for deletes, the previous index data minus the deleted lineage), for the
    covering and the z-order index."""

    def test_covering_delete_refresh_streams(self, tmp_path, wide_parquet, monkeypatch):
        twin = Twin(tmp_path, wide_parquet, lineage=True)
        twin.create("covering", "cdel", ["k"], ["v"])
        for v in sorted(os.listdir(wide_parquet))[:2]:
            os.remove(os.path.join(wide_parquet, v))
        calls = _track(monkeypatch)
        twin.set(BUDGET, 1)
        twin.clear_cache()
        twin.run("refresh_index", "cdel", "incremental")
        assert calls["port"] == calls["jax"]
        # a budget of 1 byte: every wave one file, the previous index data
        # never materialized whole
        assert calls["port"] and max(calls["port"]) == 1
        twin.assert_equal("cdel")
        _no_spill(twin)
        _served_equal(twin, lambda d: d.filter(d["k"] == 7).select("k", "v"))

    def test_zorder_incremental_refresh_streams(self, tmp_path, wide_parquet, monkeypatch):
        twin = Twin(tmp_path, wide_parquet, lineage=True)
        # the refresh's 1-byte budget splits every z-range down to single
        # parts: about a thousand files written and captured, half a minute
        # or more, so a lease the heartbeat never renews in that time
        twin.set("hyperspace.recovery.leaseMs", 600_000)
        twin.create("zorder", "zincr", ["k"], ["v"])
        rng = np.random.default_rng(11)
        for i in range(2):
            pq.write_table(pa.table({
                "k": pa.array(rng.integers(0, 500, 4000), type=pa.int64()),
                "v": pa.array(rng.normal(size=4000)),
            }), os.path.join(wide_parquet, f"zextra-{i}.parquet"))
        victim = sorted(f for f in os.listdir(wide_parquet) if f.startswith("part-"))[0]
        os.remove(os.path.join(wide_parquet, victim))
        calls = _track(monkeypatch)
        twin.set(BUDGET, 1)
        twin.clear_cache()
        twin.run("refresh_index", "zincr", "incremental")
        assert calls["port"] == calls["jax"]
        assert calls["port"] and max(calls["port"]) == 1  # one file a materialize call
        twin.assert_equal("zincr")
        _no_spill(twin)
        _served_equal(twin, lambda d: d.filter((d["k"] >= 100) & (d["k"] < 140)).select("k", "v"))

    def test_full_refresh_streams(self, tmp_path, wide_parquet):
        """``refresh_full`` goes through the lazy create: the rebuilt
        version streams past the budget, in both index kinds."""
        twin = Twin(tmp_path, wide_parquet, lineage=True)
        twin.create("covering", "cf", ["k"], ["v"])
        twin.create("zorder", "zf", ["k"], ["v"])
        os.remove(_files(wide_parquet)[0])
        twin.set(BUDGET, int(_per_file(wide_parquet) * 2.5))
        twin.clear_cache()
        for name in ("cf", "zf"):
            twin.run("refresh_index", name, "full")
            assert twin.t.build_stats["waves"] == 4  # 7 files, 2 a wave
            twin.assert_equal(name)
        _no_spill(twin)

    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_composite_scan_preserves_order_and_columns(self, tmp_path, pkg):
        mod = TB if pkg == "port" else JB
        d = tmp_path / "cs"
        d.mkdir()
        pq.write_table(pa.table({"k": pa.array([1, 2], type=pa.int64()),
                                 "v": pa.array([0.1, 0.2])}), str(d / "a.parquet"))
        pq.write_table(pa.table({"k": pa.array([3], type=pa.int64()),
                                 "v": pa.array([0.3])}), str(d / "b.parquet"))
        s1, s2 = (mod.SourceScan(files=(str(d / f),), fmt="parquet", columns=("k", "v"),
                                 file_ids=None, select_cols=("k", "v"))
                  for f in ("a.parquet", "b.parquet"))
        cs = mod.CompositeScan((s1, s2))
        assert cs.files == s1.files + s2.files
        assert cs.materialize().column("k").values.tolist() == [1, 2, 3]
        assert cs.materialize([str(d / "b.parquet")]).column("k").values.tolist() == [3]
        assert cs.stats_view(["k"]).materialize().column_names == ["k"]
        empty = cs.empty_batch()
        assert empty.num_rows == 0 and empty.column_names == ["k", "v"]
        assert cs.estimated_bytes() == sum(cs.file_sizes)


@pytest.fixture
def tied_parquet(tmp_path):
    """``tests/test_partition_build.py::tied_parquet``."""
    rng = np.random.default_rng(21)
    d = tmp_path / "tied"
    d.mkdir()
    for i in range(4):
        n = 3000
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 3, n), type=pa.int64()),
            "s": pa.array([["aa", "bb", "cc"][v] for v in rng.integers(0, 3, n)]),
            "v": pa.array(rng.normal(size=n)),
        }), d / f"part-{i}.parquet")
    return str(d)


def test_streaming_spill_bit_identical(tmp_path, tied_parquet):
    """``tests/test_partition_build.py``'s streaming-spill case: a budgeted
    build over heavily tied keys goes through the wave / spill / merge
    loop; the port's files equal the JAX package's with the pipelined
    writer's key on and off (it does not reach the streamed route)."""
    twin = Twin(tmp_path, tied_parquet)
    twin.set(BUDGET, int(_per_file(tied_parquet) * 2.5))
    for pf in (True, False):
        name = f"pf{int(pf)}"
        twin.set(PF, pf)
        twin.create("covering", name, ["k"], ["s", "v"])
        twin.assert_equal(name)
        assert twin.t.build_stats["waves"] == 2
    on, off = (twin.index_files(n, "port") for n in ("pf1", "pf0"))
    assert {k.split("/", 1)[1]: v for k, v in on.items() if k.endswith(".parquet")} == \
        {k.split("/", 1)[1]: v for k, v in off.items() if k.endswith(".parquet")}
    _no_spill(twin)


def test_no_budget_reads_the_source_once(tmp_path, wide_parquet, monkeypatch):
    """With the budget at 0 the create, the incremental and the full
    refresh read their sources whole in one call, as before."""
    twin = Twin(tmp_path, wide_parquet, lineage=True)
    calls = _track(monkeypatch)
    twin.create("covering", "nb", ["k"], ["v"])
    assert calls["port"] == calls["jax"] == [8]
    assert "waves" not in twin.t.build_stats
    os.remove(_files(wide_parquet)[0])
    twin.clear_cache()
    twin.run("refresh_index", "nb", "incremental")
    twin.assert_equal("nb")
    assert calls["port"] == calls["jax"]
    t_all = sorted_table(pa.concat_tables(
        [pq.read_table(f) for f in _entry_files(twin, "nb")]).select(["k", "v"]))
    src = sorted_table(pa.concat_tables([pq.read_table(f) for f in _files(wide_parquet)]))
    assert t_all.equals(src)
