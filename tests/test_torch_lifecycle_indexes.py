"""The lifecycle of each index kind, the port against the JAX package
(``tests/torch_lifecycle_twin.py``): a covering, a z-order and a
data-skipping index taken through appends, a delete, incremental, quick
and full refreshes, optimize and vacuum, with the log entries, every
index file (bucket, z-order and sketch files byte for byte,
``_zonemaps.json`` and ``_aggstate.json`` apart from mtimes) and query
rows compared after each step; the join over buckets that span several
files after a merge refresh; the caches after a vacuum; and the
reference's lifecycle cases of ``test_range_prune.py``
(``TestLifecycleConsistency``), ``test_agg_index.py`` (``TestLifecycle``),
``test_zorder.py`` and ``test_dataskipping.py``.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from hyperspace_tpu.execution import pipeline_compiler as JPC
from hyperspace_tpu.indexes import aggindex as JA
from hyperspace_tpu.indexes import zonemaps as JZ
from hyperspace_tpu.io import parquet as jpio
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.indexes import aggindex as TA
from hyperspace_tpu_torch.indexes import zonemaps as TZ
from hyperspace_tpu_torch.io import parquet as tpio
from torch_lifecycle_twin import Twin, config

ROW_GROUP = 512


@pytest.fixture(autouse=True)
def small_row_groups(monkeypatch):
    """Index files with 512-row groups in both packages, the fused route
    dispatched at test sizes, no assembled state carried between tests."""
    monkeypatch.setattr(tpio, "INDEX_ROW_GROUP_SIZE", ROW_GROUP)
    monkeypatch.setattr(jpio, "INDEX_ROW_GROUP_SIZE", ROW_GROUP)
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()
    yield
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()


def _kv(rng, n, lo, hi):
    return pa.table(
        {
            "k": pa.array(np.sort(rng.integers(lo, hi, n)), type=pa.int64()),
            "p": pa.array(rng.integers(0, 10, n), type=pa.int64()),
            "v": pa.array(rng.normal(0, 5, n)),
        }
    )


def _lake(root, n=4000, n_files=4):
    d = root / "src"
    d.mkdir()
    t = _kv(np.random.default_rng(17), n, 0, 1000)
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(t.slice(lo, hi - lo), str(d / f"part{i}.parquet"))
    return str(d)


KINDS = {
    "covering": ("covering", ["k"], ["p", "v"]),
    "zorder": ("zorder", ["k", "p"], ["v"]),
    "dataskipping": ("ds", ("MinMaxSketch", "k"), ("BloomFilterSketch", "p", 0.01, 20)),
}


def _queries(kind):
    qs = {
        "range": lambda d: d.filter((d["k"] >= 100) & (d["k"] < 160)).select("k", "p", "v"),
        "new keys": lambda d: d.filter(d["k"] >= 1000).select("k", "p", "v"),
    }
    if kind == "covering":
        qs["point"] = lambda d: d.filter(d["k"] == 123).select("k", "v")
    if kind != "covering":
        qs["second column"] = lambda d: d.filter(d["p"] == 3).select("k", "p", "v")
    return qs


def _check(twin, kind):
    """Entries and files equal; each query's rows and plan equal the JAX
    package's; the range is served by the index (after a quick refresh
    through the compensating Union, as in the reference)."""
    twin.assert_equal("idx")
    for label, q in _queries(kind).items():
        _rows, text = twin.query(q)
        if label == "range":
            assert "Name: idx" in text.split("Plan without indexes:")[0], text


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_lifecycle_of_each_index_kind_matches_reference(tmp_path, kind):
    twin = Twin(tmp_path / "sys", _lake(tmp_path), num_buckets=4, lineage=True)
    src = twin.src
    rng = np.random.default_rng(5)
    twin.create(KINDS[kind][0], "idx", *KINDS[kind][1:])
    _check(twin, kind)
    # appends: a batch of a few rows (a few buckets), then a larger file;
    # their keys tie with earlier rows', so the rows' order within a key
    # (appended first, then the previous data kept) shows in the files
    pq.write_table(_kv(rng, 5, 0, 1100), os.path.join(src, "part4.parquet"))
    twin.run("refresh_index", "idx", "incremental")
    _check(twin, kind)
    pq.write_table(_kv(rng, 600, 500, 1500), os.path.join(src, "part5.parquet"))
    twin.run("refresh_index", "idx", "incremental")
    _check(twin, kind)
    # optimize (quick is a no-op below a threshold of 0), then vacuum the
    # files it replaced, which prunes the retained dirs' sidecars
    twin.set("hyperspace.index.optimize.fileSizeThreshold", 0)
    twin.run("optimize_index", "idx", "quick")
    twin.run("optimize_index", "idx", "full")
    twin.run("vacuum_index", "idx")
    _check(twin, kind)
    # a delete with an append: the appended rows and the previous data
    # minus the deleted file's lineage id, rewritten as one (OVERWRITE)
    os.remove(os.path.join(src, "part0.parquet"))
    pq.write_table(_kv(rng, 40, 0, 1000), os.path.join(src, "part8.parquet"))
    twin.run("refresh_index", "idx", "incremental")
    _check(twin, kind)
    # quick (recorded, served with the appended file compensated), then
    # incremental (the appended rows in the index data)
    pq.write_table(_kv(rng, 50, 0, 2000), os.path.join(src, "part6.parquet"))
    twin.run("refresh_index", "idx", "quick")
    _check(twin, kind)
    twin.run("refresh_index", "idx", "incremental")
    _check(twin, kind)
    # full refresh and vacuum: one version dir left
    pq.write_table(_kv(rng, 50, 0, 2000), os.path.join(src, "part7.parquet"))
    twin.run("refresh_index", "idx", "full")
    twin.run("vacuum_index", "idx")
    assert len(twin.versions("idx")) == 1
    _check(twin, kind)
    twin.run("delete_index", "idx")
    twin.run("restore_index", "idx")
    twin.run("delete_index", "idx")
    twin.run("vacuum_index", "idx")
    twin.assert_equal("idx")


def test_join_over_buckets_of_several_files_takes_the_resort_route(tmp_path, monkeypatch):
    """After merge refreshes a bucket spans several files, so its rows are
    no longer key-sorted: the co-bucketed join takes the per-bucket
    re-sort route and its pairs equal the JAX package's in order."""
    from hyperspace_tpu_torch.execution import join_exec

    rng = np.random.default_rng(3)
    root = tmp_path
    li = root / "li"
    li.mkdir()
    for i in range(2):
        pq.write_table(pa.table({"l_key": rng.integers(0, 400, 800), "l_q": rng.integers(0, 50, 800)}),
                       str(li / f"p{i}.parquet"))
    od = root / "ord"
    od.mkdir()
    pq.write_table(pa.table({"o_key": np.arange(400, dtype=np.int64),
                             "o_c": rng.integers(0, 9, 400)}), str(od / "p0.parquet"))
    twin = Twin(root / "sys", str(li), num_buckets=4, lineage=True)
    twin.create("covering", "l_idx", ["l_key"], ["l_q"])
    for pkg, s, hs in twin.sides():
        hs.create_index(s.read.parquet(str(od)), config(pkg, "covering", "o_idx", ["o_key"], ["o_c"]))
    for i in range(2):
        pq.write_table(pa.table({"l_key": rng.integers(0, 400, 50), "l_q": rng.integers(0, 50, 50)}),
                       str(li / f"p{2 + i}.parquet"))
        twin.run("refresh_index", "l_idx", "incremental")
    twin.assert_equal("l_idx")
    seen = []
    inner = join_exec.prepare_join_side

    def spy(*args, **kwargs):
        prep = inner(*args, **kwargs)
        seen.append(prep.sorted_buckets)
        return prep

    monkeypatch.setattr(join_exec, "prepare_join_side", spy)
    out = {}
    for pkg, s, hs in twin.sides():
        s.enable_hyperspace()
        o, l = s.read.parquet(str(od)), s.read.parquet(str(li))
        q = o.join(l, on=o["o_key"] == l["l_key"]).select("o_key", "o_c", "l_q")
        text = hs.explain(q).split("Plan without indexes:")[0]
        assert "Name: l_idx" in text and "Name: o_idx" in text, pkg
        seen.clear()
        out[pkg] = q.collect()
        if pkg == "port":
            assert sorted(seen) == [False, True]  # the lineitem side re-sorts
        s.disable_hyperspace()
        want = q.collect()
        assert out[pkg].num_rows == 1700
        assert out[pkg].sort_by([("o_key", "ascending"), ("l_q", "ascending")]).equals(
            want.sort_by([("o_key", "ascending"), ("l_q", "ascending")]))
    assert out["port"].equals(out["jax"])


def test_caches_after_vacuum_and_rebuild_read_the_new_files(tmp_path):
    """Zone maps, aggregate sidecars and footers are cached by (path,
    size, mtime_ns): a version dir vacuumed and written again at the same
    path serves the new files' rows, and so does a refresh after a
    vacuum of outdated versions."""
    from hyperspace_tpu_torch import functions as TF

    twin = Twin(tmp_path / "sys", _lake(tmp_path), num_buckets=4, lineage=True)
    twin.create("covering", "idx", ["k"], ["p", "v"])
    q = lambda d: d.filter((d["k"] >= 0) & (d["k"] < 7000)).select("k", "p")  # noqa: E731

    def count_by_p(session):
        df = session.read.parquet(twin.src)
        session.enable_hyperspace()
        return df.filter(df["k"] >= 0).group_by("p").agg(TF.count().alias("n")).collect()

    before = twin.query(q)[0]
    count_by_p(twin.t)
    pq.write_table(_kv(np.random.default_rng(8), 300, 5000, 7000),
                   os.path.join(twin.src, "part4.parquet"))
    twin.run("refresh_index", "idx", "full")
    twin.run("vacuum_index", "idx")
    after = twin.query(q)[0]
    assert after.num_rows == before.num_rows + 300
    twin.run("delete_index", "idx")
    twin.run("vacuum_index", "idx")
    os.remove(os.path.join(twin.src, "part1.parquet"))
    twin.create("covering", "idx", ["k"], ["p", "v"])  # v__=1 again
    assert twin.versions("idx") == ["v__=1"]
    rebuilt = twin.query(q)[0]
    assert rebuilt.num_rows == after.num_rows - 1000
    got = count_by_p(twin.t)
    twin.t.disable_hyperspace()
    df = twin.t.read.parquet(twin.src)
    want = df.filter(df["k"] >= 0).group_by("p").agg(TF.count().alias("n")).collect()
    assert got.equals(want)
    twin.assert_equal("idx")


# -- tests/test_range_prune.py::TestLifecycleConsistency ----------------------


def test_refresh_and_optimize_keep_maps_consistent(tmp_path):
    rng = np.random.default_rng(17)
    n = 6000
    d = tmp_path / "life"
    d.mkdir()
    t = pa.table({"k": pa.array(np.sort(rng.integers(0, 5000, n)), type=pa.int64()),
                  "p": pa.array(rng.integers(0, 10, n), type=pa.int64())})
    for i in range(4):
        pq.write_table(t.slice(i * n // 4, n // 4), str(d / f"part{i}.parquet"))
    twin = Twin(tmp_path / "sys", str(d), num_buckets=4)
    twin.create("covering", "ci", ["k"], ["p"])
    q = lambda df: df.filter((df["k"] >= 1000) & (df["k"] < 1500)).select("k", "p")  # noqa: E731

    def three_way():
        on = twin.query(q)[0]
        twin.set("hyperspace.serve.rangeprune.enabled", False)
        off = twin.query(q)[0]
        twin.set("hyperspace.serve.rangeprune.enabled", True)
        assert on.equals(off)
        assert TZ.last_prune_stats.get("row_groups_kept", 0) >= 0

    three_way()
    extra = pa.table({"k": pa.array(rng.integers(0, 5000, 500), type=pa.int64()),
                      "p": pa.array(rng.integers(0, 10, 500), type=pa.int64())})
    pq.write_table(extra, str(d / "part9.parquet"))
    twin.run("refresh_index", "ci", "incremental")
    three_way()
    twin.run("optimize_index", "ci", "full")
    three_way()
    entry = twin.t.index_manager.get_index_log_entry("ci")
    for vd in {os.path.dirname(f) for f in entry.content.files}:
        assert os.path.exists(os.path.join(vd, TZ.SIDECAR_NAME))
    twin.assert_equal("ci")


# -- tests/test_agg_index.py::TestLifecycle -----------------------------------


def _agg_lake(tmp_path, name, n=6000):
    rng = np.random.default_rng(31)
    t = pa.table({"c": pa.array(np.sort(rng.integers(0, 40_000, n)), type=pa.int64()),
                  "p": pa.array(rng.integers(0, 6, n), type=pa.int64()),
                  "w": pa.array(rng.integers(0, 4, n), type=pa.int64()),
                  "v": pa.array(rng.normal(0, 5, n))})
    d = tmp_path / name
    d.mkdir()
    for i in range(4):
        pq.write_table(t.slice(i * n // 4, n // 4), str(d / f"part{i}.parquet"))
    twin = Twin(tmp_path / "sys", str(d), num_buckets=4)
    twin.create("covering", f"ci_{name}", ["c"], ["p", "w", "v"])
    return twin


def _metadata_answer(twin):
    """The grouped count and sum over the index in both packages: rows
    equal in order, answered from the sidecars alone (no row scanned),
    the two packages' aggregate-plane stats equal."""
    from hyperspace_tpu import functions as JF
    from hyperspace_tpu_torch import functions as TF

    out = {}
    for (pkg, s, _hs), F, pc in zip(twin.sides(), (TF, JF), (TPC, JPC)):
        s.index_manager.clear_cache()
        s.enable_hyperspace()
        pc.last_aggplane_stats = {}
        df = s.read.parquet(twin.src)
        rows = (df.filter(df["c"] >= 0).group_by("p")
                .agg(F.count().alias("n"), F.sum("c").alias("sc")).collect())
        stats = {k: v for k, v in pc.last_aggplane_stats.items() if k != "wall_s"}
        s.disable_hyperspace()
        assert stats.get("rows_scanned") == 0, (pkg, stats)
        out[pkg] = (rows, stats)
    assert out["port"][0].equals(out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    return out["port"][0]


def _sidecar_paths(idx_root):
    out = []
    for dirpath, _dirs, files in os.walk(idx_root):
        if "_aggstate.json" in files:
            out.append(os.path.join(dirpath, "_aggstate.json"))
    return sorted(out)


def test_incremental_refresh_folds_appended(tmp_path):
    """An incremental refresh writes a NEW version dir whose sidecar covers
    only the appended files; earlier dirs keep theirs, and the merged
    serve still answers from metadata."""
    twin = _agg_lake(tmp_path, "inc")
    base = _metadata_answer(twin)
    idx_root = os.path.join(twin.tsys, "ci_inc")
    before = {p: os.path.getmtime(p) for p in _sidecar_paths(idx_root)}
    assert before
    extra = pa.table({"c": pa.array([7, 39_999, 12_345], type=pa.int64()),
                      "p": pa.array([1, 2, 3], type=pa.int64()),
                      "w": pa.array([0, 1, 2], type=pa.int64()),
                      "v": pa.array([1.0, 2.0, 3.0])})
    pq.write_table(extra, os.path.join(twin.src, "part_extra.parquet"))
    twin.run("refresh_index", "ci_inc", "incremental")
    after = _sidecar_paths(idx_root)
    assert len(after) == len(before) + 1  # one NEW dir sidecar
    for p, mt in before.items():
        assert os.path.getmtime(p) == mt  # old sidecars untouched
    out = _metadata_answer(twin)
    assert out.num_rows >= base.num_rows
    twin.assert_equal("ci_inc")


def test_stale_sidecar_after_refresh_falls_back_per_file(tmp_path):
    """After a merge refresh, an entry of the earlier dir's sidecar that no
    longer matches its file falls back PER FILE to the lazy backfill:
    still no row scanned, the rows equal the JAX package's."""
    twin = _agg_lake(tmp_path, "stale")
    rng = np.random.default_rng(2)
    pq.write_table(pa.table({"c": pa.array(rng.integers(0, 40_000, 20), type=pa.int64()),
                             "p": pa.array(rng.integers(0, 6, 20), type=pa.int64()),
                             "w": pa.array(rng.integers(0, 4, 20), type=pa.int64()),
                             "v": pa.array(rng.normal(0, 5, 20))}),
                   os.path.join(twin.src, "part_extra.parquet"))
    twin.run("refresh_index", "ci_stale", "incremental")
    for sys_path in (twin.tsys, twin.jsys):
        side = _sidecar_paths(os.path.join(sys_path, "ci_stale"))[0]
        with open(side, encoding="utf-8") as fh:
            doc = json.load(fh)
        doc["files"][sorted(doc["files"])[0]]["mtime_ns"] = 1  # stale
        with open(side, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
    for m in (TA, JA):
        m._sidecar_cached.cache_clear()
        m.invalidate_local_cache()
    _metadata_answer(twin)


# -- test_zorder.py / test_dataskipping.py lifecycle cases ---------------------


def test_zorder_refresh_incremental(tmp_path, sample_parquet):
    twin = Twin(tmp_path / "sys", sample_parquet)
    twin.create("zorder", "zidx", ["clicks"], ["query"])
    extra = pa.table({"date": ["2019-01-01"] * 4, "rguid": ["a", "b", "c", "d"],
                      "clicks": pa.array([11, 12, 13, 14], pa.int64()),
                      "query": ["zz"] * 4, "imprs": pa.array([1, 2, 3, 4], pa.int64())})
    pq.write_table(extra, os.path.join(sample_parquet, "part-z.parquet"))
    twin.run("refresh_index", "zidx", "incremental")
    rows, text = twin.query(lambda d: d.filter(d["clicks"] <= 20).select("clicks", "query"))
    assert "ZOCI" in text and "zz" in rows.column("query").to_pylist()
    twin.assert_equal("zidx")


def test_dataskipping_refresh_incremental_append_and_delete(tmp_path):
    d = tmp_path / "ranged"
    d.mkdir()
    for i in range(4):
        pq.write_table(pa.table({"clicks": pa.array(range(i * 1000, i * 1000 + 100), type=pa.int64()),
                                 "name": [f"file{i}"] * 100, "part": [f"p{i}"] * 100}),
                       str(d / f"f{i}.parquet"))
    twin = Twin(tmp_path / "sys", str(d))
    twin.create("ds", "ds", ("MinMaxSketch", "clicks"))
    os.remove(str(d / "f0.parquet"))
    pq.write_table(pa.table({"clicks": pa.array(range(9000, 9100), type=pa.int64()),
                             "name": ["file9"] * 100, "part": ["p9"] * 100}),
                   str(d / "f9.parquet"))
    twin.run("refresh_index", "ds", "incremental")
    q = lambda df: df.filter(df["clicks"] == 9050).select("clicks", "name")  # noqa: E731
    rows, text = twin.query(q)
    assert "Type: DS" in text and rows.num_rows == 1
    twin.t.enable_hyperspace()
    files = twin.t.optimize(q(twin.t.read.parquet(str(d))).logical_plan).collect_leaves()[0]
    assert [os.path.basename(f) for f in files.relation.files] == ["f9.parquet"]
    twin.assert_equal("ds")
