"""The port's aggregate index plane against the JAX package, as
two-package differentials on the CPU: the ``_aggstate.json`` and
``_aggsample.parquet`` sidecars written at create, the row-group
classification, and the metadata aggregate
(``pipeline_compiler.try_metadata_aggregate``).

Both packages build the same covering index over the same source with
small row groups (so interior row groups are wholly inside a range and
the boundary ones are not): the sidecars are equal apart from the files'
mtimes, the samples are equal byte for byte, the FULL / EMPTY / PARTIAL
verdicts are equal, and the metadata route gives the rows of the fused
route, of the interpreted chain and of the JAX package (floats bit for
bit), with the reference's ``last_aggplane_stats``. An index built by
either package is answered from metadata by the other. The lazy backfill
covers an index without a sidecar and a sidecar entry gone stale, and a
file rewritten under the same name is read again, never served stale.
The lifecycle's cases (incremental refresh, vacuum) are in
``tests/test_torch_lifecycle_indexes.py``, the approximate plane's in
``tests/test_torch_approx.py``. Kept for a later item: the serve cache's
``aggstate`` kind (item 8)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu.execution import pipeline_compiler as JPC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes import aggindex as JA
from hyperspace_tpu.indexes import zonemaps as JZ
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.io import parquet as jpio
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.indexes import aggindex as TA
from hyperspace_tpu_torch.indexes import zonemaps as TZ
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.io import parquet as tpio
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.exceptions import HyperspaceException as THyperspaceException
from hyperspace_tpu_torch.kernels import KernelBuildError
from hyperspace_tpu_torch.ops import fused_agg as TFA
from hyperspace_tpu_torch.plan.nodes import AggSpec as TAggSpec
from torch_b5_cases import same_rows

AGG = "hyperspace.index.agg.enabled"
FUSED = "hyperspace.serve.fusedpipeline.enabled"


@pytest.fixture(autouse=True)
def small_row_groups(monkeypatch):
    """Index files with 512-row groups in both packages, and the fused
    route dispatched at test sizes; no assembled state carried between
    tests."""
    monkeypatch.setattr(tpio, "INDEX_ROW_GROUP_SIZE", 512)
    monkeypatch.setattr(jpio, "INDEX_ROW_GROUP_SIZE", 512)
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()
    yield
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()


def _write_files(root, name, table, n_files=4):
    d = root / name
    d.mkdir()
    n = table.num_rows
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(table.slice(lo, hi - lo), str(d / f"part{i}.parquet"))
    return str(d)


def _port(path, buckets=4):
    t = T.HyperspaceSession(device="cpu")
    t.conf.set("hyperspace.system.path", str(path))
    t.conf.set("hyperspace.index.num_buckets", buckets)
    return t


def _jax(path, buckets=4):
    j = JSession()
    j.conf.set(JC.INDEX_SYSTEM_PATH, str(path))
    j.conf.set(JC.INDEX_NUM_BUCKETS, buckets)
    j.conf.set(JC.BUILD_NUM_SHARDS, 1)
    return j


def _build(t, j, src, name, indexed, included):
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig(name, indexed, included))
    JHyperspace(j).create_index(j.read.parquet(src), JConfig(name, indexed, included))


def _data_dir(root, side, name):
    return os.path.join(str(root), side, name, "v__=1")


def _doc(path):
    with open(os.path.join(path, "_aggstate.json"), encoding="utf-8") as fh:
        doc = json.load(fh)
    for entry in doc["files"].values():
        entry.pop("mtime_ns")
    return doc


def _stats(d):
    return {k: v for k, v in d.items() if k != "wall_s"}


def _run(session, pc, src, query, fused=True, agg=True, enabled=True):
    session.conf.set(FUSED, fused)
    session.conf.set(AGG, agg)
    pc.last_aggplane_stats = {}
    pc.last_fused_stats = {}
    if enabled:
        session.enable_hyperspace()
    try:
        df = session.read.parquet(src)
        out = query(df, TF if pc is TPC else JF).collect()
    finally:
        session.disable_hyperspace()
        session.conf.set(FUSED, True)
        session.conf.set(AGG, True)
    return out, _stats(pc.last_aggplane_stats)


def _five_way(t, j, src, query, expect_meta=True):
    """``query(df, F)`` in the port with the metadata plane on, then off
    (fused route), then both off (interpreted chain), unindexed, and in
    the JAX package: the same rows; the port's metadata stats equal the
    reference's."""
    meta, stats = _run(t, TPC, src, query)
    fused, s2 = _run(t, TPC, src, query, agg=False)
    interp, _ = _run(t, TPC, src, query, fused=False, agg=False)
    raw, _ = _run(t, TPC, src, query, enabled=False)
    want, jstats = _run(j, JPC, src, query)
    assert s2 == {}
    assert same_rows(meta, fused) and same_rows(meta, interp) and same_rows(meta, want)
    assert meta.num_rows == raw.num_rows
    assert stats == jstats
    if expect_meta:
        assert stats.get("mode") == "agg_metadata" and stats["row_groups_metadata"] > 0, stats
    return meta, stats


def _dtype_tables(rng, n=8000):
    base = np.datetime64("2019-01-01")
    days = np.sort(rng.integers(0, 900, n))

    def num_aggs(F):
        return (F.count().alias("n"), F.count("c").alias("nc"), F.min("c").alias("mn"),
                F.max("c").alias("mx"), F.sum("c").alias("sc"), F.avg("c").alias("ac"),
                F.min("v").alias("mnv"), F.max("v").alias("mxv"))

    def temporal_aggs(F):
        return (F.count().alias("n"), F.min("c").alias("mn"), F.max("c").alias("mx"),
                F.min("v").alias("mnv"))

    common = {"p": pa.array(rng.integers(0, 10, n), type=pa.int64()),
              "v": pa.array(rng.normal(0, 5, n))}
    f = np.sort(rng.normal(0, 100, n))
    f[::31] = np.nan
    return {
        "ints": ({"c": pa.array(np.sort(rng.integers(-1000, 1000, n)), type=pa.int64()),
                  **common}, lambda df: (df["c"] >= -800) & (df["c"] < 800), num_aggs),
        "floats_nan": ({"c": pa.array(f), **common},
                       lambda df: (df["c"] > -250.0) & (df["c"] <= 250.0),
                       lambda F: (F.count().alias("n"), F.count("c").alias("nc"),
                                  F.min("c").alias("mn"), F.max("c").alias("mx"),
                                  F.sum("p").alias("sp"))),
        "strings": ({"c": pa.array([f"k{int(x):06d}" for x in rng.integers(0, 5000, n)]),
                     "s": pa.array(np.sort(rng.integers(0, 4000, n)), type=pa.int64()),
                     **common}, lambda df: (df["s"] >= 100) & (df["s"] < 3900),
                    lambda F: (F.count().alias("n"), F.count("c").alias("nc"))),
        "dates": ({"c": pa.array((base + days).astype("datetime64[D]")), **common},
                  lambda df: (df["c"] >= np.datetime64("2019-02-01"))
                  & (df["c"] <= np.datetime64("2021-04-01")), temporal_aggs),
        "ts_tz": ({"c": pa.array((base + days).astype("datetime64[us]"),
                                 type=pa.timestamp("us", tz="UTC")), **common},
                  lambda df: (df["c"] >= "2019-02-01") & (df["c"] < "2021-04-01"),
                  temporal_aggs),
        "nullable_int": ({"c": pa.array([None if i % 11 == 0 else int(x) for i, x in
                                         enumerate(np.sort(rng.integers(0, 10_000, n)))],
                                        type=pa.int64()), **common},
                         lambda df: (df["c"] > 500) & (df["c"] <= 9500),
                         lambda F: (F.count().alias("n"), F.count("c").alias("nc"),
                                    F.min("c").alias("mn"), F.max("c").alias("mx"),
                                    F.sum("c").alias("sc"))),
    }


DTYPES = _dtype_tables(np.random.default_rng(7))


def _dtype_world(tmp_path, name):
    arrays, cond_fn, agg_fn = DTYPES[name]
    src = _write_files(tmp_path, name, pa.table(arrays))
    t, j = _port(tmp_path / "port"), _jax(tmp_path / "jax")
    icols = ["s"] if name == "strings" else ["c"]
    _build(t, j, src, "idx", icols, [c for c in arrays if c not in icols])
    return src, t, j, cond_fn, agg_fn


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_sidecars_equal_the_reference(tmp_path, name):
    """``_aggstate.json`` equal apart from ``mtime_ns``, and
    ``_aggsample.parquet`` equal byte for byte (and as tables)."""
    _dtype_world(tmp_path, name)
    port, jax = _data_dir(tmp_path, "port", "idx"), _data_dir(tmp_path, "jax", "idx")
    assert _doc(port) == _doc(jax)
    got, want = (open(os.path.join(p, "_aggsample.parquet"), "rb").read() for p in (port, jax))
    assert got == want
    assert same_rows(pq.read_table(os.path.join(port, "_aggsample.parquet")),
                     pq.read_table(os.path.join(jax, "_aggsample.parquet")))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_metadata_plane_over_the_dtype_matrix(tmp_path, name):
    src, t, j, cond_fn, agg_fn = _dtype_world(tmp_path, name)
    out, _ = _five_way(t, j, src, lambda df, F: df.filter(cond_fn(df)).group_by("p")
                       .agg(*agg_fn(F)))
    assert 0 < out.num_rows <= 10


@pytest.mark.parametrize("name", ["ints", "floats_nan", "dates", "nullable_int"])
def test_row_group_verdicts_equal_the_reference(tmp_path, name):
    """``classify_row_groups`` over the port's index: the JAX package's
    verdicts, cell for cell."""
    src, t, j, cond_fn, agg_fn = _dtype_world(tmp_path, name)
    df = t.read.parquet(src)
    t.enable_hyperspace()
    plan = t.optimize(df.filter(cond_fn(df)).group_by("p").agg(*agg_fn(TF)).logical_plan)
    t.disable_hyperspace()
    filt = plan.child
    while not hasattr(filt, "condition"):
        filt = filt.child
    rel = filt.child.relation
    fplan = TPC._lower_fused_agg(filt.condition, plan.group_by, plan.aggs,
                                 dict(rel.schema), rel.column_names)
    ivs = TZ.predicate_intervals_complete(filt.condition, rel.schema)
    got = TA.classify_row_groups(TA.agg_data_for(rel, t.conf, "p", "cpu"), rel, ivs, "p", fplan)
    jdf = j.read.parquet(src)
    jcond = cond_fn(jdf)
    jivs = JZ.predicate_intervals_complete(jcond.expr if hasattr(jcond, "expr") else jcond,
                                           rel.schema)
    want = JA.classify_row_groups(JA.agg_data_for(rel, None, None, "p"), rel, jivs, "p", fplan)
    assert got == want
    assert {k for _f, _g, k in got} >= {"full"}


def _boundary_world(tmp_path, n=8000, seed=11):
    rng = np.random.default_rng(seed)
    src = _write_files(tmp_path, "bnd", pa.table({
        "c": pa.array(np.sort(rng.integers(0, 100_000, n)), type=pa.int64()),
        "p": pa.array(rng.integers(0, 6, n), type=pa.int64()),
        "w": pa.array(rng.integers(0, 4, n), type=pa.int64()),
        "v": pa.array(rng.normal(10, 2, n)),
    }))
    t, j = _port(tmp_path / "port"), _jax(tmp_path / "jax")
    _build(t, j, src, "idx", ["c"], ["p", "w", "v"])
    return src, t, j


def test_ungrouped_with_boundary_row_groups(tmp_path):
    src, t, j = _boundary_world(tmp_path)
    out, stats = _five_way(t, j, src, lambda df, F: df.filter(
        (df["c"] >= 7_777) & (df["c"] < 77_777)).agg(
        F.count().alias("n"), F.min("v").alias("mnv"), F.max("v").alias("mxv"),
        F.sum("p").alias("sp"), F.avg("p").alias("ap")))
    assert stats["row_groups_scanned"] > 0 and stats["rows_scanned"] > 0
    assert out.num_rows == 1


def test_fully_covered_aggregate_reads_no_row_group(tmp_path):
    src, t, j = _boundary_world(tmp_path)
    _out, stats = _five_way(t, j, src, lambda df, F: df.filter(df["c"] >= 0).group_by("p")
                            .agg(F.count().alias("n"), F.sum("c").alias("sc")))
    assert stats["row_groups_scanned"] == 0 and stats["rows_scanned"] == 0
    assert stats["row_groups_metadata"] == stats["row_groups_total"]


def test_no_filter_via_the_aggregate_rule(tmp_path):
    src, t, j = _boundary_world(tmp_path)
    _out, stats = _five_way(t, j, src, lambda df, F: df.group_by("p").agg(
        F.count().alias("n"), F.max("c").alias("mk")))
    assert stats["rows_scanned"] == 0


def test_float_sum_declines_to_the_fused_route(tmp_path):
    src, t, j = _boundary_world(tmp_path)
    q = lambda df, F: df.filter(df["c"] >= 0).group_by("p").agg(F.sum("v").alias("sv"))  # noqa: E731
    _five_way(t, j, src, q, expect_meta=False)
    _out, stats = _run(t, TPC, src, q)
    assert stats == {} and TPC.last_fused_stats.get("mode") == "agg"


def test_in_predicate_declines(tmp_path):
    src, t, j = _boundary_world(tmp_path)
    _out, stats = _five_way(t, j, src, lambda df, F: df.filter(df["c"].isin([5, 50_000]))
                            .agg(F.count().alias("n")), expect_meta=False)
    assert stats == {}


def test_agg_plane_off_writes_no_sidecar(tmp_path):
    rng = np.random.default_rng(3)
    src = _write_files(tmp_path, "off", pa.table({"c": pa.array(rng.integers(0, 99, 900))}))
    t = _port(tmp_path / "port")
    t.conf.set(AGG, False)
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("idx", ["c"], []))
    names = os.listdir(_data_dir(tmp_path, "port", "idx"))
    assert "_aggstate.json" not in names and "_aggsample.parquet" not in names
    assert "_zonemaps.json" in names and "sidecar_capture" in t.build_stats


def test_create_records_the_captures_reads_folds_and_passes(tmp_path):
    """A create splits ``sidecar_capture`` into its reads and folds and
    counts the folds' fused passes and their chunks that overflowed B5f's
    one pass (none on the CPU, which folds by the plain version)."""
    rng = np.random.default_rng(4)
    src = _write_files(tmp_path, "stats", pa.table({
        "c": pa.array(rng.integers(0, 99, 900)), "p": pa.array(rng.integers(0, 5, 900))}))
    t = _port(tmp_path / "port")
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("idx", ["c"], ["p"]))
    st = t.build_stats
    assert "_aggstate.json" in os.listdir(_data_dir(tmp_path, "port", "idx"))
    assert st["sidecar_capture_read"] >= 0 and st["sidecar_capture_fold"] > 0
    assert st["sidecar_capture_read"] + st["sidecar_capture_fold"] <= st["sidecar_capture"]
    assert st["sidecar_capture_passes"] >= 1 and st["sidecar_capture_overflowed"] == 0


def _default_device_calls(tmp_path):
    """Each entry point of the aggregate plane, called without a device."""
    from types import SimpleNamespace

    table = pa.table({"g": pa.array([1, 2, 1], type=pa.int64()),
                      "v": pa.array([1.0, 2.0, 3.0])})
    d = tmp_path / "dflt"
    d.mkdir()
    pq.write_table(table, str(d / "part0.parquet"))
    path = str(d / "part0.parquet")
    schema = dict(zip(table.schema.names, table.schema.types))
    aggs = [TAggSpec("count", None, "n"), TAggSpec("sum", "v", "s")]
    plan = TPC._lower_from_terms((), ("g",), aggs, schema)
    batch = TBatch.from_arrow(table)
    index = SimpleNamespace(kind="CoveringIndex")
    rel = SimpleNamespace(files=[path])
    return {
        "AggState": lambda: TPC.AggState(plan),
        "partials_from_batch": lambda: TPC.partials_from_batch(plan, batch),
        "kernel_filter_aggregate": lambda: TPC.kernel_filter_aggregate(
            batch, (), ["g"], aggs, schema),
        "interpreted_filter_aggregate": lambda: TPC.interpreted_filter_aggregate(
            batch, (), ["g"], aggs, schema),
        "file_agg_doc": lambda: TA.file_agg_doc(path),
        "file_agg_docs": lambda: TA.file_agg_docs([path]),
        "capture_index_dir": lambda: TA.capture_index_dir(str(d), index),
        "capture_safely": lambda: TA.capture_safely(str(d), index),
        "agg_data_for": lambda: TA.agg_data_for(rel, None, "g"),
    }


@pytest.mark.parametrize("entry", [
    "AggState", "partials_from_batch", "kernel_filter_aggregate",
    "interpreted_filter_aggregate", "file_agg_doc", "file_agg_docs", "capture_index_dir",
    "capture_safely", "agg_data_for"])
def test_entry_points_default_to_cuda(tmp_path, monkeypatch, entry):
    """Called without a device, every entry point of the aggregate plane
    runs on cuda, as the session does: without a card it raises, never
    falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(THyperspaceException, match="CUDA"):
        _default_device_calls(tmp_path)[entry]()


class _Broken:
    """Stands in for the fused fold (``ops/fused_agg.fused_filter_agg``)
    and raises ``fault`` on every chunk."""

    def __init__(self, fault):
        self.fault = fault

    def __call__(self, state, chunk):
        raise self.fault


@pytest.mark.parametrize("fault, fails", [
    (RuntimeError("B5f group pass failed: CUDA error 700"), True),
    (KernelBuildError("nvcc refused fused_agg.cu"), True),
    (OSError("unreadable index file"), False),
    (ValueError("uncapturable column set"), False),
])
def test_capture_absorbs_faults_of_the_data_only(tmp_path, monkeypatch, fault, fails):
    """A kernel that fails to build or launch during the capture fails the
    create; a fault of the data leaves the index without its sidecars."""
    rng = np.random.default_rng(5)
    src = _write_files(tmp_path, "faults", pa.table({"c": pa.array(rng.integers(0, 99, 900))}))
    t = _port(tmp_path / "port")
    monkeypatch.setattr(TFA, "fused_filter_agg", _Broken(fault))
    create = lambda: T.Hyperspace(t).create_index(  # noqa: E731
        t.read.parquet(src), TConfig("idx", ["c"], []))
    if fails:
        with pytest.raises(type(fault), match=str(fault)):
            create()
        return
    create()
    names = os.listdir(_data_dir(tmp_path, "port", "idx"))
    assert "_aggstate.json" not in names and "_aggsample.parquet" not in names
    assert "_zonemaps.json" in names and "sidecar_capture" in t.build_stats


def test_backfill_launch_failure_fails_the_query(tmp_path, monkeypatch):
    """An index without its sidecar: a kernel that fails in the lazy
    backfill fails the aggregate, never turns into a silent scan."""
    src, t, _j = _boundary_world(tmp_path)
    for f in ("_aggstate.json", "_aggsample.parquet"):
        os.unlink(os.path.join(_data_dir(tmp_path, "port", "idx"), f))
    monkeypatch.setattr(TFA, "fused_filter_agg", _Broken(RuntimeError("CUDA error 700")))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _run(t, TPC, src, _lifecycle_query)


def _lifecycle_query(df, F):
    return df.filter(df["c"] >= 0).group_by("p").agg(F.count().alias("n"), F.sum("c").alias("sc"))


def test_stale_sidecar_entry_falls_back_per_file(tmp_path):
    src, t, j = _boundary_world(tmp_path)
    for side in ("port", "jax"):
        path = os.path.join(_data_dir(tmp_path, side, "idx"), "_aggstate.json")
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        doc["files"][sorted(doc["files"])[0]]["mtime_ns"] = 1
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
    _out, stats = _five_way(t, j, src, _lifecycle_query)
    assert stats["rows_scanned"] == 0


def test_missing_sidecar_is_backfilled_per_key(tmp_path):
    src, t, j = _boundary_world(tmp_path)
    for side in ("port", "jax"):
        for f in ("_aggstate.json", "_aggsample.parquet"):
            os.unlink(os.path.join(_data_dir(tmp_path, side, "idx"), f))
    _out, stats = _five_way(t, j, src, _lifecycle_query)
    assert stats["rows_scanned"] == 0
    # a second key over the same backfilled files: a fresh assembly
    _out, stats = _five_way(t, j, src, lambda df, F: df.filter(df["c"] >= 0).group_by("w")
                            .agg(F.count().alias("n")))
    assert stats["rows_scanned"] == 0


def test_rewritten_file_is_never_served_stale(tmp_path):
    """An index file rewritten in place under the same name (its size and
    mtime change): the metadata answer follows the new bytes."""
    src, t, j = _boundary_world(tmp_path)
    _five_way(t, j, src, _lifecycle_query)
    for side in ("port", "jax"):
        data = _data_dir(tmp_path, side, "idx")
        victim = sorted(f for f in os.listdir(data) if f.startswith("part"))[0]
        path = os.path.join(data, victim)
        table = pq.read_table(path)
        p = pa.array(np.asarray(table.column("p")) % 2, type=pa.int64())
        table = table.set_column(table.schema.get_field_index("p"), "p", p).slice(0, 700)
        st = os.stat(path)
        pq.write_table(table, path, row_group_size=512)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10_000_000))
    meta, stats = _run(t, TPC, src, _lifecycle_query)
    interp, _ = _run(t, TPC, src, _lifecycle_query, fused=False, agg=False)
    want, jstats = _run(j, JPC, src, _lifecycle_query)
    assert stats.get("mode") == "agg_metadata" and stats == jstats
    assert same_rows(meta, interp) and same_rows(meta, want)


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_indexes_are_answered_from_metadata_across_packages(tmp_path, creator):
    """An index built by one package answers from its sidecars in the
    other, with the same rows as the creating package's own answer."""
    rng = np.random.default_rng(41)
    n = 6000
    src = _write_files(tmp_path, "x", pa.table({
        "c": pa.array(np.sort(rng.integers(0, 50_000, n)), type=pa.int64()),
        "p": pa.array(rng.integers(0, 8, n), type=pa.int64()),
        "v": pa.array(rng.normal(0, 5, n)),
    }))
    root = tmp_path / "shared"
    t, j = _port(root), _jax(root)
    if creator == "jax":
        JHyperspace(j).create_index(j.read.parquet(src), JConfig("idx", ["c"], ["p", "v"]))
    else:
        T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("idx", ["c"], ["p", "v"]))
    q = lambda df, F: df.filter((df["c"] >= 1_000) & (df["c"] < 45_000)).group_by("p").agg(  # noqa: E731
        F.count().alias("n"), F.min("v").alias("mn"), F.max("c").alias("mx"))
    got, stats = _run(t, TPC, src, q)
    want, jstats = _run(j, JPC, src, q)
    assert stats.get("mode") == "agg_metadata" and stats == jstats
    assert stats["row_groups_metadata"] > 0
    assert same_rows(got, want)


def test_partials_fold_equals_one_pass():
    """``PartialsAccumulator`` over chunks of a batch equals one pass over
    it, through ``finalize_partials``."""
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.plan.nodes import AggSpec

    rng = np.random.default_rng(29)
    n = 4000
    g = rng.integers(0, 12, n).astype(np.float64)
    g[::13] = np.nan
    g[::17] = -0.0
    v = rng.normal(0, 3, n)
    v[::23] = np.nan
    table = pa.table({"g": pa.array([None if i % 19 == 0 else x for i, x in enumerate(g)]),
                      "v": pa.array(v), "w": pa.array(rng.integers(-50, 50, n))})
    batch = ColumnarBatch.from_arrow(table)
    aggs = [AggSpec("count", None, "n"), AggSpec("count", "v", "nv"), AggSpec("sum", "w", "sw"),
            AggSpec("min", "v", "mnv"), AggSpec("max", "v", "mxv"), AggSpec("min", "w", "mnw"),
            AggSpec("max", "w", "mxw")]
    fplan = TPC._lower_from_terms((), ("g",), aggs, dict(zip(table.schema.names,
                                                             table.schema.types)))
    whole = TPC.partials_from_batch(fplan, batch, device="cpu")
    acc = TPC.PartialsAccumulator(fplan)
    for lo in range(0, n, 700):
        acc.fold(TPC.partials_from_batch(fplan, batch.take(np.arange(lo, min(lo + 700, n))),
                                         device="cpu"))
    assert same_rows(TPC.finalize_partials(fplan, whole).to_arrow(),
                     TPC.finalize_partials(fplan, acc.snapshot()).to_arrow())


def test_float_key_first_values_across_full_and_boundary_row_groups(tmp_path):
    """A float group key holding -0.0 and 0.0 (one group), NaN payloads
    and nulls, answered from full row groups and boundary ones: each
    group's key value is its first row's, as the reference's fold
    leaves it."""
    rng = np.random.default_rng(43)
    n = 8000
    g = rng.choice(np.array([-0.0, 0.0, 1.5, np.nan, 2.5]), n)
    g[::37] = np.array([0x7FF8000000000123], dtype=np.uint64).view(np.float64)[0]
    src = _write_files(tmp_path, "fk", pa.table({
        "c": pa.array(np.sort(rng.integers(0, 100_000, n)), type=pa.int64()),
        "g": pa.array(g, mask=rng.random(n) < 0.05),
        "w": pa.array(rng.integers(-50, 50, n), type=pa.int64()),
        "v": pa.array(rng.normal(0, 1, n)),
    }))
    t, j = _port(tmp_path / "port"), _jax(tmp_path / "jax")
    _build(t, j, src, "idx", ["c"], ["g", "w", "v"])
    out, stats = _five_way(t, j, src, lambda df, F: df.filter(
        (df["c"] >= 3_333) & (df["c"] < 96_000)).group_by("g").agg(
        F.count().alias("n"), F.min("w").alias("mn"), F.max("v").alias("mx"),
        F.sum("w").alias("sw")))
    assert stats["row_groups_scanned"] > 0 and out.num_rows == 5


@pytest.mark.parametrize("fold_rows", [1, 5000])
def test_capture_does_not_depend_on_how_row_groups_are_batched(tmp_path, monkeypatch,
                                                               fold_rows):
    """The capture passes many row groups at once, up to
    ``_FUSED_FOLD_ROWS`` rows; any batching writes the reference's
    sidecar."""
    monkeypatch.setattr(TPC, "_FUSED_FOLD_ROWS", fold_rows)
    _boundary_world(tmp_path)
    assert _doc(_data_dir(tmp_path, "port", "idx")) == _doc(_data_dir(tmp_path, "jax", "idx"))
