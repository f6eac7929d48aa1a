"""The port's z-order covering index against the JAX package, end to end
on the CPU: the same seeded sources and index through both packages give
byte-identical z-order files (also split into several files), equal
``_zonemaps.json`` (with ``rg_zspans`` and the ``zorder`` spec) and
``_aggstate.json`` apart from ``mtime_ns``, byte-identical
``_aggsample.parquet``, equal explain text and the same rows in the same
order for filters on any indexed column (the second one alone too), with
the same files and row groups kept by z-span pruning; each package serves
the other's index. The reference's own z-order cases run on the port:
``tests/test_zorder.py::TestZOrderIndexE2E`` and the z-order cases of
``tests/test_agg_index.py`` (the metadata plane over a z-order index).
The z-span capture absorbs faults of the data only."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.execution import pipeline_compiler as JPC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes import aggindex as JA
from hyperspace_tpu.indexes import zonemaps as JZ
from hyperspace_tpu.indexes.zorder import ZOrderCoveringIndexConfig as JConfig
from hyperspace_tpu.io import parquet as jpio
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.indexes import aggindex as TA
from hyperspace_tpu_torch.indexes import zonemaps as TZ
from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndexConfig as TConfig
from hyperspace_tpu_torch.io import parquet as tpio
from hyperspace_tpu_torch.kernels import KernelBuildError
from hyperspace_tpu_torch.ops import zorder as TZO
from test_torch_agg_index import DTYPES, _five_way, _run
from torch_b5_cases import same_rows

ZBYTES = "hyperspace.index.zorder.targetSourceBytesPerPartition"
PRUNE = "hyperspace.serve.rangeprune.enabled"


@pytest.fixture(autouse=True)
def small_row_groups(monkeypatch):
    """Index files with 512-row groups in both packages (so a file holds
    several row groups for the spans to prune), the fused route
    dispatched at test sizes, and no assembled state carried between
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
    d = os.path.join(str(root), name)
    os.makedirs(d)
    n = table.num_rows
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(table.slice(lo, hi - lo), os.path.join(d, f"part{i}.parquet"))
    return d


def _port(path, zbytes=None):
    t = T.HyperspaceSession(device="cpu")
    t.conf.set("hyperspace.system.path", str(path))
    if zbytes is not None:
        t.conf.set(ZBYTES, zbytes)
    return t


def _jax(path, zbytes=None):
    j = JSession()
    j.conf.set(JC.INDEX_SYSTEM_PATH, str(path))
    j.conf.set(JC.BUILD_NUM_SHARDS, 1)
    if zbytes is not None:
        j.conf.set(JC.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION, zbytes)
    return j


def _build(t, j, src, name, indexed, included):
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig(name, indexed, included))
    JHyperspace(j).create_index(j.read.parquet(src), JConfig(name, indexed, included))


def _data_dir(session, name):
    return os.path.join(session.conf.get("hyperspace.system.path"), name, "v__=1")


def _doc(path, name):
    with open(os.path.join(path, name), encoding="utf-8") as fh:
        doc = json.load(fh)
    for entry in doc["files"].values():
        entry.pop("mtime_ns")
    return doc


def _lineitem(n=6000, seed=7):
    """A small lineitem in the bench.py shape, with NULL prices and keys
    beyond 2^53. (A NULL in an indexed column encodes as 0, so min/max
    scaling would push every other value of that column to the top
    words: the z-order column stays NULL-free, as bench.py's.)"""
    rng = np.random.default_rng(seed)
    ship = np.datetime64("1994-01-01") + rng.integers(0, 2400, n).astype("timedelta64[D]")
    order = np.argsort(ship, kind="stable")
    return pa.table({
        "l_orderkey": rng.integers(0, 1500, n)[order],
        "l_shipdate": pa.array(ship[order].astype("datetime64[D]")),
        "l_quantity": rng.integers(1, 51, n)[order],
        "l_extendedprice": pa.array(rng.normal(30000, 8000, n)[order],
                                    mask=rng.random(n) < 0.01),
        "l_bigkey": (2**60 + rng.integers(0, 4000, n))[order],
        "l_flag": pa.array([["A", "N", "R"][x] for x in rng.integers(0, 3, n)]),
    })


Z_IDX = ("z_idx", ["l_shipdate", "l_quantity"], ["l_orderkey", "l_bigkey"])
AGG_IDX = ("agg_idx", ["l_orderkey"], ["l_quantity", "l_extendedprice"])
ZLO, ZHI = np.datetime64("1995-06-01"), np.datetime64("1995-06-30")


@pytest.fixture(scope="module", params=[None, 40_000], ids=["one_file", "split"])
def world(request, tmp_path_factory):
    """z_idx and agg_idx built by both packages over one source; ``split``
    sets targetSourceBytesPerPartition so each index spans several files."""
    root = tmp_path_factory.mktemp("zorder_e2e")
    src = _write_files(root, "lineitem", _lineitem())
    t, j = _port(root / "port", request.param), _jax(root / "jax", request.param)
    mp = pytest.MonkeyPatch()
    mp.setattr(tpio, "INDEX_ROW_GROUP_SIZE", 512)
    mp.setattr(jpio, "INDEX_ROW_GROUP_SIZE", 512)
    try:
        for idx in (Z_IDX, AGG_IDX):
            _build(t, j, src, *idx)
    finally:
        mp.undo()
    return {"src": src, "t": t, "j": j, "split": request.param is not None}


def _files(d):
    return sorted(f for f in os.listdir(d) if f.startswith("part"))


@pytest.mark.parametrize("index", [Z_IDX[0], AGG_IDX[0]])
def test_index_files_byte_identical(world, index):
    port, jax = _data_dir(world["t"], index), _data_dir(world["j"], index)
    names = _files(port)
    assert names == _files(jax)
    assert all(n.endswith("-zorder.parquet") for n in names)
    assert (len(names) > 1) == world["split"]
    for name in names:
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(jax, name), "rb") as b:
            assert a.read() == b.read(), name
    rows = sum(pq.ParquetFile(os.path.join(port, n)).metadata.num_rows for n in names)
    assert rows == 6000


@pytest.mark.parametrize("index", [Z_IDX[0], AGG_IDX[0]])
def test_sidecars_equal_the_reference(world, index):
    port, jax = _data_dir(world["t"], index), _data_dir(world["j"], index)
    zm = _doc(port, "_zonemaps.json")
    assert zm == _doc(jax, "_zonemaps.json")
    assert zm["zorder"]["columns"] == dict([Z_IDX[:2], AGG_IDX[:2]])[index]
    assert all(e.get("rg_zspans") for e in zm["files"].values())
    assert _doc(port, "_aggstate.json") == _doc(jax, "_aggstate.json")
    with open(os.path.join(port, "_aggsample.parquet"), "rb") as a, \
            open(os.path.join(jax, "_aggsample.parquet"), "rb") as b:
        assert a.read() == b.read()


def _normalized_entry(session, name):
    """The final log entry with timestamps and ids dropped and the system
    path's components (which differ between the two builds) replaced."""
    system_path = session.conf.get("hyperspace.system.path")
    with open(os.path.join(system_path, name, "_hyperspace_log", "2")) as fh:
        entry = json.load(fh)

    def scrub(x):
        if isinstance(x, dict):
            return {k: scrub(v) for k, v in x.items()
                    if k not in ("timestamp", "modifiedTime", "id")}
        if isinstance(x, list):
            return [scrub(v) for v in x]
        return x

    text = json.dumps(scrub(entry), sort_keys=True)
    for part in system_path.strip("/").split("/"):
        text = text.replace(f'"name": "{part}"', '"name": "<sys>"')
    return json.loads(text)


def test_log_entries_equal_the_reference(world):
    got = _normalized_entry(world["t"], "z_idx")
    assert got == _normalized_entry(world["j"], "z_idx")
    assert got["derivedDataset"]["type"] == "ZOrderCoveringIndex"


QUERIES = {
    # bench.py's q_zrange
    "zrange": (lambda df: (df["l_shipdate"] >= ZLO) & (df["l_shipdate"] <= ZHI)
               & (df["l_quantity"] <= 5), ["l_shipdate", "l_quantity", "l_orderkey"]),
    # the second indexed column alone
    "second_col": (lambda df: df["l_quantity"] >= 45, ["l_quantity", "l_orderkey"]),
    "second_col_eq": (lambda df: df["l_quantity"] == 7, ["l_shipdate", "l_bigkey"]),
    "first_col": (lambda df: df["l_shipdate"] < np.datetime64("1994-03-01"),
                  ["l_shipdate", "l_orderkey"]),
    "in_list": (lambda df: df["l_quantity"].isin([3, 30]), ["l_quantity", "l_bigkey"]),
    "contradiction": (lambda df: (df["l_quantity"] > 20) & (df["l_quantity"] < 10),
                      ["l_quantity"]),
}


def _collect(session, src, cond_fn, cols, enabled=True, prune=True):
    session.conf.set(PRUNE, prune)
    if enabled:
        session.enable_hyperspace()
    try:
        df = session.read.parquet(src)
        return df.filter(cond_fn(df)).select(*cols).collect()
    finally:
        session.disable_hyperspace()
        session.conf.set(PRUNE, True)


def _prune_counts(stats):
    return {k: stats.get(k) for k in ("files_total", "files_kept", "row_groups_total",
                                      "row_groups_kept", "z_pruned")}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_rows_equal_the_reference_in_order(world, query):
    """Rows equal in order to the JAX package's and to the port's with
    pruning off, as a multiset to the plan without Hyperspace; both
    packages keep the same files and row groups."""
    t, j, src = world["t"], world["j"], world["src"]
    cond_fn, cols = QUERIES[query]
    for m in (TZ, JZ):
        m.invalidate_local_cache()
        m.last_prune_stats = {}
    got = _collect(t, src, cond_fn, cols)
    counts = _prune_counts(TZ.last_prune_stats)
    want = _collect(j, src, cond_fn, cols)
    assert counts == _prune_counts(JZ.last_prune_stats)
    assert same_rows(got, want)
    assert same_rows(got, _collect(t, src, cond_fn, cols, prune=False))
    raw = _collect(t, src, cond_fn, cols, enabled=False)
    order = [(c, "ascending") for c in cols]
    assert got.sort_by(order).equals(raw.sort_by(order))
    if query == "zrange":
        assert counts["z_pruned"] and counts["row_groups_kept"] < counts["row_groups_total"]


@pytest.mark.parametrize("query", ["zrange", "second_col"])
def test_explain_equals_the_reference(world, query):
    t, j, src = world["t"], world["j"], world["src"]
    cond_fn, cols = QUERIES[query]
    texts = []
    for s, hs in ((t, T.Hyperspace(t)), (j, JHyperspace(j))):
        s.enable_hyperspace()
        df = s.read.parquet(src)
        text = hs.explain(df.filter(cond_fn(df)).select(*cols))
        s.disable_hyperspace()
        texts.append(text.replace(s.conf.get("hyperspace.system.path"), "<sys>"))
    assert texts[0] == texts[1]
    assert "Hyperspace(Type: ZOCI, Name: z_idx" in texts[0]


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_each_package_serves_the_others_index(tmp_path, creator):
    src = _write_files(tmp_path, "lineitem", _lineitem(3000, seed=3))
    sys_path = tmp_path / "shared"
    t, j = _port(sys_path), _jax(sys_path)
    if creator == "port":
        T.Hyperspace(t).create_index(t.read.parquet(src), TConfig(*Z_IDX))
    else:
        JHyperspace(j).create_index(j.read.parquet(src), JConfig(*Z_IDX))
    for name in ("zrange", "second_col"):
        cond_fn, cols = QUERIES[name]
        for s, stats in ((t, TZ), (j, JZ)):
            stats.invalidate_local_cache()
            s.index_manager.clear_cache()
        got = _collect(t, src, cond_fn, cols)
        assert TZ.last_prune_stats["zonemap_files_sidecar"] > 0
        want = _collect(j, src, cond_fn, cols)
        assert same_rows(got, want) and got.num_rows > 0
        t.enable_hyperspace()
        df = t.read.parquet(src)
        assert "Type: ZOCI, Name: z_idx" in T.Hyperspace(t).explain(
            df.filter(cond_fn(df)).select(*cols))
        t.disable_hyperspace()


def test_keys_beyond_2_pow_53_are_never_pruned_away(world):
    """The z-box words are the data words' own float64 scaling rounded
    outward: every key beyond 2^53 of the index is found by an equality
    filter, in both packages alike."""
    t, j, src = world["t"], world["j"], world["src"]
    keys = sorted(set(pq.read_table(src, columns=["l_bigkey"])["l_bigkey"].to_pylist()))[::97]
    tb = _port(t.conf.get("hyperspace.system.path") + "_big")
    jb = _jax(j.conf.get("hyperspace.system.path") + "_big")
    _build(tb, jb, src, "big_idx", ["l_bigkey", "l_quantity"], [])
    for key in keys:
        got = _collect(tb, src, lambda df: df["l_bigkey"] == key, ["l_bigkey"])
        raw = _collect(tb, src, lambda df: df["l_bigkey"] == key, ["l_bigkey"], enabled=False)
        assert got.num_rows == raw.num_rows > 0, key
        assert same_rows(got, _collect(jb, src, lambda df: df["l_bigkey"] == key,
                                       ["l_bigkey"]))


# -- the reference's own cases (tests/test_zorder.py::TestZOrderIndexE2E) ----


def _sample(root):
    """The reference's sample_parquet fixture's data."""
    rng = np.random.default_rng(0)
    d = os.path.join(str(root), "sample")
    os.makedirs(d)
    for i in range(3):
        n = 100
        pq.write_table(pa.table({
            "date": pa.array([f"2017-09-{(j % 28) + 1:02d}" for j in range(n)]),
            "rguid": pa.array([f"guid-{i}-{j}" for j in range(n)]),
            "clicks": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
            "query": pa.array([["ibraco", "facebook", "donde", "banana"][j % 4]
                               for j in range(n)]),
            "imprs": pa.array(rng.integers(0, 100, n), type=pa.int64()),
        }), os.path.join(d, f"part-{i}.parquet"))
    return d


def test_create_and_serve_any_indexed_col(tmp_path):
    src = _sample(tmp_path)
    t = _port(tmp_path / "port")
    hs = T.Hyperspace(t)
    df = t.read.parquet(src)
    hs.create_index(df, TConfig("zidx", ["clicks", "imprs"], ["query"]))
    assert hs.indexes().column("name").to_pylist() == ["zidx"]
    q = lambda d: d.filter(d["imprs"] >= 50).select("imprs", "query")  # noqa: E731
    t.enable_hyperspace()
    assert "Hyperspace(Type: ZOCI, Name: zidx" in hs.explain(q(df))
    got = q(df).collect()
    t.disable_hyperspace()
    base = q(df).collect()
    order = [(c, "ascending") for c in got.column_names]
    assert got.sort_by(order).equals(base.sort_by(order)) and got.num_rows > 0


def test_multi_partition_write(tmp_path):
    src = _sample(tmp_path)
    t, j = _port(tmp_path / "port", 2000), _jax(tmp_path / "jax", 2000)
    _build(t, j, src, "zidx", ["clicks"], [])
    files = t.index_manager.get_index_log_entry("zidx").content.files
    assert len(files) > 1
    assert _files(_data_dir(t, "zidx")) == _files(_data_dir(j, "zidx"))


def test_quantile_build_byte_identical(tmp_path):
    """``hyperspace.index.zorder.quantile.enabled`` with its relative error:
    quantile-scaled words, the same files in both packages."""
    src = _write_files(tmp_path, "src", _lineitem(3000, seed=8))
    t, j = _port(tmp_path / "port"), _jax(tmp_path / "jax")
    t.conf.set("hyperspace.index.zorder.quantile.enabled", True)
    t.conf.set("hyperspace.index.zorder.quantile.relativeError", 0.05)
    j.conf.set(JC.ZORDER_QUANTILE_ENABLED, True)
    j.conf.set(JC.ZORDER_QUANTILE_RELATIVE_ERROR, 0.05)
    _build(t, j, src, *Z_IDX)
    assert t.conf.zorder_quantile_relative_error == 0.05
    names = _files(_data_dir(t, "z_idx"))
    assert names == _files(_data_dir(j, "z_idx"))
    for name in names:
        with open(os.path.join(_data_dir(t, "z_idx"), name), "rb") as a, \
                open(os.path.join(_data_dir(j, "z_idx"), name), "rb") as b:
            assert a.read() == b.read()


# -- the z-order cases of tests/test_agg_index.py, on both packages --------


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_metadata_plane_over_a_zorder_index(tmp_path, name):
    """tests/test_agg_index.py::TestMetadataPlaneMatrix::test_dtype_matrix_grouped."""
    arrays, cond_fn, agg_fn = DTYPES[name]
    src = _write_files(tmp_path, name, pa.table(arrays))
    t, j = _port(tmp_path / "port"), _jax(tmp_path / "jax")
    icols = ["s"] if name == "strings" else ["c"]
    _build(t, j, src, "z", icols, [c for c in arrays if c not in icols])
    assert _doc(_data_dir(t, "z"), "_aggstate.json") == _doc(_data_dir(j, "z"), "_aggstate.json")
    out, _ = _five_way(t, j, src, lambda df, F: df.filter(cond_fn(df)).group_by("p")
                       .agg(*agg_fn(F)))
    assert 0 < out.num_rows <= 10


def _boundary_world(tmp_path, n, seed, hi):
    rng = np.random.default_rng(seed)
    src = _write_files(tmp_path, "bnd", pa.table({
        "c": pa.array(np.sort(rng.integers(0, hi, n)), type=pa.int64()),
        "p": pa.array(rng.integers(0, 6, n), type=pa.int64()),
        "v": pa.array(rng.normal(10, 2, n)),
    }))
    t, j = _port(tmp_path / "port"), _jax(tmp_path / "jax")
    _build(t, j, src, "z", ["c"], ["p", "v"])
    return src, t, j


def test_ungrouped_with_boundary(tmp_path):
    """...::test_ungrouped_with_boundary: interior row groups from metadata,
    boundary ones scanned."""
    src, t, j = _boundary_world(tmp_path, 8000, 11, 100_000)
    out, stats = _five_way(t, j, src, lambda df, F: df.filter(
        (df["c"] >= 7_777) & (df["c"] < 77_777)).agg(
        F.count().alias("n"), F.min("v").alias("mnv"), F.max("v").alias("mxv"),
        F.sum("p").alias("sp"), F.avg("p").alias("ap")))
    assert stats["row_groups_scanned"] > 0 and stats["rows_scanned"] > 0
    assert out.num_rows == 1


def test_fully_covered_zero_rows_read(tmp_path):
    """...::test_fully_covered_zero_rows_read."""
    src, t, j = _boundary_world(tmp_path, 6000, 13, 50_000)
    _out, stats = _five_way(t, j, src, lambda df, F: df.filter(df["c"] >= 0).group_by("p")
                            .agg(F.count().alias("n"), F.sum("c").alias("sc")))
    assert stats["row_groups_scanned"] == 0 and stats["rows_scanned"] == 0
    assert stats["row_groups_metadata"] == stats["row_groups_total"]


def test_float_sum_declines_to_fused(tmp_path):
    """...::test_float_sum_declines_to_fused."""
    src, t, j = _boundary_world(tmp_path, 5000, 19, 5000)
    q = lambda df, F: df.filter(df["c"] >= 0).group_by("p").agg(F.sum("v").alias("sv"))  # noqa: E731
    _five_way(t, j, src, q, expect_meta=False)
    _out, stats = _run(t, TPC, src, q)
    assert stats == {} and TPC.last_fused_stats.get("mode") == "agg"


# -- the z-span capture's faults -------------------------------------------


class _FailingCapture:
    """``interleave`` that raises ``fault`` from its second call on: the
    first is the build's, the rest the z-span capture's."""

    def __init__(self, fault):
        self.fault, self.calls, self.real = fault, 0, TZO.interleave

    def __call__(self, words, bits):
        self.calls += 1
        if self.calls > 1:
            raise self.fault
        return self.real(words, bits)


@pytest.mark.parametrize("fault, fails", [
    (KernelBuildError("nvcc refused zorder_interleave.cu"), True),
    (RuntimeError("z-order interleave kernel launch failed: CUDA error 700"), True),
    (OSError("disk gone"), False),
    (ValueError("bad words"), False),
])
def test_zspan_capture_absorbs_faults_of_the_data_only(tmp_path, monkeypatch, fault, fails):
    """A kernel that fails to build or launch fails the create; a fault of
    the data leaves the min/max sidecar without spans, as the
    reference's."""
    src = _write_files(tmp_path, "src", _lineitem(2000, seed=5))
    t = _port(tmp_path / "port")
    broken = _FailingCapture(fault)
    monkeypatch.setattr(TZO, "interleave", broken)
    hs = T.Hyperspace(t)
    if fails:
        with pytest.raises(type(fault)):
            hs.create_index(t.read.parquet(src), TConfig(*Z_IDX))
        assert hs.get_index("z_idx") is None
        return
    hs.create_index(t.read.parquet(src), TConfig(*Z_IDX))
    assert broken.calls == 2
    doc = _doc(_data_dir(t, "z_idx"), "_zonemaps.json")
    assert "zorder" not in doc and doc["files"]
    assert not any("rg_zspans" in e for e in doc["files"].values())
    assert hs.get_index("z_idx").state == "ACTIVE"


def test_zonemap_capture_defaults_to_cuda(tmp_path, monkeypatch):
    import torch

    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndex

    src = _write_files(tmp_path, "src", _lineitem(500, seed=9), n_files=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = ZOrderCoveringIndex(["l_orderkey"], [], "[]", 1 << 30)
    with pytest.raises(HyperspaceException, match="device='cpu'"):
        TZ.capture_index_dir(src, index)


def test_create_records_the_zorder_stages(tmp_path):
    src = _write_files(tmp_path, "src", _lineitem(1000, seed=6))
    t = _port(tmp_path / "port")
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig(*Z_IDX))
    assert {"scan", "z_address", "sort", "write", "zonemap_capture",
            "sidecar_capture"} <= set(t.build_stats)
