"""The port's range serve plane against the JAX package: zone maps,
row-group narrowing and the pruned scan, as two-package differentials.

The contract (``indexes/zonemaps.py``): pruned scan == full scan + mask
for every predicate and dtype. Each case builds the same covering index
with both packages and checks that, in the port, range pruning on, off
and the unindexed plan give the same rows in the same order; that those
rows equal the JAX package's; and that both packages keep the same files
and row groups. Both packages write the same ``_zonemaps.json`` (apart
from the files' mtimes) and serve each other's indexes the same way.

Bucket files of a covering index are hash buckets, so at these sizes the
row groups are made small (``INDEX_ROW_GROUP_SIZE`` patched alike in
both packages) for narrowing to have something to narrow; one case runs
at the real 64k-row groups. Cases kept for later items: z-order
(``TestZBoxRanges``), refresh and optimize (``TestLifecycleConsistency``),
Hybrid Scan (``TestHybridFallback``, now in ``tests/test_torch_hybrid.py``).
The serve cache's ``zonemap`` kind is held here too
(``test_serve_cache_zonemap_kind_evicts``)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import datetime as dt
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes import zonemaps as JZ
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.io import parquet as jpio
from hyperspace_tpu.plan import expressions as JE
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch.indexes import zonemaps as TZ
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.io import parquet as tpio
from hyperspace_tpu_torch.plan import expressions as TE

RANGEPRUNE = "hyperspace.serve.rangeprune.enabled"
N_BUCKETS = 4
SMALL_ROW_GROUPS = 500


@pytest.fixture
def small_row_groups(monkeypatch):
    """Index files written with 500-row groups by both packages."""
    monkeypatch.setattr(tpio, "INDEX_ROW_GROUP_SIZE", SMALL_ROW_GROUPS)
    monkeypatch.setattr(jpio, "INDEX_ROW_GROUP_SIZE", SMALL_ROW_GROUPS)


def _write_files(root, name, table, n_files=4):
    d = root / name
    d.mkdir()
    n = table.num_rows
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(table.slice(lo, hi - lo), str(d / f"part{i}.parquet"))
    return str(d)


def _sessions(root, num_buckets=N_BUCKETS):
    t = T.HyperspaceSession(device="cpu")
    t.conf.set("hyperspace.system.path", str(root / "port"))
    t.conf.set("hyperspace.index.num_buckets", num_buckets)
    j = JSession()
    j.conf.set(JC.INDEX_SYSTEM_PATH, str(root / "jax"))
    j.conf.set(JC.INDEX_NUM_BUCKETS, num_buckets)
    j.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
    return t, j


def _build(t, j, src, name, indexed, included):
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig(name, indexed, included))
    JHyperspace(j).create_index(j.read.parquet(src), JConfig(name, indexed, included))


def _prune_counts(stats):
    return {k: stats.get(k) for k in (
        "files_total", "files_kept", "row_groups_total", "row_groups_kept")}


def _collect(session, src, cond_fn, cols, enabled, prune):
    df = session.read.parquet(src)
    session.conf.set(RANGEPRUNE, prune)
    if enabled:
        session.enable_hyperspace()
    else:
        session.disable_hyperspace()
    try:
        return df.filter(cond_fn(df)).select(*cols).collect()
    finally:
        session.disable_hyperspace()
        session.conf.set(RANGEPRUNE, True)


def _same_rows(a: pa.Table, b: pa.Table) -> bool:
    """Rows equal in order, float columns compared bit for bit (NaN
    equals NaN, -0.0 differs from 0.0), unlike ``Table.equals``."""
    if a.schema != b.schema or a.num_rows != b.num_rows:
        return False
    for name in a.column_names:
        x, y = a.column(name).combine_chunks(), b.column(name).combine_chunks()
        if pa.types.is_floating(x.type):
            if not np.array_equal(np.asarray(x.is_null()), np.asarray(y.is_null())):
                return False
            xv = x.fill_null(0).to_numpy(zero_copy_only=False).view(np.int64)
            yv = y.fill_null(0).to_numpy(zero_copy_only=False).view(np.int64)
            if not np.array_equal(xv, yv):
                return False
        elif not x.equals(y):
            return False
    return True


def _three_way(t, j, src, cond_fn, cols):
    """The port's rows with range pruning on, off and unindexed are
    identical (rows and order) and equal the JAX package's; both
    packages keep the same files and row groups. Returns the rows and
    the port's pruning counts."""
    TZ.invalidate_local_cache()
    JZ.invalidate_local_cache()
    TZ.last_prune_stats = {}
    on = _collect(t, src, cond_fn, cols, True, True)
    port_counts = _prune_counts(TZ.last_prune_stats)
    JZ.last_prune_stats = {}
    ref = _collect(j, src, cond_fn, cols, True, True)
    assert port_counts == _prune_counts(JZ.last_prune_stats)
    off = _collect(t, src, cond_fn, cols, True, False)
    raw = _collect(t, src, cond_fn, cols, False, True)
    assert _same_rows(on, off), "rangeprune on/off results differ"
    assert _same_rows(on, ref), "the port's rows differ from the JAX package's"
    assert on.num_rows == raw.num_rows
    return on, port_counts


# -- interval extraction --------------------------------------------------------

SCHEMA = {"i": pa.int64(), "f": pa.float64(), "s": pa.string(), "d": pa.date32()}

INTERVAL_CASES = {
    "range conjuncts intersect": (
        lambda E: (E.Col("i") >= 3) & (E.Col("i") < 10) & (E.Col("i") > 4),
        {"i": (4, True, 10, True, False)}),
    "eq and contradiction": (
        lambda E: (E.Col("i") == 5) & (E.Col("i") > 7), {"i": "empty"}),
    "in hull and ne abstains": (
        lambda E: E.Col("i").isin(3, 9, 5) & (E.Col("f") != 1.0),
        {"i": (3, False, 9, False, False)}),
    "sub-day instant on a date never equals": (
        lambda E: E.Col("d") == "2020-01-01T12:00:00", {"d": "empty"}),
    "between-tick range snaps": (
        lambda E: E.Col("d") > "2020-01-01T12:00:00", None),
    "string columns str-cast": (
        lambda E: (E.Col("s") >= "b") & (E.Col("s") < "m"),
        {"s": ("b", False, "m", True, False)}),
    "case insensitive, or abstains": (
        lambda E: (E.Col("I") >= 1) & ((E.Col("f") > 0) | (E.Col("i") < 0)),
        {"i": (1, False, None, False, False)}),
    "float literal on int": (
        lambda E: (E.Col("i") > 2.5) & (E.Col("f") <= float("inf")), None),
    "nan literal abstains": (lambda E: E.Col("f") < float("nan"), {}),
    "in with null and strings": (lambda E: E.Col("s").isin("x", None, "c"), None),
    "in without a matchable literal": (lambda E: E.Col("i").isin("a"), {"i": "empty"}),
}


def _iv(iv):
    return "empty" if iv.empty else (iv.lo, iv.lo_strict, iv.hi, iv.hi_strict, iv.empty)


@pytest.mark.parametrize("case", sorted(INTERVAL_CASES))
def test_interval_extraction_matches_reference(case):
    build, want = INTERVAL_CASES[case]
    got = {k: _iv(v) for k, v in TZ.predicate_intervals(build(TE), SCHEMA).items()}
    ref = {k: _iv(v) for k, v in JZ.predicate_intervals(build(JE), SCHEMA).items()}
    assert repr(got) == repr(ref)
    if want is not None:
        assert got == want
    complete_t = TZ.predicate_intervals_complete(build(TE), SCHEMA)
    complete_j = JZ.predicate_intervals_complete(build(JE), SCHEMA)
    assert (complete_t is None) == (complete_j is None)
    if complete_t is not None:
        assert repr({k: _iv(v) for k, v in complete_t.items()}) == repr(
            {k: _iv(v) for k, v in complete_j.items()})


@pytest.mark.parametrize("v", [2**53, -(2**53), 0.1, 1e300, -0.0, 7, np.int64(5), 2.5])
def test_directed_rounding_matches_reference(v):
    assert TZ.f64_down(v) == JZ.f64_down(v) and TZ.f64_up(v) == JZ.f64_up(v)
    assert TZ.f64_down(v) <= v <= TZ.f64_up(v)


@pytest.mark.parametrize(
    "v", [2**53 + 1, -(2**53) - 1, 2**63 - 1, -(2**63) + 1, np.int64(2**53 + 1)])
def test_directed_rounding_is_exact_beyond_2_53(v):
    """Ints beyond 2^53 round outward. The JAX package compares them with
    an ``np.float64`` on the left, which rounds the int first, so its
    ``f64_up(2^53 + 1)`` is 2^53 (ROADMAP C.3); the port's is not."""
    w = int(v)  # Python compares a float with an int exactly
    assert TZ.f64_down(v) <= w <= TZ.f64_up(v)
    assert TZ.f64_down(v) < TZ.f64_up(v)
    assert not JZ.f64_down(v) <= w <= JZ.f64_up(v)


def test_bounds_beyond_2_53_prune_soundly(tmp_path):
    """int64 keys around 2^53 with two-row groups: ``c < 2^53 + 1`` keeps
    the groups whose least key is 2^53 in the port, so the pruned rows
    equal the unpruned ones. The JAX package rounds the bound down to 2^53
    and drops them (ROADMAP C.3): it returns 4 of the 6 rows."""
    big = 2**53
    src = tmp_path / "big"
    src.mkdir()
    keys = [big - 4, big - 3, big - 2, big - 1, big, big, big + 2, big + 2]
    pq.write_table(pa.table({"c": pa.array(keys, type=pa.int64())}), str(src / "p.parquet"))
    t, j = _sessions(tmp_path, num_buckets=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpio, "INDEX_ROW_GROUP_SIZE", 2)
        mp.setattr(jpio, "INDEX_ROW_GROUP_SIZE", 2)
        _build(t, j, str(src), "ci_2_53", ["c"], [])
    for cond_fn in (lambda df: df["c"] < big + 1, lambda df: df["c"] <= big + 1,
                    lambda df: df["c"] > big - 1, lambda df: df["c"] >= big + 1):
        on = _collect(t, str(src), cond_fn, ["c"], True, True)
        assert on.equals(_collect(t, str(src), cond_fn, ["c"], True, False))
        assert on.equals(_collect(j, str(src), cond_fn, ["c"], True, False))
    ref = _collect(j, str(src), lambda df: df["c"] < big + 1, ["c"], True, True)
    assert ref.num_rows == 4


# -- the superset-safety matrix -----------------------------------------------


def _dtype_tables(rng, n=8000):
    base = np.datetime64("2019-01-01")
    days = np.sort(rng.integers(0, 900, n))
    p = pa.array(rng.integers(0, 10, n), type=pa.int64())
    f = rng.normal(0, 100, n)
    f[::31] = np.nan
    return {
        "ints": ({"c": pa.array(np.sort(rng.integers(-1000, 1000, n)), type=pa.int64()),
                  "p": p}, lambda df: (df["c"] >= -100) & (df["c"] < 250)),
        "floats_nan": ({"c": pa.array(f), "p": p},
                       lambda df: (df["c"] > -50.0) & (df["c"] <= 50.0)),
        "strings": ({"c": pa.array([f"k{int(v):06d}" for v in rng.integers(0, 5000, n)]),
                     "p": p}, lambda df: (df["c"] >= "k001000") & (df["c"] < "k002000")),
        "dates": ({"c": pa.array((base + days).astype("datetime64[D]")), "p": p},
                  lambda df: (df["c"] >= np.datetime64("2019-06-01"))
                  & (df["c"] <= np.datetime64("2019-09-01"))),
        "ts_tz": ({"c": pa.array((base + days).astype("datetime64[us]"),
                                 type=pa.timestamp("us", tz="UTC")), "p": p},
                  lambda df: (df["c"] >= "2019-06-01") & (df["c"] < "2019-09-01")),
        "nullable_int": ({"c": pa.array(
            [None if i % 11 == 0 else int(v)
             for i, v in enumerate(np.sort(rng.integers(0, 10_000, n)))], type=pa.int64()),
            "p": p}, lambda df: (df["c"] > 2000) & (df["c"] <= 4000)),
    }


DTYPES = ("ints", "floats_nan", "strings", "dates", "ts_tz", "nullable_int")


@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_matrix(dtype, tmp_path, small_row_groups):
    arrays, cond_fn = _dtype_tables(np.random.default_rng(7))[dtype]
    table = pa.table(arrays)
    src = _write_files(tmp_path, dtype, table)
    t, j = _sessions(tmp_path)
    _build(t, j, src, f"ci_{dtype}", ["c"], ["p"])
    out, counts = _three_way(t, j, src, cond_fn, ["c", "p"])
    assert 0 < out.num_rows < table.num_rows, dtype
    assert counts["row_groups_total"] > N_BUCKETS  # several row groups a file


# case -> (condition, rows or None, whether row groups are dropped)
EQ_IN_CASES = {
    "eq": (lambda df: df["c"] == 123, None, True),
    "in": (lambda df: df["c"].isin(5, 123, 499), None, False),  # the hull spans all
    "narrow in": (lambda df: df["c"].isin(120, 123), None, True),
    "contradiction": (lambda df: (df["c"] > 400) & (df["c"] < 100), 0, True),
}


@pytest.mark.parametrize("case", sorted(EQ_IN_CASES))
def test_eq_and_in_predicates(case, tmp_path, small_row_groups):
    rng = np.random.default_rng(11)
    table = pa.table({"c": pa.array(np.sort(rng.integers(0, 500, 6000)), type=pa.int64()),
                      "p": pa.array(rng.integers(0, 10, 6000), type=pa.int64())})
    src = _write_files(tmp_path, "eqin", table)
    t, j = _sessions(tmp_path)
    _build(t, j, src, "ci_eqin", ["c"], ["p"])
    cond_fn, rows, drops = EQ_IN_CASES[case]
    out, counts = _three_way(t, j, src, cond_fn, ["c", "p"])
    if rows is not None:
        assert out.num_rows == rows
    assert (counts["row_groups_kept"] < counts["row_groups_total"]) == drops


def test_string_allnull_and_missing_stats(tmp_path, small_row_groups):
    """A row group holding only NULL strings (nulls sort first in their
    key-sorted bucket) prunes under a string comparison, since nulls never
    satisfy it, without tripping the object-array compares; the results
    stay identical three ways and across packages."""
    d = tmp_path / "strnull"
    d.mkdir()
    pq.write_table(pa.table({"c": pa.array([f"v{i:04d}" for i in range(2000)]),
                             "p": pa.array(np.arange(2000), type=pa.int64())}),
                   str(d / "a.parquet"))
    pq.write_table(pa.table({"c": pa.array([None] * 500, type=pa.string()),
                             "p": pa.array(np.arange(500), type=pa.int64())}),
                   str(d / "b.parquet"))
    t, j = _sessions(tmp_path, num_buckets=8)
    _build(t, j, str(d), "ci_sn", ["c"], ["p"])
    out, counts = _three_way(
        t, j, str(d), lambda df: (df["c"] >= "v0100") & (df["c"] < "v0200"), ["c", "p"])
    assert out.num_rows == 100
    entry = T.Hyperspace(t).get_index("ci_sn")
    zd = TZ.assemble_zone_data(tuple(entry.content.files), {"c": pa.string()})
    assert zd.cols["c"].allnull.any()
    assert counts["row_groups_kept"] < counts["row_groups_total"]


def test_pruning_actually_prunes(tmp_path, small_row_groups):
    """A narrow range drops row groups, the sidecar feeds the serve, and
    the pruned scan reads fewer rows."""
    rng = np.random.default_rng(13)
    table = pa.table({"c": pa.array(rng.integers(0, 100_000, 8000), type=pa.int64()),
                      "p": pa.array(rng.integers(0, 10, 8000), type=pa.int64())})
    src = _write_files(tmp_path, "prunes", table)
    t, j = _sessions(tmp_path)
    _build(t, j, src, "ci_pr", ["c"], ["p"])
    out, counts = _three_way(
        t, j, src, lambda df: (df["c"] >= 10_000) & (df["c"] < 12_000), ["c", "p"])
    assert out.num_rows > 0
    assert counts["row_groups_kept"] < counts["row_groups_total"] // 2, counts
    assert TZ.last_prune_stats["zonemap_files_sidecar"] == N_BUCKETS  # capture fed it
    assert TZ.last_prune_stats["zonemap_files_footer"] == 0


# -- row-group narrowing ---------------------------------------------------------


def test_row_group_read_matches_full(tmp_path):
    rng = np.random.default_rng(3)
    t = pa.table({"a": rng.integers(0, 100, 10_000)})
    p = str(tmp_path / "rg.parquet")
    pq.write_table(t, p, row_group_size=1000)
    full = tpio.read_table_row_groups([p], [None], ["a"])
    assert full.equals(pq.read_table(p))
    assert full.equals(jpio.read_table_row_groups([p], [None], ["a"]))
    sel = tpio.read_table_row_groups([p], [(0, 3, 7)], ["a"])
    ref = pa.concat_tables(
        [pq.ParquetFile(p).read_row_groups([i], columns=["a"]) for i in (0, 3, 7)])
    assert sel.equals(ref)
    two = tpio.read_table_row_groups([p, p], [(1,), None], ["a"])
    assert two.equals(jpio.read_table_row_groups([p, p], [(1,), None], ["a"]))
    empty = tpio.read_table_row_groups([p], [()], ["a"])
    assert empty.num_rows == 0 and empty.column_names == ["a"]


def test_multi_group_narrowing_end_to_end(tmp_path):
    """Above 64k rows a bucket file has several row groups at the real
    row-group size; a narrow range keeps a minority of them."""
    rng = np.random.default_rng(5)
    n = 200_000
    table = pa.table({"c": pa.array(rng.integers(0, 10**6, n), type=pa.int64()),
                      "p": pa.array(rng.integers(0, 10, n), type=pa.int64())})
    src = _write_files(tmp_path, "big", table, n_files=2)
    t, j = _sessions(tmp_path, num_buckets=2)
    _build(t, j, src, "ci_big", ["c"], ["p"])
    out, counts = _three_way(
        t, j, src, lambda df: (df["c"] >= 500_000) & (df["c"] < 520_000), ["c", "p"])
    assert out.num_rows > 0
    assert counts["row_groups_total"] >= 3
    assert counts["row_groups_kept"] < counts["row_groups_total"], counts


# -- stale sidecar entries ----------------------------------------------------------


class _FakeIndex:
    kind = "CoveringIndex"
    indexed_columns = ["a"]


def test_rewritten_file_ignores_stale_sidecar(tmp_path):
    rng = np.random.default_rng(19)
    p = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"a": rng.integers(0, 100, 1000)}), p, row_group_size=500)
    assert TZ.capture_index_dir(str(tmp_path), _FakeIndex())
    side = TZ._sidecar_for_dir(str(tmp_path))
    assert TZ._file_stats_from_sidecar(p, side) is not None
    # rewrite the file: size/mtime change, the sidecar entry is stale
    pq.write_table(pa.table({"a": rng.integers(500, 600, 2000)}), p, row_group_size=500)
    assert TZ._file_stats_from_sidecar(p, side) is None
    assert JZ._file_stats_from_sidecar(p, side) is None
    # assembly falls back to the (fresh) footer and stays correct
    zd = TZ.assemble_zone_data((p,), {"a": pa.int64()})
    assert zd.footer_files == 1 and zd.sidecar_files == 0
    cz = zd.cols["a"]
    assert cz.has.all() and float(cz.lo.min()) >= 500.0
    ref = JZ.assemble_zone_data((p,), {"a": pa.int64()}).cols["a"]
    for field in ("lo", "hi", "has", "allnull"):
        assert np.array_equal(getattr(cz, field), getattr(ref, field))


# -- the sidecar format ----------------------------------------------------------------

STAT_VALUES = [
    None, True, -5, 2.5, float("inf"), float("nan"), "abc", dt.date(2020, 1, 2),
    dt.datetime(2020, 1, 2, 3, 4, 5, 123456),
    dt.datetime(2020, 1, 2, tzinfo=dt.timezone.utc), dt.time(23, 59, 59),
    dt.timedelta(days=2, seconds=3, microseconds=4), np.int32(7), np.float64(1.5),
]


@pytest.mark.parametrize("i", range(len(STAT_VALUES)))
def test_sidecar_value_encoding_matches_reference(i):
    v = STAT_VALUES[i]
    enc = TZ._enc_stat(v)
    assert json.dumps(enc) == json.dumps(JZ._enc_stat(v))  # JSON-serializable, equal
    dec = TZ._dec_stat(enc)
    assert repr(dec) == repr(JZ._dec_stat(enc))
    if not (isinstance(v, float) and np.isnan(v)):
        assert dec == v
    assert TZ._dec_stat(TZ._enc_stat(object())) is None


def _sidecar(system_path, name):
    with open(os.path.join(system_path, name, "v__=1", TZ.SIDECAR_NAME)) as f:
        doc = json.load(f)
    for entry in doc["files"].values():
        entry.pop("mtime_ns")
    return doc


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """A covering index over a mixed-dtype table (nulls, NaN, strings,
    dates, timestamps), built by each package with 500-row groups."""
    root = tmp_path_factory.mktemp("torch_range_lake")
    rng = np.random.default_rng(23)
    n = 6000
    f = rng.normal(0, 10, n)
    f[::37] = np.nan
    table = pa.table({
        "k": pa.array(rng.integers(0, 20_000, n), mask=rng.random(n) < 0.01),
        "f": pa.array(f, mask=rng.random(n) < 0.02),
        "s": pa.array([f"w{int(x):05d}" for x in rng.integers(0, 3000, n)]),
        "d": pa.array((np.datetime64("2020-01-01")
                       + rng.integers(0, 700, n)).astype("datetime64[D]")),
        "ts": pa.array(rng.integers(1_600_000_000_000_000, 1_700_000_000_000_000, n),
                       type=pa.timestamp("us")),
    })
    src = _write_files(root, "src", table)
    t, j = _sessions(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpio, "INDEX_ROW_GROUP_SIZE", SMALL_ROW_GROUPS)
        mp.setattr(jpio, "INDEX_ROW_GROUP_SIZE", SMALL_ROW_GROUPS)
        _build(t, j, src, "mix", ["k"], ["f", "s", "d", "ts"])
    return {"root": root, "src": src, "t": t, "j": j}


def test_sidecar_equals_reference_apart_from_mtimes(lake):
    got = _sidecar(str(lake["root"] / "port"), "mix")
    want = _sidecar(str(lake["root"] / "jax"), "mix")
    assert len(got["files"]) == N_BUCKETS
    assert got == want


CROSS_QUERIES = {
    "key range": (lambda df: (df["k"] >= 5000) & (df["k"] < 5600), ["k", "f", "s"]),
    "key and float": (lambda df: (df["k"] > 100) & (df["k"] <= 9000) & (df["f"] < 0.0),
                      ["k", "f"]),
    "key and date": (lambda df: (df["k"] < 3000) & (df["d"] >= np.datetime64("2021-01-01")),
                     ["k", "d"]),
    "key and string": (lambda df: (df["k"] >= 12_000) & (df["s"] < "w01000"), ["k", "s"]),
    "key eq": (lambda df: df["k"] == 777, ["k", "ts"]),
    "key in": (lambda df: df["k"].isin(3, 9000, 19_999), ["k", "f"]),
}


@pytest.mark.parametrize("query", sorted(CROSS_QUERIES))
def test_each_package_prunes_the_other_index_alike(lake, query):
    """Each package serves the index the other built with the same rows,
    in order, keeping the same files and row groups as on its own."""
    cond_fn, cols = CROSS_QUERIES[query]
    root, src = lake["root"], lake["src"]
    port_on_jax, jax_on_port = _sessions(root)
    port_on_jax.conf.set("hyperspace.system.path", str(root / "jax"))
    jax_on_port.conf.set(JC.INDEX_SYSTEM_PATH, str(root / "port"))
    out, counts = _three_way(lake["t"], lake["j"], src, cond_fn, cols)
    cross, cross_counts = _three_way(port_on_jax, jax_on_port, src, cond_fn, cols)
    assert _same_rows(cross, out)
    assert cross_counts == counts
    assert counts["row_groups_total"] > N_BUCKETS


def test_serve_cache_zonemap_kind_evicts(tmp_path):
    """Assembled zone maps go into a serve cache under ``("zonemap", fp)``
    (a miss, then a hit from the cache once the module LRU is dropped) and
    leave with ``evict_kind("zonemap")``, in both packages; the two
    assemblies prune alike."""
    from hyperspace_tpu.execution.serve_cache import ServeCache as JCache
    from hyperspace_tpu.plan.nodes import Relation as JRelation
    from hyperspace_tpu_torch.execution.serve_cache import ServeCache as TCache
    from hyperspace_tpu_torch.plan.nodes import Relation as TRelation

    rng = np.random.default_rng(23)
    p = str(tmp_path / "g.parquet")
    pq.write_table(pa.table({"a": rng.integers(0, 100, 100)}), p)
    out = {}
    for Z, Relation, Cache in ((TZ, TRelation, TCache), (JZ, JRelation, JCache)):
        rel = Relation(root_paths=(str(tmp_path),), files=(p,), fmt="parquet",
                       schema_fields=(("a", pa.int64()),), index_info=("x", 1, "CI"))
        cache = Cache(1 << 20)
        Z.invalidate_local_cache()
        zd, hit = Z.zone_data_for(rel, cache)
        first = (hit, len(cache))
        Z.invalidate_local_cache()
        _zd2, hit2 = Z.zone_data_for(rel, cache)
        out[Z.__name__.split(".")[0]] = (first, hit2, cache.evict_kind("zonemap"), len(cache),
                                         cache.stats()["hits"], cache.stats()["misses"],
                                         zd.footer_files, zd.sidecar_files)
        Z.invalidate_local_cache()
    assert out["hyperspace_tpu_torch"] == out["hyperspace_tpu"] == (
        (False, 1), True, 1, 0, 1, 1, 1, 0)
