"""The port's data-skipping index against the JAX package, on the CPU.

First the reference's own cases (``tests/test_dataskipping.py``) on the
port: min/max, Bloom filter and partition sketches pruning source files,
a covering index outranking data skipping, the sketches' serialization
and the uint64 literal reps. Its Hybrid Scan case is in
``tests/test_torch_hybrid.py`` and its incremental refresh case in
``tests/test_torch_lifecycle_indexes.py``.

Then the differentials, each exact: the sketch table's parquet bytes for
each sketch kind over a dtype grid (all-null, constant and empty files
among them), the index directory's listing, the log entry apart from
timestamps and ids, ``hs.indexes()`` and ``hs.index(name)`` apart from
``indexLocation``, the explain text as a whole, the source files kept
and the rows in order for =, <, <=, >, >=, IN, AND and OR, literal
coercion, an untranslatable predicate (plan unchanged), an absent key
(no file left: an empty result with the source's schema), each package
serving the other's index, and the routes and stats of an aggregate and
a fused filter over a pruned scan. The sketches run on the session's
device, and a fault of kernel B7 fails the create or the query instead
of turning into an abstention.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

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
from hyperspace_tpu.indexes import sketches as JS
from hyperspace_tpu.indexes import zonemaps as JZ
from hyperspace_tpu.indexes.dataskipping import DataSkippingIndexConfig as JConfig
from hyperspace_tpu.io.columnar import Column as JColumn
from hyperspace_tpu.io.columnar import column_value_range as j_value_range
from hyperspace_tpu.rules import dataskipping_rule as JR
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.indexes import aggindex as TA
from hyperspace_tpu_torch.indexes import sketches as TS
from hyperspace_tpu_torch.indexes import zonemaps as TZ
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig
from hyperspace_tpu_torch.indexes.dataskipping import DataSkippingIndexConfig as TConfig
from hyperspace_tpu_torch.io.columnar import Column as TColumn
from hyperspace_tpu_torch.io.columnar import column_value_range as t_value_range
from hyperspace_tpu_torch.kernels import KernelBuildError, KernelLaunchError
from hyperspace_tpu_torch.ops import bloom as TB
from hyperspace_tpu_torch.rules import dataskipping_rule as TR
from test_torch_zorder_e2e import _normalized_entry
from torch_b5_cases import same_rows

SYS = "hyperspace.system.path"


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """The fused routes dispatched at test sizes, and no assembled state
    or sketch table carried between tests."""
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()
    for r in (TR, JR):
        r._load_sketch_table.cache_clear()
    yield


def _port(path):
    t = T.HyperspaceSession(device="cpu")
    t.conf.set(SYS, str(path))
    return t


def _jax(path):
    j = JSession()
    j.conf.set(JC.INDEX_SYSTEM_PATH, str(path))
    j.conf.set(JC.BUILD_NUM_SHARDS, 1)
    return j


# -- the reference's cases (tests/test_dataskipping.py) on the port ------------


@pytest.fixture
def session(tmp_path):
    return _port(tmp_path / "indexes")


@pytest.fixture
def hs(session):
    return T.Hyperspace(session)


@pytest.fixture
def ranged_parquet(tmp_path):
    """4 files with disjoint clicks ranges -> ideal for min/max pruning."""
    d = tmp_path / "ranged"
    d.mkdir()
    for i in range(4):
        t = pa.table(
            {
                "clicks": pa.array(range(i * 1000, i * 1000 + 100), type=pa.int64()),
                "name": [f"file{i}"] * 100,
                "part": [f"p{i}"] * 100,
            }
        )
        pq.write_table(t, d / f"f{i}.parquet")
    return str(d)


def scanned_files(session, df_plan):
    leaves = session.optimize(df_plan).collect_leaves()
    return leaves[0].relation.files


def sorted_table(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


class TestMinMaxSkipping:
    def test_prunes_files_and_matches(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("ds", TS.MinMaxSketch("clicks")))
        session.enable_hyperspace()
        q = lambda d: d.filter(d["clicks"] == 2050).select("clicks", "name")
        plan_files = scanned_files(session, q(df).logical_plan)
        assert len(plan_files) == 1 and "f2.parquet" in plan_files[0]
        plan = q(df).explain()
        assert "Hyperspace(Type: DS, Name: ds" in plan
        session.disable_hyperspace()
        base = q(df).collect()
        session.enable_hyperspace()
        got = q(df).collect()
        assert sorted_table(got).equals(sorted_table(base))
        assert got.num_rows == 1

    def test_range_and_in_predicates(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("ds", TS.MinMaxSketch("clicks")))
        session.enable_hyperspace()
        f = scanned_files(session, df.filter(df["clicks"] < 1050).select("clicks").logical_plan)
        assert len(f) == 2  # f0 fully, f1 partially
        f = scanned_files(
            session, df.filter(df["clicks"].isin(5, 3005)).select("clicks").logical_plan
        )
        assert len(f) == 2
        # conjunct with untranslatable part still prunes on the other
        f = scanned_files(
            session,
            df.filter((df["clicks"] == 5) & (df["name"] != "x")).select("clicks").logical_plan,
        )
        assert len(f) == 1

    def test_untranslatable_predicate_no_rewrite(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("ds", TS.MinMaxSketch("clicks")))
        session.enable_hyperspace()
        plan = df.filter(df["name"] == "file1").select("name").explain()
        assert "Hyperspace" not in plan


class TestBloomSkipping:
    def test_bloom_prunes_string_equality(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("dsb", TS.BloomFilterSketch("name", 0.01, 1000)))
        session.enable_hyperspace()
        q = lambda d: d.filter(d["name"] == "file3").select("clicks", "name")
        files = scanned_files(session, q(df).logical_plan)
        assert len(files) == 1 and "f3.parquet" in files[0]
        session.disable_hyperspace()
        base = q(df).collect()
        session.enable_hyperspace()
        assert sorted_table(q(df).collect()).equals(sorted_table(base))

    def test_bloom_float_literal_on_int_column(self, session, hs, ranged_parquet):
        """A float literal the executor would match (2050.0 == 2050) must
        NOT be pruned away by bit-exact rep hashing."""
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("dsb", TS.BloomFilterSketch("clicks", 0.01, 1000)))
        session.enable_hyperspace()
        q = lambda d: d.filter(d["clicks"] == 2050.0).select("clicks")
        session.disable_hyperspace()
        base = q(df).collect()
        session.enable_hyperspace()
        got = q(df).collect()
        assert got.num_rows == base.num_rows == 1
        # non-integral literal matches nothing -> pruned to zero files
        files = scanned_files(
            session, df.filter(df["clicks"] == 2050.5).select("clicks").logical_plan
        )
        assert files == ()

    def test_minmax_in_with_incomparable_literal(self, session, hs, ranged_parquet):
        """One bad IN value must make the sketch abstain, not kill the
        whole optimizer pass."""
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("ds", TS.MinMaxSketch("clicks")))
        session.enable_hyperspace()
        out = df.filter(df["clicks"].isin(5, "a")).select("clicks").collect()
        assert out.num_rows == 1

    def test_bloom_numeric_in(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("dsb", TS.BloomFilterSketch("clicks", 0.01, 1000)))
        session.enable_hyperspace()
        files = scanned_files(
            session, df.filter(df["clicks"].isin(50, 1050)).select("clicks").logical_plan
        )
        assert len(files) == 2


class TestPartitionSketch:
    def test_constant_column_pruning(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("dsp", TS.PartitionSketch("part")))
        session.enable_hyperspace()
        q = lambda d: d.filter(d["part"] == "p1").select("clicks", "part")
        files = scanned_files(session, q(df).logical_plan)
        assert len(files) == 1 and "f1.parquet" in files[0]
        session.disable_hyperspace()
        base = q(df).collect()
        session.enable_hyperspace()
        assert sorted_table(q(df).collect()).equals(sorted_table(base))


class TestDataSkippingLifecycle:
    def test_covering_index_outranks_dataskipping(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(df, TConfig("ds", TS.MinMaxSketch("clicks")))
        hs.create_index(df, CoveringIndexConfig("ci", ["clicks"], ["name"]))
        session.enable_hyperspace()
        plan = df.filter(df["clicks"] == 5).select("clicks", "name").explain()
        assert "Type: CI" in plan and "Type: DS" not in plan

    def test_sketch_roundtrip_serialization(self, session, hs, ranged_parquet):
        df = session.read.parquet(ranged_parquet)
        hs.create_index(
            df,
            TConfig("ds", TS.MinMaxSketch("clicks"), TS.BloomFilterSketch("name", 0.05, 500)),
        )
        session.index_manager.clear_cache()
        entry = session.index_manager.get_index_log_entry("ds")
        kinds = {s.kind for s in entry.derived_dataset.sketches}
        assert kinds == {"MinMaxSketch", "BloomFilterSketch"}


class TestValueRepUint64:
    def test_uint64_probe_matches_bit_view(self):
        """uint64 literals >= 2^63 probe with the int64 bit-view that
        io/columnar assigns as the column key rep."""
        v = (1 << 63) + 12345
        rep = TS._value_rep(v, "uint64")
        assert rep == int(np.uint64(v).view(np.int64))
        assert rep < 0
        assert TS._value_rep(1 << 64, "uint64") is TS._NO_MATCH
        assert TS._value_rep(-1, "uint64") is TS._NO_MATCH
        assert TS._value_rep((1 << 63) + 12345, "int64") is TS._NO_MATCH
        assert TS._value_rep(42, "uint32") == 42


# -- sketch tables over a dtype grid ------------------------------------------


def _dtype_grid():
    """name -> (arrow type, 200 values of the first file, the constant
    file's value). Each source has four files: the values (nulls among
    them), all nulls, one constant value, and no rows."""
    rng = np.random.default_rng(17)
    f64 = rng.normal(0, 100, 200)
    f64[[3, 50, 77, 120]] = [np.nan, -0.0, np.inf, -np.inf]
    base = np.datetime64("2001-01-01")
    return {
        "int8": (pa.int8(), rng.integers(-128, 128, 200).tolist(), -7),
        "int16": (pa.int16(), rng.integers(-30000, 30000, 200).tolist(), 300),
        "int32": (pa.int32(), rng.integers(-(2**31), 2**31 - 1, 200).tolist(), 12),
        "int64": (pa.int64(), rng.integers(-(2**63), 2**63 - 1, 200).tolist()
                  + [], -(2**63)),
        "uint64": (pa.uint64(), [(1 << 63) + int(x) for x in rng.integers(0, 2**40, 200)],
                   (1 << 64) - 1),
        "float32": (pa.float32(), f64.astype(np.float32).tolist(), -0.0),
        "float64": (pa.float64(), f64.tolist(), np.nan),
        "string": (pa.string(), [f"s{x}" for x in rng.integers(0, 50, 200)], "const"),
        "bool": (pa.bool_(), rng.random(200).__lt__(0.5).tolist(), True),
        "date32": (pa.date32(), (base + rng.integers(0, 5000, 200).astype("timedelta64[D]"))
                   .tolist(), base.tolist()),
        "timestamp": (pa.timestamp("us"), (base.astype("datetime64[us]") + rng.integers(
            0, 10**12, 200).astype("timedelta64[us]")).tolist(),
            base.astype("datetime64[us]").tolist()),
    }


DTYPES = _dtype_grid()
SKETCH_KINDS = {
    "minmax": lambda S: S.MinMaxSketch("c"),
    "bloom": lambda S: S.BloomFilterSketch("c", 0.01, 100),
    "partition": lambda S: S.PartitionSketch("c"),
}


def _dtype_source(root, name):
    t, values, const = DTYPES[name]
    values = list(values)
    values[::9] = [None] * len(values[::9])
    d = os.path.join(str(root), f"src_{name}")
    os.makedirs(d)
    files = {
        "a_values": values,
        "b_allnull": [None] * 200,
        "c_constant": [const] * 200,
        "d_empty": [],
    }
    for fname, col in files.items():
        pq.write_table(pa.table({"c": pa.array(col, type=t),
                                 "k": pa.array(range(len(col)), type=pa.int64())}),
                       os.path.join(d, f"{fname}.parquet"))
    return d


def _index_dir(session, name):
    return os.path.join(session.conf.get(SYS), name, "v__=1")


@pytest.mark.parametrize("kind", sorted(SKETCH_KINDS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sketch_table_byte_equal_over_the_dtype_grid(tmp_path, dtype, kind):
    """The sketch parquet written by each package is the same bytes, and
    the index directories list the same files (no sidecar: both captures
    leave a sketch table alone)."""
    src = _dtype_source(tmp_path, dtype)
    t, j = _port(tmp_path / "port"), _jax(tmp_path / "jax")
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("ds", SKETCH_KINDS[kind](TS)))
    JHyperspace(j).create_index(j.read.parquet(src), JConfig("ds", SKETCH_KINDS[kind](JS)))
    port, jax = _index_dir(t, "ds"), _index_dir(j, "ds")
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax)) == ["part-00000-sketch.parquet"]
    with open(os.path.join(port, "part-00000-sketch.parquet"), "rb") as a, \
            open(os.path.join(jax, "part-00000-sketch.parquet"), "rb") as b:
        assert a.read() == b.read()
    assert pq.read_table(os.path.join(port, "part-00000-sketch.parquet")).num_rows == 4


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_column_value_range_equals_the_reference(tmp_path, dtype):
    src = _dtype_source(tmp_path, dtype)
    for f in sorted(os.listdir(src)):
        arr = pq.read_table(os.path.join(src, f))["c"]
        got = t_value_range(TColumn.from_arrow(arr))
        want = j_value_range(JColumn.from_arrow(arr))
        assert repr(got) == repr(want), f


LITERALS = [0, -1, 7, 2050, 2050.0, 2050.5, -0.0, float("nan"), 1 << 63, (1 << 63) + 5,
            1 << 64, -(1 << 63), "a", "", True, None]


@pytest.mark.parametrize("type_str", ["int8", "int64", "uint32", "uint64", "float", "double",
                                      "halffloat", "string", "large_string", "bool",
                                      "date32[day]", "decimal128(10, 2)"])
def test_value_rep_equals_the_reference(type_str):
    for v in LITERALS:
        got, want = TS._value_rep(v, type_str), JS._value_rep(v, type_str)
        for t_sentinel, j_sentinel in ((TS._ABSTAIN, JS._ABSTAIN), (TS._NO_MATCH, JS._NO_MATCH)):
            assert (got is t_sentinel) == (want is j_sentinel), (v, type_str)
        if not isinstance(want, object.__class__) and want not in (JS._ABSTAIN, JS._NO_MATCH):
            assert got == want, (v, type_str)
    assert TS._value_rep(5, None) is TS._ABSTAIN


# -- one index through both packages: files kept, rows, explain ---------------

N_ROWS, N_ORDERS, N_FILES = 6000, 1500, 6


def _lineitem(n=N_ROWS, seed=11):
    """A small lineitem in ship-date order across its files, so min/max
    sketches on l_shipdate prune; l_orderkey over 1,500 orders, each in
    about three files; l_file constant a file."""
    rng = np.random.default_rng(seed)
    ship = np.sort(np.datetime64("1994-01-01") + rng.integers(0, 2400, n).astype("timedelta64[D]"))
    return pa.table({
        "l_orderkey": rng.integers(0, N_ORDERS, n),
        "l_shipdate": pa.array(ship.astype("datetime64[D]")),
        "l_quantity": rng.integers(1, 51, n),
        "l_extendedprice": pa.array(rng.normal(30000, 8000, n), mask=rng.random(n) < 0.01),
        "l_file": pa.array([f"f{i * N_FILES // n}" for i in range(n)]),
    })


def _write_source(root, table, name="lineitem"):
    d = os.path.join(str(root), name)
    os.makedirs(d)
    n = table.num_rows
    for i in range(N_FILES):
        lo, hi = i * n // N_FILES, (i + 1) * n // N_FILES
        pq.write_table(table.slice(lo, hi - lo), os.path.join(d, f"part{i}.parquet"))
    return d


def _sketches(S):
    return (S.MinMaxSketch("l_shipdate"), S.BloomFilterSketch("l_orderkey", 0.01, 1000),
            S.PartitionSketch("l_file"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataskipping")
    src = _write_source(root, _lineitem())
    t, j = _port(root / "port"), _jax(root / "jax")
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("ds", *_sketches(TS)))
    JHyperspace(j).create_index(j.read.parquet(src), JConfig("ds", *_sketches(JS)))
    keys = pq.read_table(src, columns=["l_orderkey"])["l_orderkey"].to_numpy()
    return {"src": src, "t": t, "j": j, "key": int(keys[0]), "key2": int(keys[-1])}


D1, D2 = np.datetime64("1994-08-01"), np.datetime64("1999-06-01")
COLS = ["l_orderkey", "l_shipdate", "l_quantity"]
QUERIES = {
    "eq": lambda df, w: df["l_orderkey"] == w["key"],
    "lt": lambda df, w: df["l_shipdate"] < D1,
    "le": lambda df, w: df["l_shipdate"] <= D1,
    "gt": lambda df, w: df["l_shipdate"] > D2,
    "ge": lambda df, w: df["l_shipdate"] >= D2,
    "in": lambda df, w: df["l_orderkey"].isin([w["key"], w["key2"], N_ORDERS + 3]),
    "and": lambda df, w: (df["l_shipdate"] >= D1) & (df["l_shipdate"] < D2)
    & (df["l_orderkey"] == w["key2"]),
    "and_one_side": lambda df, w: (df["l_shipdate"] < D1) & (df["l_quantity"] == 5),
    "or_both": lambda df, w: (df["l_orderkey"] == w["key"]) | (df["l_shipdate"] > D2),
    "or_one_side": lambda df, w: (df["l_orderkey"] == w["key"]) | (df["l_quantity"] == 5),
    "partition": lambda df, w: df["l_file"] == "f2",
    "untranslatable": lambda df, w: df["l_quantity"] == 5,
    "float_on_int": lambda df, w: df["l_orderkey"] == float(w["key"]),
    "fraction_on_int": lambda df, w: df["l_orderkey"] == w["key"] + 0.5,
    "string_on_int": lambda df, w: df["l_orderkey"] == "a",
    "absent": lambda df, w: df["l_orderkey"] == N_ORDERS + 3,
}
#: the queries no sketch can translate: the plan stays as it was
UNCHANGED = ("or_one_side", "untranslatable", "string_on_int")


def _plan(session, w, query):
    df = session.read.parquet(w["src"])
    return df.filter(QUERIES[query](df, w)).select(*COLS)


def _kept(session, w, query):
    session.enable_hyperspace()
    try:
        leaves = session.optimize(_plan(session, w, query).logical_plan).collect_leaves()
    finally:
        session.disable_hyperspace()
    rel = leaves[0].relation
    return rel.index_info, tuple(os.path.basename(f) for f in rel.files)


def _collect(session, w, query, enabled=True):
    if enabled:
        session.enable_hyperspace()
    try:
        return _plan(session, w, query).collect()
    finally:
        session.disable_hyperspace()


def _explain(session, hs, w, query):
    session.enable_hyperspace()
    try:
        return hs.explain(_plan(session, w, query)).replace(session.conf.get(SYS), "<sys>")
    finally:
        session.disable_hyperspace()


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_files_kept_and_rows_equal_the_reference(world, query):
    """The same source files kept, in the same order, by both packages;
    the rows equal in order to the JAX package's and as a multiset to the
    plan without Hyperspace."""
    t, j = world["t"], world["j"]
    info, files = _kept(t, world, query)
    j_info, j_files = _kept(j, world, query)
    assert files == j_files and (info is None) == (j_info is None)
    if query in UNCHANGED:
        assert info is None and len(files) == N_FILES
    else:
        assert info[0] == j_info[0] == "ds" and info[2] == j_info[2] == "DS"
        assert len(files) < N_FILES or query == "or_both"
    if query == "string_on_int":  # both executors refuse the comparison alike
        for s in (t, j):
            with pytest.raises(TypeError):
                _collect(s, world, query)
        return
    got, want = _collect(t, world, query), _collect(j, world, query)
    assert same_rows(got, want)
    raw = _collect(t, world, query, enabled=False)
    order = [(c, "ascending") for c in COLS]
    assert got.sort_by(order).equals(raw.sort_by(order))
    if query in ("fraction_on_int", "absent"):
        assert files == () and got.num_rows == 0 and got.schema == raw.schema


@pytest.mark.parametrize("query", ["eq", "in", "and", "or_both", "partition", "absent",
                                   "untranslatable"])
def test_explain_equals_the_reference(world, query):
    t, j = world["t"], world["j"]
    text = _explain(t, T.Hyperspace(t), world, query)
    assert text == _explain(j, JHyperspace(j), world, query)
    assert ("Hyperspace(Type: DS, Name: ds" in text) == (query != "untranslatable")


def test_index_directory_and_log_entry_equal_the_reference(world):
    t, j = world["t"], world["j"]
    port, jax = _index_dir(t, "ds"), _index_dir(j, "ds")
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax)) == ["part-00000-sketch.parquet"]
    with open(os.path.join(port, "part-00000-sketch.parquet"), "rb") as a, \
            open(os.path.join(jax, "part-00000-sketch.parquet"), "rb") as b:
        assert a.read() == b.read()
    got = _normalized_entry(t, "ds")
    assert got == _normalized_entry(j, "ds")
    assert got["derivedDataset"]["type"] == "DataSkippingIndex"
    ids = pq.read_table(os.path.join(port, "part-00000-sketch.parquet"))["_data_file_id"]
    assert ids.to_pylist() == list(range(N_FILES))


def _without_location(table):
    rows = table.to_pylist()
    for r in rows:
        r.pop("indexLocation")
    return rows


def test_index_tables_equal_the_reference(world):
    t, j = world["t"], world["j"]
    ths, jhs = T.Hyperspace(t), JHyperspace(j)
    assert _without_location(ths.indexes()) == _without_location(jhs.indexes())
    got, want = ths.index("ds"), jhs.index("ds")
    assert got.schema == want.schema
    row = _without_location(got)
    assert row == _without_location(want)
    assert row[0]["numBuckets"] == 0 and "BloomFilterSketch(l_orderkey)" in row[0]["additionalStats"]


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_each_package_serves_the_others_index(tmp_path, creator):
    src = _write_source(tmp_path, _lineitem(3000, seed=3))
    w = {"src": src, "key": int(pq.read_table(src)["l_orderkey"][0].as_py()), "key2": 0}
    shared = tmp_path / "shared"
    t, j = _port(shared), _jax(shared)
    if creator == "port":
        T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("ds", *_sketches(TS)))
    else:
        JHyperspace(j).create_index(j.read.parquet(src), JConfig("ds", *_sketches(JS)))
    for query in ("eq", "lt", "in", "partition"):
        info, files = _kept(t, w, query)
        assert info is not None and info[2] == "DS" and len(files) < N_FILES
        assert (info, files) == _kept(j, w, query)
        assert same_rows(_collect(t, w, query), _collect(j, w, query))


# -- routes and stats over a pruned scan ---------------------------------------


def _stats(d):
    """A route's stats as the reference keeps them: without the wall
    seconds and the port's own keys of the fused route."""
    return {k: v for k, v in d.items() if k not in ("wall_s", "fused_route", "overflowed_chunks")}


ROUTE_QUERIES = {
    # the window's groups: a fused or metadata aggregate over the kept files
    "agg": lambda df, F: df.filter((df["l_shipdate"] >= D1) & (df["l_shipdate"] < np.datetime64(
        "1995-06-01"))).group_by("l_quantity").agg(F.count().alias("n"),
                                                   F.sum("l_orderkey").alias("s")),
    # a float SUM, which never takes the metadata plane
    "agg_float": lambda df, F: df.filter(df["l_shipdate"] > D2).agg(
        F.sum("l_extendedprice").alias("s"), F.count().alias("n")),
    # the fused select
    "select": lambda df, F: df.filter((df["l_shipdate"] < D1) & (df["l_quantity"] < 24)).select(
        "l_orderkey", "l_quantity"),
    # a Bloom-pruned point aggregate
    "agg_point": lambda df, F: df.filter(df["l_orderkey"] == 7).agg(F.count().alias("n")),
}


@pytest.mark.parametrize("query", sorted(ROUTE_QUERIES))
def test_routes_over_a_pruned_scan_equal_the_reference(world, query):
    """An aggregate and a fused filter over a data-skipping scan take the
    reference's routes: the same range-pruning, fused-route and
    metadata-plane stats, and the same rows."""
    outs = []
    for s, pc, zm, F in ((world["t"], TPC, TZ, TF), (world["j"], JPC, JZ, JF)):
        pc.last_fused_stats, pc.last_aggplane_stats, zm.last_prune_stats = {}, {}, {}
        s.enable_hyperspace()
        try:
            df = s.read.parquet(world["src"])
            q = ROUTE_QUERIES[query](df, F)
            leaves = s.optimize(q.logical_plan).collect_leaves()
            rows = q.collect()
        finally:
            s.disable_hyperspace()
        outs.append((rows, leaves[0].relation.index_info, _stats(pc.last_fused_stats),
                     _stats(pc.last_aggplane_stats), dict(zm.last_prune_stats)))
    (got, info, fused, plane, prune), (want, j_info, j_fused, j_plane, j_prune) = outs
    assert info is not None and info[2] == "DS" and j_info is not None
    assert same_rows(got, want) and got.num_rows > 0
    assert (fused, plane, prune) == (j_fused, j_plane, j_prune)
    assert fused or plane  # a fused or metadata route ran


def test_an_in_list_that_keeps_every_file_takes_the_reference_routes(world):
    """chip_smoke's d3 shape: an IN-list whose keys lie in every file keeps
    all of them. The rewritten scan takes the reference's range-pruning
    pass over the source footers and fused-route stats, and the same mask
    route as the plan without Hyperspace."""
    keys = [int(pq.read_table(os.path.join(world["src"], path), columns=["l_orderkey"])
                ["l_orderkey"][0].as_py()) for path in sorted(os.listdir(world["src"]))]
    outs = []
    for s, pc, zm in ((world["t"], TPC, TZ), (world["j"], JPC, JZ)):
        pc.last_fused_stats, zm.last_prune_stats = {}, {}
        s.enable_hyperspace()
        try:
            df = s.read.parquet(world["src"])
            q = df.filter(df["l_orderkey"].isin(keys)).select(*COLS)
            leaves = s.optimize(q.logical_plan).collect_leaves()
            routes = dict(s.exec_stats.as_dict()) if s is world["t"] else None
            rows = q.collect()
            if routes is not None:
                routes = {k: v - routes[k] for k, v in s.exec_stats.as_dict().items()}
        finally:
            s.disable_hyperspace()
        outs.append((rows, leaves[0].relation, _stats(pc.last_fused_stats),
                     dict(zm.last_prune_stats), routes))
    (got, rel, fused, prune, routes), (want, j_rel, j_fused, j_prune, _) = outs
    assert rel.index_info[2] == "DS" and len(rel.files) == N_FILES
    assert rel.files == j_rel.files and j_rel.index_info[2] == "DS"
    assert same_rows(got, want) and got.num_rows >= len(keys)
    assert (fused, prune) == (j_fused, j_prune)
    assert prune["files_total"] == prune["files_kept"] == N_FILES
    t = world["t"]
    before = dict(t.exec_stats.as_dict())
    df = t.read.parquet(world["src"])
    raw = df.filter(df["l_orderkey"].isin(keys)).select(*COLS).collect()
    assert {k: v - before[k] for k, v in t.exec_stats.as_dict().items()} == routes
    assert same_rows(got, raw)


# -- the sketches on the session's device; kernel faults -----------------------


def test_sketches_run_b7_on_the_sessions_device(tmp_path, monkeypatch):
    """The create builds one filter a file and the probe takes the bit
    indices, each through the dispatching wrapper with a tensor on the
    session's device."""
    calls = []
    for name in ("build_bloom", "bit_indices"):
        inner = getattr(TB, name)

        def spy(reps, m, k, inner=inner, name=name):
            calls.append((name, reps.device.type, reps.numel()))
            return inner(reps, m, k)

        monkeypatch.setattr(TB, name, spy)
    src = _write_source(tmp_path, _lineitem(1200, seed=5))
    t = _port(tmp_path / "idx")
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("ds", *_sketches(TS)))
    assert calls == [("build_bloom", "cpu", 200)] * N_FILES
    assert [k for k in t.build_stats if k.startswith("sketch")] == ["sketch_read", "sketch"]
    calls.clear()
    w = {"src": src, "key": 3, "key2": 4}
    _kept(t, w, "in")
    # once for each node the rule is tried at: Project(Filter(Scan)) and
    # Filter(Scan), as in the reference's search
    assert calls == [("bit_indices", "cpu", 3)] * 2


class _Fault:
    def __init__(self, exc):
        self.exc = exc

    def __call__(self, *args, **kwargs):
        raise self.exc


@pytest.mark.parametrize("exc", [KernelBuildError("nvcc failed"),
                                 RuntimeError("Bloom bit-index kernel launch failed")],
                         ids=["build", "launch"])
def test_a_b7_fault_fails_the_create(tmp_path, monkeypatch, exc):
    src = _write_source(tmp_path, _lineitem(1200, seed=5))
    t = _port(tmp_path / "idx")
    monkeypatch.setattr(TB, "build_bloom", _Fault(exc))
    with pytest.raises(type(exc)):
        T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("ds", *_sketches(TS)))


@pytest.mark.parametrize("exc", [KernelBuildError("nvcc failed"),
                                 KernelLaunchError("Bloom bit-index kernel launch failed")],
                         ids=["build", "launch"])
def test_a_b7_fault_fails_the_query_and_does_not_abstain(tmp_path, monkeypatch, exc):
    src = _write_source(tmp_path, _lineitem(1200, seed=5))
    t = _port(tmp_path / "idx")
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("ds", *_sketches(TS)))
    monkeypatch.setattr(TB, "bit_indices", _Fault(exc))
    # the optimizer's catch-all (ApplyHyperspace's fallback to the
    # original plan) lets a kernel fault through
    w = {"src": src, "key": 3, "key2": 4}
    with pytest.raises(type(exc)):
        _kept(t, w, "eq")
    with pytest.raises(type(exc)):
        _collect(t, w, "eq")
    assert _kept(t, w, "lt")[0] is not None  # min/max alone still prunes
    monkeypatch.setattr(TB, "bit_indices", _Fault(ValueError("not a kernel fault")))
    assert _kept(t, w, "eq")[0] is None  # any other fault keeps the fallback


def test_a_b7_fault_read_back_fails_the_query(tmp_path, monkeypatch):
    """The probe reads B7's indices back through ``ops/bloom.to_host``,
    where a fault of the kernel's run raises: it fails the query too."""
    src = _write_source(tmp_path, _lineitem(1200, seed=5))
    t = _port(tmp_path / "idx")
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig("ds", *_sketches(TS)))
    monkeypatch.setattr(TB, "to_host", _Fault(KernelLaunchError("B7 failed while it ran")))
    w = {"src": src, "key": 3, "key2": 4}
    with pytest.raises(KernelLaunchError):
        _kept(t, w, "eq")
    with pytest.raises(KernelLaunchError):
        _collect(t, w, "eq")


def test_rule_order_equals_the_reference():
    from hyperspace_tpu.rules.score import _all_rules as j_rules
    from hyperspace_tpu_torch.rules.score import _all_rules as t_rules

    assert [r.name for r in t_rules()] == [r.name for r in j_rules()]
    assert [getattr(r, "base_score", None) for r in t_rules()] == [
        getattr(r, "base_score", None) for r in j_rules()]


def test_the_package_exports_the_config_lazily():
    assert T.DataSkippingIndexConfig is TConfig
