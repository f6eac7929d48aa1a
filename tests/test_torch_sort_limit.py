"""The port's ORDER BY and LIMIT against the JAX package: the ordering
permutation equals the reference's over every column kind, in both
directions and over several keys; sorted and limited queries give the
reference's rows in order (floats bit for bit); a streaming limit stops
reading files once it has its rows; and AggregateIndexRule's explain
equals the reference's."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.ops.sort import ordering_permutation as j_ordering_permutation
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.io import parquet as tpio
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.ops.sort import ordering_permutation
from torch_b5_cases import same_rows

N_BUCKETS = 4
N_FILES = 8


def _keys_table(n=600, seed=3):
    rng = np.random.default_rng(seed)
    f = rng.integers(-6, 6, n).astype(np.float64) / 2
    f[::17], f[3::19], f[5::23], f[7::29], f[9::31] = np.nan, -0.0, 0.0, np.inf, -np.inf
    words = np.array(["pear", "apple", "", "fig", "Fig", "zebra"])
    return pa.table(
        {
            "i": pa.array(rng.integers(-5, 5, n), type=pa.int64()),
            "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                           mask=rng.random(n) < 0.05),
            "u": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
                          % np.uint64(7) * np.uint64(2**61)),
            "f": pa.array(f, mask=rng.random(n) < 0.05),
            "f32": pa.array(f.astype(np.float32)),
            "s": pa.array(words[rng.integers(0, len(words), n)], mask=rng.random(n) < 0.1),
            "d": pa.array(rng.integers(18000, 18010, n).astype(np.int32)).cast(pa.date32()),
            "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        }
    )


KEY_SETS = {
    "int": [("i", True)],
    "int_desc": [("i", False)],
    "int8_with_nulls_desc": [("i8", False)],
    "uint_high_bit": [("u", True)],
    "uint_desc": [("u", False)],
    "float_nan_zeros_infs": [("f", True)],
    "float_desc": [("f", False)],
    "float32": [("f32", True)],
    "string_with_nulls": [("s", True)],
    "string_desc": [("s", False)],
    "date": [("d", True)],
    "date_desc": [("d", False)],
    "bool_with_nulls": [("b", False)],
    "multi_key": [("s", True), ("f", False), ("i", True)],
    "multi_key_desc": [("d", False), ("b", True), ("f32", False), ("u", True)],
}


@pytest.mark.parametrize("keys", sorted(KEY_SETS))
def test_ordering_permutation_equals_the_reference(keys):
    table = _keys_table()
    want = j_ordering_permutation(JBatch.from_arrow(table), KEY_SETS[keys])
    got = ordering_permutation(TBatch.from_arrow(table), KEY_SETS[keys], "cpu")
    assert got.numpy().tolist() == np.asarray(want).tolist()


def test_ordering_permutation_of_no_rows():
    table = _keys_table().slice(0, 0)
    assert ordering_permutation(TBatch.from_arrow(table), [("f", False)], "cpu").numel() == 0


def _write(root, name, table, n_files):
    d = root / name
    d.mkdir()
    step = -(-table.num_rows // n_files)
    for i in range(n_files):
        pq.write_table(table.slice(i * step, step), d / f"p{i}.parquet")
    return str(d)


def _sources(root):
    rng = np.random.default_rng(5)
    n = 2000
    items = pa.table(
        {
            "k": pa.array(rng.integers(0, 300, n), type=pa.int64()),
            "q": pa.array(rng.integers(1, 51, n), type=pa.int64()),
            "p": rng.normal(3000, 800, n),
            "t": pa.array(rng.integers(18000, 18400, n).astype(np.int32)).cast(pa.date32()),
            "s": pa.array([["apple", "pear", "fig", None][int(x)] for x in rng.integers(0, 4, n)]),
        }
    )
    floats = pa.table({"v": pa.array([3.5, -1.25, 0.0, -0.0, np.inf, -np.inf, 2.0, -7.5,
                                      np.nan, None], type=pa.float64())})
    return {"items": _write(root, "items", items, N_FILES),
            "floats": _write(root, "floats", floats, 2)}


def _port_session(system_path):
    s = T.HyperspaceSession(device="cpu")
    s.conf.set("hyperspace.system.path", system_path)
    s.conf.set("hyperspace.index.num_buckets", N_BUCKETS)
    return s


def _jax_session(system_path):
    s = JSession()
    s.conf.set(JC.INDEX_SYSTEM_PATH, system_path)
    s.conf.set(JC.INDEX_NUM_BUCKETS, N_BUCKETS)
    s.conf.set(JC.BUILD_NUM_SHARDS, 1)
    return s


# an index holding (k, q) and a larger one holding (k, q, t): the
# aggregate rule takes the smallest that covers the aggregate
INDEXES = [("kq_idx", ["k"], ["q"]), ("kqt_idx", ["k"], ["q", "t", "s"])]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sort_limit")
    src = _sources(root)
    w = {"src": src, "tsys": str(root / "port"), "jsys": str(root / "jax")}
    w["t"] = _port_session(w["tsys"])
    w["j"] = _jax_session(w["jsys"])
    for s, hs, cfg in ((w["t"], T.Hyperspace(w["t"]), TConfig),
                       (w["j"], JHyperspace(w["j"]), JConfig)):
        df = s.read.parquet(src["items"])
        for name, indexed, included in INDEXES:
            hs.create_index(df, cfg(name, indexed, included))
    return w


QUERIES = {
    "sort_single_key": lambda r, F: r("items").sort("q"),
    "sort_descending_and_multi_key": lambda r, F: r("items").sort("s", ("q", False), "t"),
    "sort_ascending_list": lambda r, F: r("items").order_by("t", "p", ascending=[False, True]),
    "sort_floats_nan_null_zeros": lambda r, F: r("floats").sort(("v", False)),
    "limit_zero": lambda r, F: r("items").limit(0),
    "limit_over_everything": lambda r, F: r("items").limit(10**9),
    "limit_of_sort_top_n": lambda r, F: r("items").sort(("p", False)).limit(7),
    "limit_through_project": lambda r, F: r("items").select("q", "s").limit(25),
    "streaming_limit_of_filter": lambda r, F: r("items").filter(r("items")["q"] == 7).limit(20),
    "limit_of_sort_of_filter": lambda r, F: r("items")
    .filter(r("items")["t"] < np.datetime64("2019-04-01")).sort(("p", False)).limit(10),
    "q18_shape_top_groups": lambda r, F: r("items").group_by("k")
    .agg(F.sum("q").alias("sq")).sort(("sq", False), "k").limit(12),
    "sort_of_aggregate": lambda r, F: r("items").group_by("s")
    .agg(F.count().alias("n"), F.max("p")).orderBy(("n", False)),
    "float_sum_aggregate_sorted": lambda r, F: r("items").group_by("q")
    .agg(F.sum("p").alias("sp")).sort(("sp", True)).limit(5),
    "limit_of_aggregate": lambda r, F: r("items").group_by("t").agg(F.min("s")).limit(3),
}


def _run(session, src, query, enabled, functions):
    q = QUERIES[query](lambda name: session.read.parquet(src[name]), functions)
    if enabled:
        session.enable_hyperspace()
    else:
        session.disable_hyperspace()
    try:
        return q.collect(), q
    finally:
        session.disable_hyperspace()


@pytest.mark.parametrize("enabled", [True, False], ids=["hyperspace_on", "hyperspace_off"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_sort_limit_rows_match_reference_in_order(world, query, enabled):
    got, tq = _run(world["t"], world["src"], query, enabled, TF)
    want, jq = _run(world["j"], world["src"], query, enabled, JF)
    assert same_rows(got, want)
    if enabled:
        assert T.Hyperspace(world["t"]).explain(tq) == JHyperspace(world["j"]).explain(
            jq).replace(world["jsys"], world["tsys"])


def test_limit_zero_keeps_the_schema(world):
    got, _ = _run(world["t"], world["src"], "limit_zero", False, TF)
    assert got.num_rows == 0 and got.column_names == ["k", "q", "p", "t", "s"]


def _files_to_read(src, n):
    """Files a streaming limit of ``n`` rows of ``q == 7`` reads: groups of
    1, 2, 4, ... files until the groups read hold n matching rows."""
    files = sorted(tpio.expand_path(src, "parquet"))
    per_file = [int((pq.read_table(f).column("q").to_numpy() == 7).sum()) for f in files]
    pos, group, got = 0, 1, 0
    while pos < len(files) and got < n:
        got += sum(per_file[pos:pos + group])
        pos, group = min(pos + group, len(files)), group * 2
    return pos


@pytest.mark.parametrize("n", [1, 12, 30, 10**6])
def test_streaming_limit_stops_reading_files(world, monkeypatch, n):
    """Files are read in groups of 1, 2, 4, ... until the limit has its
    rows (about 5 rows a file hold q == 7): a small limit reads one file,
    more than the table has reads all of them."""
    files = _files_to_read(world["src"]["items"], n)
    if n == 1:
        assert files == 1  # the first file holds a row with q == 7
    read = []
    inner = tpio.read_table

    def counting(paths, *args, **kwargs):
        read.extend(paths)
        return inner(paths, *args, **kwargs)

    monkeypatch.setattr(tpio, "read_table", counting)
    s = world["t"]
    df = s.read.parquet(world["src"]["items"])
    got = df.filter(df["q"] == 7).limit(n).collect()
    assert len(read) == files
    read.clear()
    s.disable_hyperspace()
    want = df.filter(df["q"] == 7).collect()
    assert same_rows(got, want.slice(0, min(n, want.num_rows)))


def test_sort_stage_is_recorded(world):
    s = world["t"]
    _run(s, world["src"], "q18_shape_top_groups", False, TF)
    assert {"scan", "factorize", "reduce", "finalize", "sort"} == set(s.agg_stats)


def _used(text):
    return text.split("Indexes used:")[1].split("\n")[2].split()[0]


def test_aggregate_rule_takes_the_smallest_covering_index(world):
    got, tq = _run(world["t"], world["src"], "q18_shape_top_groups", True, TF)
    text = T.Hyperspace(world["t"]).explain(tq)
    assert _used(text) == "kq_idx"
    _, jq = _run(world["j"], world["src"], "q18_shape_top_groups", True, JF)
    assert text == JHyperspace(world["j"]).explain(jq).replace(world["jsys"], world["tsys"])


def test_aggregate_rule_leaves_float_sums_on_the_source(world):
    _, tq = _run(world["t"], world["src"], "float_sum_aggregate_sorted", True, TF)
    text = T.Hyperspace(world["t"]).explain(tq)
    assert "Hyperspace(Type: CI" not in text and _used(text) == "(none)"
    _, jq = _run(world["j"], world["src"], "float_sum_aggregate_sorted", True, JF)
    assert text == JHyperspace(world["j"]).explain(jq).replace(world["jsys"], world["tsys"])
