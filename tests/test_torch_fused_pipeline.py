"""The port's fused serve pipeline against the JAX package: the fused
filter→aggregate (kernel B5f's route) and filter→select (kernel B3b's
route), as two-package differentials on the CPU.

Chunk level: the cases of ``torch_b5f_cases`` go through the JAX
package's ``kernel_filter_aggregate`` (its native host kernel
``hs_fused_filter_agg``, as its own tests run it), its
``interpreted_filter_aggregate`` and its ``_AggState`` partials, and
through the port's plain route (``ops/fused_agg.fused_filter_agg_torch``
with B5's plain versions). Rows compare in order with floats bit for bit;
``AggPartials`` compare array by array, groups in the reference kernel's
first-occurrence order and again sorted by (rep, null). The fused select
equals ``np.nonzero`` of the mask and the reference's native select. When
the reference's native library does not load, the kernel-side
comparisons are skipped by the reference's own ``native.load`` and the
interpreted and partials comparisons carry the test.

Executor level (the cases of ``tests/test_fused_pipeline.py`` over
covering indexes with small row groups, as the port has no z-order
index yet): fused on, fused off, unindexed and the JAX package give the
same rows, and the port's ``last_fused_stats`` equal the reference's
apart from the wall seconds."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu import native as jnative
from hyperspace_tpu.execution import pipeline_compiler as JPC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.io import parquet as jpio
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.plan.nodes import AggSpec as JAggSpec
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.io import parquet as tpio
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.ops import filter as TFilter
from hyperspace_tpu_torch.ops import fused_agg as FA
from torch_b5_cases import same_rows
from torch_b5f_cases import B3B_CASES, B5F_CASES, port_aggs

FUSED = "hyperspace.serve.fusedpipeline.enabled"
AGG = "hyperspace.index.agg.enabled"


@pytest.fixture(autouse=True)
def force_fused_dispatch(monkeypatch):
    """Both packages dispatch the fused routes at test sizes."""
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)


def _native_loaded() -> bool:
    return jnative.load(wait=True) is not None


def _schema(case):
    t = case["chunks"][0]
    return dict(zip(t.schema.names, t.schema.types))


def _jaggs(case):
    return [JAggSpec(func, col, name) for func, col, name in case["aggs"]]


def _concat(chunks):
    return pa.concat_tables(chunks)


# -- chunk level ---------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(B5F_CASES))
def test_fused_aggregate_rows_equal_the_reference(case):
    """The port's fused route over the chunks, its interpreted twin, the
    JAX package's interpreted twin and (when its native library loads) its
    fused kernel: the same rows in the same order, floats bit for bit."""
    c = B5F_CASES[case]
    schema, terms, gb = _schema(c), list(c["terms"]), c["group_by"]
    got = TPC.kernel_filter_aggregate(
        [TBatch.from_arrow(t) for t in c["chunks"]], terms, gb, port_aggs(c), schema, "cpu")
    assert got is not None
    got = got.to_arrow()
    whole = _concat(c["chunks"])
    twin = TPC.interpreted_filter_aggregate(
        TBatch.from_arrow(whole), terms, gb, port_aggs(c), schema, "cpu").to_arrow()
    want = JPC.interpreted_filter_aggregate(
        JBatch.from_arrow(whole), terms, gb, _jaggs(c), schema).to_arrow()
    assert same_rows(got, twin) and same_rows(got, want)
    if _native_loaded():
        kern = JPC.kernel_filter_aggregate(
            [JBatch.from_arrow(t) for t in c["chunks"]], terms, gb, _jaggs(c), schema)
        assert kern is not None and same_rows(got, kern.to_arrow())


def _partials_arrays(p):
    return {k: getattr(p, k) for k in (
        "g_reps", "g_nulls", "g_kvals", "g_kvalid", "acc_i", "acc_cnt", "acc_aux")} | {
        "acc_f": p.acc_f.view(np.int64)}


def _sorted_by_key(p):
    planes = []
    for j in range(p.g_reps.shape[0]):
        planes += [p.g_reps[j], p.g_nulls[j].astype(np.int64)]
    order = np.lexsort(planes[::-1]) if planes else np.arange(p.n_groups)
    return {k: v[:, order] for k, v in _partials_arrays(p).items()}


@pytest.mark.parametrize("case", sorted(B5F_CASES))
def test_fused_partials_equal_the_reference_kernel(case):
    """``AggState`` partials after the chunks, carried state included:
    the same groups, first-occurrence key values, accumulators and row
    counts as the reference kernel's ``_AggState``, in its
    first-occurrence order and sorted by (rep, null)."""
    if not _native_loaded():
        pytest.skip("the JAX package's native library did not load; "
                    "test_fused_aggregate_rows_equal_the_reference holds the rows")
    c = B5F_CASES[case]
    schema, terms, gb = _schema(c), list(c["terms"]), c["group_by"]
    tplan = TPC._lower_from_terms(terms, gb, port_aggs(c), schema)
    jplan = JPC._lower_from_terms(terms, gb, _jaggs(c), schema)
    ts, js = TPC.AggState(tplan, "cpu"), JPC._AggState(jplan)
    for t in c["chunks"]:
        assert ts.accumulate(TBatch.from_arrow(t))
        assert js.accumulate(JBatch.from_arrow(t))
    tp, jp = ts.partials(), js.partials()
    assert (tp.n_groups, tp.rows_scanned, tp.rows_passed, tp.key_has_validity) == (
        jp.n_groups, jp.rows_scanned, jp.rows_passed, jp.key_has_validity)
    for pick in (_partials_arrays, _sorted_by_key):
        got, want = pick(tp), pick(jp)
        for k in want:
            assert np.array_equal(got[k], want[k]), (k, pick.__name__)


@pytest.mark.parametrize("case", sorted(B5F_CASES))
def test_partials_from_batch_equals_the_reference(case):
    """The capture's and boundary chunks' hook on each filtered chunk:
    every array equal to the JAX package's numpy twin, groups in
    ``_factorize``'s order."""
    c = B5F_CASES[case]
    schema, terms, gb = _schema(c), list(c["terms"]), c["group_by"]
    tplan = TPC._lower_from_terms(terms, gb, port_aggs(c), schema)
    jplan = JPC._lower_from_terms(terms, gb, _jaggs(c), schema)
    for t in c["chunks"]:
        mask = TFilter.range_mask_numpy(TBatch.from_arrow(t), terms)
        ft = t.filter(pa.array(mask))
        tp = TPC.partials_from_batch(tplan, TBatch.from_arrow(ft), rows_scanned=t.num_rows,
                                     device="cpu")
        jp = JPC.partials_from_batch(jplan, JBatch.from_arrow(ft), rows_scanned=t.num_rows)
        assert (tp.n_groups, tp.rows_scanned, tp.rows_passed, tp.key_has_validity) == (
            jp.n_groups, jp.rows_scanned, jp.rows_passed, jp.key_has_validity)
        got, want = _partials_arrays(tp), _partials_arrays(jp)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


def test_cases_cross_the_reference_first_table_and_carry_float_sums():
    """The cases reach what they are named for: more than the reference
    kernel's 1,024-slot first table in one chunk, and a float sum whose
    bits differ when the chunk sums are added afterwards instead of
    folded from the carry."""
    c = B5F_CASES["groups_1025"]
    assert len(np.unique(c["chunks"][0].column("g").to_numpy())) == 1025 > JPC._AggState._INIT_CAP
    c = B5F_CASES["three_chunks_carried_float_sum"]
    plan = TPC._lower_from_terms(list(c["terms"]), c["group_by"], port_aggs(c), _schema(c))
    carried, apart = TPC.AggState(plan, "cpu"), []
    for t in c["chunks"]:
        carried.accumulate(TBatch.from_arrow(t))
        one = TPC.AggState(plan, "cpu")
        one.accumulate(TBatch.from_arrow(t))
        apart.append(one.partials().acc_f[3])
    folded = carried.partials().acc_f[3]
    summed = apart[0] + apart[1] + apart[2]
    assert not np.array_equal(folded.view(np.int64), summed.view(np.int64))


def test_b5f_plain_version_counts_no_launch():
    c = B5F_CASES["no_groups"]
    before = FA.launches
    TPC.kernel_filter_aggregate([TBatch.from_arrow(c["chunks"][0])], list(c["terms"]),
                                [], port_aggs(c), _schema(c), "cpu")
    assert FA.launches == before


@pytest.mark.parametrize("case", sorted(B3B_CASES))
def test_fused_select_equals_nonzero(case):
    """The fused select's indices equal ``np.nonzero`` of the host mask,
    the JAX package's interpreted select and (when its native library
    loads) its native one; NEVER_MATCH gives none without a launch."""
    table, terms = B3B_CASES[case]
    tb, jb = TBatch.from_arrow(table), JBatch.from_arrow(table)
    before = TFilter.select_launches
    got = TFilter.fused_filter_select(list(terms), tb, "cpu")
    assert TFilter.select_launches == before
    want = np.nonzero(TFilter.range_mask_numpy(tb, list(terms)))[0]
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, JPC.filter_select_interpreted(jb, list(terms)))
    if _native_loaded() and table.num_rows:
        from hyperspace_tpu.ops import filter as JFilter

        prep = JFilter.native_terms_for_batch(jb, list(terms))
        if prep is not None and prep != JFilter.NEVER_MATCH:
            assert np.array_equal(got, jnative.fused_filter_select(*prep, table.num_rows))


def test_b5f_and_b3b_are_registered_twins():
    from hyperspace_tpu_torch import ops

    assert ops.KERNEL_TWINS["fused_filter_agg"] == (
        "hyperspace_tpu_torch.ops.fused_agg", "fused_filter_agg_kernel",
        "fused_filter_agg_torch", "hyperspace_tpu_torch/csrc/fused_agg.cu")
    assert ops.KERNEL_TWINS["fused_select"] == (
        "hyperspace_tpu_torch.ops.filter", "select_kernel", "select_torch",
        "hyperspace_tpu_torch/csrc/fused_select.cu")
    ops.reset_launch_counts()
    assert ops.launch_counts()["fused_select"] == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    c = B5F_CASES["one_group"]
    plan = TPC._lower_from_terms(list(c["terms"]), c["group_by"], port_aggs(c), _schema(c))
    st = TPC.AggState(plan, "cpu")
    chunk = st._chunk(TBatch.from_arrow(c["chunks"][0]))
    with pytest.raises(ValueError, match="CUDA"):
        FA.fused_filter_agg_kernel(st.state, chunk)
    with pytest.raises(ValueError, match="CUDA"):
        TFilter.select_kernel(chunk.terms)


def test_table_sizes_are_powers_of_two_above_twice_the_live_keys():
    for groups, n in ((0, 0), (0, 1), (1024, 5125), (7, 100_000)):
        size = FA.table_size(groups, n)
        assert size & (size - 1) == 0 and size >= 2 * (groups + n) and size > groups + n


# -- executor level ------------------------------------------------------------------


@pytest.fixture
def small_row_groups(monkeypatch):
    monkeypatch.setattr(tpio, "INDEX_ROW_GROUP_SIZE", 500)
    monkeypatch.setattr(jpio, "INDEX_ROW_GROUP_SIZE", 500)


def _write_files(root, name, table, n_files=4):
    d = root / name
    d.mkdir()
    n = table.num_rows
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(table.slice(lo, hi - lo), str(d / f"part{i}.parquet"))
    return str(d)


def _sessions(root, agg_plane=False):
    """A port and a JAX session, 4 buckets; the metadata plane off unless
    asked for, so the fused route is what answers."""
    t = T.HyperspaceSession(device="cpu")
    t.conf.set("hyperspace.system.path", str(root / "port"))
    t.conf.set("hyperspace.index.num_buckets", 4)
    j = JSession()
    j.conf.set(JC.INDEX_SYSTEM_PATH, str(root / "jax"))
    j.conf.set(JC.INDEX_NUM_BUCKETS, 4)
    j.conf.set(JC.BUILD_NUM_SHARDS, 1)
    for s, key in ((t, AGG), (j, JC.INDEX_AGG_ENABLED)):
        s.conf.set(key, agg_plane)
    return t, j


def _build(t, j, src, name, indexed, included):
    T.Hyperspace(t).create_index(t.read.parquet(src), TConfig(name, indexed, included))
    JHyperspace(j).create_index(j.read.parquet(src), JConfig(name, indexed, included))


def _stats(d):
    """Fused stats as the reference keeps them: without the wall seconds
    and the port's own route keys (``fused_route``, ``overflowed_chunks``)."""
    return {k: v for k, v in d.items() if k not in ("wall_s", "fused_route", "overflowed_chunks")}


def _four_way(t, j, src, query, mode):
    """``query(df, F)`` on the port with the fused route on and off and
    unindexed, and on the JAX package: the same rows; the port's fused
    stats equal the reference's (``mode`` None: no fused route ran)."""
    tdf, jdf = t.read.parquet(src), j.read.parquet(src)
    t.enable_hyperspace()
    TPC.last_fused_stats = {}
    on = query(tdf, TF).collect()
    if TPC.last_fused_stats.get("mode") == "agg":
        assert TPC.last_fused_stats["fused_route"] in ("one_pass", "ordered")
        assert TPC.last_fused_stats["overflowed_chunks"] == 0  # no blocks on the CPU
    t_stats = _stats(TPC.last_fused_stats)
    t.conf.set(FUSED, False)
    TPC.last_fused_stats = {}
    off = query(tdf, TF).collect()
    assert TPC.last_fused_stats == {}
    t.conf.set(FUSED, True)
    t.disable_hyperspace()
    raw = query(tdf, TF).collect()
    j.enable_hyperspace()
    JPC.last_fused_stats = {}
    want = query(jdf, JF).collect()
    j_stats = _stats(JPC.last_fused_stats)
    j.disable_hyperspace()
    assert same_rows(on, off) and same_rows(on, want)
    assert on.num_rows == raw.num_rows
    assert t_stats == j_stats
    assert t_stats.get("mode") == mode, t_stats
    return on


def _dtype_tables(rng, n=8000):
    base = np.datetime64("2019-01-01")
    days = np.sort(rng.integers(0, 900, n))

    def num_aggs(F):
        return (F.count().alias("n"), F.count("c").alias("nc"), F.min("c").alias("mn"),
                F.max("c").alias("mx"), F.sum("v").alias("sv"), F.avg("v").alias("av"))

    def temporal_aggs(F):
        return (F.count().alias("n"), F.min("c").alias("mn"), F.max("c").alias("mx"),
                F.sum("v").alias("sv"))

    def count_only(F):
        return (F.count().alias("n"), F.count("c").alias("nc"), F.sum("v").alias("sv"))

    common = {"p": pa.array(rng.integers(0, 10, n), type=pa.int64()),
              "v": pa.array(rng.normal(0, 5, n))}
    f = rng.normal(0, 100, n)
    f[::31] = np.nan
    return {
        "ints": ({"c": pa.array(np.sort(rng.integers(-1000, 1000, n)), type=pa.int64()),
                  **common}, lambda df: (df["c"] >= -100) & (df["c"] < 250), num_aggs),
        "floats_nan": ({"c": pa.array(f), **common},
                       lambda df: (df["c"] > -50.0) & (df["c"] <= 50.0), num_aggs),
        "strings": ({"c": pa.array([f"k{int(x):06d}" for x in rng.integers(0, 5000, n)]),
                     **common}, lambda df: (df["p"] >= 2) & (df["p"] < 7), count_only),
        "dates": ({"c": pa.array((base + days).astype("datetime64[D]")), **common},
                  lambda df: (df["c"] >= np.datetime64("2019-06-01"))
                  & (df["c"] <= np.datetime64("2019-09-01")), temporal_aggs),
        "ts_tz": ({"c": pa.array((base + days).astype("datetime64[us]"),
                                 type=pa.timestamp("us", tz="UTC")), **common},
                  lambda df: (df["c"] >= "2019-06-01") & (df["c"] < "2019-09-01"),
                  temporal_aggs),
        "nullable_int": ({"c": pa.array([None if i % 11 == 0 else int(x) for i, x in
                                         enumerate(np.sort(rng.integers(0, 10_000, n)))],
                                        type=pa.int64()), **common},
                         lambda df: (df["c"] > 2000) & (df["c"] <= 4000), num_aggs),
    }


DTYPES = _dtype_tables(np.random.default_rng(7))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_grouped_aggregate_over_the_dtype_matrix(tmp_path, small_row_groups, name):
    arrays, cond_fn, agg_fn = DTYPES[name]
    src = _write_files(tmp_path, name, pa.table(arrays))
    t, j = _sessions(tmp_path)
    icols = ["p"] if name == "strings" else ["c"]
    _build(t, j, src, "idx", icols, [c for c in ("c", "p", "v") if c not in icols])
    out = _four_way(t, j, src, lambda df, F: df.filter(cond_fn(df)).group_by("p")
                    .agg(*agg_fn(F)), "agg")
    assert 0 < out.num_rows <= 10


def test_nan_and_null_group_keys(tmp_path, small_row_groups):
    rng = np.random.default_rng(11)
    n = 6000
    g = rng.normal(0, 2, n).round(1)
    g[::13] = np.nan
    g[::17] = -0.0
    g[::19] = 0.0
    src = _write_files(tmp_path, "nanng", pa.table({
        "c": pa.array(np.sort(rng.integers(0, 5000, n)), type=pa.int64()),
        "g": pa.array([None if i % 23 == 0 else float(x) for i, x in enumerate(g)],
                      type=pa.float64()),
        "v": pa.array(rng.normal(0, 5, n)),
    }))
    t, j = _sessions(tmp_path)
    _build(t, j, src, "idx", ["c"], ["g", "v"])
    out = _four_way(t, j, src, lambda df, F: df.filter((df["c"] >= 500) & (df["c"] < 3500))
                    .group_by("g").agg(F.count().alias("n"), F.sum("v").alias("sv"),
                                       F.min("v").alias("mnv"), F.max("v").alias("mxv")),
                    "agg")
    keys = out.column("g")
    assert keys.null_count == 1
    assert any(v.as_py() is not None and np.isnan(v.as_py()) for v in keys.combine_chunks())


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
def test_empty_ranges_and_row_group_survivors(tmp_path, small_row_groups, grouped):
    """A narrow range keeps a few row groups; an empty range keeps none
    (the fused route then declines in both packages, and the ungrouped
    aggregate still gives its one row)."""
    rng = np.random.default_rng(13)
    n = 8000
    src = _write_files(tmp_path, "empties", pa.table({
        "c": pa.array(np.sort(rng.integers(0, 100_000, n)), type=pa.int64()),
        "p": pa.array(rng.integers(0, 10, n), type=pa.int64()),
        "v": pa.array(rng.normal(0, 5, n)),
    }))
    t, j = _sessions(tmp_path)
    _build(t, j, src, "idx", ["c"], ["p", "v"])

    def agg(df, F, lo, hi):
        q = df.filter((df["c"] >= lo) & (df["c"] < hi))
        q = q.group_by("p") if grouped else q
        return q.agg(F.count().alias("n"), F.sum("v").alias("sv"))

    out = _four_way(t, j, src, lambda df, F: agg(df, F, 10_000, 12_000), "agg")
    assert out.num_rows > 0
    out = _four_way(t, j, src, lambda df, F: agg(df, F, 100_001, 100_002), None)
    if grouped:
        assert out.num_rows == 0
    else:
        assert out.column("n").to_pylist() == [0] and out.column("sv").to_pylist() == [None]


def test_bucket_pruned_grouped_aggregate(tmp_path):
    rng = np.random.default_rng(17)
    n = 6000
    src = _write_files(tmp_path, "bp", pa.table({
        "k": pa.array(rng.integers(0, 50, n), type=pa.int64()),
        "p": pa.array(rng.integers(0, 5, n), type=pa.int64()),
        "v": pa.array(rng.normal(0, 5, n)),
    }))
    t, j = _sessions(tmp_path)
    t.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    j.conf.set(JC.INDEX_FILTER_RULE_USE_BUCKET_SPEC, True)
    _build(t, j, src, "idx", ["k"], ["p", "v"])
    out = _four_way(t, j, src, lambda df, F: df.filter(df["k"] == 7).group_by("p").agg(
        F.count().alias("n"), F.sum("v").alias("sv"), F.min("v").alias("mn"),
        F.max("v").alias("mx")), "agg")
    assert out.num_rows > 0


def _dispatch_world(tmp_path, name):
    rng = np.random.default_rng(19)
    n = 5000
    src = _write_files(tmp_path, name, pa.table({
        "c": pa.array(np.sort(rng.integers(0, 5000, n)), type=pa.int64()),
        "p": pa.array(rng.integers(0, 8, n), type=pa.int64()),
        "v": pa.array(rng.normal(0, 5, n)),
    }))
    t, j = _sessions(tmp_path)
    _build(t, j, src, "idx", ["c"], ["p", "v"])
    return src, t, j


def test_below_threshold_takes_the_interpreted_chain(tmp_path, small_row_groups, monkeypatch):
    src, t, j = _dispatch_world(tmp_path, "disp")
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1 << 30)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1 << 30)
    small = _four_way(t, j, src, lambda df, F: df.filter((df["c"] >= 1000) & (df["c"] < 3000))
                      .group_by("p").agg(F.count().alias("n"), F.sum("v").alias("sv")), None)
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    fused = _four_way(t, j, src, lambda df, F: df.filter((df["c"] >= 1000) & (df["c"] < 3000))
                      .group_by("p").agg(F.count().alias("n"), F.sum("v").alias("sv")), "agg")
    assert same_rows(small, fused)


def test_unsupported_predicate_takes_the_interpreted_chain(tmp_path, small_row_groups):
    src, t, j = _dispatch_world(tmp_path, "unsup")
    out = _four_way(t, j, src, lambda df, F: df.filter((df["c"] < 100) | (df["c"] > 4000))
                    .group_by("p").agg(F.count().alias("n")), None)
    assert out.num_rows > 0


def test_executor_counts_each_route(tmp_path, small_row_groups):
    src, t, _j = _dispatch_world(tmp_path, "counts")
    t.enable_hyperspace()
    df = t.read.parquet(src)
    t.exec_stats.reset()
    df.filter((df["c"] >= 1000) & (df["c"] < 3000)).group_by("p").agg(
        TF.count().alias("n"), TF.sum("v").alias("sv")).collect()
    assert "fused" in t.agg_stats and "scan" in t.agg_stats
    df.filter((df["c"] >= 1000) & (df["c"] < 3000)).select("c", "v").collect()
    stats = t.exec_stats.as_dict()
    assert stats["fused_aggregates"] == 1 and stats["fused_selects"] == 1
    assert stats["metadata_aggregates"] == 0 and stats["fused_range_masks"] == 0


def test_filter_project_fused_select(tmp_path, small_row_groups):
    """Filter→Project over the index: the fused select replaces mask and
    nonzero; string columns ride through the projection."""
    rng = np.random.default_rng(29)
    n = 6000
    src = _write_files(tmp_path, "fp", pa.table({
        "c": pa.array(np.sort(rng.integers(0, 5000, n)), type=pa.int64()),
        "s": pa.array([f"v{int(x) % 97:03d}" for x in rng.integers(0, 10**6, n)]),
        "v": pa.array(rng.normal(0, 5, n)),
    }))
    t, j = _sessions(tmp_path)
    _build(t, j, src, "idx", ["c"], ["s", "v"])
    out = _four_way(t, j, src, lambda df, F: df.filter((df["c"] >= 1000) & (df["c"] < 3000))
                    .select("c", "s", "v"), "select")
    assert out.num_rows > 0


@pytest.mark.parametrize("fold_rows", [1, 3000, 1 << 23])
def test_folds_of_any_size_give_the_same_answer(tmp_path, small_row_groups, monkeypatch,
                                                fold_rows):
    """The chunked fused pass joins files' tables into folds of up to
    ``_FUSED_FOLD_ROWS`` rows: a fold a file, a few files a fold, or one
    fold give the reference's rows and stats (float sums, first key
    values and -0.0/NaN keys included)."""
    monkeypatch.setattr(TPC, "_FUSED_FOLD_ROWS", fold_rows)
    rng = np.random.default_rng(31)
    n = 6000
    g = rng.normal(0, 2, n).round(0)
    g[::11] = -0.0
    g[::13] = np.nan
    src = _write_files(tmp_path, "folds", pa.table({
        "c": pa.array(np.sort(rng.integers(0, 5000, n)), type=pa.int64()),
        "g": pa.array([None if i % 17 == 0 else float(x) for i, x in enumerate(g)]),
        "v": pa.array(rng.normal(0, 1e8, n)),
    }))
    t, j = _sessions(tmp_path)
    _build(t, j, src, "idx", ["c"], ["g", "v"])
    _four_way(t, j, src, lambda df, F: df.filter((df["c"] >= 300) & (df["c"] < 4700))
              .group_by("g").agg(F.count().alias("n"), F.sum("v").alias("sv"),
                                 F.min("v").alias("mn")), "agg")
