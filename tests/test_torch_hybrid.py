"""The port's Hybrid Scan against the JAX package.

Both packages index the same source, take the same appends and deletes,
and answer the same queries with ``hyperspace.index.hybridscan.enabled``
on: the explain text (the ``Union`` with the appended files' scan, the
lineage NOT-IN inside the index scan), the candidate filter's tags and
filter reasons, and the rows in order must equal the reference's, and the
rows must equal the unindexed plan's as a multiset. Ported cases:

* ``tests/test_e2e_covering.py::TestHybridScan`` (an appended file served
  through a ``Union``; too much appended refused), with the delete side
  (lineage NOT-IN; too much deleted; no lineage);
* ``tests/test_range_prune.py::TestHybridFallback`` (the index side
  prunes, the appended files are read whole);
* ``tests/test_serve_pipeline.py``'s Hybrid Scan append and delete cases,
  with the pipelined join serve on and off (the appended rows hashed into
  the index's buckets by B1, here its plain version);
* ``tests/test_dataskipping.py::TestBloomSkipping::
  test_modified_file_not_scanned_twice_hybrid``;
* ``tests/test_join_rule.py::test_join_hybrid_appended_rows``;
* ``tests/test_serve_pipeline.py::TestDeltaCache`` (the serve cache keeps
  the appended rows split by bucket under their files' fingerprint);
* a ``limit`` over a ``Union``, and an aggregate over a hybrid plan, which
  declines the metadata plane and the fused route.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu.execution import executor as JX
from hyperspace_tpu.execution import serve_cache as JSC
from hyperspace_tpu.execution import pipeline_compiler as JPC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes import aggindex as JA
from hyperspace_tpu.indexes import zonemaps as JZ
from hyperspace_tpu.io import parquet as jpio
from hyperspace_tpu.plan.nodes import Limit as JLimit
from hyperspace_tpu.rules import candidate as jcand
from hyperspace_tpu.rules import tags as jtags
from hyperspace_tpu.rules.hybrid import transform_plan_to_use_hybrid_scan as jhybrid
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.execution import executor as TX
from hyperspace_tpu_torch.execution import serve_cache as TSC
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.indexes import aggindex as TA
from hyperspace_tpu_torch.indexes import zonemaps as TZ
from hyperspace_tpu_torch.io import parquet as tpio
from hyperspace_tpu_torch.ops import hash as thash
from hyperspace_tpu_torch.plan.nodes import Limit as TLimit
from hyperspace_tpu_torch.rules import candidate as tcand
from hyperspace_tpu_torch.rules import tags as ttags
from hyperspace_tpu_torch.rules.hybrid import transform_plan_to_use_hybrid_scan as thybrid
from torch_b5_cases import same_rows
from torch_lifecycle_twin import append_file, config, sorted_table

HYBRID = "hyperspace.index.hybridscan.enabled"
MAX_DELETED = "hyperspace.index.hybridscan.maxDeletedRatio"
LINEAGE = "hyperspace.index.lineage.enabled"
PIPELINE = "hyperspace.serve.pipeline.enabled"
RANGEPRUNE = "hyperspace.serve.rangeprune.enabled"
TAGS = ("COMMON_SOURCE_SIZE_IN_BYTES", "HYBRIDSCAN_REQUIRED", "HYBRIDSCAN_APPENDED",
        "HYBRIDSCAN_DELETED")


@pytest.fixture(autouse=True)
def small_row_groups(monkeypatch):
    """512-row index row groups in both packages, the fused routes
    dispatched at test sizes, no assembled state between tests."""
    monkeypatch.setattr(tpio, "INDEX_ROW_GROUP_SIZE", 512)
    monkeypatch.setattr(jpio, "INDEX_ROW_GROUP_SIZE", 512)
    monkeypatch.setattr(TPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    monkeypatch.setattr(JPC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 1)
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()
    yield
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()


class Pair:
    """A port session (``device="cpu"``) and a JAX-package session, each
    with its own system path, over the same source directories."""

    def __init__(self, root, num_buckets=4, lineage=False):
        self.sys = {"port": str(root / "port"), "jax": str(root / "jax")}
        self.t = T.HyperspaceSession(device="cpu")
        self.t.conf.set("hyperspace.system.path", self.sys["port"])
        self.j = JSession()
        self.j.conf.set(JC.INDEX_SYSTEM_PATH, self.sys["jax"])
        self.j.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
        self.set("hyperspace.index.num_buckets", num_buckets)
        self.set(LINEAGE, lineage)
        self.hs = {"port": T.Hyperspace(self.t), "jax": JHyperspace(self.j)}

    def sides(self):
        return (("port", self.t), ("jax", self.j))

    def set(self, key, value):
        for _pkg, s in self.sides():
            s.conf.set(key, value)

    def create(self, kind, src, name, *args):
        for pkg, s in self.sides():
            self.hs[pkg].create_index(s.read.parquet(src), config(pkg, kind, name, *args))

    def clear(self):
        for _pkg, s in self.sides():
            s.index_manager.clear_cache()

    def query(self, q):
        """``q(read, F)`` with Hyperspace on in each package (``read`` is
        the session's ``read.parquet``): rows equal in order across the
        packages and to the unindexed plan as a multiset, explain text
        equal apart from the system paths. Returns ``(port rows, port
        explain)``."""
        out = {}
        for pkg, s in self.sides():
            s.index_manager.clear_cache()
            f = TF if pkg == "port" else JF
            df = q(s.read.parquet, f)
            s.enable_hyperspace()
            got = df.collect()
            text = self.hs[pkg].explain(df).replace(self.sys[pkg], "<sys>")
            s.disable_hyperspace()
            want = df.collect()
            assert sorted_table(got).equals(sorted_table(want)), pkg
            out[pkg] = (got, text)
        assert same_rows(out["port"][0], out["jax"][0])
        assert out["port"][1] == out["jax"][1]
        return out["port"]

    def candidates(self, q, name):
        """The file-signature filter of each package over ``q``'s scan and
        the index ``name``: (kept, filter reasons, hybrid tags), equal
        across the packages."""
        out = {}
        for pkg, s in self.sides():
            cand, tg = (tcand, ttags) if pkg == "port" else (jcand, jtags)
            s.index_manager.clear_cache()
            entry = s.index_manager.get_index_log_entry(name)
            entry.set_tag(None, tg.INDEX_PLAN_ANALYSIS_ENABLED, True)
            scan = q(s.read.parquet, TF if pkg == "port" else JF).logical_plan.collect_leaves()[0]
            kept = cand.file_signature_filter(s, scan, [entry])
            reasons = [(r.code, r.args) for r in entry.get_tag(scan, tg.FILTER_REASONS) or []]
            tags = {t: entry.get_tag(scan, getattr(tg, t)) for t in TAGS}
            out[pkg] = (bool(kept), reasons, tags)
        assert out["port"] == out["jax"], out
        return out["port"]


def _served(text):
    return text.split("Plan without indexes:")[0]


# -- TestHybridScan (tests/test_e2e_covering.py:227) ---------------------------


def test_appended_files_served_hybrid(tmp_path, sample_parquet):
    pair = Pair(tmp_path)
    pair.create("covering", sample_parquet, "idx1", ["clicks"], ["query"])
    append_file(sample_parquet, clicks=(700, 701, 702))
    pair.set(HYBRID, True)

    def q(read, f):
        d = read(sample_parquet)
        return d.filter(d["clicks"] >= 500).select("clicks", "query")

    kept, reasons, tags = pair.candidates(q, "idx1")
    assert kept and not reasons and tags["HYBRIDSCAN_REQUIRED"]
    assert tags["HYBRIDSCAN_APPENDED"] == [os.path.join(sample_parquet, "part-extra.parquet")]
    rows, text = pair.query(q)
    assert "Hyperspace(Type: CI, Name: idx1" in _served(text)
    assert "Union" in _served(text)
    assert "appended" in rows.column("query").to_pylist()


def test_too_much_appended_rejected(tmp_path, sample_parquet):
    pair = Pair(tmp_path)
    pair.create("covering", sample_parquet, "idx1", ["clicks"], ["query"])
    raw = pq.read_table(sample_parquet)
    for i in range(9):
        pq.write_table(raw, os.path.join(sample_parquet, f"big-{i}.parquet"))
    pair.set(HYBRID, True)

    def q(read, f):
        d = read(sample_parquet)
        return d.filter(d["clicks"] >= 500).select("clicks", "query")

    kept, reasons, _tags = pair.candidates(q, "idx1")
    assert not kept and [c for c, _ in reasons] == ["TOO_MUCH_APPENDED"]
    _rows, text = pair.query(q)
    assert "Hyperspace" not in _served(text)


@pytest.mark.parametrize(
    "lineage,max_deleted,served,reason",
    [
        (True, 0.5, True, None),
        (True, 0.2, False, "TOO_MUCH_DELETED"),
        (False, 0.5, False, "NO_DELETE_SUPPORT"),
    ],
    ids=["lineage_not_in", "too_much_deleted", "no_delete_support"],
)
def test_deleted_files(tmp_path, sample_parquet, lineage, max_deleted, served, reason):
    """A deleted source file (a third of the indexed bytes): with lineage
    and a ratio limit above it the index serves with its rows excluded
    by the lineage NOT-IN (no Union); else the reference's reason."""
    pair = Pair(tmp_path, lineage=lineage)
    pair.create("covering", sample_parquet, "idx1", ["clicks"], ["query"])
    os.remove(os.path.join(sample_parquet, "part-0.parquet"))
    pair.set(HYBRID, True)
    pair.set(MAX_DELETED, max_deleted)

    def q(read, f):
        d = read(sample_parquet)
        return d.filter(d["clicks"] >= 300).select("clicks", "query")

    kept, reasons, tags = pair.candidates(q, "idx1")
    assert kept == served
    assert [c for c, _ in reasons] == ([] if reason is None else [reason])
    rows, text = pair.query(q)
    assert ("Name: idx1" in _served(text)) == served
    assert "Union" not in _served(text)
    if served:
        assert tags["HYBRIDSCAN_DELETED"] and not tags["HYBRIDSCAN_APPENDED"]
        assert rows.num_rows > 0


def test_append_and_delete_together(tmp_path, sample_parquet):
    """An append and a delete at once: the Union over the index scan with
    its NOT-IN, in both packages alike, also for a projection that leaves
    the lineage column out."""
    pair = Pair(tmp_path, lineage=True)
    pair.create("covering", sample_parquet, "idx1", ["clicks"], ["query", "imprs"])
    os.remove(os.path.join(sample_parquet, "part-1.parquet"))
    append_file(sample_parquet)
    pair.set(HYBRID, True)
    pair.set(MAX_DELETED, 0.5)

    def q(read, f):
        d = read(sample_parquet)
        return d.filter((d["clicks"] >= 100) & (d["clicks"] < 9002)).select("imprs")

    _rows, text = pair.query(q)
    assert "Union" in _served(text) and "Name: idx1" in _served(text)


# -- TestHybridFallback (tests/test_range_prune.py:433) ------------------------


def test_range_pruned_index_side_and_whole_appended_files(tmp_path):
    pair = Pair(tmp_path)
    rng = np.random.default_rng(29)
    n = 4000
    t = pa.table({
        "k": pa.array(np.sort(rng.integers(0, 5000, n)), type=pa.int64()),
        "p": pa.array(rng.integers(0, 10, n), type=pa.int64()),
    })
    d = tmp_path / "hyb"
    d.mkdir()
    for i in range(4):
        pq.write_table(t.slice(i * 1000, 1000), str(d / f"part{i}.parquet"))
    d = str(d)
    pair.create("covering", d, "hci", ["k"], ["p"])
    extra = pa.table({
        "k": pa.array(rng.integers(0, 5000, 300), type=pa.int64()),
        "p": pa.array(rng.integers(0, 10, 300), type=pa.int64()),
    })
    pq.write_table(extra, os.path.join(d, "appended.parquet"))
    pair.set(HYBRID, True)

    def q(read, f):
        df = read(d)
        return df.filter((df["k"] >= 1000) & (df["k"] < 2000)).select("k", "p")

    rows, text = pair.query(q)
    assert rows.num_rows > 0 and "Union" in _served(text)
    pruned_stats = dict(TZ.last_prune_stats)
    assert pruned_stats["files_kept"] <= pruned_stats["files_total"]
    # the unpruned route: the same rows in the same order
    pair.set(RANGEPRUNE, False)
    unpruned, _ = pair.query(q)
    assert same_rows(rows, unpruned)


# -- joins: tests/test_serve_pipeline.py:91, :159; tests/test_join_rule.py:140 --


def _join_tables(root, n=4000, n_orders=500, n_files=4):
    rng = np.random.default_rng(17)
    idir, odir = root / "items", root / "orders"
    idir.mkdir()
    odir.mkdir()
    items = pa.table({
        "k": rng.integers(0, n_orders, n).astype(np.int64),
        "q": rng.integers(1, 51, n).astype(np.int64),
        "price": rng.normal(100.0, 10.0, n),
        "tag": pa.array(rng.choice(["alpha", "beta", "gamma", "delta"], n)),
    })
    orders = pa.table({
        "ok": np.arange(n_orders, dtype=np.int64),
        "cust": rng.integers(0, 50, n_orders).astype(np.int64),
    })
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(items.slice(lo, hi - lo), str(idir / f"p{i}.parquet"))
        lo, hi = i * n_orders // n_files, (i + 1) * n_orders // n_files
        pq.write_table(orders.slice(lo, hi - lo), str(odir / f"p{i}.parquet"))
    return str(idir), str(odir)


def _join_q(idir, odir):
    def q(read, f):
        items, orders = read(idir), read(odir)
        return orders.join(items, on=orders["ok"] == items["k"]).select(
            "ok", "cust", "q", "price", "tag"
        )

    return q


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
def test_join_hybrid_append_and_string_payload(tmp_path, pipeline):
    idir, odir = _join_tables(tmp_path)
    pair = Pair(tmp_path, num_buckets=8)
    pair.create("covering", idir, "i1", ["k"], ["q", "price", "tag"])
    pair.create("covering", odir, "o1", ["ok"], ["cust"])
    rng = np.random.default_rng(3)
    pq.write_table(
        pa.table({
            "k": rng.integers(0, 600, 300).astype(np.int64),  # keys past the orders too
            "q": np.full(300, 7, dtype=np.int64),
            "price": np.full(300, 1.0),
            "tag": pa.array(np.full(300, "omega")),
        }),
        idir + "/appended.parquet",
    )
    pair.set(HYBRID, True)
    pair.set(PIPELINE, pipeline)
    rows, text = pair.query(_join_q(idir, odir))
    assert _served(text).count("Hyperspace(Type: CI") == 2, text
    assert "Union" in _served(text)
    assert "omega" in set(rows.column("tag").to_pylist())
    # the appended rows' hashing counts as prepare, on either route
    pair.t.enable_hyperspace()
    _join_q(idir, odir)(pair.t.read.parquet, TF).collect()
    assert pair.t.join_stats["prepare"] > 0 and pair.t.join_stats["scan"] > 0
    # the other route: the same rows in the same order
    pair.set(PIPELINE, not pipeline)
    other, _ = pair.query(_join_q(idir, odir))
    assert same_rows(rows, other)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
def test_join_delete_compensation(tmp_path, pipeline):
    """A deleted source file (lineage NOT-IN) breaks the clean shape: the
    pipelined route falls back to the sequential one, same rows."""
    idir, odir = _join_tables(tmp_path)
    pair = Pair(tmp_path, num_buckets=8, lineage=True)
    pair.create("covering", idir, "i1", ["k"], ["q", "price", "tag"])
    pair.create("covering", odir, "o1", ["ok"], ["cust"])
    os.unlink(idir + "/p3.parquet")
    pair.set(HYBRID, True)
    pair.set(MAX_DELETED, 1.0)
    pair.set(PIPELINE, pipeline)
    rows, text = pair.query(_join_q(idir, odir))
    assert _served(text).count("Hyperspace(Type: CI") == 2, text
    pair.set(PIPELINE, not pipeline)
    other, _ = pair.query(_join_q(idir, odir))
    assert same_rows(rows, other)


def test_join_hybrid_appended_rows(tmp_path):
    """``tests/test_join_rule.py::test_join_hybrid_appended_rows``: the
    appended rows' bucket ids are the reference's murmur3 ids."""
    rng = np.random.default_rng(11)
    n1, n2 = 400, 600
    orders = pa.table({
        "o_key": pa.array(rng.integers(0, 80, n1), type=pa.int64()),
        "o_amount": pa.array(rng.normal(100, 20, n1)),
    })
    items = pa.table({
        "l_key": pa.array(rng.integers(0, 80, n2), type=pa.int64()),
        "l_qty": pa.array(rng.integers(1, 9, n2), type=pa.int64()),
    })
    d1, d2 = tmp_path / "orders", tmp_path / "items"
    d1.mkdir(), d2.mkdir()
    for i in range(2):
        pq.write_table(orders.slice(i * 200, 200), d1 / f"p{i}.parquet")
    for i in range(3):
        pq.write_table(items.slice(i * 200, 200), d2 / f"p{i}.parquet")
    d1, d2 = str(d1), str(d2)
    pair = Pair(tmp_path, num_buckets=8)
    pair.create("covering", d1, "o_idx", ["o_key"], ["o_amount"])
    pair.create("covering", d2, "i_idx", ["l_key"], ["l_qty"])
    pq.write_table(
        pa.table({
            "l_key": pa.array([5, 7, 7], type=pa.int64()),
            "l_qty": pa.array([100, 200, 300], type=pa.int64()),
        }),
        os.path.join(d2, "extra.parquet"),
    )
    pair.set(HYBRID, True)
    calls = []
    real = thash.bucket_ids

    def spy(reps, num_buckets, seed=42):
        out = real(reps, num_buckets, seed)
        calls.append((reps.clone(), num_buckets, out.clone()))
        return out

    TX.bucket_ids = spy
    try:
        def q(read, f):
            o, i = read(d1), read(d2)
            return o.join(i, on=o["o_key"] == i["l_key"]).select("o_key", "l_qty")

        rows, text = pair.query(q)
    finally:
        TX.bucket_ids = real
    assert _served(text).count("Hyperspace(Type: CI") == 2
    assert "Union" in _served(text)
    assert 300 in rows.column("l_qty").to_pylist()
    from hyperspace_tpu.ops.hash import bucket_ids_np

    delta = [c for c in calls if c[0].shape[1] == 3]
    assert delta
    for reps, nb, got in delta:
        np.testing.assert_array_equal(got.numpy(), bucket_ids_np(reps.numpy(), nb))


# -- data skipping (tests/test_dataskipping.py:164) ----------------------------


def test_modified_file_not_scanned_twice_hybrid(tmp_path):
    d = tmp_path / "ranged"
    d.mkdir()
    for i in range(4):
        pq.write_table(
            pa.table({
                "clicks": pa.array(range(i * 1000, i * 1000 + 100), type=pa.int64()),
                "name": [f"file{i}"] * 100,
                "part": [f"p{i}"] * 100,
            }),
            d / f"f{i}.parquet",
        )
    d = str(d)
    pair = Pair(tmp_path)
    pair.create("ds", d, "ds", ("MinMaxSketch", "clicks"))
    pq.write_table(
        pa.table({
            "clicks": pa.array([2050, 2051], type=pa.int64()),
            "name": ["file2x"] * 2,
            "part": ["p2"] * 2,
        }),
        os.path.join(d, "f2.parquet"),
    )
    pair.set(HYBRID, True)

    def q(read, f):
        df = read(d)
        return df.filter(df["clicks"] == 2050).select("clicks", "name")

    rows, _text = pair.query(q)
    assert rows.num_rows == 1  # no duplicated rows


# -- limit over a Union; an aggregate over a hybrid plan ----------------------


@pytest.mark.parametrize("n", [5, 350, 600])
def test_limit_over_a_union(tmp_path, sample_parquet, n):
    """``Limit(n, Union(index, appended))``: the first n rows of the index
    side, then of the appended files, as in the reference (n=5 stops in the
    index side's 300 rows, 350 and 600 reach into and past the appended
    file's 200)."""
    pair = Pair(tmp_path)
    pair.create("covering", sample_parquet, "idx1", ["clicks"], ["query"])
    append_file(sample_parquet, clicks=tuple(range(9000, 9200)))
    pair.set(HYBRID, True)
    pair.set("hyperspace.index.hybridscan.maxAppendedRatio", 0.9)
    out = {}
    for pkg, s in pair.sides():
        cand, tg, hybrid, limit, X = (
            (tcand, ttags, thybrid, TLimit, TX) if pkg == "port"
            else (jcand, jtags, jhybrid, JLimit, JX)
        )
        s.index_manager.clear_cache()
        entry = s.index_manager.get_index_log_entry("idx1")
        scan = s.read.parquet(sample_parquet).logical_plan.collect_leaves()[0]
        assert cand.file_signature_filter(s, scan, [entry])
        assert entry.get_tag(scan, tg.HYBRIDSCAN_REQUIRED)
        union = hybrid(s, entry, scan)
        assert type(union).__name__ == "Union"
        out[pkg] = X.execute(limit(n, union), s)
    assert same_rows(out["port"], out["jax"])
    assert out["port"].num_rows == min(n, 300 + 200)


@pytest.mark.parametrize("shape", ["append", "delete"])
def test_aggregate_over_a_hybrid_plan_declines_the_fused_routes(tmp_path, sample_parquet, shape):
    pair = Pair(tmp_path, lineage=True)
    pair.create("covering", sample_parquet, "idx1", ["clicks"], ["imprs"])
    if shape == "append":
        append_file(sample_parquet)
    else:
        os.remove(os.path.join(sample_parquet, "part-2.parquet"))
        pair.set(MAX_DELETED, 0.5)
    pair.set(HYBRID, True)

    def q(read, f):
        d = read(sample_parquet)
        return d.filter(d["clicks"] >= 0).group_by("imprs").agg(
            f.count().alias("n"), f.sum("clicks").alias("s")
        )

    _rows, text = pair.query(q)
    assert "Name: idx1" in _served(text)
    pair.t.enable_hyperspace()
    before = pair.t.exec_stats.as_dict()
    TPC.last_fused_stats, TPC.last_aggplane_stats = {}, {}
    q(pair.t.read.parquet, TF).collect()
    after = pair.t.exec_stats.as_dict()
    assert after["metadata_aggregates"] == before["metadata_aggregates"]
    assert after["fused_aggregates"] == before["fused_aggregates"]
    assert TPC.last_fused_stats == {} and TPC.last_aggplane_stats == {}


def test_keys_and_defaults_match_the_reference():
    for name in ("INDEX_HYBRID_SCAN_ENABLED", "INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO",
                 "INDEX_HYBRID_SCAN_MAX_DELETED_RATIO"):
        assert getattr(TC, name) == getattr(JC, name)
        assert getattr(TC, name + "_DEFAULT") == getattr(JC, name + "_DEFAULT")
    assert not T.HyperspaceSession(device="cpu").conf.hybrid_scan_enabled


class TestDeltaCache:
    """``tests/test_serve_pipeline.py::TestDeltaCache`` through both
    packages (``torch_serve_twin.Twin``: the pipelined serve on, as the
    reference's default)."""

    def test_delta_entry_cached_and_reused(self, tmp_path, monkeypatch):
        """With serve-server mode on, the hybrid delta is kept by its files'
        fingerprint: evicting every other kind does not read the appended
        file again; appending another file re-keys the entry."""
        from torch_serve_twin import Twin

        idir, odir = _join_tables(tmp_path)
        tw = Twin(tmp_path)
        tw.create("covering", idir, "i1", ["k"], ["q", "price", "tag"])
        tw.create("covering", odir, "o1", ["ok"], ["cust"])
        tw.enable()
        rng = np.random.default_rng(9)
        extra = pa.table({
            "k": rng.integers(0, 500, 300).astype(np.int64),
            "q": np.full(300, 9, dtype=np.int64),
            "price": np.full(300, 2.0),
            "tag": pa.array(np.full(300, "late")),
        })
        pq.write_table(extra, idir + "/appended.parquet")
        tw.set(HYBRID, True)
        tw.set("hyperspace.serve.cache.enabled", True)
        tw.clear()
        q = _join_q(idir, odir)

        def run():
            return tw.run(lambda s, f: q(s.read.parquet, f))

        baseline = run()
        for cache in tw.caches():
            assert "delta" in {k[0] for k in cache._entries}
            for kind in ("joinside", "bucketed", "scan"):
                cache.evict_kind(kind)
        reads = []
        for X in (TX, JX):
            real = X.pio.read_table

            def counting(paths, *a, real=real, **k):
                reads.extend(p for p in paths if str(p).endswith("appended.parquet"))
                return real(paths, *a, **k)

            monkeypatch.setattr(X.pio, "read_table", counting)
        assert same_rows(run(), baseline)
        assert not reads, "appended delta read again despite its cached entry"
        monkeypatch.undo()
        pq.write_table(extra, idir + "/appended2.parquet")
        tw.clear()
        assert run().num_rows > baseline.num_rows

    def test_evict_kind(self):
        for sc in (TSC, JSC):
            c = sc.ServeCache(max_bytes=1000)
            c.put(("delta", 1), "a", 10)
            c.put(("joinside", 1), "b", 10)
            c.put(("joinside", 2), "c", 10)
            assert c.evict_kind("joinside") == 2
            assert c.get(("delta", 1)) == "a"
            assert c.get(("joinside", 1)) is None
            assert c.resident_bytes == 10
