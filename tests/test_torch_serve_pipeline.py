"""The port's pipelined join serve against its sequential route and the
JAX package: the two sides prepare on two threads, each streaming its
per-bucket reads from the scan pool into
``join_exec.prepare_join_side_pipelined``. The rows must be bit-identical
to the sequential route's and to the reference's, in order; the overlap
must be real (an injected slow reader shows it); the side threads must
run no device work (the clean ``Project*(Scan)`` shape has no Filter);
and the route is off unless asked for."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.execution import join_exec as jje
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch.execution import executor as tex
from hyperspace_tpu_torch.execution import join_exec as tje
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch

PIPELINE = "hyperspace.serve.pipeline.enabled"
N_BUCKETS = 8


def _tables(root, n=40_000, n_orders=5_000, n_files=4):
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
        "cust": rng.integers(0, 500, n_orders).astype(np.int64),
    })
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(items.slice(lo, hi - lo), str(idir / f"p{i}.parquet"))
        lo, hi = i * n_orders // n_files, (i + 1) * n_orders // n_files
        pq.write_table(orders.slice(lo, hi - lo), str(odir / f"p{i}.parquet"))
    return str(idir), str(odir)


def _sessions(root):
    t = T.HyperspaceSession(device="cpu")
    t.conf.set("hyperspace.system.path", str(root / "port"))
    t.conf.set("hyperspace.index.num_buckets", N_BUCKETS)
    j = JSession()
    j.conf.set(JC.INDEX_SYSTEM_PATH, str(root / "jax"))
    j.conf.set(JC.INDEX_NUM_BUCKETS, N_BUCKETS)
    j.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
    return t, j


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve_pipeline")
    idir, odir = _tables(root)
    t, j = _sessions(root)
    for s, hs, cfg in ((t, T.Hyperspace(t), TConfig), (j, JHyperspace(j), JConfig)):
        hs.create_index(s.read.parquet(idir), cfg("i1", ["k"], ["q", "price", "tag"]))
        hs.create_index(s.read.parquet(odir), cfg("o1", ["ok"], ["cust"]))
    return {"t": t, "j": j, "idir": idir, "odir": odir, "root": root}


def _join(s, idir, odir, filtered=False):
    items, orders = s.read.parquet(idir), s.read.parquet(odir)
    if filtered:
        items = items.filter(items["q"] < 20)
    s.enable_hyperspace()
    try:
        return (orders.join(items, on=orders["ok"] == items["k"])
                .select("ok", "cust", "q", "price", "tag").collect())
    finally:
        s.disable_hyperspace()


def _run(s, pipeline, *args, **kw):
    s.conf.set(PIPELINE, pipeline)
    return _join(s, *args, **kw)


@pytest.mark.parametrize("filtered", [False, True], ids=["clean", "filtered_side"])
def test_join_identical_with_pipeline_on_and_off(world, filtered):
    t, idir, odir = world["t"], world["idir"], world["odir"]
    t.exec_stats.reset()
    r_pipe = _run(t, True, idir, odir, filtered)
    stages = set(t.join_stats)
    r_seq = _run(t, False, idir, odir, filtered)
    assert set(t.join_stats) == stages == {
        "scan", "prepare", "match", "to_host", "verify", "assemble"}
    assert r_pipe.num_rows > 0 and r_pipe.equals(r_seq)  # rows AND order
    assert r_pipe.equals(_run(world["j"], True, idir, odir, filtered))
    assert t.exec_stats.co_bucketed_joins == 2


def test_string_key_join_identical(tmp_path):
    """String join keys take the murmur-collision re-verify on both
    routes."""
    rng = np.random.default_rng(7)
    idir, odir = tmp_path / "si", tmp_path / "so"
    idir.mkdir()
    odir.mkdir()
    keys = [f"user-{i}" for i in range(500)]
    left = pa.table({"name": pa.array(rng.choice(keys, 20_000)),
                     "v": rng.integers(0, 100, 20_000).astype(np.int64)})
    right = pa.table({"uname": pa.array(keys), "score": rng.normal(0, 1, len(keys))})
    for i in range(2):
        pq.write_table(left.slice(i * 10_000, 10_000), str(idir / f"p{i}.parquet"))
        pq.write_table(right.slice(i * 250, 250), str(odir / f"p{i}.parquet"))
    t, j = _sessions(tmp_path)
    for s, hs, cfg in ((t, T.Hyperspace(t), TConfig), (j, JHyperspace(j), JConfig)):
        hs.create_index(s.read.parquet(str(idir)), cfg("si", ["name"], ["v"]))
        hs.create_index(s.read.parquet(str(odir)), cfg("so", ["uname"], ["score"]))

    def q(s, pipeline):
        s.conf.set(PIPELINE, pipeline)
        ldf, rdf = s.read.parquet(str(idir)), s.read.parquet(str(odir))
        s.enable_hyperspace()
        return ldf.join(rdf, on=ldf["name"] == rdf["uname"]).select(
            "name", "v", "score").collect()

    r_pipe = q(t, True)
    assert r_pipe.num_rows > 0
    assert q(t, False).equals(r_pipe)
    assert q(j, True).equals(r_pipe)


# -- prepare_join_side_pipelined, field by field --------------------------------------


def _random_buckets(rng, sorted_buckets):
    tables = {}
    for b in range(5):
        n = int(rng.integers(0, 2_000))
        keys = rng.integers(-50, 50, n).astype(np.int64)
        if sorted_buckets:
            keys = np.sort(keys)
        mask = rng.random(n) < 0.05
        tables[b] = pa.table({
            "k": pa.array(np.where(mask, 0, keys), mask=mask, type=pa.int64()),
            "tag": pa.array(rng.choice(["x", "y", "z"], n)),
        })
    return tables


@pytest.mark.parametrize("sorted_buckets", [True, False])
def test_pipelined_prepare_equals_sequential_and_reference(sorted_buckets):
    tables = _random_buckets(np.random.default_rng(13), sorted_buckets)
    batches = {b: TBatch.from_arrow(t) for b, t in tables.items()}
    seq = tje.prepare_join_side(batches, ["k"])
    stats = {}
    pipe = tje.prepare_join_side_pipelined(
        [(b, (lambda bb=bb: bb)) for b, bb in sorted(batches.items())], ["k"], stats)
    ref = jje.prepare_join_side_pipelined(
        [(b, (lambda t=t: JBatch.from_arrow(t))) for b, t in sorted(tables.items())], ["k"])
    assert set(stats) == {"scan", "prepare"}
    for other in (seq, ref):
        assert pipe.buckets == other.buckets
        np.testing.assert_array_equal(pipe.reps, other.reps)
        np.testing.assert_array_equal(pipe.combined, other.combined)
        assert (pipe.nulls is None) == (other.nulls is None)
        if pipe.nulls is not None:
            np.testing.assert_array_equal(pipe.nulls, other.nulls)
        assert pipe.sorted_buckets == other.sorted_buckets
        assert pipe.batch.to_arrow().equals(other.batch.to_arrow())
    np.testing.assert_array_equal(pipe.offs, seq.offs)
    # the reference keeps bucket starts and sizes; the port B + 1 offsets
    np.testing.assert_array_equal(pipe.offs[:-1], ref.offs)
    np.testing.assert_array_equal(np.diff(pipe.offs), ref.sizes)


def test_empty_stream_returns_none():
    assert tje.prepare_join_side_pipelined([], ["k"]) is None


# -- the overlap, and no device work on the side threads --------------------------------


def test_slow_reader_overlaps_prepare(world, monkeypatch):
    """With a slow reader, the read of a later bucket is still in flight
    when an earlier bucket's prepare starts, the reads overlap each
    other, and the rows equal the sequential route's."""
    t, idir, odir = world["t"], world["idir"], world["odir"]
    want = _run(t, False, idir, odir)
    events = []
    lock = threading.Lock()
    real_read = tex.pio.read_tables

    def slow_read(paths, *a, **k):
        t0 = time.perf_counter()
        time.sleep(0.15)
        out = real_read(paths, *a, **k)
        with lock:
            events.append(("scan", t0, time.perf_counter()))
        return out

    real_prepare = tje.prepare_join_side_pipelined

    def traced_prepare(stream, key_cols, stats=None):
        def trace(fetch):
            def run():
                batch = fetch()
                with lock:
                    events.append(("prep_start", time.perf_counter(), None))
                return batch

            return run

        return real_prepare([(b, trace(f)) for b, f in stream], key_cols, stats)

    monkeypatch.setattr(tex.pio, "read_tables", slow_read)
    monkeypatch.setattr(tje, "prepare_join_side_pipelined", traced_prepare)
    got = _run(t, True, idir, odir)
    assert got.equals(want)
    scans = [e for e in events if e[0] == "scan"]
    preps = [e for e in events if e[0] == "prep_start"]
    assert len(scans) == 2 * N_BUCKETS and len(preps) == 2 * N_BUCKETS, events
    assert min(e[1] for e in preps) < max(e[2] for e in scans), "no scan/prepare overlap"
    by_start = sorted(scans, key=lambda e: e[1])
    assert any(by_start[i + 1][1] < by_start[i][2] for i in range(len(by_start) - 1)), (
        "bucket reads ran strictly one after another")


def test_side_threads_run_no_device_work(world, monkeypatch):
    """The clean shape has no Filter, so no kernel (B1, B3, B3a) may run
    on a side, scan or prepare thread: only the match (B4) runs, on the
    calling thread. Each device entry point is wrapped to record its
    thread."""
    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.ops import hash as H

    calls = []

    def spy(mod, name):
        inner = getattr(mod, name)

        def run(*a, **k):
            calls.append((name, threading.current_thread().name))
            return inner(*a, **k)

        monkeypatch.setattr(mod, name, run)

    for mod, name in ((H, "bucket_ids"), (F, "range_mask"), (F, "device_filter_mask"),
                      (tex, "fused_range_mask"), (tex, "device_filter_mask"),
                      (tex, "bucket_ids"), (tje, "match_pairs")):
        spy(mod, name)
    got = _run(world["t"], True, world["idir"], world["odir"])
    assert got.num_rows > 0
    assert calls == [("match_pairs", threading.current_thread().name)]


def test_pipeline_serves_the_reference_built_index(world):
    """The port's pipelined route over the JAX package's indexes gives the
    reference's rows in order."""
    t2, _j = _sessions(world["root"])
    t2.conf.set("hyperspace.system.path", str(world["root"] / "jax"))
    got = _run(t2, True, world["idir"], world["odir"])
    assert got.equals(_run(world["j"], True, world["idir"], world["odir"]))


def test_stage_seconds_are_side_thread_seconds(world, monkeypatch):
    """On the pipelined route ``scan`` and ``prepare`` are seconds of the
    two side threads (the waits for reads, not the scan pool's busy
    seconds), as on the sequential route: with 16 slow reads in flight
    together they sum to at most twice the join's wall time, and the
    first read's wait is not hidden."""
    t, idir, odir = world["t"], world["idir"], world["odir"]
    real_read = tex.pio.read_tables

    def slow_read(paths, *a, **k):
        time.sleep(0.15)
        return real_read(paths, *a, **k)

    monkeypatch.setattr(tex.pio, "read_tables", slow_read)
    t0 = time.perf_counter()
    _run(t, True, idir, odir)
    wall = time.perf_counter() - t0
    stats = t.join_stats
    assert stats["scan"] >= 0.15
    assert stats["scan"] + stats["prepare"] <= 2 * wall


def test_pipeline_is_off_by_default(world, monkeypatch):
    """A session that sets nothing takes the sequential route."""
    t2, _j = _sessions(world["root"])

    def refuse(*a, **k):
        raise AssertionError("pipelined prepare ran with the route off")

    monkeypatch.setattr(tje, "prepare_join_side_pipelined", refuse)
    got = _join(t2, world["idir"], world["odir"])
    assert t2.exec_stats.co_bucketed_joins == 1
    assert got.equals(_run(world["t"], False, world["idir"], world["odir"]))
