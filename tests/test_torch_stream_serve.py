"""The port's streaming per-bucket join serve against the JAX package's.

Every case of the reference's ``tests/test_stream_serve.py`` (its 3
classes), through both packages over the same numpy-seeded tables and
indexes (``torch_serve_twin.Twin``): the streamed join's rows equal the
JAX package's in order (floats bit for bit) and the port's materializing
route's in order, ``last_stream_stats`` is equal, and so are the waves
themselves, bucket by bucket and side by side (each package's
``_stream_wave_prepared`` recorded). Each wave's match is B4's plain
version in the port. ``prepare_join_side_contiguous`` equals
``prepare_join_side`` field by field in the port, and its fields equal
the reference's (the port's offsets are [B + 1], the reference's [B]
beside its sizes)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from hyperspace_tpu.execution import executor as JX
from hyperspace_tpu.execution import join_exec as JJ
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu_torch.execution import executor as TX
from hyperspace_tpu_torch.execution import join_exec as TJ
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from torch_b5_cases import same_rows
from torch_lifecycle_twin import sorted_table
from torch_serve_twin import Twin

STREAM = "hyperspace.serve.stream.enabled"
STREAM_BYTES = "hyperspace.serve.stream.maxBytes"
MMAP = "hyperspace.io.mmap.enabled"
HYBRID = "hyperspace.index.hybridscan.enabled"


def _tables(tmp_path, n=40_000, n_orders=5_000, n_files=4):
    rng = np.random.default_rng(17)
    idir, odir = tmp_path / "items", tmp_path / "orders"
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


def _indexed(tmp_path, lineage=False):
    idir, odir = _tables(tmp_path)
    tw = Twin(tmp_path)
    tw.set("hyperspace.index.lineage.enabled", lineage)
    tw.create("covering", idir, "i1", ["k"], ["q", "price", "tag"])
    tw.create("covering", odir, "o1", ["ok"], ["cust"])
    tw.enable()
    return tw, idir, odir


def _join(idir, odir):
    def q(s, F):
        items, orders = s.read.parquet(idir), s.read.parquet(odir)
        return orders.join(items, on=orders["ok"] == items["k"]).select(
            "ok", "cust", "q", "price", "tag")

    return q


@pytest.fixture
def waves(monkeypatch):
    """Each package's streamed waves in order: (side's first key column,
    buckets) a ``_stream_wave_prepared`` call."""
    seen = {"port": [], "jax": []}
    for pkg, X in (("port", TX), ("jax", JX)):
        inner = X._stream_wave_prepared

        def spy(state, wave, key_cols, *rest, inner=inner, log=seen[pkg]):
            log.append((tuple(key_cols), tuple(wave)))
            return inner(state, wave, key_cols, *rest)

        monkeypatch.setattr(X, "_stream_wave_prepared", spy)
    return seen


def streamed(tw, q, waves):
    """The streamed join through both packages: rows equal in order,
    ``last_stream_stats`` and the waves equal. Returns (rows, stats)."""
    for log in waves.values():
        log.clear()
    got = tw.run(q)
    stats = dict(TX.last_stream_stats)
    assert stats == dict(JX.last_stream_stats)
    assert sorted(waves["port"]) == sorted(waves["jax"])
    assert len(waves["port"]) == 2 * stats["stream_waves"]
    return got, stats


class TestStreamBitIdentity:
    """stream on == stream off == unindexed, in both packages."""

    def test_multiwave_three_way_differential(self, tmp_path, waves):
        tw, idir, odir = _indexed(tmp_path)
        q = _join(idir, odir)
        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 64_000)  # many waves
        r_stream, stats = streamed(tw, q, waves)
        assert stats.get("stream_waves", 0) > 1, stats
        tw.set(STREAM, False)
        assert same_rows(r_stream, tw.run(q))  # rows AND order
        tw.enable(False)
        assert sorted_table(r_stream).equals(sorted_table(tw.run(q)))

    def test_single_wave_identical(self, tmp_path, waves):
        tw, idir, odir = _indexed(tmp_path)
        q = _join(idir, odir)
        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 1 << 30)  # one wave
        r_stream, stats = streamed(tw, q, waves)
        assert stats["stream_waves"] == 1
        tw.set(STREAM, False)
        assert same_rows(r_stream, tw.run(q))

    def test_mmap_reads_identical(self, tmp_path, waves):
        """Memory-mapped reads change where the bytes live, never the
        bytes."""
        tw, idir, odir = _indexed(tmp_path)
        q = _join(idir, odir)
        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 64_000)
        tw.set(MMAP, True)
        r_mmap, _ = streamed(tw, q, waves)
        tw.set(MMAP, False)
        tw.set(STREAM, False)
        assert same_rows(r_mmap, tw.run(q))

    def test_string_key_join_identical(self, tmp_path, waves):
        """String join keys take the hash-collision re-verify on every
        wave."""
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
        tw = Twin(tmp_path)
        tw.create("covering", str(idir), "si", ["name"], ["v"])
        tw.create("covering", str(odir), "so", ["uname"], ["score"])
        tw.enable()

        def q(s, F):
            ldf, rdf = s.read.parquet(str(idir)), s.read.parquet(str(odir))
            return ldf.join(rdf, on=ldf["name"] == rdf["uname"]).select("name", "v", "score")

        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 64_000)
        r_stream, stats = streamed(tw, q, waves)
        assert stats["stream_waves"] > 1
        tw.set(STREAM, False)
        assert same_rows(r_stream, tw.run(q))

    def test_hybrid_append_identical(self, tmp_path, waves):
        """Appended files (Hybrid Scan) merge into each wave's buckets as
        the materializing Union route merges them (B1's plain version
        hashes them in the port)."""
        tw, idir, odir = _indexed(tmp_path)
        rng = np.random.default_rng(3)
        extra = pa.table({
            "k": rng.integers(0, 5_000, 3_000).astype(np.int64),
            "q": np.full(3_000, 7, dtype=np.int64),
            "price": np.full(3_000, 1.0),
            "tag": pa.array(np.full(3_000, "omega")),
        })
        pq.write_table(extra, idir + "/appended.parquet")
        tw.set(HYBRID, True)
        tw.clear()
        q = _join(idir, odir)
        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 64_000)
        r_stream, stats = streamed(tw, q, waves)
        assert stats["stream_waves"] > 1
        tw.set(STREAM, False)
        assert same_rows(r_stream, tw.run(q))
        assert "omega" in set(r_stream.column("tag").to_pylist())

    def test_delete_compensation_falls_back_and_matches(self, tmp_path, waves):
        """Lineage delete compensation breaks the streamable shape: the
        probe declines and the materializing route serves the right rows."""
        tw, idir, odir = _indexed(tmp_path, lineage=True)
        os.unlink(idir + "/p3.parquet")
        tw.set(HYBRID, True)
        tw.set("hyperspace.index.hybridscan.maxDeletedRatio", 1.0)
        tw.clear()
        q = _join(idir, odir)
        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 64_000)
        r_stream = tw.run(q)
        assert waves["port"] == [] and waves["jax"] == []  # no wave streamed
        tw.set(STREAM, False)
        assert same_rows(r_stream, tw.run(q))


class TestStreamWaves:
    def test_wave_telemetry_and_stage_span(self, tmp_path, waves):
        """A small budget packs many waves, the buckets cover every common
        bucket once either way, and the join's stage seconds hold
        ``stream_wave``."""
        tw, idir, odir = _indexed(tmp_path)
        q = _join(idir, odir)
        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 64_000)
        small, many = streamed(tw, q, waves)
        bd = dict(tw.t.join_stats)
        tw.set(STREAM_BYTES, 1 << 30)
        big, one = streamed(tw, q, waves)
        assert same_rows(small, big)
        assert many["stream_waves"] > one["stream_waves"] == 1
        assert many["stream_buckets"] == one["stream_buckets"]
        assert bd.get("stream_wave", 0) > 0, bd

    def test_oversized_bucket_runs_alone(self, tmp_path, waves):
        """A budget below every bucket gives one bucket a wave."""
        tw, idir, odir = _indexed(tmp_path)
        q = _join(idir, odir)
        tw.set(STREAM, True)
        tw.set(STREAM_BYTES, 1)
        r, stats = streamed(tw, q, waves)
        assert stats["stream_waves"] == stats["stream_buckets"]
        tw.set(STREAM, False)
        assert same_rows(r, tw.run(q))


class TestPrepareContiguousUnit:
    """prepare_join_side_contiguous against prepare_join_side over the same
    rows, every field equal, in the port and against the reference."""

    def _bucketed(self, rng, sorted_keys, with_nulls):
        tables = {}
        for b in range(5):
            n = int(rng.integers(1, 2_000))
            keys = rng.integers(-50, 50, n).astype(np.int64)
            if sorted_keys:
                keys = np.sort(keys)
            mask = rng.random(n) < (0.05 if with_nulls else 0.0)
            tables[b] = pa.table({"k": pa.array(np.where(mask, 0, keys), mask=mask,
                                                type=pa.int64()),
                                  "tag": pa.array(rng.choice(["x", "y", "z"], n))})
        return tables

    @pytest.mark.parametrize("sorted_keys", [True, False])
    @pytest.mark.parametrize("with_nulls", [True, False])
    def test_fields_identical(self, sorted_keys, with_nulls):
        tables = self._bucketed(np.random.default_rng(13), sorted_keys, with_nulls)
        order = sorted(tables)
        out = {}
        for pkg, B, J in (("port", TBatch, TJ), ("jax", JBatch, JJ)):
            batches = {b: B.from_arrow(t) for b, t in tables.items()}
            seq = J.prepare_join_side(batches, ["k"])
            contig = J.prepare_join_side_contiguous(
                B.concat([batches[b] for b in order]), tuple(order),
                [batches[b].num_rows for b in order], ["k"])
            assert contig.buckets == seq.buckets
            for f in ("sizes", "offs", "reps", "combined"):
                np.testing.assert_array_equal(getattr(contig, f), getattr(seq, f))
            assert (contig.nulls is None) == (seq.nulls is None)
            if contig.nulls is not None:
                np.testing.assert_array_equal(contig.nulls, seq.nulls)
            assert contig.sorted_buckets == seq.sorted_buckets
            assert contig.batch.to_arrow().equals(seq.batch.to_arrow())
            out[pkg] = contig
        port, ref = out["port"], out["jax"]
        assert port.buckets == ref.buckets and port.sorted_buckets == ref.sorted_buckets
        for f in ("sizes", "reps", "combined"):
            np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
        np.testing.assert_array_equal(port.offs[:-1], ref.offs)
        assert (port.nulls is None) == (ref.nulls is None)
        if port.nulls is not None:
            np.testing.assert_array_equal(port.nulls, ref.nulls)
        assert same_rows(port.batch.to_arrow(), ref.batch.to_arrow())

    def test_empty_wave_returns_none(self):
        for B, J in ((TBatch, TJ), (JBatch, JJ)):
            empty = B.from_arrow(pa.table({"k": pa.array([], type=pa.int64())}))
            assert J.prepare_join_side_contiguous(empty, (), [], ["k"]) is None
