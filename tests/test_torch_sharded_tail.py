"""The port's sharded build and serve tail against the JAX package's, on
the CPU.

Every case of ``tests/test_sharded_tail.py`` that tests the tail itself,
both packages at 8 shards: with ``hyperspace.build.shardedTail.enabled``
on, each shard's slice sorts and writes its own buckets (the build) and
prepares and matches its own (the serve), concurrently; with it off one
tail takes everything. The bucket files equal the JAX package's at 8
shards byte for byte with the flag on and off, in memory, streamed in
waves (with the concurrent per-shard merges) and after an incremental
refresh; the joins give the JAX package's rows in order, with a Hybrid
Scan delta too; an index built sharded serves from one shard; the sharded
sort permutation equals the global one within every bucket; the skew
telemetry and warning are the reference's. (The reference file's native
temp-file sweep and shard_map lint cases test its native library and its
analyzer, which the port does not have.)
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import logging
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from torch_mesh_twin import (
    HYBRID,
    SHARDED_TAIL,
    assert_identical_files,
    build,
    covering,
    hyperspace,
    session,
    sorted_table,
)

from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.ops import join as TJ


@pytest.fixture
def mixed_parquet(tmp_path):
    """Heavily tied keys (stability), a string column and a nullable float
    payload (validity masks through the exchange and the shard tails)."""
    rng = np.random.default_rng(17)
    d = tmp_path / "mixed"
    d.mkdir()
    for i in range(4):
        n = 3000
        vals = rng.normal(size=n)
        t = pa.table(
            {
                "k": pa.array(rng.integers(0, 5, n), type=pa.int64()),
                "s": pa.array([["aa", "bb", "cc"][v] for v in rng.integers(0, 3, n)]),
                "v": pa.array(
                    [None if j % 13 == 0 else vals[j] for j in range(n)], type=pa.float64()
                ),
            }
        )
        pq.write_table(t, d / f"part-{i}.parquet")
    return str(d)


def _budget(src, factor):
    from hyperspace_tpu_torch.indexes.covering_build import per_file_materialized_bytes

    first = os.path.join(src, sorted(os.listdir(src))[0])
    return int(per_file_materialized_bytes([first], "parquet")[0] * factor)


class TestShardedBuildDifferential:
    def test_in_memory_bit_identical(self, tmp_path, mixed_parquet):
        ref = build(session("jax", tmp_path, 8), mixed_parquet, "shref", sharded=True)
        port = session("port", tmp_path, 8)
        on = build(port, mixed_parquet, "shon", sharded=True)
        assert port.build_stats.get("tail_shards", 0) > 1
        assert port.build_stats["tail_wall"] > 0
        off = build(port, mixed_parquet, "shoff", sharded=False)
        assert "tail_shards" not in port.build_stats
        assert_identical_files(on, ref, "on")
        assert_identical_files(off, ref, "off")

    @pytest.mark.parametrize("partition_first", [True, False])
    def test_legacy_route_after_the_exchange(self, tmp_path, mixed_parquet, partition_first):
        """``partitionFirst`` off (bucketize, then write_bucket_files) after
        an 8-shard exchange writes the same files."""
        ref = build(session("jax", tmp_path, 8), mixed_parquet, "lgref")
        port = session("port", tmp_path, 8)
        port.conf.set(TC.INDEX_BUILD_PARTITION_FIRST, partition_first)
        assert_identical_files(build(port, mixed_parquet, "lg"), ref)

    def test_streaming_waves_bit_identical(self, tmp_path, mixed_parquet):
        """Budgeted builds wave, spill and merge; the per-wave sharded sort
        and the concurrent per-shard merges land the same bytes."""
        budget = _budget(mixed_parquet, 2.5)
        ref = build(session("jax", tmp_path, 8), mixed_parquet, "stref", sharded=True,
                    budget=budget)
        port = session("port", tmp_path, 8)
        on = build(port, mixed_parquet, "ston", sharded=True, budget=budget)
        assert port.build_stats["waves"] > 1
        off = build(port, mixed_parquet, "stoff", sharded=False, budget=budget)
        assert port.build_stats["merge_workers"] == 1
        assert_identical_files(on, ref, "on")
        assert_identical_files(off, ref, "off")

    def test_concurrent_merges_within_the_budget(self, tmp_path):
        """Buckets of an eighth of the data each under a budget of 2.5
        files: the merges of 5 shards' buckets run at once (5 of the
        largest fit the budget), with the reference's files."""
        rng = np.random.default_rng(9)
        d = tmp_path / "wide"
        d.mkdir()
        for i in range(4):
            pq.write_table(
                pa.table({"k": pa.array(rng.integers(0, 4000, 4000), type=pa.int64()),
                          "s": pa.array(["aa"] * 4000), "v": pa.array(rng.normal(size=4000))}),
                d / f"part-{i}.parquet",
            )
        budget = _budget(str(d), 2.5)
        ref = build(session("jax", tmp_path, 8), str(d), "cmref", budget=budget)
        port = session("port", tmp_path, 8)
        files = build(port, str(d), "cm", budget=budget)
        assert 1 < port.build_stats["merge_workers"] <= 8
        assert_identical_files(files, ref)

    def test_refresh_incremental_bit_identical(self, tmp_path, mixed_parquet):
        def run(pkg, name, sharded):
            s = session(pkg, tmp_path, 8)
            build(s, mixed_parquet, name, sharded=sharded, lineage=True)
            rng = np.random.default_rng(5)
            extra = pa.table(
                {
                    "k": pa.array(rng.integers(0, 5, 500), type=pa.int64()),
                    "s": pa.array(["dd"] * 500),
                    "v": pa.array(rng.normal(size=500)),
                }
            )
            extra_path = os.path.join(mixed_parquet, "extra.parquet")
            pq.write_table(extra, extra_path)
            s.index_manager.clear_cache()
            hyperspace(s).refresh_index(name, "incremental")
            os.remove(extra_path)  # the same source for the next leg
            s.index_manager.clear_cache()
            return sorted(s.index_manager.get_index_log_entry(name).content.files)

        ref = run("jax", "rfref", True)
        assert_identical_files(run("port", "rfon", True), ref, "on")
        assert_identical_files(run("port", "rfoff", False), ref, "off")

    def test_cross_mesh_serve(self, tmp_path, mixed_parquet):
        """An index built by the sharded tail serves from one shard the
        rows the unindexed plan gives."""
        build(session("port", tmp_path, 8), mixed_parquet, "xms", sharded=True)
        server = session("port", tmp_path, 1)
        df = server.read.parquet(mixed_parquet)

        def q(d):
            return d.filter(d["k"] == 2).select("k", "s", "v")

        server.disable_hyperspace()
        base = q(df).collect()
        server.enable_hyperspace()
        assert "Hyperspace(Type: CI" in hyperspace(server).explain(q(df))
        got = q(df).collect()
        assert sorted_table(got).equals(sorted_table(base))
        assert got.num_rows > 0


@pytest.fixture
def join_data(tmp_path):
    rng = np.random.default_rng(23)
    fact = tmp_path / "fact"
    dim = tmp_path / "dim"
    fact.mkdir()
    dim.mkdir()
    for i in range(3):
        n = 4000
        t = pa.table(
            {
                "k": pa.array(rng.integers(0, 100, n), type=pa.int64()),
                "p": pa.array(rng.normal(size=n)),
            }
        )
        pq.write_table(t, fact / f"f{i}.parquet")
    pq.write_table(
        pa.table(
            {"j": pa.array(np.arange(100), type=pa.int64()), "w": pa.array(rng.normal(size=100))}
        ),
        dim / "d.parquet",
    )
    return str(fact), str(dim)


class TestShardedServeDifferential:
    @staticmethod
    def _indexed(s, fact, dim):
        hs = hyperspace(s)
        f = s.read.parquet(fact)
        d = s.read.parquet(dim)
        hs.create_index(f, covering(s, "fidx", ["k"], ["p"]))
        hs.create_index(d, covering(s, "didx", ["j"], ["w"]))
        return f, d

    @staticmethod
    def _q(f, d):
        return f.join(d, on=f["k"] == d["j"]).select("k", "p", "w")

    @pytest.mark.parametrize("pipelined", [False, True])
    def test_join_bit_identical(self, tmp_path, join_data, pipelined):
        j = session("jax", tmp_path, 8)
        jf, jd = self._indexed(j, *join_data)
        j.enable_hyperspace()
        want = self._q(jf, jd).collect()
        port = session("port", tmp_path, 8)
        port.conf.set("hyperspace.serve.pipeline.enabled", pipelined)
        f, d = self._indexed(port, *join_data)
        port.enable_hyperspace()
        assert hyperspace(port).explain(self._q(f, d)).count("Hyperspace(Type: CI") == 2
        port.conf.set(SHARDED_TAIL, True)
        before = TJ.shard_launches
        on = self._q(f, d).collect()
        assert TJ.shard_launches == before  # launches count only on the card
        port.conf.set(SHARDED_TAIL, False)
        off = self._q(f, d).collect()
        # the same rows in the same order, not only the same set
        assert on.equals(off)
        assert on.equals(want)
        port.disable_hyperspace()
        base = self._q(f, d).collect()
        assert sorted_table(on).equals(sorted_table(base))
        assert on.num_rows > 0

    def test_hybrid_delta_bit_identical(self, tmp_path, join_data):
        fact, dim = join_data
        port = session("port", tmp_path, 8)
        f, d = self._indexed(port, fact, dim)
        pq.write_table(
            pa.table(
                {
                    # one key past the dim's range: rows only the delta has
                    "k": pa.array([0, 1, 2, 300], type=pa.int64()),
                    "p": pa.array([1.0, 2.0, 3.0, 4.0]),
                }
            ),
            os.path.join(fact, "extra.parquet"),
        )
        port.conf.set(HYBRID, True)
        port.index_manager.clear_cache()
        f2 = port.read.parquet(fact)
        port.enable_hyperspace()
        assert hyperspace(port).explain(self._q(f2, d)).count("Hyperspace(Type: CI") == 2
        port.conf.set(SHARDED_TAIL, True)
        on = self._q(f2, d).collect()
        port.conf.set(SHARDED_TAIL, False)
        off = self._q(f2, d).collect()
        assert on.equals(off)
        port.disable_hyperspace()
        base = self._q(f2, d).collect()
        assert sorted_table(on).equals(sorted_table(base))


class TestShardedMatch:
    @pytest.mark.parametrize("D", [1, 2, 3, 8])
    def test_sharded_match_equals_one_device(self, D):
        """B4 a shard block (its plain version here) gives the one-device
        pairs in order, with and without row maps, the bucket count not a
        multiple of D."""
        rng = np.random.default_rng(D)
        sizes_l, sizes_r = rng.integers(0, 40, 13), rng.integers(0, 40, 13)
        l_offs = np.concatenate([[0], np.cumsum(sizes_l)])
        r_offs = np.concatenate([[0], np.cumsum(sizes_r)])
        lk = torch.from_numpy(rng.integers(0, 20, int(l_offs[-1])))
        rk = torch.from_numpy(rng.integers(0, 20, int(r_offs[-1])))
        lk, l_row = TJ.segment_sort(lk, l_offs)
        rk, r_row = TJ.segment_sort(rk, r_offs)
        for maps in ((None, None), (l_row, r_row), (None, r_row)):
            want = TJ.match_pairs(lk, l_offs, rk, r_offs, *maps)
            got = TJ.match_pairs_sharded(["cpu"] * D, lk, l_offs, rk, r_offs, *maps)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert want[0].numel() > 0


class TestShardedSortPermutation:
    @pytest.mark.parametrize("n,nb,k", [(0, 8, 1), (9, 3, 2), (60_000, 8, 1)])
    def test_per_bucket_equals_global(self, n, nb, k):
        """Shard-major output differs in global order from the global
        (bucket, keys) sort by design; within any bucket the two are the
        same, the only order the bucketed writers see."""
        from hyperspace_tpu_torch.ops.sort import sharded_sort_permutation, sort_permutation

        rng = np.random.default_rng(n + nb + k)
        D = 4
        reps = rng.integers(-(2**60), 2**60, size=(k, n), dtype=np.int64)
        owner = rng.integers(0, D, n)
        order = np.argsort(owner, kind="stable")
        reps = reps[:, order]
        owner = owner[order]
        buckets = np.empty(n, dtype=np.int32)
        for s in range(D):
            m = owner == s
            buckets[m] = (rng.integers(0, max(nb // D, 1), int(m.sum())) * D + s) % nb
        shard_offs = np.concatenate([[0], np.cumsum(np.bincount(owner, minlength=D))]).astype(
            np.int64
        )
        reps_t, buckets_t = torch.from_numpy(reps), torch.from_numpy(buckets)
        perm = sharded_sort_permutation(reps_t, buckets_t, nb, shard_offs, ["cpu"] * D).numpy()
        ref = sort_permutation(reps_t, buckets_t).numpy()
        for b in np.unique(buckets):
            np.testing.assert_array_equal(perm[buckets[perm] == b], ref[buckets[ref] == b])


class TestSkewTelemetry:
    def test_skew_recorded_and_warned(self, tmp_path, caplog):
        """All rows in one bucket: one hot (shard, peer) slot; the
        telemetry records the ratio the JAX package records, and the
        warning fires."""
        from hyperspace_tpu.indexes.covering_build import last_build_telemetry

        d = tmp_path / "skew"
        d.mkdir()
        n = 20000
        t = pa.table(
            {
                "k": pa.array(np.full(n, 7), type=pa.int64()),
                "s": pa.array(["x"] * n),
                "v": pa.array(np.ones(n)),
            }
        )
        pq.write_table(t, d / "p0.parquet")
        pq.write_table(t, d / "p1.parquet")
        port = session("port", tmp_path, 8)
        with caplog.at_level(logging.WARNING, "hyperspace_tpu_torch.shuffle"):
            build(port, str(d), "skidx", sharded=True)
        assert port.build_telemetry["shuffle_skew_ratio"] >= TC.BUILD_SHUFFLE_SKEW_WARN_RATIO
        assert any("shuffle skew" in r.message for r in caplog.records)
        build(session("jax", tmp_path, 8), str(d), "skidx", sharded=True)
        for key in ("shuffle_skew_ratio", "shuffle_max_peer_count", "shuffle_cap"):
            assert port.build_telemetry[key] == last_build_telemetry[key], key

    def test_balanced_no_warning(self, tmp_path, mixed_parquet, caplog):
        port = session("port", tmp_path, 8)
        with caplog.at_level(logging.WARNING, "hyperspace_tpu_torch.shuffle"):
            # 5 keys over 8 buckets is mildly skewed, below the warning
            build(port, mixed_parquet, "balidx", sharded=True)
        assert not [r for r in caplog.records if "shuffle skew" in r.message]
        assert "shuffle_skew_ratio" in port.build_telemetry
        assert port.build_telemetry["shuffle_devices"] == 8.0
