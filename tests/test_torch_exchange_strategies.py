"""The port's exchange strategies against the JAX package's, on the CPU.

Every case of ``tests/test_exchange_strategies.py``, each package at the
same D: the port's ``flat`` (kernels B1, B8a and B8b, their plain versions
here), ``host``, ``compact`` and ``twostage`` give the JAX package's
``bucket_shuffle(strategy="flat")`` bucket ids, payload columns with their
dtypes and shard offsets, over D in {1, 2, 8} and both skews; shards that
own no bucket get empty extents; every (H, L) carve of 8 shards lands the
same rows; the canonical order is the naive lexsort and the JAX
package's; ``auto`` resolves as documented. B8's plain versions, a
shard at a time around the block exchange, give the JAX package's
``_flat_program`` output slot for slot. Whole builds at 8 shards (in
memory and streamed in waves, every strategy) write the JAX package's
bucket files at 8 byte for byte, with the exchange telemetry and the
once-a-build skew warning.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from torch_mesh_twin import assert_identical_files, build, session

from hyperspace_tpu.ops import pad_len
from hyperspace_tpu.parallel import shuffle as jsh
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.ops import exchange as X
from hyperspace_tpu_torch.parallel import shuffle as tsh
from hyperspace_tpu_torch.parallel.mesh import Mesh, default_mesh


def _jmesh(D):
    return jax.sharding.Mesh(np.array(jax.devices()[:D]), (jsh.SHARD_AXIS,))


def _tmesh(D):
    return Mesh(["cpu"] * D)


def _payload_matrix(rng, n):
    """One array per payload kind the build decomposes batches into, and
    the narrower widths B8 moves as raw bits: int64, float64 with NaNs,
    int32 codes, bool masks, uint8 and int16."""
    f = rng.normal(size=n)
    f[rng.integers(0, 2, n).astype(bool)] = np.nan
    return [
        rng.integers(-(2**60), 2**60, n).astype(np.int64),
        f,
        rng.integers(0, 3, n).astype(np.int32),
        rng.integers(0, 2, n).astype(bool),
        rng.integers(0, 256, n).astype(np.uint8),
        rng.integers(-(2**15), 2**15, n).astype(np.int16),
    ]


def _keys(rng, n, skew):
    if skew == "hot":  # every row hashes into ONE bucket
        return np.full((1, n), 7, dtype=np.int64)
    return rng.integers(0, 97, (2, n)).astype(np.int64)


def _assert_same(got, ref, tag):
    np.testing.assert_array_equal(got[0], ref[0], err_msg=tag)
    assert got[0].dtype == ref[0].dtype, tag
    np.testing.assert_array_equal(got[2], ref[2], err_msg=tag)
    assert len(got[1]) == len(ref[1]), tag
    for a, b in zip(got[1], ref[1]):
        assert a.dtype == b.dtype, tag
        np.testing.assert_array_equal(a, b, err_msg=tag)


class TestStrategyDifferential:
    @pytest.mark.parametrize("D", [1, 2, 8])
    @pytest.mark.parametrize("skew", ["uniform", "hot"])
    def test_bit_identical_to_flat(self, D, skew):
        rng = np.random.default_rng(D * 31 + len(skew))
        n, nb = 3001, 16
        keys = _keys(rng, n, skew)
        payloads = _payload_matrix(rng, n)
        ref = jsh.bucket_shuffle(
            _jmesh(D), keys, payloads, nb, with_shard_offsets=True, strategy="flat"
        )
        for strat in tsh.STRATEGIES:
            got = tsh.bucket_shuffle(
                _tmesh(D), keys, payloads, nb, with_shard_offsets=True,
                strategy=strat, twostage_hosts=2,
            )
            _assert_same(got, ref, strat)
            assert tsh.last_shuffle_stats["strategy"] == strat
            assert tsh.last_shuffle_stats["devices"] == float(D)

    def test_flat_cap_is_the_reference_cap(self):
        rng = np.random.default_rng(4)
        keys = rng.integers(0, 97, (1, 5000)).astype(np.int64)
        jsh.bucket_shuffle(_jmesh(8), keys, [keys[0]], 16, strategy="flat")
        tsh.bucket_shuffle(_tmesh(8), keys, [keys[0]], 16, strategy="flat")
        for k in ("cap", "max_peer_count", "mean_peer_count", "skew_ratio"):
            assert tsh.last_shuffle_stats[k] == jsh.last_shuffle_stats[k], k

    def test_empty_peer_extents(self):
        """num_buckets < D: shards that own no buckets report empty
        extents in every strategy."""
        rng = np.random.default_rng(3)
        n, nb = 999, 3  # owners only 0..2 of 8 shards
        keys = rng.integers(0, 50, (1, n)).astype(np.int64)
        payloads = [np.arange(n, dtype=np.int64)]
        ref = jsh.bucket_shuffle(
            _jmesh(8), keys, payloads, nb, with_shard_offsets=True, strategy="flat"
        )
        assert (np.diff(ref[2])[nb:] == 0).all()
        for strat in tsh.STRATEGIES:
            got = tsh.bucket_shuffle(
                _tmesh(8), keys, payloads, nb, with_shard_offsets=True,
                strategy=strat, twostage_hosts=4,
            )
            _assert_same(got, ref, strat)

    @pytest.mark.parametrize("hosts", [2, 4, 8])
    def test_twostage_host_factorizations(self, hosts):
        """Every (H, L) carve of the 8-shard mesh lands the same rows."""
        rng = np.random.default_rng(hosts)
        n, nb = 2048, 16
        keys = rng.integers(0, 200, (1, n)).astype(np.int64)
        payloads = [keys[0], rng.normal(size=n)]
        ref = jsh.bucket_shuffle(
            _jmesh(8), keys, payloads, nb, with_shard_offsets=True, strategy="flat"
        )
        got = tsh.bucket_shuffle(
            _tmesh(8), keys, payloads, nb, with_shard_offsets=True,
            strategy="twostage", twostage_hosts=hosts,
        )
        _assert_same(got, ref, f"hosts={hosts}")
        jsh.bucket_shuffle(
            _jmesh(8), keys, payloads, nb, strategy="twostage", twostage_hosts=hosts
        )
        assert tsh.last_shuffle_stats["hosts"] == float(hosts)
        for k in ("hosts", "round_cap_max", "round_cap_min", "cap"):
            assert tsh.last_shuffle_stats[k] == jsh.last_shuffle_stats[k], k

    def test_canonical_order_is_flat_order(self):
        """The host-side permutation equals the naive (owner, bucket, row)
        lexsort and the JAX package's canonical order."""
        rng = np.random.default_rng(11)
        n, nb, D = 5000, 13, 8
        ids = rng.integers(0, nb, n).astype(np.int32)
        perm, offs = tsh.canonical_order(ids, nb, D)
        np.testing.assert_array_equal(perm, np.lexsort((np.arange(n), ids, ids % D)))
        np.testing.assert_array_equal(np.diff(offs), np.bincount(ids % D, minlength=D))
        jperm, joffs = jsh.canonical_order(ids, nb, D)
        np.testing.assert_array_equal(perm, jperm)
        np.testing.assert_array_equal(offs, joffs)

    def test_shape_cap_and_pair_ranks_equal_the_reference(self):
        for exact in (0, 1, 7, 8, 9, 100, 1023, 1024, 1025, 10**6 + 3):
            assert tsh._shape_cap(exact) == jsh._shape_cap(exact)
        rng = np.random.default_rng(2)
        slots = rng.integers(0, 37, 4000).astype(np.int32)
        np.testing.assert_array_equal(tsh._pair_ranks(slots, 37), jsh._pair_ranks(slots, 37))
        owner = rng.integers(0, 4, 4000)
        valid = rng.integers(0, 2, 4000).astype(bool)
        np.testing.assert_array_equal(
            tsh._peer_counts(owner, valid, 1000, 4), jsh._peer_counts(owner, valid, 1000, 4)
        )

    def test_resolve(self):
        mesh = _tmesh(8)
        # CPU mesh: auto takes the host-side exchange
        assert tsh.resolve_strategy("auto", mesh, 10**6) == tsh.STRATEGY_HOST
        assert tsh.resolve_strategy("flat", mesh, 10) == tsh.STRATEGY_FLAT
        assert tsh.resolve_strategy("TwoStage", mesh, 10) == tsh.STRATEGY_TWOSTAGE
        with pytest.raises(ValueError, match="unknown exchange strategy"):
            tsh.resolve_strategy("bogus", mesh, 10)
        # a CUDA mesh takes flat (no calibration probe: the reference's
        # uncalibrated choice), a job of several processes twostage
        assert tsh.resolve_strategy("auto", Mesh(["cuda:0"]), 10**6) == tsh.STRATEGY_FLAT
        assert tsh.resolve_strategy("compact", Mesh(["cpu"], processes=2), 10) == "twostage"

    def test_default_mesh_and_numbers(self):
        mesh = default_mesh(["cpu"] * 3)
        assert (mesh.size, mesh.local_size, mesh.processes, mesh.platform) == (3, 3, 1, "cpu")
        assert mesh.device(2) == torch.device("cpu")


class TestB8PlainVersions:
    """B8a and B8b's plain versions around the block exchange, a shard at
    a time, against the JAX package's ``_flat_program`` slot for slot
    (its bucket, validity and payload planes, invalid slots included)."""

    @pytest.mark.parametrize("D, skew", [(1, "uniform"), (2, "hot"), (8, "uniform"), (8, "hot")])
    def test_pack_exchange_order_equal_the_flat_program(self, D, skew):
        rng = np.random.default_rng(D + len(skew))
        n, nb = 3001, 16
        keys = _keys(rng, n, skew)
        payloads = _payload_matrix(rng, n)
        target = pad_len(n)
        target += (-target) % D
        keys = np.pad(keys, ((0, 0), (0, target - n)))
        payloads = [np.pad(p, (0, target - n)) for p in payloads]
        valid = np.arange(target) < n
        ids = jsh._host_bucket_ids(keys, nb, 42)
        cap, _counts = jsh._flat_cap(ids, valid, D)
        jb, jv, jcols = jsh._flat_program(
            _jmesh(D), jnp.asarray(ids), jnp.asarray(valid),
            tuple(jnp.asarray(p) for p in payloads), nb, len(payloads), cap,
        )
        jb, jv = np.asarray(jb), np.asarray(jv)
        jcols = [np.asarray(c) for c in jcols]
        n_local = target // D
        packed = []
        for s in range(D):
            sl = slice(s * n_local, (s + 1) * n_local)
            t_ids = torch.from_numpy(ids[sl].copy())
            t_valid = torch.from_numpy(valid[sl].copy())
            cols = [t_ids, t_valid] + [torch.from_numpy(p[sl].copy()) for p in payloads]
            counts, bufs = X.pack_torch(t_ids, t_valid, D, cap, cols)
            assert counts.tolist() == [
                int(((ids[sl] % D == t) & valid[sl]).sum()) for t in range(D)
            ]
            packed.append(bufs)
        recv = [tsh._exchange_blocks(_tmesh(D), [p[c] for p in packed])
                for c in range(len(packed[0]))]
        for t in range(D):
            out, count = X.order_torch(recv[0][t], recv[1][t], nb, [r[t] for r in recv])
            sl = slice(t * D * cap, (t + 1) * D * cap)
            np.testing.assert_array_equal(out[0].numpy(), jb[sl])
            np.testing.assert_array_equal(out[1].numpy(), jv[sl])
            assert int(count) == int(jv[sl].sum())
            for got, want in zip(out[2:], jcols):
                assert got.numpy().dtype == want.dtype
                np.testing.assert_array_equal(got.numpy(), want[sl])

    def test_pack_refuses_a_slot_past_cap(self):
        ids = torch.zeros(10, dtype=torch.int32)
        valid = torch.ones(10, dtype=torch.bool)
        with pytest.raises(ValueError, match="overflow"):
            X.pack(ids, valid, 2, 4, [ids])

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        ids = torch.zeros(4, dtype=torch.int32)
        valid = torch.ones(4, dtype=torch.bool)
        with pytest.raises(ValueError, match="CUDA"):
            X.pack_kernel(ids, valid, 2, 4, [ids])
        with pytest.raises(ValueError, match="CUDA"):
            X.order_kernel(ids, valid, 8, [ids])

    def test_inputs_are_checked(self):
        ids = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="int32"):
            X.pack(ids.long(), torch.ones(4, dtype=torch.bool), 2, 4, [])
        with pytest.raises(ValueError, match="bool"):
            X.order(ids, torch.ones(4, dtype=torch.int32), 8, [])
        with pytest.raises(ValueError, match="column 0"):
            X.order(ids, torch.ones(4, dtype=torch.bool), 8, [torch.zeros(3)])


# ---------------------------------------------------------------------------
# Session level: whole builds, parquet bytes
# ---------------------------------------------------------------------------


@pytest.fixture
def mixed_parquet(tmp_path):
    rng = np.random.default_rng(17)
    d = tmp_path / "mixed"
    d.mkdir()
    for i in range(4):
        n = 2500
        vals = rng.normal(size=n)
        t = pa.table(
            {
                "k": pa.array(rng.integers(0, 40, n), type=pa.int64()),
                "s": pa.array([["aa", "bb", "cc"][v] for v in rng.integers(0, 3, n)]),
                "v": pa.array(
                    [None if j % 13 == 0 else vals[j] for j in range(n)], type=pa.float64()
                ),
            }
        )
        pq.write_table(t, d / f"part-{i}.parquet")
    return str(d)


def _wave_budget(src, factor):
    from hyperspace_tpu_torch.indexes.covering_build import per_file_materialized_bytes

    first = os.path.join(src, sorted(os.listdir(src))[0])
    return int(per_file_materialized_bytes([first], "parquet")[0] * factor)


class TestBuildDifferential:
    def test_in_memory_builds_bit_identical(self, tmp_path, mixed_parquet):
        ref = build(session("jax", tmp_path, 8), mixed_parquet, "exflat", strategy="flat")
        port = session("port", tmp_path, 8)
        for strat in ("auto", "flat", "host", "compact", "twostage"):
            files = build(port, mixed_parquet, f"ex{strat}", strategy=strat, hosts=2)
            assert_identical_files(files, ref, strat)
            expect = "host" if strat == "auto" else strat
            assert port.build_telemetry["shuffle_strategy"] == expect

    def test_streaming_waves_bit_identical(self, tmp_path, mixed_parquet):
        budget = _wave_budget(mixed_parquet, 1.5)  # several waves
        ref = build(session("jax", tmp_path, 8), mixed_parquet, "stflat", strategy="flat",
                    budget=budget)
        port = session("port", tmp_path, 8)
        for strat in ("flat", "host", "compact", "twostage"):
            files = build(port, mixed_parquet, f"st{strat}", strategy=strat, budget=budget,
                          hosts=2)
            assert_identical_files(files, ref, strat)
            t = port.build_telemetry
            assert t["shuffle_waves"] > 1
            assert "shuffle_skew_ratio_max" in t and "shuffle_skew_ratio_mean" in t

    def test_stage_seconds_and_strategy_in_telemetry(self, tmp_path, mixed_parquet):
        port = session("port", tmp_path, 8)
        build(port, mixed_parquet, "tele", strategy="auto")
        t = port.build_telemetry
        assert t["shuffle_strategy"] == "host"
        for key in ("shuffle_pack_s", "shuffle_exchange_s", "shuffle_unpack_s"):
            assert key in t, t
        assert t["shuffle_devices"] == 8.0
        assert port.build_stats["tail_shards"] > 1


class TestSkewWarnRateLimit:
    def test_streaming_build_warns_once(self, tmp_path, caplog):
        """A skewed streamed build exchanges once a wave; the skew warning
        fires once a build while the telemetry records every wave."""
        d = tmp_path / "skew"
        d.mkdir()
        n = 40000
        t = pa.table(
            {
                "k": pa.array(np.full(n, 7), type=pa.int64()),
                "s": pa.array(["x"] * n),
                "v": pa.array(np.ones(n)),
            }
        )
        for i in range(4):
            pq.write_table(t, d / f"p{i}.parquet")
        budget = _wave_budget(str(d), 1.5)
        port = session("port", tmp_path, 8)
        with caplog.at_level(logging.WARNING, "hyperspace_tpu_torch.shuffle"):
            build(port, str(d), "skew1x", strategy="auto", budget=budget)
        warns = [r for r in caplog.records if "shuffle skew" in r.message]
        assert len(warns) == 1, warns
        tele = port.build_telemetry
        assert tele["shuffle_waves"] > 1
        assert tele["shuffle_skew_ratio_max"] >= TC.BUILD_SHUFFLE_SKEW_WARN_RATIO
        assert tele["shuffle_skew_ratio_mean"] > 1.0
        caplog.clear()  # a second build warns again (a fresh latch a data op)
        with caplog.at_level(logging.WARNING, "hyperspace_tpu_torch.shuffle"):
            build(port, str(d), "skew2x", strategy="auto", budget=budget)
        assert len([r for r in caplog.records if "shuffle skew" in r.message]) == 1
