"""Cross-mesh layout compatibility of the port, and across packages, on
the CPU.

``tests/test_mesh_sizes.py``'s cases on the port: an index built on 8
shards serves from 1 and the reverse, a filter and a co-bucketed join
(the bucket of a key's value, one file a bucket, whatever mesh built
it). Then across packages: the JAX package at 8 shards builds and the port
at 4 serves, and the port at 4 builds and the JAX package at 8 serves,
with the rows the unindexed plan gives; the 4-shard port build's bucket
files equal the 8-shard JAX build's byte for byte. And the
``hyperspace.build.numShards`` cap of the build mesh.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_mesh_twin import (
    NUM_SHARDS,
    assert_identical_files,
    build,
    hyperspace,
    session,
    sorted_table,
)


@pytest.fixture
def dataset(tmp_path):
    rng = np.random.default_rng(21)
    d = tmp_path / "xm"
    d.mkdir()
    for i in range(4):
        t = pa.table(
            {
                "k": pa.array(rng.integers(0, 100, 500), type=pa.int64()),
                "p": pa.array(rng.integers(0, 100, 500), type=pa.int64()),
            }
        )
        pq.write_table(t, d / f"f{i}.parquet")
    return str(d)


@pytest.fixture
def dim(tmp_path):
    rng = np.random.default_rng(5)
    d = tmp_path / "dim"
    d.mkdir()
    t = pa.table(
        {"j": pa.array(np.arange(100), type=pa.int64()), "w": pa.array(rng.normal(size=100))}
    )
    pq.write_table(t, d / "dim.parquet")
    return str(d)


def _filter(d):
    return d.filter(d["k"] == 42).select("k", "p")


def _join(a, b):
    return a.join(b, on=a["k"] == b["j"]).select("k", "p", "w")


def _serve_filter(server, dataset, name):
    dfs = server.read.parquet(dataset)
    server.disable_hyperspace()
    base = _filter(dfs).collect()
    server.enable_hyperspace()
    assert f"Hyperspace(Type: CI, Name: {name}" in hyperspace(server).explain(_filter(dfs))
    got = _filter(dfs).collect()
    assert sorted_table(got).equals(sorted_table(base))
    assert got.num_rows > 0
    return got


def _serve_join(server, dataset, dim):
    f, d = server.read.parquet(dataset), server.read.parquet(dim)
    server.disable_hyperspace()
    base = _join(f, d).collect()
    server.enable_hyperspace()
    assert hyperspace(server).explain(_join(f, d)).count("Hyperspace(Type: CI") == 2
    got = _join(f, d).collect()
    assert sorted_table(got).equals(sorted_table(base))
    assert got.num_rows > 0
    return got


@pytest.mark.parametrize("build_devs,serve_devs", [(8, 1), (1, 8)], ids=["b8s1", "b1s8"])
def test_build_serve_cross_mesh(tmp_path, dataset, build_devs, serve_devs):
    build_sess = session("port", tmp_path, build_devs)
    build(build_sess, dataset, "xidx", included=("p",))
    server = session("port", tmp_path, serve_devs)
    assert server.runtime.num_shards == serve_devs
    _serve_filter(server, dataset, "xidx")


@pytest.mark.parametrize("build_devs,serve_devs", [(8, 1), (1, 8)], ids=["b8s1", "b1s8"])
def test_join_cross_mesh(tmp_path, dataset, dim, build_devs, serve_devs):
    build_sess = session("port", tmp_path, build_devs)
    build(build_sess, dataset, "fidx", included=("p",))
    build(build_sess, dim, "didx", indexed=("j",), included=("w",))
    _serve_join(session("port", tmp_path, serve_devs), dataset, dim)


@pytest.mark.parametrize("build_pkg,server_pkg", [("jax", "port"), ("port", "jax")],
                         ids=["jax8_builds_port4_serves", "port4_builds_jax8_serves"])
def test_across_packages(tmp_path, dataset, dim, build_pkg, server_pkg):
    """The JAX package at 8 shards and the port at 4 share one system
    path: an index either builds the other serves, filter and join, and
    the two builds' bucket files are the same bytes."""
    shards = {"jax": 8, "port": 4}
    build_sess = session(build_pkg, tmp_path, shards[build_pkg])
    build_sess.conf.set("hyperspace.system.path", str(tmp_path / "shared"))
    files = build(build_sess, dataset, "fidx", included=("p",))
    build(build_sess, dim, "didx", indexed=("j",), included=("w",))
    server = session(server_pkg, tmp_path, shards[server_pkg])
    server.conf.set("hyperspace.system.path", str(tmp_path / "shared"))
    _serve_filter(server, dataset, "fidx")
    rows = _serve_join(server, dataset, dim)
    other = session(server_pkg, tmp_path, shards[server_pkg])
    assert_identical_files(build(other, dataset, "fidx", included=("p",)), files)
    # the server's own build serves the same join rows in order
    build(other, dim, "didx", indexed=("j",), included=("w",))
    f, d = other.read.parquet(dataset), other.read.parquet(dim)
    other.enable_hyperspace()
    assert _join(f, d).collect().equals(rows)


def test_build_num_shards_caps_build_mesh(tmp_path):
    """``hyperspace.build.numShards`` caps the build mesh to the first N
    shards (0 = the whole session mesh), memoized per context."""
    from hyperspace_tpu_torch.indexes.context import IndexerContext
    from hyperspace_tpu_torch.metadata.entry import FileIdTracker

    s = session("port", tmp_path, 8)
    assert IndexerContext(s, FileIdTracker(), "unused").mesh.size == 8
    s.conf.set(NUM_SHARDS, 2)
    capped = IndexerContext(s, FileIdTracker(), "unused")
    assert capped.mesh.size == 2
    assert capped.mesh is capped.mesh
    s.conf.set(NUM_SHARDS, 0)
    assert IndexerContext(s, FileIdTracker(), "unused").mesh.size == 8
    s.conf.set(NUM_SHARDS, 64)
    assert IndexerContext(s, FileIdTracker(), "unused").mesh.size == 8


def test_capped_build_writes_the_reference_files(tmp_path, dataset):
    """A build capped to 3 of 8 shards writes the JAX package's files at
    its own cap of 3."""
    j = session("jax", tmp_path, 8)
    j.conf.set(NUM_SHARDS, 3)
    port = session("port", tmp_path, 8)
    port.conf.set(NUM_SHARDS, 3)
    assert_identical_files(
        build(port, dataset, "cap", included=("p",)), build(j, dataset, "cap", included=("p",))
    )
    assert port.build_telemetry["shuffle_devices"] == 3.0


def test_session_devices():
    """``devices`` is the mesh and ``device`` its first shard; a device
    that is not the first shard is refused."""
    import torch

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.exceptions import HyperspaceException

    s = HyperspaceSession(devices=["cpu"] * 3)
    assert s.device == torch.device("cpu") and s.runtime.num_shards == 3
    assert HyperspaceSession(device="cpu").runtime.num_shards == 1
    assert HyperspaceSession(device="cpu").runtime.is_coordinator
    with pytest.raises(HyperspaceException):
        HyperspaceSession(devices=[])
