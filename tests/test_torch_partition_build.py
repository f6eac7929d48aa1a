"""The port's pipelined partition-first build writer against the JAX package.

``tests/test_partition_build.py``'s in-memory, lineage and incremental
refresh cases as differentials: the JAX package builds with
``hyperspace.index.build.partitionFirst`` on (its default), the port with
it on and off, over the same heavily tied source, and every bucket file
must be the same rows in the same order and the same parquet bytes (sha
equal); the port's ``session.build_stats`` carries the reference's stage
keys on both routes. The card's per-bucket runs (``ops/sort.
bucket_sort_runs``) must equal ``sort_permutation`` over heavy ties,
single and empty buckets. A crash at ``mid_data_write`` inside the writer
thread leaves the same data files in both packages: in raise mode every
bucket but the crashed one (the buckets queued behind it still land), in
exit mode, in a child interpreter of each package, those before it.

The reference's streaming-spill case runs in
``tests/test_torch_streaming_build.py`` with the other budgeted builds;
its native-leg case has no counterpart (the port has no native host
kernels).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import hashlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu.testing import faults as jfaults
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.ops import sort as S
from hyperspace_tpu_torch.testing import faults as tfaults

PF = "hyperspace.index.build.partitionFirst"
N_BUCKETS = 8
STAGES = {"scan", "hash_shuffle", "sort", "write"}


@pytest.fixture
def tied_parquet(tmp_path):
    """``tests/test_partition_build.py::tied_parquet``: 4 files whose keys
    collide heavily (3 distinct values), a string column and a float
    payload."""
    rng = np.random.default_rng(21)
    d = tmp_path / "tied"
    d.mkdir()
    for i in range(4):
        n = 3000
        t = pa.table(
            {
                "k": pa.array(rng.integers(0, 3, n), type=pa.int64()),
                "s": pa.array([["aa", "bb", "cc"][v] for v in rng.integers(0, 3, n)]),
                "v": pa.array(rng.normal(size=n)),
            }
        )
        pq.write_table(t, d / f"part-{i}.parquet")
    return str(d)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _port(root):
    s = T.HyperspaceSession(device="cpu")
    s.conf.set("hyperspace.system.path", str(root / "port"))
    s.conf.set("hyperspace.index.num_buckets", N_BUCKETS)
    return s, T.Hyperspace(s)


def _jax(root):
    s = JSession()
    s.conf.set(JC.INDEX_SYSTEM_PATH, str(root / "jax"))
    s.conf.set(JC.INDEX_NUM_BUCKETS, N_BUCKETS)
    s.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
    return s, JHyperspace(s)


def _build(s, hs, cfg, src, name, partition_first, lineage=False):
    s.conf.set(PF, partition_first)
    s.conf.set("hyperspace.index.lineage.enabled", lineage)
    hs.create_index(s.read.parquet(src), cfg(name, ["k"], ["s", "v"]))
    return sorted(s.index_manager.get_index_log_entry(name).content.files)


def _assert_identical_files(files_a, files_b):
    assert [os.path.basename(f) for f in files_a] == [os.path.basename(f) for f in files_b]
    for fa, fb in zip(files_a, files_b):
        assert pq.read_table(fa).equals(pq.read_table(fb)), (fa, fb)
        assert _sha(fa) == _sha(fb), (fa, fb)


@pytest.mark.parametrize("lineage", [False, True], ids=["in_memory", "lineage"])
def test_build_files_equal_the_reference_with_the_key_on_and_off(tmp_path, tied_parquet, lineage):
    t, ths = _port(tmp_path)
    j, jhs = _jax(tmp_path)
    want = _build(j, jhs, JConfig, tied_parquet, "ref", True, lineage)
    stages = {}
    for pf in (True, False):
        got = _build(t, ths, TConfig, tied_parquet, f"pf{int(pf)}", pf, lineage)
        stages[pf] = set(t.build_stats)
        _assert_identical_files(want, got)
    # the reference's stage keys on both routes (the captures are inside)
    assert STAGES <= stages[True] and STAGES <= stages[False]
    if lineage:
        t_all = pa.concat_tables([pq.read_table(f) for f in got])
        assert len(set(t_all.column(TC.DATA_FILE_NAME_ID).to_pylist())) == 4


def test_refresh_incremental_files_equal_the_reference(tmp_path, tied_parquet):
    """The refresh data plane (an append) rides the same writer: the
    refreshed version's files equal the reference's with the key on, and
    the port's legacy route's."""
    t, ths = _port(tmp_path)
    j, jhs = _jax(tmp_path)

    def run(s, hs, cfg, name, pf):
        _build(s, hs, cfg, tied_parquet, name, pf, lineage=True)
        rng = np.random.default_rng(5)
        extra = pa.table(
            {
                "k": pa.array(rng.integers(0, 3, 500), type=pa.int64()),
                "s": pa.array(["dd"] * 500),
                "v": pa.array(rng.normal(size=500)),
            }
        )
        extra_path = os.path.join(tied_parquet, "extra.parquet")
        pq.write_table(extra, extra_path)
        s.index_manager.clear_cache()
        hs.refresh_index(name, "incremental")
        os.remove(extra_path)  # the source as it was, for the next leg
        s.index_manager.clear_cache()
        return sorted(s.index_manager.get_index_log_entry(name).content.files)

    want = run(j, jhs, JConfig, "r", True)
    on = run(t, ths, TConfig, "r", True)
    off = run(t, ths, TConfig, "r_off", False)
    _assert_identical_files(want, on)
    # the legacy index has another name: compare its files position by position
    assert [os.path.basename(f) for f in on] == [os.path.basename(f) for f in off]
    for a, b in zip(on, off):
        assert _sha(a) == _sha(b)


@pytest.mark.parametrize("at", [1, 5, 8])
def test_a_crash_in_the_writer_thread_leaves_the_reference_files(tmp_path, at):
    """``mid_data_write`` in raise mode fires inside the writer thread; the
    buckets queued behind the crashed file are still written before the
    crash surfaces, in both packages alike."""
    rng = np.random.default_rng(at)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        pq.write_table(
            pa.table({
                "k": pa.array(rng.integers(0, 10_000, 2000), type=pa.int64()),
                "s": pa.array(rng.choice(["aa", "bb"], 2000)),
                "v": pa.array(rng.normal(size=2000)),
            }),
            src / f"part-{i}.parquet",
        )
    tied_parquet = str(src)
    t, ths = _port(tmp_path)
    j, jhs = _jax(tmp_path)
    spec = f"raise;at={at}"
    left = {}
    for pkg, s, hs, cfg, faults, sys_dir in (
        ("port", t, ths, TConfig, tfaults, tmp_path / "port"),
        ("jax", j, jhs, JConfig, jfaults, tmp_path / "jax"),
    ):
        faults.set_crash("mid_data_write", spec)
        try:
            with pytest.raises(faults.SimulatedCrash):
                hs.create_index(s.read.parquet(tied_parquet), cfg("c", ["k"], ["s", "v"]))
        finally:
            faults.reset()
        data = sys_dir / "c" / "v__=1"
        left[pkg] = {n: _sha(data / n) for n in sorted(os.listdir(data)) if n.endswith(".parquet")}
    assert left["port"] == left["jax"]
    assert len(left["port"]) == N_BUCKETS - 1


EXIT_CHILD = """
import sys
sys.path.insert(0, {repo!r})
{setup}
from {pkg}.hyperspace import Hyperspace
from {pkg}.indexes.covering import CoveringIndexConfig
from {pkg}.testing import faults

s.conf.set("hyperspace.system.path", {root!r})
s.conf.set("hyperspace.index.num_buckets", {buckets})
hs = Hyperspace(s)
faults.set_crash("mid_data_write", "exit;at=3")
hs.create_index(s.read.parquet({src!r}), CoveringIndexConfig("c", ["k"], ["s", "v"]))
raise SystemExit(7)  # never reached: the crash point exits first
"""

SETUP = {
    "hyperspace_tpu_torch": "import torch\ntorch.set_num_threads(1)\n"
    "from hyperspace_tpu_torch.session import HyperspaceSession\n"
    "s = HyperspaceSession(device='cpu')",
    "hyperspace_tpu": "from hyperspace_tpu.session import HyperspaceSession\n"
    "s = HyperspaceSession()\ns.conf.set('hyperspace.build.numShards', 1)",
}


def test_an_exit_in_the_writer_thread_leaves_the_reference_files(tmp_path):
    """``mid_data_write`` in exit mode kills the process from the writer
    thread at its third file: in a child interpreter of each package the
    two files before it are all that land, the same bytes."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(3)
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(
        pa.table({
            "k": pa.array(rng.integers(0, 10_000, 4000), type=pa.int64()),
            "s": pa.array(rng.choice(["aa", "bb"], 4000)),
            "v": pa.array(rng.normal(size=4000)),
        }),
        src / "part-0.parquet",
    )
    left = {}
    for pkg_name, setup in SETUP.items():
        root = tmp_path / pkg_name
        code = EXIT_CHILD.format(repo=repo, setup=setup, pkg=pkg_name, root=str(root),
                                 buckets=N_BUCKETS, src=str(src))
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=300, cwd=str(tmp_path),
                              env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == tfaults.CRASH_EXIT_CODE, (pkg_name, proc.stderr[-2000:])
        data = root / "c" / "v__=1"
        left[pkg_name] = {n: _sha(data / n) for n in sorted(os.listdir(data))
                          if n.endswith(".parquet")}
    assert left["hyperspace_tpu_torch"] == left["hyperspace_tpu"]
    assert len(left["hyperspace_tpu_torch"]) == 2


def _check_runs(reps_np, buckets_np, nb):
    reps = torch.from_numpy(reps_np)
    buckets = torch.from_numpy(buckets_np)
    perm, offsets = S.bucket_sort_runs(reps, buckets, nb)
    want = S.sort_permutation(reps, buckets).numpy()
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(np.diff(offsets), np.bincount(buckets_np, minlength=nb))
    assert offsets[0] == 0 and offsets[-1] == len(buckets_np)
    for b in range(nb):
        assert np.all(buckets_np[perm[offsets[b] : offsets[b + 1]]] == b)


@pytest.mark.parametrize("n,nb,k", [(0, 8, 1), (1, 1, 1), (7, 3, 2), (50_000, 8, 1), (20_001, 200, 3)])
def test_bucket_runs_match_the_global_sort(n, nb, k):
    rng = np.random.default_rng(n + nb + k)
    _check_runs(
        rng.integers(-(2**60), 2**60, size=(k, n), dtype=np.int64),
        rng.integers(0, nb, n).astype(np.int32),
        nb,
    )


def test_bucket_runs_heavy_ties():
    rng = np.random.default_rng(9)
    n = 80_000
    _check_runs(
        rng.integers(0, 2, size=(2, n), dtype=np.int64),
        rng.integers(0, 4, n).astype(np.int32),
        4,
    )


def test_bucket_runs_single_and_empty_buckets():
    rng = np.random.default_rng(11)
    n = 10_000
    _check_runs(
        rng.integers(-5, 5, size=(1, n), dtype=np.int64),
        np.full(n, 6, dtype=np.int32),
        16,
    )


def test_the_key_defaults_on_as_in_the_reference():
    assert TC.INDEX_BUILD_PARTITION_FIRST == JC.INDEX_BUILD_PARTITION_FIRST
    assert TC.INDEX_BUILD_PARTITION_FIRST_DEFAULT is JC.INDEX_BUILD_PARTITION_FIRST_DEFAULT is True
    assert T.HyperspaceSession(device="cpu").conf.build_partition_first
