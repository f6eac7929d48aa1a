"""Two-process dryrun of hyperspace_tpu_torch's multi-process plane.

    python3 scripts/torch_dryrun_multihost.py [--device cuda|cpu] [--local-shards N]
        [--timeout SECONDS]

Runs on the card (``--device cuda``, the default) unless asked for the CPU,
and refuses to start when the card is asked for and CUDA is not available.
Starts 2 worker processes joined by ``parallel/mesh.initialize_distributed``
(gloo over a ``file://`` rendezvous in a temporary directory; both ranks
may share one card, which NCCL would refuse), each with a mesh of
``--local-shards`` local shards (2 by default) on ``--device``, so the job
has 4 shards by default. Each worker runs:

  * the flat ``all_to_all_single`` and an ``all_reduce`` across the process
    boundary, on the device's tensors;
  * the process-local two-stage bucket exchange (each rank feeds its half
    of one global dataset) against ``parallel/shuffle.canonical_order``
    restricted to the buckets its shards own;
  * a 2-process CREATE: each rank scans its stripe of the 4 source files,
    the exchange routes rows to their owner rank, each writes its own
    buckets; rank 0 alone writes the log entry pair (ids 1 and 2) and the
    latestStable pointer; both list the same files with the same row
    counts (the content hash both print);
  * an abort: a CREATE whose validate fails on rank 1 alone raises
    ``ConcurrentWriteException`` on both ranks and writes no log entry.

The parent then builds the same index in one process over the source files
in process-major order (rank 0's stripe, then rank 1's: the 2-process
build's global row order) and holds every bucket file's rows, in order, to
the 2-process build's. It prints ``DRYRUN-OK`` once a worker and exits 0
when both workers passed, their content hashes agree and the one-process
build matches.

With ``HS_COLLECTIVE_WITNESS=<prefix>`` set, each worker wraps the port's
``COLLECTIVE_SITES`` (``testing/collective_witness.py``) before the
bootstrap and writes its ordered collective sequence to
``<prefix>.p<rank>.json`` (``tests/test_torch_witnesses.py`` holds the two
sequences to each other). The witness-coverage matrix below is the contract
that ``python -m hyperspace_tpu_torch.analysis`` (HS703) holds the registry
to: every registered site is exercised here across processes, proven
coordinator-only, or asserted to be a one-process exchange that a job of
processes never routes through.

Run as one worker (the parent does): ``--worker RANK ROOT``. A worker
expects the dataset under ``ROOT/data`` and leaves the index under
``ROOT/indexes``; ``tests/test_torch_multihost_parity.py`` runs the workers
alone at ``--local-shards 4`` and holds that index to the JAX package's.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOCAL_SHARDS = 2
N_GLOBAL_CREATE = 4000
CREATE_FILES = 4
NUM_BUCKETS = 16

#: sites every process of the job must witness
WITNESS_MULTIHOST_SITES = (
    "hyperspace_tpu_torch.parallel.mesh.initialize_distributed",
    "hyperspace_tpu_torch.parallel.shuffle._twostage_exchange",
    "hyperspace_tpu_torch.parallel.shuffle._twostage_exchange_mp",
    "hyperspace_tpu_torch.parallel.shuffle._all_to_all_bytes",
    "hyperspace_tpu_torch.indexes.covering_build._global_written",
    "hyperspace_tpu_torch.actions.base._action_rendezvous",
)
#: coordinator-gated sites: witnessed on rank 0, never elsewhere
WITNESS_COORDINATOR_SITES = (
    "hyperspace_tpu_torch.actions.base._publish_log",
    "hyperspace_tpu_torch.actions.base._publish_latest_stable",
)
#: one-process exchanges a job of processes must never route through
#: (resolve_strategy takes twostage there)
WITNESS_SINGLE_HOST_SITES = (
    "hyperspace_tpu_torch.parallel.shuffle._flat_exchange",
    "hyperspace_tpu_torch.parallel.shuffle._compact_exchange",
)


def _session(device: str, root: str, system_dir: str, shards: int):
    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch import constants as C

    session = HyperspaceSession(device=device, devices=[device] * shards)
    session.conf.set(C.INDEX_SYSTEM_PATH, os.path.join(root, system_dir))
    session.conf.set(C.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    return session


def _check_collectives(pid: int, dev) -> str:
    """The flat all_to_all_single and an all_reduce across the process
    boundary."""
    import torch
    import torch.distributed as dist

    from hyperspace_tpu_torch.parallel.shuffle import _all_to_all_bytes

    block = 4
    x = torch.arange(WORLD * block, dtype=torch.int64, device=dev) + 100 * pid
    out = torch.empty_like(x)
    sizes = [block * 8] * WORLD
    _all_to_all_bytes(out.view(torch.uint8), x.view(torch.uint8), sizes, sizes)
    want = torch.cat([
        torch.arange(pid * block, (pid + 1) * block, dtype=torch.int64) + 100 * j
        for j in range(WORLD)
    ])
    assert torch.equal(out.cpu(), want), (out, want)
    total = x.sum().reshape(1)
    try:
        dist.all_reduce(total)
        route = "device"
    except RuntimeError:  # gloo without CUDA all_reduce: stage through the host
        host = total.cpu()
        dist.all_reduce(host)
        total.copy_(host)
        route = "host-staged"
    expect = sum(int((torch.arange(WORLD * block) + 100 * j).sum()) for j in range(WORLD))
    assert int(total.item()) == expect, (int(total.item()), expect)
    return f"all_reduce={int(total.item())} ({route})"


def _check_exchange(pid: int, dev, local_shards: int) -> str:
    """The process-local two-stage exchange against the canonical order."""
    import numpy as np
    import torch

    from hyperspace_tpu_torch.ops.hash import bucket_ids
    from hyperspace_tpu_torch.parallel import mesh as hs_mesh
    from hyperspace_tpu_torch.parallel import shuffle as hs_shuffle

    mesh = hs_mesh.default_mesh([dev] * local_shards)
    D, L = mesh.size, mesh.local_size
    assert D == WORLD * local_shards, mesh
    rng = np.random.default_rng(7)
    n_global = 4000
    keys_g = rng.integers(0, 500, (1, n_global)).astype(np.int64)
    pay_g = rng.integers(0, 10**9, n_global).astype(np.int64)
    half = n_global // WORLD
    lo, hi = pid * half, (pid + 1) * half
    got_b, got_cols, got_offs = hs_shuffle.bucket_shuffle(
        mesh, keys_g[:, lo:hi], [keys_g[0, lo:hi], pay_g[lo:hi]], NUM_BUCKETS,
        with_shard_offsets=True,
    )
    stats = hs_shuffle.last_shuffle_stats
    assert stats["strategy"] == "twostage" and stats.get("process_local") == 1.0, stats
    ids = bucket_ids(torch.from_numpy(keys_g), NUM_BUCKETS).numpy()
    order = np.lexsort((np.arange(n_global), ids, ids % D))
    exp_rows = order[(ids[order] % D) // L == pid]
    np.testing.assert_array_equal(got_b, ids[exp_rows])
    np.testing.assert_array_equal(got_cols[0], keys_g[0, exp_rows])
    np.testing.assert_array_equal(got_cols[1], pay_g[exp_rows])
    per_shard = np.zeros(D, dtype=np.int64)
    counts = np.bincount(ids % D, minlength=D)
    per_shard[pid * L : (pid + 1) * L] = counts[pid * L : (pid + 1) * L]
    np.testing.assert_array_equal(got_offs, np.concatenate([[0], np.cumsum(per_shard)]))
    return f"exchange_rows={len(got_b)}/{n_global}"


def _create_end_to_end(root: str, device: str, local_shards: int) -> tuple:
    """The 2-process CREATE and its single-writer metadata plane; returns
    (content hash, rows)."""
    import pyarrow.parquet as pq
    import torch.distributed as dist

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.constants import States
    from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager

    session = _session(device, root, "indexes", local_shards)
    hs = Hyperspace(session)
    df = session.read.parquet(os.path.join(root, "data"))
    hs.create_index(df, CoveringIndexConfig("mh_create", ["k"], ["v"]))
    # a worker returns from op() before the coordinator commits
    dist.barrier()
    index_root = os.path.join(root, "indexes", "mh_create")
    log_dir = os.path.join(index_root, C.HYPERSPACE_LOG_DIR)
    ids = sorted(int(n) for n in os.listdir(log_dir) if n.isdigit())
    assert ids == [1, 2], f"expected one begin/commit pair, got ids {ids}"
    log_mgr = IndexLogManager(index_root)
    assert log_mgr.get_log(1).state == States.CREATING
    final = log_mgr.get_log(2)
    assert final.state == States.ACTIVE, final.state
    assert log_mgr.get_latest_stable_pointer_id() == 2
    strays = [n for n in os.listdir(index_root) if n.startswith("_spill_")]
    assert not strays, strays
    data_dirs = [os.path.join(index_root, n) for n in os.listdir(index_root) if n.startswith("v__=")]
    assert len(data_dirs) == 1, data_dirs
    on_disk = sorted(
        n for n in os.listdir(data_dirs[0]) if n.endswith(".parquet") and not n.startswith(("_", "."))
    )
    assert sorted(os.path.basename(f) for f in final.content.files) == on_disk
    rows = 0
    digest = hashlib.md5()
    for name in on_disk:
        meta = pq.read_metadata(os.path.join(data_dirs[0], name))
        rows += meta.num_rows
        digest.update(f"{name}:{meta.num_rows}\n".encode())
    assert rows == N_GLOBAL_CREATE, rows
    return digest.hexdigest()[:12], rows


def _abort_one_sided(root: str, device: str, pid: int, local_shards: int) -> str:
    """A CREATE whose validate fails on rank 1 alone: both ranks raise
    ConcurrentWriteException and no log entry is written."""
    import torch.distributed as dist

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.actions.create import CreateAction
    from hyperspace_tpu_torch.exceptions import ConcurrentWriteException

    session = _session(device, root, "indexes", local_shards)
    hs = Hyperspace(session)
    df = session.read.parquet(os.path.join(root, "data"))
    validate = CreateAction.validate

    def one_sided(self):
        validate(self)
        if pid == 1:  # this rank alone sees a concurrent writer
            raise ConcurrentWriteException("injected on rank 1: a concurrent writer")

    CreateAction.validate = one_sided
    try:
        hs.create_index(df, CoveringIndexConfig("mh_abort", ["k"], ["v"]))
        raise AssertionError("the one-sided validate failure did not abort")
    except ConcurrentWriteException as e:
        message = str(e)
    finally:
        CreateAction.validate = validate
    dist.barrier()
    if pid == 0:
        assert "aborted at step 'validate'" in message, message
    log_dir = os.path.join(root, "indexes", "mh_abort", C.HYPERSPACE_LOG_DIR)
    left = os.listdir(log_dir) if os.path.isdir(log_dir) else []
    assert not [n for n in left if n.isdigit()], left
    return "abort=ConcurrentWriteException"


def worker(pid: int, root: str, device: str, local_shards: int = LOCAL_SHARDS) -> None:
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from hyperspace_tpu_torch.parallel import mesh as hs_mesh

    witness_prefix = os.environ.get("HS_COLLECTIVE_WITNESS")
    if witness_prefix:
        # installed before the bootstrap, so initialize_distributed is
        # recorded too
        from hyperspace_tpu_torch.testing import collective_witness

        collective_witness.install()
    hs_mesh.initialize_distributed(
        "file://" + os.path.join(root, "rendezvous"), WORLD, pid, "gloo", timeout_s=60.0
    )
    try:
        dev = torch.device(device)
        assert hs_mesh.process_count() == WORLD
        collectives = _check_collectives(pid, dev)
        exchange = _check_exchange(pid, dev, local_shards)
        content, rows = _create_end_to_end(root, device, local_shards)
        abort = _abort_one_sided(root, device, pid, local_shards)
        print(
            f"DRYRUN-OK proc={pid} procs={hs_mesh.process_count()} device={device} "
            f"backend={hs_mesh.backend()} shards={WORLD * local_shards} {collectives} "
            f"{exchange} create_content={content} create_rows={rows} {abort}",
            flush=True,
        )
        if witness_prefix:
            doc = collective_witness.dump(witness_prefix)
            witnessed = {r["site"] for r in doc["sequence"]}
            missing = [s for s in WITNESS_MULTIHOST_SITES if s not in witnessed]
            assert not missing, f"unwitnessed multi-process sites: {missing}"
            for site in WITNESS_COORDINATOR_SITES:
                assert (site in witnessed) == (pid == 0), (site, pid, site in witnessed)
            routed = [s for s in WITNESS_SINGLE_HOST_SITES if s in witnessed]
            assert not routed, f"a job of processes routed through one-process exchanges: {routed}"
            print(f"witness proc={pid} records={len(doc['sequence'])}", flush=True)
    finally:
        hs_mesh.shutdown_distributed()


def _write_dataset(root: str) -> list:
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir)
    rng = np.random.default_rng(11)
    per = N_GLOBAL_CREATE // CREATE_FILES
    paths = []
    for i in range(CREATE_FILES):
        path = os.path.join(data_dir, f"part-{i}.parquet")
        pq.write_table(
            pa.table({
                "k": pa.array(rng.integers(0, 300, per), type=pa.int64()),
                "v": pa.array(rng.integers(0, 10**9, per), type=pa.int64()),
            }),
            path,
        )
        paths.append(path)
    return paths


def _one_process_build(root: str, device: str, paths: list) -> int:
    """The same index built in this (unjoined) process over the files in
    process-major order; every bucket file's rows held to the 2-process
    build's in order. Returns the number of bucket files compared."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace

    ordered = os.path.join(root, "data_process_major")
    os.makedirs(ordered)
    stripes = [p for r in range(WORLD) for p in paths[r::WORLD]]
    for i, p in enumerate(stripes):
        shutil.copy(p, os.path.join(ordered, f"p{i}.parquet"))
    session = _session(device, root, "one_process", 1)
    Hyperspace(session).create_index(
        session.read.parquet(ordered), CoveringIndexConfig("mh_create", ["k"], ["v"])
    )

    def files(system_dir):
        d = os.path.join(root, system_dir, "mh_create", "v__=1")
        return {n: os.path.join(d, n) for n in os.listdir(d) if n.endswith(".parquet") and not n.startswith("_")}

    two, one = files("indexes"), files("one_process")
    assert sorted(two) == sorted(one), (sorted(two), sorted(one))
    for name in sorted(one):
        a, b = pq.ParquetFile(two[name]).read(), pq.ParquetFile(one[name]).read()
        assert a.equals(b), f"{name}: rows differ from the one-process build"
    return len(one)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--local-shards", type=int, default=LOCAL_SHARDS)
    parser.add_argument("--timeout", type=float, default=240.0)
    parser.add_argument("--worker", nargs=2, metavar=("RANK", "ROOT"))
    return parser.parse_args(argv)


def check_device(device: str) -> None:
    """Raise when the card is asked for and CUDA is not available: the
    dryrun never falls back to the CPU."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but CUDA is not available; "
                           "pass --device cpu to run on the CPU")


def main() -> int:
    args = parse_args()
    check_device(args.device)
    if args.worker:
        worker(int(args.worker[0]), args.worker[1], args.device, args.local_shards)
        return 0
    sys.path.insert(0, REPO)
    root = tempfile.mkdtemp(prefix="hs_torch_dryrun_")
    procs = []
    try:
        paths = _write_dataset(root)
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--device", args.device,
                 "--local-shards", str(args.local_shards), "--worker", str(i), root],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in range(WORLD)
        ]
        ok, contents = 0, []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\nworker timed out after {args.timeout}s\n"
            if p.returncode == 0 and "DRYRUN-OK" in out:
                ok += 1
            contents += re.findall(r"create_content=(\w+)", out)
            sys.stdout.write(out)
        if ok != WORLD:
            print(f"torch multihost dryrun: {ok}/{WORLD} workers ok")
            return 1
        if len(contents) != WORLD or len(set(contents)) != 1:
            print(f"torch multihost dryrun: content hashes diverge: {contents}")
            return 1
        compared = _one_process_build(root, args.device, paths)
        print(
            f"torch multihost dryrun: {ok}/{WORLD} workers ok, content {contents[0]}, "
            f"{compared} bucket files equal in rows and order to a one-process build "
            f"over the files in process-major order"
        )
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
