"""The two-process create held byte for byte to the JAX package's
(ROADMAP C.19).

One dataset, from the generator both dryrun scripts share (seed 11, 4,000
rows, 4 files), goes through two jobs of two processes each:

* the JAX package's workers, ``scripts/dryrun_multihost.py --worker I
  PORT`` with ``HS_DRYRUN_ROOT`` set (2 processes x 4 CPU devices, a
  rendezvous on a free TCP port), which leave their index under the root;
* the port's workers, ``scripts/torch_dryrun_multihost.py --device cpu
  --local-shards 4 --worker I ROOT`` (2 processes x 4 shards, gloo over a
  ``file://`` rendezvous), on a copy of the same files.

Both jobs run in turn at the same absolute root (the first job's tree is
moved aside before the second starts; the copies keep the files' mtimes),
so the source paths and signatures in the log entries are the same. Every
bucket file of ``mh_create`` is then compared byte for byte, and the log
entries apart from their ids and timestamps. Neither script is changed by
the comparison; each job runs under its own timeout, in a directory of
this module's own.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import importlib.util
import os
import shutil
import socket
import subprocess
import sys

import pyarrow.parquet as pq
import pytest
from torch_index_files import index_files, normalized_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SCRIPT = os.path.join(REPO, "scripts", "dryrun_multihost.py")
PORT_SCRIPT = os.path.join(REPO, "scripts", "torch_dryrun_multihost.py")
JOB_TIMEOUT_S = 240


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _job(cmds, env) -> list:
    """Start every worker, wait for each within the job's timeout, kill
    what is left; return each worker's (returncode, output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for c in cmds]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=JOB_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\nworker timed out after {JOB_TIMEOUT_S}s\n"
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _copy_data(dataset, root):
    os.makedirs(root)
    shutil.copytree(os.path.join(dataset, "data"), os.path.join(root, "data"))  # keeps mtimes


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mh_parity"))
    ref_mod = _load(REF_SCRIPT, "dryrun_multihost_ref")
    port_mod = _load(PORT_SCRIPT, "torch_dryrun_multihost_port")
    dataset, twin = os.path.join(base, "dataset"), os.path.join(base, "dataset_port")
    ref_mod._write_create_dataset(dataset)
    os.makedirs(twin)
    port_mod._write_dataset(twin)
    run = os.path.join(base, "run")

    _copy_data(dataset, run)
    port = str(_free_port())
    ref = _job([[sys.executable, REF_SCRIPT, "--worker", str(i), port] for i in range(2)],
               dict(os.environ, HS_DRYRUN_ROOT=run))
    os.rename(run, os.path.join(base, "jax"))

    _copy_data(dataset, run)
    mine = _job([[sys.executable, PORT_SCRIPT, "--device", "cpu", "--local-shards", "4",
                  "--worker", str(i), run] for i in range(2)], dict(os.environ))
    os.rename(run, os.path.join(base, "port"))
    return {"base": base, "run": run, "jax": ref, "port": mine,
            "datasets": (dataset, twin)}


def _index(jobs, side):
    return os.path.join(jobs["base"], side, "indexes", "mh_create")


def test_both_scripts_generate_the_same_dataset(jobs):
    a, b = (os.path.join(d, "data") for d in jobs["datasets"])
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == [f"part-{i}.parquet" for i in range(4)]
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as x, open(os.path.join(b, name), "rb") as y:
            assert x.read() == y.read(), name


def test_both_jobs_pass(jobs):
    for side in ("jax", "port"):
        for rc, out in jobs[side]:
            assert rc == 0 and "DRYRUN-OK" in out, (side, out[-3000:])
    assert all("devices=8" in out for _rc, out in jobs["jax"])
    assert all("shards=8" in out for _rc, out in jobs["port"])


def test_bucket_files_are_byte_equal_to_the_reference(jobs):
    mine, ref = index_files(_index(jobs, "port")), index_files(_index(jobs, "jax"))
    data = [p for p in ref if p.endswith(".parquet") and not os.path.basename(p).startswith("_")]
    assert len(data) == 16, sorted(ref)
    assert sorted(mine) == sorted(ref)
    for rel in sorted(ref):
        assert mine[rel] == ref[rel], f"{rel} differs from the JAX package's file"
    assert sum(pq.read_metadata(os.path.join(_index(jobs, "jax"), p)).num_rows for p in data) == 4000


def test_log_entries_equal_the_reference(jobs):
    sys_path = os.path.join(jobs["run"], "indexes")
    mine = normalized_log(_index(jobs, "port"), sys_path)
    ref = normalized_log(_index(jobs, "jax"), sys_path)
    assert sorted(mine) == sorted(ref) == ["1", "2", "latestStable"]
    assert mine == ref
