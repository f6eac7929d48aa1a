"""The port's multi-process plane on the CPU: ``scripts/torch_dryrun_multihost.py``.

The script joins 2 real processes through ``parallel/mesh.
initialize_distributed`` (gloo, a ``file://`` rendezvous, 2 shards each):
the flat all-to-all and an all-reduce across the process boundary, the
process-local two-stage exchange against the canonical order, a
2-process CREATE whose log entry pair rank 0 alone writes and whose files
both ranks list alike (held to a one-process build over the source files
in process-major order, rows in order), and a CREATE whose validate fails
on rank 1 alone, which raises ``ConcurrentWriteException`` on both ranks
and writes nothing. The script runs once a module, within its own
timeout; the cases below read its output. NCCL asked for with more ranks
than GPUs raises. The script runs on the card unless asked for the CPU
(``--device cuda`` by default), and without a card it refuses to start.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_dryrun_multihost.py")


@pytest.fixture(scope="module")
def dryrun():
    out = subprocess.run(
        [sys.executable, SCRIPT, "--device", "cpu", "--timeout", "150"],
        capture_output=True, text=True, timeout=200, cwd=REPO,
    )
    return out.returncode, out.stdout + out.stderr


def test_two_process_dryrun_passes(dryrun):
    rc, out = dryrun
    assert rc == 0, out
    assert out.count("DRYRUN-OK") == 2, out
    assert "backend=gloo" in out and "shards=4" in out, out


def test_create_content_is_the_same_on_both_ranks(dryrun):
    _rc, out = dryrun
    hashes = re.findall(r"create_content=(\w+)", out)
    assert len(hashes) == 2 and len(set(hashes)) == 1, out
    assert out.count("create_rows=4000") == 2, out
    # one begin/commit pair, written by rank 0 alone (each worker asserts
    # the log ids and states), and the one-process build's rows in order
    assert "16 bucket files equal in rows and order to a one-process build" in out, out


def test_one_sided_validate_failure_aborts_both_ranks(dryrun):
    _rc, out = dryrun
    assert out.count("abort=ConcurrentWriteException") == 2, out


def test_exchange_covers_every_row(dryrun):
    _rc, out = dryrun
    rows = [int(a) for a, _ in re.findall(r"exchange_rows=(\d+)/(\d+)", out)]
    assert len(rows) == 2 and sum(rows) == 4000, out


def test_nccl_with_more_ranks_than_gpus_raises(tmp_path):
    """NCCL is never swapped for gloo: two ranks on a host without two
    GPUs raise before any process group exists."""
    import torch.distributed as dist

    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.parallel import mesh

    with pytest.raises(HyperspaceException, match="one GPU a rank"):
        mesh.initialize_distributed(f"file://{tmp_path}/rdzv", 2, 0, "nccl", timeout_s=5)
    assert not (dist.is_available() and dist.is_initialized())
    with pytest.raises(HyperspaceException, match="backend"):
        mesh.initialize_distributed(f"file://{tmp_path}/rdzv", 2, 0, "mpi", timeout_s=5)
    assert mesh.process_count() == 1 and mesh.process_index() == 0


def test_collective_sites_name_the_port():
    """Every registered site is a module-level callable of the port, with
    a known contract."""
    import importlib

    from hyperspace_tpu_torch.parallel.collectives import COLLECTIVE_SITES, CONTRACTS

    for site, (_op, contract, _why) in COLLECTIVE_SITES.items():
        assert contract in CONTRACTS, site
        mod, name = site.rsplit(".", 1)
        assert mod.startswith("hyperspace_tpu_torch.")
        assert callable(getattr(importlib.import_module(mod), name)), site


def _dryrun_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_dryrun_multihost", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_defaults_to_the_card_and_refuses_without_it(monkeypatch):
    """The dryrun's arguments default to ``--device cuda`` and 2 local
    shards; asked for the card where CUDA is not available, it raises
    instead of running on the CPU. Only the arguments are parsed: no job
    starts."""
    import torch

    mod = _dryrun_module()
    args = mod.parse_args([])
    assert (args.device, args.local_shards, args.worker) == ("cuda", 2, None)
    assert mod.parse_args(["--device", "cpu", "--local-shards", "4"]).local_shards == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.check_device(args.device)
    mod.check_device("cpu")  # asked for the CPU: no error
