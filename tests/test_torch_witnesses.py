"""The port's registries and runtime witnesses, on the CPU.

* Every path in ``OBS_SITES`` (``obs/sites.py``), ``SHARED_STATE``
  (``concurrency.py``, locks included) and ``ALLOC_SITES``
  (``memory.py``) names a real object of the port: a module, a function,
  a method, a module global, or an attribute an instance sets in its
  constructor. Their vocabularies (site kinds, policies, bound classes)
  are the reference's.
* The lock, residency and collective witnesses install, record and
  uninstall, leaving the patched attributes as they were.
* The collective witness runs in ``scripts/torch_dryrun_multihost.py``'s
  two workers; their recorded sequences agree as
  ``tests/test_multihost.py`` requires of the reference's: the same
  sites in the same order with the same waves, equal signatures at every
  ``symmetric-all`` site, and the ``coordinator-gated`` sites on rank 0
  alone.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu import concurrency as JCc
from hyperspace_tpu import memory as JMem
from hyperspace_tpu.obs import sites as JSites
from hyperspace_tpu_torch import concurrency as TCc
from hyperspace_tpu_torch import memory as TMem
from hyperspace_tpu_torch.execution.serve_cache import ServeCache
from hyperspace_tpu_torch.obs import sites as TSites
from hyperspace_tpu_torch.testing import artifacts, collective_witness, lock_witness, residency_witness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: how to build an instance of each class whose instance state is declared
INSTANCES = {
    "ServeCache": lambda: ServeCache(1 << 20),
    "HyperspaceSession": lambda: T.HyperspaceSession(device="cpu"),
}


def _resolve(path: str):
    """The object ``path`` names, importing its module; an attribute an
    instance sets in its constructor resolves on a built instance."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        rest = parts[i:]
        for j, name in enumerate(rest):
            if not hasattr(obj, name) and isinstance(obj, type) and j == len(rest) - 1:
                obj = getattr(INSTANCES[obj.__name__](), name)
            else:
                obj = getattr(obj, name)
        return obj
    raise ImportError(path)


class TestRegistries:
    def test_every_obs_site_resolves(self):
        assert TSites.KINDS == JSites.KINDS
        assert set(JSites.STAGE_NAMES) <= set(TSites.STAGE_NAMES)
        for path, (kind, why) in TSites.OBS_SITES.items():
            assert path.startswith("hyperspace_tpu_torch.")
            assert kind in TSites.KINDS and why
            obj = _resolve(path)
            if kind == "span":
                assert callable(obj), path
            else:
                assert callable(obj) or isinstance(obj, types.ModuleType), path

    def test_every_shared_state_entry_resolves(self):
        policies = {p for _l, p, _w in JCc.SHARED_STATE.values()}
        for path, (lock, policy, why) in TCc.SHARED_STATE.items():
            assert path.startswith("hyperspace_tpu_torch.") and why
            assert policy in policies, (path, policy)
            _resolve(path)
            if lock.startswith("self."):
                mod, _, _attr = path.rpartition(".")
                cls = _resolve(mod)
                inst = INSTANCES[cls.__name__]()
                assert hasattr(getattr(inst, lock[5:]), "acquire"), path
            elif lock:
                assert hasattr(_resolve(lock), "acquire"), (path, lock)
        # the port's own locks and the serve cache's state are declared
        for want in ("hyperspace_tpu_torch.session.HyperspaceSession.build_stats",
                     "hyperspace_tpu_torch.execution.serve_cache.ServeCache._entries",
                     "hyperspace_tpu_torch.obs.trace._finished"):
            assert want in TCc.SHARED_STATE
        assert TCc.SHARED_STATE["hyperspace_tpu_torch.session.HyperspaceSession.build_stats"][0] == (
            "hyperspace_tpu_torch.indexes.covering_build._stats_lock")

    def test_every_alloc_site_resolves(self):
        assert TMem.PLANES == JMem.PLANES
        assert TMem.BOUND_CLASSES == JMem.BOUND_CLASSES
        assert TMem.BOUND_CLASS_CEILINGS == JMem.BOUND_CLASS_CEILINGS
        for path, (plane, bound, why) in TMem.ALLOC_SITES.items():
            assert plane in TMem.PLANES and bound in TMem.BOUND_CLASSES and why
            assert callable(_resolve(path)), path

    def test_no_module_of_the_port_imports_the_reference_or_jax(self):
        pkg = os.path.join(REPO, "hyperspace_tpu_torch")
        for name in ("obs/sites.py", "obs/metrics.py", "obs/trace.py", "obs/querylog.py",
                     "obs/planspec.py", "obs/__init__.py", "telemetry.py", "concurrency.py",
                     "memory.py", "sql.py", "testing/artifacts.py", "testing/lock_witness.py",
                     "testing/residency_witness.py", "testing/replay.py",
                     "testing/collective_witness.py"):
            src = open(os.path.join(pkg, name)).read()
            for line in src.splitlines():
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    assert "jax" not in s.split("#")[0].replace("hyperspace_tpu_torch", ""), (name, s)


class TestLockWitness:
    def test_install_record_dump_uninstall(self, tmp_path):
        from hyperspace_tpu_torch.indexes import covering_build

        orig = covering_build._stats_lock
        lock_witness.reset()
        wrapped = lock_witness.install()
        try:
            assert wrapped["hyperspace_tpu_torch.session.HyperspaceSession.build_stats"] == (
                "indexes/covering_build.py::_stats_lock")
            assert covering_build._stats_lock is not orig
            cache = ServeCache(1 << 20)
            cache.put(("scan", 1), np.arange(10), 80)
            assert cache.get(("scan", 1)) is not None
            with covering_build._stats_lock:
                with cache._lock:
                    pass
            doc = lock_witness.snapshot()
            assert doc["package"] == "hyperspace_tpu_torch"
            assert doc["locks"]["execution/serve_cache.py::ServeCache._lock"] >= 3
            assert ["indexes/covering_build.py::_stats_lock",
                    "execution/serve_cache.py::ServeCache._lock", 1] in doc["edges"]
            path = str(tmp_path / "lw.json")
            lock_witness.dump(path)
            again = lock_witness.dump(path)
            assert again["locks"]["indexes/covering_build.py::_stats_lock"] == (
                2 * doc["locks"]["indexes/covering_build.py::_stats_lock"])
        finally:
            lock_witness.uninstall()
            lock_witness.reset()
        assert covering_build._stats_lock is orig


class TestResidencyWitness:
    def test_install_record_dump_uninstall(self, tmp_path):
        from hyperspace_tpu_torch.execution import serve_cache
        from hyperspace_tpu_torch.io import parquet as pio

        f = str(tmp_path / "a.parquet")
        pq.write_table(pa.table({"k": np.arange(1000, dtype=np.int64)}), f)
        orig = pio.read_table
        residency_witness.reset()
        wrapped = residency_witness.install()
        try:
            assert wrapped["hyperspace_tpu_torch.io.parquet.read_table"] is True
            assert pio.read_table is not orig
            t = pio.read_table([f], ["k"], "parquet")
            doc = residency_witness.snapshot()
            rec = doc["sites"]["hyperspace_tpu_torch.io.parquet.read_table"]
            assert rec["calls"] == 1
            assert rec["peak_bytes"] == serve_cache.estimate_nbytes(t) > 0
            assert doc["budgets"] == TMem.BOUND_CLASS_CEILINGS
            assert doc["rss_high_water"] > 0
            residency_witness.dump(str(tmp_path / "rw.json"))
            merged = residency_witness.dump(str(tmp_path / "rw.json"))
            assert merged["sites"]["hyperspace_tpu_torch.io.parquet.read_table"]["calls"] == 2
        finally:
            residency_witness.uninstall()
            residency_witness.reset()
        assert pio.read_table is orig

    def test_a_tensor_weighs_numel_times_element_size(self):
        x = torch.zeros(1000, dtype=torch.int32)
        assert residency_witness.value_nbytes(x) == 4000
        assert residency_witness.value_nbytes(x[::2]) == 2000


class TestCollectiveWitness:
    def test_install_record_uninstall_in_process(self):
        from hyperspace_tpu_torch.parallel import mesh

        orig = mesh.initialize_distributed
        collective_witness.reset()
        wrapped = collective_witness.install()
        try:
            assert set(wrapped) == set(
                importlib.import_module("hyperspace_tpu_torch.parallel.collectives").COLLECTIVE_SITES)
            assert mesh.initialize_distributed is not orig
            doc = collective_witness.snapshot()
            assert (doc["process"], doc["process_count"], doc["sequence"]) == (0, 1, [])
            assert collective_witness._sig_one(torch.zeros(3, 2, dtype=torch.int64)) == "torch.int64[2d]"
        finally:
            collective_witness.uninstall()
            collective_witness.reset()
        assert mesh.initialize_distributed is orig

    def test_two_process_sequences_agree(self, tmp_path):
        prefix = str(tmp_path / "cw")
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "torch_dryrun_multihost.py"),
             "--device", "cpu", "--timeout", "150"],
            capture_output=True, text=True, timeout=200, cwd=REPO,
            env=dict(os.environ, HS_COLLECTIVE_WITNESS=prefix),
        )
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.count("DRYRUN-OK") == 2, out.stdout
        docs = []
        for p in (0, 1):
            with open(collective_witness.artifact_path(prefix, p)) as fh:
                docs.append(json.load(fh))
        assert [(d["process"], d["process_count"]) for d in docs] == [(0, 2), (1, 2)]
        registered = docs[0]["registered"]
        seqs = [d["sequence"] for d in docs]
        for seq in seqs:
            assert {r["site"] for r in seq} <= set(registered)
        gated = [[r for r in seq if r["contract"] == "coordinator-gated"] for seq in seqs]
        assert gated[0] and not gated[1]
        assert "hyperspace_tpu_torch.actions.base._publish_log" in {r["site"] for r in gated[0]}
        shared = [[r for r in seq if r["contract"] != "coordinator-gated"] for seq in seqs]
        key = lambda r: (r["site"], r["op"], r["contract"], r["wave"])  # noqa: E731
        assert [key(r) for r in shared[0]] == [key(r) for r in shared[1]]
        for a, b in zip(*shared):
            if a["contract"] == "symmetric-all":
                assert a["sig"] == b["sig"], (a, b)
        sites = {r["site"].rpartition(".")[2] for r in shared[0]}
        assert {"initialize_distributed", "_twostage_exchange_mp", "_action_rendezvous",
                "_global_written"} <= sites


def test_artifacts_helpers(tmp_path):
    path = str(tmp_path / "a.json")
    artifacts.atomic_write_json(path, {"x": 1})
    assert artifacts.load_json(path) == {"x": 1}
    assert artifacts.load_json(str(tmp_path / "none.json")) is None
    assert artifacts.merge_count_maps({"a": 1}, {"a": 2, "b": 1}) == {"a": 3, "b": 1}
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    assert inspect.getsource(artifacts).count("import jax") == 0
