"""Helpers of the crash-recovery differentials
(``tests/test_torch_crash_recovery.py``, ``tests/test_torch_crash_matrix.py``).

:class:`Pkg` holds one package's modules, so a scenario runs over either;
:func:`both` runs it over each and holds the observations equal.
:func:`crash_cell` drives one cell of the reference's crash matrix
(``tests/test_crash_recovery.py``) through both packages in lockstep
(``tests/torch_lifecycle_twin.py``) with both fault registries armed.

Both packages run with their default build route, the pipelined
partition-first writer (``hyperspace.index.build.partitionFirst`` on): a
``mid_data_write`` crash fires in its writer thread, and the buckets
queued behind the crashed file still land before the crash surfaces, in
both alike. ``crash_twin(..., partition_first=False)`` turns the key off in
both packages, to hold the legacy route too.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_lifecycle_twin import Twin, append_file

import hyperspace_tpu_torch as T
from hyperspace_tpu.testing import faults as jfaults
from hyperspace_tpu_torch.testing import faults as tfaults

LEASE_MS = 40
GRACE_KEEP_MS = 10 * 60_000  # the quarantine stays for the comparison


def reset_faults():
    for f in (tfaults, jfaults):
        f.reset()


def wait_lease():
    time.sleep(LEASE_MS * 2.5 / 1000.0)


def faults_of(pkg):
    return tfaults if pkg == "port" else jfaults


# ---------------------------------------------------------------------------
# One package's namespace, so a scenario runs over either
# ---------------------------------------------------------------------------


class Pkg:
    def __init__(self, name):
        import importlib

        self.name = name
        root = "hyperspace_tpu_torch" if name == "port" else "hyperspace_tpu"

        def m(mod):
            return importlib.import_module(f"{root}.{mod}")

        self.C = m("constants")
        self.States = self.C.States
        self.recovery = m("metadata.recovery")
        self.faults = m("testing.faults")
        self.exc = m("exceptions")
        self.Hyperspace = m("hyperspace").Hyperspace
        self.CoveringIndexConfig = m("indexes.covering").CoveringIndexConfig
        self.Content = m("metadata.entry").Content
        self.IndexLogManager = m("metadata.log_manager").IndexLogManager
        self.actions = {a: m(f"actions.{a}") for a in ("create", "refresh", "delete", "cancel")}
        self.Config = m("config").Config
        self._session_cls = m("session").HyperspaceSession

    def session(self, sys_path, lease_ms=LEASE_MS, grace_ms=0):
        s = self._session_cls(device="cpu") if self.name == "port" else self._session_cls()
        s.conf.set(self.C.INDEX_SYSTEM_PATH, sys_path)
        s.conf.set(self.C.INDEX_NUM_BUCKETS, 8)
        s.conf.set(self.C.RECOVERY_LEASE_MS, lease_ms)
        s.conf.set(self.C.RECOVERY_ORPHAN_GRACE_MS, grace_ms)
        s.conf.set(self.C.INDEX_LINEAGE_ENABLED, True)
        if self.name == "jax":
            s.conf.set(self.C.BUILD_NUM_SHARDS, 1)
        return s


PKGS = {}


def pkg(name):
    if name not in PKGS:
        PKGS[name] = Pkg(name)
    return PKGS[name]


def both(scenario, tmp_path, *args):
    """Run ``scenario(P, root, *args)`` over each package, each in a
    directory of its own under a copy of the source; the observations must
    be equal."""
    obs = {}
    for name in ("port", "jax"):
        root = tmp_path / name
        root.mkdir()
        obs[name] = scenario(pkg(name), root, *args)
    assert obs["port"] == obs["jax"], obs
    return obs["port"]


def sample_source(root):
    """``tests/conftest.py::sample_parquet``'s dataset under ``root``."""
    rng = np.random.default_rng(0)
    d = root / "sample"
    d.mkdir()
    for i in range(3):
        n = 100
        pq.write_table(
            pa.table(
                {
                    "date": pa.array([f"2017-09-{(j % 28) + 1:02d}" for j in range(n)]),
                    "rguid": pa.array([f"guid-{i}-{j}" for j in range(n)]),
                    "clicks": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
                    "query": pa.array(
                        [["ibraco", "facebook", "donde", "banana"][j % 4] for j in range(n)]
                    ),
                    "imprs": pa.array(rng.integers(0, 100, n), type=pa.int64()),
                }
            ),
            str(d / f"part-{i}.parquet"),
        )
    return str(d)


def sorted_table(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


def serve_matches_source(s, src):
    df = s.read.parquet(src)
    q = df.filter(df["clicks"] >= 500).select("clicks", "query")
    s.index_manager.clear_cache()
    s.disable_hyperspace()
    base = q.collect()
    s.enable_hyperspace()
    got = q.collect()
    s.disable_hyperspace()
    assert sorted_table(got).equals(sorted_table(base))
    return got.num_rows


def mk_index(P, root):
    src = sample_source(root)
    s = P.session(str(root / "sys"))
    hs = P.Hyperspace(s)
    hs.create_index(s.read.parquet(src), P.CoveringIndexConfig("idx", ["clicks"], ["query"]))
    log_mgr, _ = s.index_manager._managers("idx")
    return s, hs, src, log_mgr


def data_files(index_path, relative=True):
    """Data files under the index's version dirs (log and quarantine
    excluded), relative to the index dir."""
    from hyperspace_tpu_torch.utils import files as file_utils
    from hyperspace_tpu_torch.utils.paths import is_data_path

    out = set()
    if not os.path.isdir(index_path):
        return out
    for name in os.listdir(index_path):
        if name.startswith("_"):
            continue
        root = os.path.join(index_path, name)
        if os.path.isdir(root):
            for p, _s, _m in file_utils.list_leaf_files(root):
                if is_data_path(p):
                    out.add(os.path.relpath(p, index_path) if relative else p)
    return out


def quarantine(index_path):
    """Relative paths of every file under the quarantine, without the stamp."""
    q = os.path.join(index_path, "_hyperspace_quarantine")
    out = set()
    if not os.path.isdir(q):
        return out
    for stamp in os.listdir(q):
        base = os.path.join(q, stamp)
        for dirpath, _dirs, names in os.walk(base):
            out.update(os.path.relpath(os.path.join(dirpath, n), base) for n in names)
    return out


# ---------------------------------------------------------------------------
# The crash matrix, through both packages
# ---------------------------------------------------------------------------

# action -> (crash points it passes, state after a rollback, state after an
# after_end_log crash and the pointer's healing): tests/test_crash_recovery.py
MATRIX = {
    "create": (["after_begin_log", "mid_data_write", "after_data_write", "after_end_log"],
               "DOESNOTEXIST", "ACTIVE"),
    "refresh_full": (["after_begin_log", "mid_data_write", "after_data_write", "after_end_log"],
                     "ACTIVE", "ACTIVE"),
    "refresh_incremental": (
        ["after_begin_log", "mid_data_write", "after_data_write", "after_end_log"],
        "ACTIVE", "ACTIVE"),
    "refresh_quick": (["after_begin_log", "after_data_write", "after_end_log"], "ACTIVE", "ACTIVE"),
    "optimize": (["after_begin_log", "mid_data_write", "after_data_write", "after_end_log"],
                 "ACTIVE", "ACTIVE"),
    "delete": (["after_begin_log", "after_data_write", "after_end_log"], "ACTIVE", "DELETED"),
    "restore": (["after_begin_log", "after_data_write", "after_end_log"], "DELETED", "ACTIVE"),
    "vacuum_deleted": (["after_begin_log", "mid_vacuum_delete", "after_data_write",
                        "after_end_log"], "DELETED", "DOESNOTEXIST"),
    "vacuum_outdated": (["after_begin_log", "mid_vacuum_delete", "after_data_write",
                         "after_end_log"], "ACTIVE", "ACTIVE"),
}
CELLS = [(a, p) for a, (points, _r, _f) in MATRIX.items() for p in points]

TRIGGERS = {
    "refresh_full": ("refresh_index", "full"),
    "refresh_incremental": ("refresh_index", "incremental"),
    "refresh_quick": ("refresh_index", "quick"),
    "optimize": ("optimize_index", "full"),
    "delete": ("delete_index",),
    "restore": ("restore_index",),
    "vacuum_deleted": ("vacuum_index",),
    "vacuum_outdated": ("vacuum_index",),
}

KINDS = {
    "covering": ("covering", ["clicks"], ["query"]),
    "zorder": ("zorder", ["clicks", "imprs"], ["query"]),
    "ds": ("ds", ("MinMaxSketch", "clicks"), ("BloomFilterSketch", "imprs", 0.01, 20)),
}


def crash_twin(tmp_path, src, partition_first=True):
    twin = Twin(tmp_path / "sys", src, lineage=True)
    twin.set("hyperspace.recovery.leaseMs", LEASE_MS)
    twin.set("hyperspace.recovery.orphanGraceMs", GRACE_KEEP_MS)
    twin.set("hyperspace.index.build.partitionFirst", partition_first)
    return twin


def setup_action(twin, action, kind="covering"):
    cfg = KINDS[kind]
    if action != "create":
        twin.create(cfg[0], "idx", *cfg[1:])
    if action.startswith("refresh"):
        append_file(twin.src)
    elif action == "optimize":
        append_file(twin.src, "e1")
        twin.run("refresh_index", "idx", "incremental")
        append_file(twin.src, "e2", clicks=(9101, 9102))
        twin.run("refresh_index", "idx", "incremental")
    elif action == "vacuum_outdated":
        append_file(twin.src)
        twin.run("refresh_index", "idx", "full")
    elif action in ("restore", "vacuum_deleted"):
        twin.run("delete_index", "idx")


def trigger(twin, pkg_name, action, kind="covering"):
    _p, s, hs = dict((p, (p, s, h)) for p, s, h in twin.sides())[pkg_name]
    if action == "create":
        from torch_lifecycle_twin import config

        cfg = KINDS[kind]
        hs.create_index(s.read.parquet(twin.src), config(pkg_name, cfg[0], "idx", *cfg[1:]))
    else:
        op, *args = TRIGGERS[action]
        getattr(hs, op)("idx", *args)


def _q(d):
    return d.filter(d["clicks"] >= 500).select("clicks", "query")


def crash_cell(tmp_path, src, action, point, kind="covering"):
    """One cell through both packages: crash, recover, compare, retry,
    compare."""
    twin = crash_twin(tmp_path, src)
    setup_action(twin, action, kind)
    _points, rolled_state, committed_state = MATRIX[action]
    committed = point == "after_end_log"
    paths = {p: os.path.join(twin.tsys if p == "port" else twin.jsys, "idx")
             for p in ("port", "jax")}
    before = {p: data_files(paths[p]) for p in paths}
    assert before["port"] == before["jax"]
    for p, _s, _hs in twin.sides():
        faults_of(p).set_crash(point, "raise")
    reports = {}
    for p, s, hs in twin.sides():
        f = faults_of(p)
        with pytest.raises(f.SimulatedCrash):
            trigger(twin, p, action, kind)
        assert f.stats() == {"crash." + point: 1}, (p, f.stats())
        tip = s.index_manager._managers("idx")[0].get_latest_log()
        assert (tip.state in ("ACTIVE", "DELETED", "DOESNOTEXIST")) == committed, tip.state
    # the crashed entries compare (the lease too) before the recovery
    assert twin.log_entries("idx", "port") == twin.log_entries("idx", "jax")
    wait_lease()
    for p, s, hs in twin.sides():
        reports[p] = hs.recover("idx")
    assert reports["port"] == reports["jax"], reports
    rep = reports["port"]
    tip_state = twin.latest_state("idx")
    if committed:
        assert rep["healed_pointer"] and not rep["rolled_back"]
        assert tip_state == committed_state
    else:
        assert rep["rolled_back"] and not rep["healed_pointer"]
        assert tip_state == rolled_state
    after = {p: data_files(paths[p]) for p in paths}
    assert after["port"] == after["jax"]
    if not committed:
        if action.startswith("vacuum"):
            assert after["port"] <= before["port"]
        else:
            assert after["port"] == before["port"]
    assert quarantine(paths["port"]) == quarantine(paths["jax"])
    assert twin.log_entries("idx", "port") == twin.log_entries("idx", "jax")
    twin.query(_q)
    # purge the quarantine; no orphan is left and a second GC moves nothing
    for p, side in (("port", pkg("port")), ("jax", pkg("jax"))):
        side.recovery.gc_orphans(paths[p], grace_ms=0)
        assert side.recovery.find_orphans(paths[p]) == []
        gc2 = side.recovery.gc_orphans(paths[p], grace_ms=0)
        assert gc2["quarantined_files"] == 0 and gc2["quarantined_dirs"] == 0
    # the retried action completes (one that had committed is refused as
    # an illegal state, or is a no-op), alike in both packages
    outcome = {}
    for p, _s, _hs in twin.sides():
        try:
            trigger(twin, p, action, kind)
            outcome[p] = "ran"
        except (T.HyperspaceException, pkg("jax").exc.HyperspaceException) as e:
            assert committed, e
            outcome[p] = type(e).__name__
    assert outcome["port"] == outcome["jax"]
    assert twin.latest_state("idx") in ("ACTIVE", "DELETED", "DOESNOTEXIST")
    twin.assert_equal("idx")
    twin.query(_q)
    return rep
