"""Both packages driven in lockstep over one source directory, for the
lifecycle differentials (``tests/test_torch_lifecycle*.py``).

A :class:`Twin` holds a port session (``device="cpu"``) and a JAX-package
session, each with its own system path under one root, over the same
source files: an append or a delete is made once and both packages see
the same files, sizes and mtimes. Every lifecycle call goes to both, and
the checks hold the port to the JAX package:

* log entries, every numbered one and ``latestStable``, equal apart from
  the entry's id and timestamp, the index files' mtimes and the system
  path. Crash recovery is on by default in both packages, so their begin
  entries carry the two writer-lease properties: each side's are checked
  well formed (:func:`check_lease`) and then compared by presence, since
  the owner is random and the expiry a time;
* index files equal byte for byte, ``_zonemaps.json`` and
  ``_aggstate.json`` apart from their files' ``mtime_ns``;
* query rows equal in order, and the explain text equal apart from the
  system path.
"""

import os

import pyarrow as pa
import pyarrow.parquet as pq
from torch_index_files import LEASE_PROPS, index_files, normalized_entry, read_log

import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu import constants as JC
from hyperspace_tpu.exceptions import HyperspaceException as JHyperspaceException
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.session import HyperspaceSession as JSession

TRANSIENT_STATES = frozenset(States.ROLLBACK)

#: how far a begin entry's lease expiry may lie past its timestamp plus the
#: lease: the time from the entry's making to its stamp, and the heartbeat's
#: renewals while the action ran
LEASE_SLACK_MS = 30_000


def check_lease(entry: dict, lease_ms: int) -> bool:
    """True when ``entry`` (a parsed log entry) carries the writer lease,
    after asserting it well formed: an owner of 32 hex digits and an expiry,
    an int string, within ``LEASE_SLACK_MS`` past ``timestamp + lease_ms``.
    (``normalized_entry`` then compares the lease by its presence.)"""
    props = entry.get("properties", {})
    present = [p in props for p in LEASE_PROPS]
    assert all(present) or not any(present), props
    if not any(present):
        return False
    owner, expires = props[LEASE_PROPS[0]], props[LEASE_PROPS[1]]
    assert len(owner) == 32 and int(owner, 16) >= 0, owner
    assert isinstance(expires, str) and str(int(expires)) == expires, expires
    late = int(expires) - (int(entry["timestamp"]) + lease_ms)
    assert 0 <= late <= LEASE_SLACK_MS, (expires, entry["timestamp"], lease_ms)
    return True


def append_file(src, name="extra", clicks=(9001, 9002, 9003)):
    """``tests/test_lifecycle.py::append_file``."""
    t = pa.table(
        {
            "date": ["2018-02-02"] * len(clicks),
            "rguid": [f"g{i}" for i in range(len(clicks))],
            "clicks": pa.array(list(clicks), pa.int64()),
            "query": ["appended"] * len(clicks),
            "imprs": pa.array(list(range(len(clicks))), pa.int64()),
        }
    )
    pq.write_table(t, os.path.join(src, f"part-{name}.parquet"))


class Twin:
    def __init__(self, root, src, num_buckets: int = 8, lineage: bool = False):
        self.root, self.src = str(root), str(src)
        self.tsys = os.path.join(self.root, "port")
        self.jsys = os.path.join(self.root, "jax")
        self.t = T.HyperspaceSession(device="cpu")
        self.t.conf.set("hyperspace.system.path", self.tsys)
        self.t.conf.set("hyperspace.index.num_buckets", num_buckets)
        self.j = JSession()
        self.j.conf.set(JC.INDEX_SYSTEM_PATH, self.jsys)
        self.j.conf.set(JC.INDEX_NUM_BUCKETS, num_buckets)
        self.j.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
        self.set("hyperspace.index.lineage.enabled", lineage)
        self.ths, self.jhs = T.Hyperspace(self.t), JHyperspace(self.j)

    # -- driving ------------------------------------------------------------
    def set(self, key, value) -> None:
        self.t.conf.set(key, value)
        self.j.conf.set(key, value)

    def sides(self):
        return (("port", self.t, self.ths), ("jax", self.j, self.jhs))

    def create(self, kind: str, name: str, *args) -> None:
        """``kind`` is covering, zorder or ds; ``args`` the config's, with
        a data-skipping index's sketches given as (class name, *args)."""
        for pkg, s, hs in self.sides():
            hs.create_index(s.read.parquet(self.src), config(pkg, kind, name, *args))

    def run(self, op: str, *args) -> None:
        """``hs.<op>(*args)`` in each package."""
        for _pkg, _s, hs in self.sides():
            getattr(hs, op)(*args)

    def run_raises(self, match: str, op: str, *args) -> None:
        """``hs.<op>(*args)`` raises each package's HyperspaceException,
        with ``match`` in both messages."""
        import pytest

        for pkg, _s, hs in self.sides():
            exc = T.HyperspaceException if pkg == "port" else JHyperspaceException
            with pytest.raises(exc, match=match):
                getattr(hs, op)(*args)

    def clear_cache(self) -> None:
        for _pkg, s, _hs in self.sides():
            s.index_manager.clear_cache()

    def enable(self, on: bool = True) -> None:
        for _pkg, s, _hs in self.sides():
            (s.enable_hyperspace if on else s.disable_hyperspace)()

    # -- checks -------------------------------------------------------------
    def query(self, q, same_plan: bool = True):
        """``q(df)`` over a fresh read of the source, Hyperspace on, in each
        package: rows equal in order (and as a multiset to the plan without
        Hyperspace), explain text equal apart from the system path. Where
        the packages' plans differ by design (``same_plan`` False) the rows
        are held equal as a multiset and the explains are not compared.
        Returns ``(port rows, port explain)``."""
        out = {}
        for pkg, s, hs in self.sides():
            s.index_manager.clear_cache()
            plan = q(s.read.parquet(self.src))
            s.enable_hyperspace()
            got = plan.collect()
            text = hs.explain(plan).replace(self.tsys if pkg == "port" else self.jsys, "<sys>")
            s.disable_hyperspace()
            want = plan.collect()
            s.enable_hyperspace()
            assert sorted_table(got).equals(sorted_table(want)), pkg
            out[pkg] = (got, text)
        if same_plan:
            assert out["port"][0].equals(out["jax"][0])
            assert out["port"][1] == out["jax"][1]
        else:
            assert sorted_table(out["port"][0]).equals(sorted_table(out["jax"][0]))
        return out["port"]

    def assert_equal(self, name: str) -> None:
        """Log entries and index files of ``name`` equal across packages."""
        assert self.log_entries(name, "port") == self.log_entries(name, "jax")
        assert self.index_files(name, "port") == self.index_files(name, "jax")

    def log_entries(self, name: str, pkg: str) -> dict:
        """Normalized log entries of ``name``; with recovery on a transient
        entry carries the writer lease (checked by :func:`check_lease`), a
        stable one never does."""
        s = self.t if pkg == "port" else self.j
        sys_path = self.tsys if pkg == "port" else self.jsys
        lease_ms, recovery_on = s.conf.recovery_lease_ms, s.conf.recovery_enabled
        out = {}
        for f, entry in read_log(os.path.join(sys_path, name)).items():
            leased = check_lease(entry, lease_ms)
            transient = entry["state"] in TRANSIENT_STATES
            assert leased == (transient and recovery_on), (pkg, f, entry["state"])
            out[f] = normalized_entry(entry, sys_path)
        return out

    def index_files(self, name: str, pkg: str) -> dict:
        """``torch_index_files.index_files`` of the index dir."""
        return index_files(os.path.join(self.tsys if pkg == "port" else self.jsys, name))

    def versions(self, name: str, pkg: str = "port") -> list:
        root = os.path.join(self.tsys if pkg == "port" else self.jsys, name)
        return sorted(d for d in os.listdir(root) if d.startswith("v__="))

    def state(self, name: str) -> str:
        """The latest stable state, equal in both packages."""
        got = [s.index_manager.get_index_log_entry(name).state for _p, s, _h in self.sides()]
        assert got[0] == got[1]
        return got[0]

    def latest_state(self, name: str) -> str:
        """The state at the log tip, equal in both packages."""
        got = [s.index_manager._managers(name)[0].get_latest_log().state
               for _p, s, _h in self.sides()]
        assert got[0] == got[1]
        return got[0]


def sorted_table(t: pa.Table) -> pa.Table:
    return t.sort_by([(c, "ascending") for c in t.column_names])


def config(pkg: str, kind: str, name: str, *args):
    """``kind``'s index config of package ``pkg``."""
    if pkg == "port":
        from hyperspace_tpu_torch.indexes import covering, dataskipping, sketches, zorder
    else:
        from hyperspace_tpu.indexes import covering, dataskipping, sketches, zorder
    if kind == "covering":
        return covering.CoveringIndexConfig(name, *args)
    if kind == "zorder":
        return zorder.ZOrderCoveringIndexConfig(name, *args)
    return dataskipping.DataSkippingIndexConfig(
        name, *(getattr(sketches, cls)(*a) for cls, *a in args)
    )
