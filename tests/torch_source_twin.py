"""Both packages over one lake, for the source differentials
(``tests/test_torch_sources.py``, ``tests/test_torch_formats.py``).

A :class:`Lake` holds a port session (``device="cpu"``) and a JAX-package
session, each with its own system path under one root, reading the same
tables (built by ``tests/torch_lake.py``): a commit or a file is made once
and both packages see the same files, sizes and mtimes. The checks hold
the port to the JAX package:

* snapshots (files, sizes, mtimes, schema, version) and the relations the
  readers build (files, format, schema, options), and each provider's
  signature;
* log entries equal apart from ids and timestamps, index files byte for
  byte (``torch_index_files``);
* explain text equal apart from the system path (so the LogVersion a
  time-travel query names too), rows equal in order, and equal as a
  multiset to the plan without Hyperspace.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import pyarrow as pa
from torch_index_files import index_files, normalized_log

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.session import HyperspaceSession as JSession


def sorted_table(t: pa.Table) -> pa.Table:
    return t.sort_by([(c, "ascending") for c in t.column_names])


def config(pkg: str, name: str, indexed, included):
    if pkg == "port":
        from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig
    else:
        from hyperspace_tpu.indexes.covering import CoveringIndexConfig
    return CoveringIndexConfig(name, list(indexed), list(included))


def snapshot_view(snap) -> dict:
    """A Delta or Iceberg snapshot as plain data (types as strings)."""
    out = dict(vars(snap))
    out["schema_fields"] = [(n, str(t)) for n, t in snap.schema_fields]
    out["file_paths"] = snap.file_paths
    return out


def relation_view(rel) -> dict:
    return {"root_paths": rel.root_paths, "files": rel.files, "fmt": rel.fmt,
            "schema": [(n, str(t)) for n, t in rel.schema_fields],
            "options": rel.options}


class Lake:
    def __init__(self, root, num_buckets: int = 4, lineage: bool = False):
        self.root = str(root)
        self.sys = {"port": os.path.join(self.root, "port"),
                    "jax": os.path.join(self.root, "jax")}
        self.t = T.HyperspaceSession(device="cpu")
        self.t.conf.set("hyperspace.system.path", self.sys["port"])
        self.j = JSession()
        self.j.conf.set(JC.INDEX_SYSTEM_PATH, self.sys["jax"])
        self.j.conf.set(JC.BUILD_NUM_SHARDS, 1)  # the port builds on one device
        self.set("hyperspace.index.num_buckets", num_buckets)
        self.set("hyperspace.index.lineage.enabled", lineage)
        self.hs = {"port": T.Hyperspace(self.t), "jax": JHyperspace(self.j)}

    # -- driving ------------------------------------------------------------
    def sides(self):
        return (("port", self.t), ("jax", self.j))

    def set(self, key, value) -> None:
        for _pkg, s in self.sides():
            s.conf.set(key, value)

    def read(self, pkg: str, kind: str, *args, **kw):
        """``session.read.<kind>(*args, **kw)`` in package ``pkg``."""
        s = self.t if pkg == "port" else self.j
        return getattr(s.read, kind)(*args, **kw)

    def create(self, name: str, kind: str, path, indexed, included, **kw) -> None:
        for pkg, _s in self.sides():
            self.hs[pkg].create_index(self.read(pkg, kind, path, **kw),
                                      config(pkg, name, indexed, included))

    def run(self, op: str, *args) -> None:
        """``hs.<op>(*args)`` in each package."""
        for pkg, _s in self.sides():
            getattr(self.hs[pkg], op)(*args)

    def clear(self) -> None:
        for _pkg, s in self.sides():
            s.index_manager.clear_cache()

    # -- checks -------------------------------------------------------------
    def relations(self, kind: str, path, **kw) -> dict:
        """The reader's relation and the provider's signature, equal across
        the packages; returns the port's relation view."""
        out = {}
        for pkg, s in self.sides():
            rel = self.read(pkg, kind, path, **kw).logical_plan.collect_leaves()[0].relation
            provider_rel = s.source_manager.get_relation(rel)
            out[pkg] = (relation_view(rel), provider_rel.signature(),
                        provider_rel.all_file_infos())
        assert out["port"] == out["jax"]
        return out["port"][0]

    def assert_index_equal(self, name: str) -> None:
        """Log entries and index files of ``name`` equal across packages."""
        logs, files = {}, {}
        for pkg, _s in self.sides():
            root = os.path.join(self.sys[pkg], name)
            logs[pkg] = normalized_log(root, self.sys[pkg])
            files[pkg] = index_files(root)
        assert logs["port"] == logs["jax"]
        assert files["port"] == files["jax"]

    def properties(self, name: str) -> dict:
        """The index's derived-dataset properties, equal across packages."""
        got = [s.index_manager.get_index_log_entry(name).derived_dataset.properties
               for _pkg, s in self.sides()]
        assert got[0] == got[1]
        return dict(got[0])

    def query(self, kind: str, path, q, **kw):
        """``q(df)`` over a fresh read (``read.<kind>(path, **kw)``) with
        Hyperspace on in each package: rows equal in order across the
        packages and to the unindexed plan as a multiset, explain text
        equal apart from the system paths. Returns ``(port rows, port
        explain)``."""
        out = {}
        for pkg, s in self.sides():
            s.index_manager.clear_cache()
            df = q(self.read(pkg, kind, path, **kw))
            s.enable_hyperspace()
            got = df.collect()
            text = self.hs[pkg].explain(df).replace(self.sys[pkg], "<sys>")
            s.disable_hyperspace()
            want = df.collect()
            assert sorted_table(got).equals(sorted_table(want)), pkg
            out[pkg] = (got, text)
        assert out["port"][0].equals(out["jax"][0])
        assert out["port"][1] == out["jax"][1]
        return out["port"]


def served(text: str) -> str:
    """The "Plan with indexes" part of an explain text."""
    return text.split("Plan without indexes:")[0]
