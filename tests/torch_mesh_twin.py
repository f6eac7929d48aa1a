"""Both packages at D shards over one source: the helpers of the sharded
build and serve differentials (``tests/test_torch_exchange_strategies.py``,
``test_torch_sharded_tail.py``, ``test_torch_mesh_sizes.py``).

The JAX package's session takes the first D of the 8 virtual CPU devices
``tests/conftest.py`` forces; the port's takes ``devices=["cpu"] * D``,
D shards on the one CPU. Both set the same string conf keys.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import hashlib
import os

import jax

import hyperspace_tpu_torch as T
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JCoveringIndexConfig
from hyperspace_tpu.session import HyperspaceSession as JSession

SYSTEM_PATH = "hyperspace.system.path"
NUM_BUCKETS = "hyperspace.index.num_buckets"
STRATEGY = "hyperspace.build.exchange.strategy"
HOSTS = "hyperspace.build.exchange.twostageHosts"
BUDGET = "hyperspace.index.build.memoryBudgetBytes"
SHARDED_TAIL = "hyperspace.build.shardedTail.enabled"
NUM_SHARDS = "hyperspace.build.numShards"
LINEAGE = "hyperspace.index.lineage.enabled"
HYBRID = "hyperspace.index.hybridscan.enabled"


def session(pkg: str, root, D: int, num_buckets: int = 8):
    """A session of ``pkg`` ("port" or "jax") at D shards, its system path
    ``<root>/<pkg>``."""
    if pkg == "port":
        s = T.HyperspaceSession(device="cpu", devices=["cpu"] * D)
    else:
        s = JSession(devices=jax.devices()[:D])
    s.conf.set(SYSTEM_PATH, os.path.join(str(root), pkg))
    s.conf.set(NUM_BUCKETS, num_buckets)
    return s


def hyperspace(s):
    return T.Hyperspace(s) if isinstance(s, T.HyperspaceSession) else JHyperspace(s)


def covering(s, name, indexed, included):
    cls = T.CoveringIndexConfig if isinstance(s, T.HyperspaceSession) else JCoveringIndexConfig
    return cls(name, list(indexed), list(included))


def build(s, src, name, indexed=("k",), included=("s", "v"), **conf):
    """Create ``name`` over the parquet source with the conf keys given
    (``strategy``, ``hosts``, ``budget``, ``sharded``, ``lineage``);
    returns the committed files, sorted."""
    keys = {"strategy": STRATEGY, "hosts": HOSTS, "budget": BUDGET,
            "sharded": SHARDED_TAIL, "lineage": LINEAGE}
    for k, v in conf.items():
        s.conf.set(keys[k], v)
    hyperspace(s).create_index(s.read.parquet(src), covering(s, name, indexed, included))
    return sorted(s.index_manager.get_index_log_entry(name).content.files)


def sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def assert_identical_files(files_a, files_b, tag="") -> None:
    """The same bucket file names, byte for byte the same contents."""
    assert [os.path.basename(f) for f in files_a] == [os.path.basename(f) for f in files_b], tag
    for fa, fb in zip(files_a, files_b):
        assert sha(fa) == sha(fb), f"{tag}: parquet bytes differ: {fa} vs {fb}"


def sorted_table(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])
