"""Both packages' serve tiers side by side, for the frontend, stress, fleet
and fault differentials (``tests/test_torch_serve_frontend.py``,
``test_torch_serve_stress.py``, ``test_torch_fleet.py``,
``test_torch_faults_serve.py``).

``PKG[name]`` holds one package's modules under common names, so one test
body drives either package. :func:`session` opens a session of either
package on one system path (the port's on ``device="cpu"``, the JAX
package's on one CPU device), and :func:`lake` writes a source directory
and builds one covering index over it with the JAX package, so the lake is
built by one package and served by both. :func:`reference_answer` is the
JAX package's unindexed answer to a port plan, the truth the port's served
answers are held to.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import types

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

import hyperspace_tpu.execution as jexecution
import hyperspace_tpu_torch.execution as texecution
from hyperspace_tpu import constants as JC
from hyperspace_tpu import exceptions as JE
from hyperspace_tpu import functions as JF
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JCovering
from hyperspace_tpu.obs import planspec as jplanspec
from hyperspace_tpu.obs import querylog as jquerylog
from hyperspace_tpu.obs import trace as jtrace
from hyperspace_tpu.serve import bus as jbus
from hyperspace_tpu.serve import fastbus as jfastbus
from hyperspace_tpu.serve import fleet as jfleet
from hyperspace_tpu.serve import frontend as jfrontend
from hyperspace_tpu.serve import router as jrouter
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu.testing import faults as jfaults
from hyperspace_tpu.testing import lock_witness as jlock_witness
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import exceptions as TE
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.hyperspace import Hyperspace as THyperspace
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TCovering
from hyperspace_tpu_torch.obs import planspec as tplanspec
from hyperspace_tpu_torch.obs import querylog as tquerylog
from hyperspace_tpu_torch.obs import trace as ttrace
from hyperspace_tpu_torch.serve import bus as tbus
from hyperspace_tpu_torch.serve import fastbus as tfastbus
from hyperspace_tpu_torch.serve import fleet as tfleet
from hyperspace_tpu_torch.serve import frontend as tfrontend
from hyperspace_tpu_torch.serve import router as trouter
from hyperspace_tpu_torch.session import HyperspaceSession as TSession
from hyperspace_tpu_torch.testing import faults as tfaults
from hyperspace_tpu_torch.testing import lock_witness as tlock_witness

PKGS = ("port", "jax")

PKG = {
    "port": types.SimpleNamespace(
        C=TC, F=TF, E=TE, execution=texecution, frontend=tfrontend, fleet=tfleet,
        bus=tbus, fastbus=tfastbus, router=trouter, faults=tfaults, trace=ttrace,
        querylog=tquerylog, Hyperspace=THyperspace, Covering=TCovering,
        lock_witness=tlock_witness,
    ),
    "jax": types.SimpleNamespace(
        C=JC, F=JF, E=JE, execution=jexecution, frontend=jfrontend, fleet=jfleet,
        bus=jbus, fastbus=jfastbus, router=jrouter, faults=jfaults, trace=jtrace,
        querylog=jquerylog, Hyperspace=JHyperspace, Covering=JCovering,
        lock_witness=jlock_witness,
    ),
}

#: the frontend counters held equal across the packages
COUNTERS = ("admitted", "completed", "deduped", "shed", "retries", "degraded", "failed")


def session(pkg: str, system_path: str, num_buckets: int = 8, **conf):
    """A session of ``pkg`` on ``system_path`` with ``conf`` set, Hyperspace
    enabled."""
    s = TSession(device="cpu") if pkg == "port" else JSession(devices=jax.devices()[:1])
    s.conf.set("hyperspace.system.path", system_path)
    s.conf.set("hyperspace.index.num_buckets", num_buckets)
    for k, v in conf.items():
        s.conf.set(k, v)
    s.enable_hyperspace()
    return s


def write_rows(path, n, seed, key_hi=400, float_col=False):
    """The reference tests' rows: int64 keys below ``key_hi`` and quantities
    (and a normal float column ``v`` with ``float_col``)."""
    rng = np.random.default_rng(seed)
    cols = {
        "k": pa.array(rng.integers(0, key_hi, n), pa.int64()),
        "q": pa.array(rng.integers(1, 50, n), pa.int64()),
    }
    if float_col:
        cols["v"] = pa.array(rng.normal(0.0, 1.0, n))
    pq.write_table(pa.table(cols), path)


def atomic_append(src_dir, tmp_dir, name, n, seed, **kw):
    """Publish a new source file atomically (write outside the listed dir,
    then rename in), so concurrent listings never see a torn file."""
    tmp = os.path.join(tmp_dir, name)
    write_rows(tmp, n, seed, **kw)
    os.rename(tmp, os.path.join(src_dir, name))


def lake(root, files=2, rows=6000, key_hi=400, included=("q",), float_col=False,
         bucket_spec=True):
    """``root/src`` of ``files`` parquet files and index ``i1`` on ``k``
    built by the JAX package under ``root/indexes``; returns (src, system
    path)."""
    src = os.path.join(str(root), "src")
    os.makedirs(src, exist_ok=True)
    for i in range(files):
        write_rows(os.path.join(src, f"p{i}.parquet"), rows, i, key_hi=key_hi, float_col=float_col)
    system_path = os.path.join(str(root), "indexes")
    builder = session("jax", system_path)
    builder.conf.set(JC.INDEX_FILTER_RULE_USE_BUCKET_SPEC, bucket_spec)
    JHyperspace(builder).create_index(builder.read.parquet(src), JCovering("i1", ["k"], list(included)))
    return src, system_path


def reference_answer(system_path: str, plan):
    """The JAX package's unindexed answer to the port's ``plan``, carried
    across as a plan spec (its scans read the same source files), from a
    session on ``system_path``."""
    spec = tplanspec.to_spec(plan)
    assert spec is not None, plan
    s = session("jax", system_path)
    s.disable_hyperspace()
    return s.execute(jplanspec.from_spec(s, spec))


def sorted_table(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


def counters(fe) -> dict:
    st = fe.stats()
    return {k: st[k] for k in COUNTERS}
