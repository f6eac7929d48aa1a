"""Both packages' serve sessions side by side, for the serve-cache and
streaming-join differentials (``tests/test_torch_serve_cache.py``,
``tests/test_torch_stream_serve.py``).

A :class:`Twin` holds a port session (``device="cpu"``) and a JAX-package
session on one CPU device (the JAX package's tests' own settings: 8
buckets), each with its own system path over the same source directories,
and the pipelined join serve on in both (the reference's default). It
runs one query closure through both, holds the rows equal in order (float
columns bit for bit, ``torch_b5_cases.same_rows``) and the two serve
caches' counters equal after each step.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import jax

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu import native as jnative
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import functions as TF
from torch_b5_cases import same_rows
from torch_lifecycle_twin import config

#: ``ServeCache.stats()`` counters held equal across the packages
COUNTERS = ("entries", "hits", "misses", "evictions", "insert_failures", "spill_entries",
            "spill_demotes", "spill_restores", "spill_drops")

PIPELINE = "hyperspace.serve.pipeline.enabled"


class Twin:
    def __init__(self, root, num_buckets: int = 8):
        # the reference's fused routes wait for its native library; load it
        # first, so that its route (and its cache calls) do not depend on a
        # background compile
        jnative.load()
        self.sys = {"port": str(root / "port_ix"), "jax": str(root / "jax_ix")}
        self.t = T.HyperspaceSession(device="cpu")
        self.t.conf.set("hyperspace.system.path", self.sys["port"])
        self.j = JSession(devices=jax.devices()[:1])
        self.j.conf.set(JC.INDEX_SYSTEM_PATH, self.sys["jax"])
        self.set("hyperspace.index.num_buckets", num_buckets)
        self.set(PIPELINE, True)
        self.hs = {"port": T.Hyperspace(self.t), "jax": JHyperspace(self.j)}

    def sides(self):
        return (("port", self.t), ("jax", self.j))

    def set(self, key, value):
        for _pkg, s in self.sides():
            s.conf.set(key, value)

    def create(self, kind, src, name, *args):
        for pkg, s in self.sides():
            self.hs[pkg].create_index(s.read.parquet(src), config(pkg, kind, name, *args))

    def refresh(self, name, mode):
        for pkg, _s in self.sides():
            self.hs[pkg].refresh_index(name, mode)

    def clear(self):
        for _pkg, s in self.sides():
            s.index_manager.clear_cache()

    def enable(self, on: bool = True):
        for _pkg, s in self.sides():
            s.enable_hyperspace() if on else s.disable_hyperspace()

    def explain(self, q) -> dict:
        return {pkg: self.hs[pkg].explain(q(s, TF if pkg == "port" else JF))
                for pkg, s in self.sides()}

    def run(self, q, stats: bool = True):
        """``q(session, F)`` collected in each package: rows equal in order
        (the port's returned), and with ``stats`` the caches' counters equal
        after it."""
        out = {pkg: q(s, TF if pkg == "port" else JF).collect() for pkg, s in self.sides()}
        assert same_rows(out["port"], out["jax"]), (out["port"], out["jax"])
        if stats:
            self.stats_equal()
        return out["port"]

    def caches(self):
        return self.t.serve_cache, self.j.serve_cache

    def stats_equal(self, bytes_too: bool = False) -> dict:
        """The two serve caches' counters (``COUNTERS``, with ``bytes_too``
        also the resident and high-water bytes), equal; returns the port's
        stats."""
        tc, jc = self.caches()
        assert (tc is None) == (jc is None)
        if tc is None:
            return {}
        keys = COUNTERS + (("resident_bytes", "high_water_bytes") if bytes_too else ())
        ts, js = tc.stats(), jc.stats()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}, (ts, js)
        assert kinds(tc) == kinds(jc)
        return ts


def kinds(cache) -> list:
    """The resident entries' kinds, sorted."""
    with cache._lock:
        return sorted(k[0] for k in cache._entries)
