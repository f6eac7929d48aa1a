"""hyperspace_tpu_torch — the PyTorch/CUDA port of hyperspace_tpu.

A data-lake indexing engine modelled on Microsoft Hyperspace: covering
indexes over Parquet, a versioned operation log on the lake, and a planner
that rewrites queries onto the indexes. The JAX package ``hyperspace_tpu``
beside it is the reference; this package keeps its module paths, its
on-disk layout and its results, and runs its device work on an NVIDIA GPU
(kernels written by hand for Hopper under ``csrc/``). It imports neither
JAX nor the reference package.

The ported slices cover building a covering index, serving a
bucket-pruned filter from it, serving an equi-join of two tables
indexed on the join key bucket by bucket, without a shuffle,
aggregates, ORDER BY and LIMIT over any of them, the z-order
covering index (``ZOrderCoveringIndexConfig``), whose filters on any
indexed column are pruned by the files' z-address spans, and the
data-skipping index (``DataSkippingIndexConfig`` over the sketches of
``indexes/sketches.py``), whose filters read only the source files
their sketches cannot rule out, and the index lifecycle over all three
kinds: refresh (full, incremental, quick), optimize (quick, full),
delete, restore, vacuum and cancel::

    from hyperspace_tpu_torch import HyperspaceSession, Hyperspace, CoveringIndexConfig

    sess = HyperspaceSession()            # device "cuda"; device="cpu" for tests
    hs = Hyperspace(sess)
    df = sess.read.parquet("/data/t")
    hs.create_index(df, CoveringIndexConfig("idx", ["k"], ["v"]))
    sess.enable_hyperspace()
    df.filter(df["k"] == 3).select("v").collect()   # served from the index
    other = sess.read.parquet("/data/u")
    hs.create_index(other, CoveringIndexConfig("u_idx", ["j"], ["w"]))
    df.join(other, on=df["k"] == other["j"]).select("v", "w").collect()
    from hyperspace_tpu_torch import functions as F
    df.group_by("k").agg(F.count(), F.sum("v")).sort(("sum(v)", False)).limit(10).collect()
    # ... files land in /data/t ...
    hs.refresh_index("idx", "incremental")   # index the appended files
    hs.optimize_index("idx", "full")         # one file a bucket again
    hs.vacuum_index("idx")                   # drop the outdated versions
"""

from hyperspace_tpu_torch.exceptions import HyperspaceException  # noqa: F401

__version__ = "0.1.0"

# Lazy top-level imports (PEP 562): `import hyperspace_tpu_torch` stays
# cheap and imports no torch until a session is made.
_LAZY = {
    "HyperspaceSession": ("hyperspace_tpu_torch.session", "HyperspaceSession"),
    "Hyperspace": ("hyperspace_tpu_torch.hyperspace", "Hyperspace"),
    "CoveringIndexConfig": (
        "hyperspace_tpu_torch.indexes.covering",
        "CoveringIndexConfig",
    ),
    "IndexConfig": ("hyperspace_tpu_torch.indexes.covering", "CoveringIndexConfig"),
    "ZOrderCoveringIndexConfig": (
        "hyperspace_tpu_torch.indexes.zorder",
        "ZOrderCoveringIndexConfig",
    ),
    "DataSkippingIndexConfig": (
        "hyperspace_tpu_torch.indexes.dataskipping",
        "DataSkippingIndexConfig",
    ),
    "functions": ("hyperspace_tpu_torch.functions", None),
    "ServeFrontend": ("hyperspace_tpu_torch.serve", "ServeFrontend"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        m = importlib.import_module(mod)
        return m if attr is None else getattr(m, attr)
    raise AttributeError(f"module 'hyperspace_tpu_torch' has no attribute {name!r}")


__all__ = ["HyperspaceException", "__version__"] + sorted(_LAZY)
