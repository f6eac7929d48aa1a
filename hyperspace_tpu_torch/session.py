"""HyperspaceSession — conf + device + reader + optimizer hook.

Counterpart of ``hyperspace_tpu/session.py``. The session owns the config
(reference: Spark SQL conf, ``util/HyperspaceConf.scala``), the device its
ops run on, source reading (reference: ``DataFrameReader``), and the
optimizer extension point where ``enable_hyperspace()`` injects the
index-rewrite rule — mirroring ``spark.enableHyperspace()``
(``package.scala:26-95``).

Device rule: the session runs on ``cuda`` unless the caller asks for the
CPU with ``device="cpu"`` (as the tests do). Without a CUDA device and
without that request it raises; it never falls back to the CPU quietly.
The device is carried on the session and reaches every op call.
"""

from __future__ import annotations

import os
from typing import List

import pyarrow as pa
import pyarrow.parquet as pq
import torch

from hyperspace_tpu_torch.config import Config
from hyperspace_tpu_torch.dataframe import DataFrame
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan.nodes import Relation, Scan


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda (raising when no CUDA device is available); an
    explicit device is taken as given, and an explicit CUDA device must
    exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HyperspaceException(
            "HyperspaceSession runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise HyperspaceException(f"Unsupported device {dev}")
    return dev


class ExecStats:
    """Counts of what the executor ran, per session: predicate masks
    evaluated on the device, masks evaluated on the host because the
    predicate does not lower (``ops/filter.Unsupported``), bucket-pruned
    scans, joins served shuffle-free from co-bucketed index scans, and
    joins run unindexed."""

    def __init__(self):
        self.device_filter_evals = 0
        self.host_filter_evals = 0
        self.bucket_pruned_scans = 0
        self.co_bucketed_joins = 0
        self.unbucketed_joins = 0

    def reset(self) -> None:
        self.__init__()

    def as_dict(self) -> dict:
        return dict(vars(self))


class DataFrameReader:
    """``session.read.parquet(path)`` — builds a Scan over a file snapshot
    (listing happens here, like Spark's ``InMemoryFileIndex``). Other
    formats and the Delta/Iceberg readers are ported with their sources
    (ROADMAP queue A item 10)."""

    def __init__(self, session: "HyperspaceSession"):
        self._session = session

    def parquet(self, *paths: str) -> DataFrame:
        from hyperspace_tpu_torch.io.columnar import flatten_schema_fields
        from hyperspace_tpu_torch.io.parquet import expand_path

        files: List[str] = []
        for p in paths:
            files.extend(expand_path(p, "parquet"))
        if not files:
            raise HyperspaceException(f"No parquet files under {list(paths)}")
        schema = pq.read_schema(files[0])
        # struct columns surface as flat __hs_nested.<path> leaf columns
        fields = flatten_schema_fields(tuple((f.name, f.type) for f in schema))
        # glob patterns stay patterns in root_paths, absolutized like plain
        # paths so re-expansion does not depend on the process cwd
        rel = Relation(
            root_paths=tuple(os.path.abspath(p) for p in paths),
            files=tuple(os.path.abspath(f) for f in files),
            fmt="parquet",
            schema_fields=fields,
        )
        return DataFrame(self._session, Scan(rel))


class HyperspaceSession:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.conf = Config()
        self.exec_stats = ExecStats()
        #: stage wall seconds of the latest index build (indexes/covering_build)
        self.build_stats: dict = {}
        #: stage wall seconds of the latest join (execution/join_exec)
        self.join_stats: dict = {}
        self._hyperspace_enabled = False
        self._source_manager = None
        self._index_manager = None

    # -- context (HyperspaceContext, Hyperspace.scala:195-223) --------------
    @property
    def source_manager(self):
        if self._source_manager is None:
            from hyperspace_tpu_torch.sources.manager import SourceProviderManager

            self._source_manager = SourceProviderManager(self)
        return self._source_manager

    @property
    def index_manager(self):
        if self._index_manager is None:
            from hyperspace_tpu_torch.manager import CachingIndexCollectionManager

            self._index_manager = CachingIndexCollectionManager(self)
        return self._index_manager

    # -- reading ------------------------------------------------------------
    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    # -- hyperspace enable/disable (package.scala:40-80) --------------------
    def enable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._hyperspace_enabled

    # -- planning & execution ----------------------------------------------
    def optimize(self, plan):
        """Apply the Hyperspace rewrite when enabled (the injected-rule
        equivalent of ``ApplyHyperspace``, rules/ApplyHyperspace.scala:45-66)."""
        if self._hyperspace_enabled and self.conf.apply_enabled:
            from hyperspace_tpu_torch.rules.apply import apply_hyperspace

            return apply_hyperspace(self, plan)
        return plan

    def execute(self, plan) -> pa.Table:
        from hyperspace_tpu_torch.execution import execute

        return execute(self.optimize(plan), self)
