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
The device is carried on the session and reaches every op call; the
shard mesh of the build and the sharded serve is ``session.runtime``
(``devices=``, one shard on ``device`` by default).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import warnings
from typing import List, Optional, Sequence

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


#: the ``record_function`` around the kernels ``_profiled`` launches at
#: each end of a CUDA trace
PROFILE_PAD = "hyperspace.profile.pad"
#: one-element kernels in each pad
PROFILE_PAD_LAUNCHES = 256


def launches_without_kernels(trace_path: str) -> int:
    """Kernel launches in the Chrome trace at ``trace_path`` (its
    ``cuda_runtime`` events named ``*LaunchKernel*``), outside the pads
    :data:`PROFILE_PAD` where the trace has them, whose correlation id no
    device ``kernel`` event carries: 0 when the trace holds every kernel
    it saw launched."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    pads = [
        (e["ts"], e["ts"] + e.get("dur", 0))
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") == PROFILE_PAD
    ]
    launched, ran = set(), set()
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", ""):
            if not any(lo <= e["ts"] <= hi for lo, hi in pads):
                launched.add(corr)
        elif e.get("cat") == "kernel":
            ran.add(corr)
    return len(launched - ran)


def _profile_pad(device: torch.device) -> None:
    """:data:`PROFILE_PAD_LAUNCHES` one-element kernels, waited for, under
    the ``record_function`` :data:`PROFILE_PAD`. On an H100 (torch 2.11,
    CUDA 12.8), once a process's first trace is some tens of seconds old,
    torch.profiler drops device records at the ends of a new trace as
    outside its capture window (PERF.md §7); a pad at each end takes that
    loss instead of the query's kernels."""
    import torch.profiler as tp

    with tp.record_function(PROFILE_PAD):
        x = torch.zeros(1, device=device)
        for _ in range(PROFILE_PAD_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize(device)


class ExecStats:
    """Counts of what the executor ran, per session: predicate masks
    evaluated on the device by the general mask and by the fused range
    mask (kernel B3a), masks evaluated on the host because the predicate
    does not lower (``ops/filter.Unsupported``), bucket-pruned scans,
    joins served shuffle-free from co-bucketed index scans, and joins run
    unindexed; filters served by the fused select (kernel B3b), and
    aggregates answered by the metadata plane and by the fused
    filter→aggregate (kernel B5f)."""

    def __init__(self):
        self.device_filter_evals = 0
        self.fused_range_masks = 0
        self.host_filter_evals = 0
        self.bucket_pruned_scans = 0
        self.co_bucketed_joins = 0
        self.unbucketed_joins = 0
        self.fused_selects = 0
        self.metadata_aggregates = 0
        self.fused_aggregates = 0

    def reset(self) -> None:
        self.__init__()

    def as_dict(self) -> dict:
        return dict(vars(self))


class DataFrameReader:
    """``session.read.parquet(path)`` etc. — builds a Scan over a file
    snapshot (listing happens here, like Spark's ``InMemoryFileIndex``):
    the default provider's formats (parquet, csv, json, orc, avro, text),
    Delta Lake tables with time travel and Iceberg tables pinned to a
    snapshot. Counterpart of the reference's reader
    (``hyperspace_tpu/session.py:29-121``)."""

    def __init__(self, session: "HyperspaceSession"):
        self._session = session

    def _scan(self, fmt: str, paths: Sequence[str]) -> DataFrame:
        from hyperspace_tpu_torch.io.columnar import flatten_schema_fields
        from hyperspace_tpu_torch.io.parquet import expand_path, read_table

        files: List[str] = []
        for p in paths:
            files.extend(expand_path(p, fmt))
        if not files:
            raise HyperspaceException(f"No {fmt} files under {list(paths)}")
        if fmt == "parquet":
            schema = pq.read_schema(files[0])
            fields = tuple((f.name, f.type) for f in schema)
        else:
            head = read_table(files[:1], None, fmt)
            fields = tuple((n, head.schema.field(n).type) for n in head.column_names)
        # struct columns surface as flat __hs_nested.<path> leaf columns
        fields = flatten_schema_fields(fields)
        # glob patterns stay patterns in root_paths, absolutized like plain
        # paths so re-expansion does not depend on the process cwd
        rel = Relation(
            root_paths=tuple(os.path.abspath(p) for p in paths),
            files=tuple(os.path.abspath(f) for f in files),
            fmt=fmt,
            schema_fields=fields,
        )
        return DataFrame(self._session, Scan(rel))

    def parquet(self, *paths: str) -> DataFrame:
        return self._scan("parquet", paths)

    def csv(self, *paths: str) -> DataFrame:
        return self._scan("csv", paths)

    def json(self, *paths: str) -> DataFrame:
        return self._scan("json", paths)

    def orc(self, *paths: str) -> DataFrame:
        return self._scan("orc", paths)

    def avro(self, *paths: str) -> DataFrame:
        return self._scan("avro", paths)

    def text(self, *paths: str) -> DataFrame:
        return self._scan("text", paths)

    def delta(self, path: str, version_as_of: Optional[int] = None) -> DataFrame:
        """Read a Delta Lake table, optionally pinned to a version (the
        reference records ``versionAsOf`` for time travel,
        DeltaLakeRelation.scala:96-99)."""
        from hyperspace_tpu_torch.io.columnar import flatten_schema_fields
        from hyperspace_tpu_torch.sources import delta_log

        snap = delta_log.read_snapshot(path, version_as_of)
        options = [("deltaVersion", str(snap.version))]
        if version_as_of is not None:
            options.append(("versionAsOf", str(version_as_of)))
        rel = Relation(
            root_paths=(os.path.abspath(path),),
            files=tuple(snap.file_paths),
            fmt="delta",
            schema_fields=flatten_schema_fields(snap.schema_fields),
            options=tuple(options),
        )
        return DataFrame(self._session, Scan(rel))

    def iceberg(self, path: str, snapshot_id: Optional[int] = None) -> DataFrame:
        """Read an Iceberg table, optionally pinned to a snapshot (the
        reference pins scans to snapshot ids, IcebergRelation.scala:222-223)."""
        from hyperspace_tpu_torch.io.columnar import flatten_schema_fields
        from hyperspace_tpu_torch.sources import iceberg_meta

        snap = iceberg_meta.read_snapshot(path, snapshot_id)
        options = [("snapshotId", str(snap.snapshot_id))]
        if snapshot_id is not None:
            options.append(("snapshotAsOf", str(snapshot_id)))
        rel = Relation(
            root_paths=(os.path.abspath(path),),
            files=tuple(snap.file_paths),
            fmt="iceberg",
            schema_fields=flatten_schema_fields(snap.schema_fields),
            options=tuple(options),
        )
        return DataFrame(self._session, Scan(rel))


class HyperspaceSession:
    """``device`` is where queries run; ``devices`` the shard mesh of the
    build and the sharded serve (``parallel/mesh.py``), one entry a shard,
    a device listed once a shard it holds (``["cpu"] * 4`` runs 4 shards
    on the CPU, ``["cuda:0"] * 4`` 4 shards on one GPU). Default: one
    shard on ``device``; given only ``devices``, ``device`` is the first
    shard's."""

    def __init__(self, device=None, devices: Optional[Sequence] = None):
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if not devices:
                raise HyperspaceException("devices must name at least one device")
            if device is not None and resolve_device(device) != devices[0]:
                raise HyperspaceException(
                    f"device {device} is not the mesh's first shard {devices[0]}"
                )
            device = devices[0]
        self.device = resolve_device(device)
        from hyperspace_tpu_torch.parallel.mesh import MeshRuntime

        self.runtime = MeshRuntime(devices if devices is not None else [self.device])
        self.conf = Config()
        self.exec_stats = ExecStats()
        #: stage wall seconds of the latest index build (indexes/covering_build)
        self.build_stats: dict = {}
        #: the bucket exchange's telemetry of the latest build
        #: (``shuffle_<key>``, indexes/covering_build)
        self.build_telemetry: dict = {}
        #: stage wall seconds of the latest join (execution/join_exec)
        self.join_stats: dict = {}
        #: stage wall seconds of the latest query's aggregates, sorts and
        #: limits (execution/executor, execution/aggregate_exec)
        self.agg_stats: dict = {}
        self._hyperspace_enabled = False
        self._source_manager = None
        self._index_manager = None
        self._serve_cache = None
        self._serve_cache_lock = threading.Lock()
        self._catalog: dict = {}
        self._trace_seq = itertools.count(1)
        from hyperspace_tpu_torch.obs import metrics as obs_metrics
        from hyperspace_tpu_torch.telemetry import EventLogging

        self.event_logging = EventLogging(self.conf)
        # the reference's breakdown instruments, read from this session's
        # own dicts (the newest session wins; no second copy is kept)
        obs_metrics.registry.register_stage_view(
            "hs_serve_stage_seconds", "serve stage busy seconds (breakdown view)",
            self, "join_stats",
        )
        obs_metrics.registry.register_stage_view(
            "hs_build_stage_seconds", "build stage busy seconds (breakdown view)",
            self, "build_stats",
        )

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

    @property
    def serve_cache(self):
        """The serve-server data cache (``execution/serve_cache.py``) when
        ``hyperspace.serve.cache.enabled`` is on, else None. Stale entries
        are impossible (keys fingerprint the immutable index file set);
        ``clear_serve_cache()`` just frees the memory. A change of
        ``maxBytes`` or of the spill cap builds a new, empty cache."""
        if not self.conf.serve_cache_enabled:
            return None
        max_bytes = self.conf.serve_cache_max_bytes
        spill_max_bytes = self.conf.serve_spill_max_bytes
        with self._serve_cache_lock:
            if (
                self._serve_cache is None
                or self._serve_cache.max_bytes != max_bytes
                or self._serve_cache.spill_max_bytes != spill_max_bytes
            ):
                from hyperspace_tpu_torch.execution.serve_cache import ServeCache, spill_root

                self._serve_cache = ServeCache(
                    max_bytes,
                    spill_dir=spill_root(self.conf) if spill_max_bytes > 0 else None,
                    spill_max_bytes=spill_max_bytes,
                )
            return self._serve_cache

    def clear_serve_cache(self) -> None:
        if self._serve_cache is not None:
            self._serve_cache.clear()

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

    # -- SQL surface (HyperspaceSparkSessionExtension.scala:44-69 analogue:
    # SQL flows through the same optimizer, so index rewrites apply) ------
    def register_view(self, name: str, df: DataFrame) -> None:
        self._catalog[name.lower()] = df

    def sql(self, query: str) -> DataFrame:
        from hyperspace_tpu_torch.sql import parse_sql

        return parse_sql(self, query, self._catalog)

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

        trace_dir = self.conf.profile_trace_dir
        if trace_dir:
            # the port's jax.profiler.trace: host ops, and on a CUDA session
            # the kernels and copies, in a Chrome trace a query
            with self._profiled(trace_dir):
                return execute(self.optimize(plan), self)
        return execute(self.optimize(plan), self)

    @contextlib.contextmanager
    def _profiled(self, trace_dir: str):
        """Run the block under ``torch.profiler.profile`` and write its
        Chrome trace to ``<trace_dir>/hs_trace.<pid>.<seq>.json``. On a CUDA
        session the device is synchronised before the profiler starts, and
        the block runs between two pads (:func:`_profile_pad`), each of which
        waits for the device, so every kernel the block launched has ended
        inside the trace's window, away from its ends; a trace that still
        lacks the device event of a kernel the block launched warns
        (:func:`launches_without_kernels`)."""
        import torch.profiler as tp

        cuda = self.device.type == "cuda"
        activities = [tp.ProfilerActivity.CPU]
        if cuda:
            activities.append(tp.ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"hs_trace.{os.getpid()}.{next(self._trace_seq):06d}.json")
        if cuda:
            torch.cuda.synchronize(self.device)
        with tp.profile(activities=activities) as prof:
            if cuda:
                _profile_pad(self.device)
            yield
            if cuda:
                _profile_pad(self.device)
        prof.export_chrome_trace(path)
        if cuda:
            missing = launches_without_kernels(path)
            if missing:
                warnings.warn(
                    f"{path}: torch.profiler kept no device event for {missing} kernel "
                    "launches of the query",
                    RuntimeWarning,
                    stacklevel=3,
                )
