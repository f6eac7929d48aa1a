"""CreateAction — build a new index.

Reference: ``actions/CreateAction.scala:29-100`` (validation: supported
relation `:52-57`, column resolution `:62-66`, name/state uniqueness
`:74-80`; op = ``index.write``) and ``actions/CreateActionBase.scala``
(log-entry construction: signature, relation metadata, enriched
properties, content-from-directory). Counterpart of
``hyperspace_tpu/actions/create.py``; the log entry it commits is the
reference's apart from timestamps and ids.
"""

from __future__ import annotations

import time

from typing import Dict

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.context import IndexerContext
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.entry import (
    Content,
    FileIdTracker,
    IndexLogEntry,
    Source,
    SourcePlan,
)
from hyperspace_tpu_torch.obs import trace as _obs_trace
from hyperspace_tpu_torch.signatures import IndexSignatureProvider
from hyperspace_tpu_torch.telemetry import CreateActionEvent
from hyperspace_tpu_torch.utils import resolver


def capture_sidecars(session, index_data_path: str, index) -> None:
    """The sidecars of a freshly written version directory (best effort:
    the serve path backfills without them): zone maps for the range serve
    plane (with a z-order index's z-spans, interleaved on the session's
    device), their seconds the build stage "zonemap_capture"; then the
    aggregate index plane's _aggstate.json and _aggsample.parquet,
    computed on the session's device, their seconds the build stage
    "sidecar_capture", split into its row-group reads and its folds (with
    the folds' fused passes and their overflowed chunks). Create, refresh
    and optimize each run it over their new directory alone. On a job of
    several processes only the coordinator writes them, after the build's
    barrier (``covering_build._global_written``) has every bucket file in
    place."""
    from hyperspace_tpu_torch.indexes import aggindex, zonemaps

    if not session.runtime.is_coordinator:
        return
    t0 = time.perf_counter()
    zonemaps.capture_safely(index_data_path, index, session.device)
    dt = time.perf_counter() - t0
    session.build_stats["zonemap_capture"] = dt
    _obs_trace.stage("zonemap_capture", t0, seconds=dt)
    t0 = time.perf_counter()
    aggindex.capture_safely(index_data_path, index, session.conf, session.device)
    dt = time.perf_counter() - t0
    session.build_stats["sidecar_capture"] = dt
    _obs_trace.stage("sidecar_capture", t0, seconds=dt)
    for k in ("read", "fold", "passes", "overflowed"):
        session.build_stats[f"sidecar_capture_{k}"] = aggindex.capture_stats[k]


class CreateAction(Action):
    transient_state = States.CREATING
    final_state = States.ACTIVE

    def __init__(self, session, df, index_config, log_manager, data_manager):
        super().__init__(session, log_manager)
        self.df = df
        self.index_config = index_config
        self.data_manager: IndexDataManager = data_manager
        self._sources = session.source_manager
        self._resnapshot()

    def _resnapshot(self) -> None:
        super()._resnapshot()
        self.tracker = FileIdTracker()
        version = (self.data_manager.get_latest_version_id() or 0) + 1
        self.index_data_path = self.data_manager.get_path(version)
        self._index = None

    # -- validation (CreateAction.scala:50-81) ------------------------------
    def validate(self) -> None:
        leaves = self.df.logical_plan.collect_leaves()
        if len(leaves) != 1:
            raise HyperspaceException(
                "Only queries over a single supported relation can be indexed"
            )
        if not self._sources.is_supported(leaves[0].relation):
            raise HyperspaceException(
                f"Relation is not supported by any source provider: "
                f"{leaves[0].relation.root_paths}"
            )
        resolved = resolver.resolve(
            self.index_config.referenced_columns,
            self.df.columns,
            nested_available=resolver.nested_available_from(self.df.columns),
        )
        if resolved is None:
            raise HyperspaceException(
                f"Index columns {self.index_config.referenced_columns} could "
                f"not be resolved against {self.df.columns}"
            )
        # nested-field gate (CreateAction.scala:69-71): struct paths index
        # only when hyperspace.index.supportNestedFields is on
        if not self.session.conf.support_nested_fields and any(
            rc.normalized_name.startswith(C.NESTED_FIELD_PREFIX)
            for rc in resolved
        ):
            raise HyperspaceException(
                "Indexing nested (struct) fields requires "
                f"{C.INDEX_SUPPORT_NESTED_FIELDS}=true"
            )
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != States.DOESNOTEXIST:
            raise HyperspaceException(
                f"Index {self.index_config.index_name!r} already exists "
                f"(state {latest.state})"
            )

    # -- op (CreateAction.scala:85) -----------------------------------------
    def op(self) -> None:
        ctx = IndexerContext(self.session, self.tracker, self.index_data_path)
        index, index_data = self.index_config.create_index(
            ctx, self.df, self._enriched_properties()
        )
        index.write(ctx, index_data)
        capture_sidecars(self.session, self.index_data_path, index)
        self._index = index

    def _enriched_properties(self) -> Dict[str, str]:
        """CreateActionBase 'enriched' index properties: lineage flag and
        source-format hint, plus provider enrichment."""
        props = {
            C.LINEAGE_PROPERTY: str(self.session.conf.lineage_enabled).lower(),
        }
        leaf = self.df.logical_plan.collect_leaves()[0]
        if leaf.relation.fmt in ("parquet", "delta", "iceberg"):
            props[C.HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY] = "true"
        rel = self._sources.get_relation(leaf.relation)
        # final entry commits at base_id + 2 (Action id arithmetic)
        return rel.enrich_index_properties(props, self.base_id + 2)

    # -- log entry (CreateActionBase.getIndexLogEntry:41-83) ----------------
    def begin_log_entry(self) -> IndexLogEntry:
        return self._build_entry(content=Content.from_leaf_files([]))

    def event(self, success: bool, message: str = ""):
        return CreateActionEvent(index_name=self.index_config.index_name, message=message)

    def log_entry(self) -> IndexLogEntry:
        content = Content.from_directory_scan(self.index_data_path, self.tracker)
        return self._build_entry(content)

    def _build_entry(self, content: Content) -> IndexLogEntry:
        leaf = self.df.logical_plan.collect_leaves()[0]
        source_rel = self._sources.get_relation(leaf.relation)
        meta_relation = source_rel.create_metadata_relation(self.tracker)
        fingerprint = IndexSignatureProvider(self._sources).fingerprint(
            self.df.logical_plan
        )
        if self._index is None:
            # begin-phase: materialize the index object without building data
            ctx = IndexerContext(self.session, self.tracker, self.index_data_path)
            index = self.index_config.describe_index(
                ctx, self.df, self._enriched_properties()
            )
        else:
            index = self._index
        return IndexLogEntry(
            name=self.index_config.index_name,
            derived_dataset=index,
            content=content,
            source=Source(SourcePlan([meta_relation], provider="default")),
            fingerprint=fingerprint,
            properties={},
        )
