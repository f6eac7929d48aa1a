"""Refresh actions: full rebuild, incremental, quick (metadata only).

Reference: ``actions/RefreshActionBase.scala:37-129`` (reconstruct the
source from stored relation metadata, diff current against indexed file
sets), ``RefreshAction.scala:33-64`` (full rebuild; no-op when unchanged),
``RefreshIncrementalAction.scala`` (index appended files, lineage
anti-filter for deletes, Directory.merge content),
``RefreshQuickAction.scala:32-80`` (record the delta in ``Update`` and a
new fingerprint). Counterpart of ``hyperspace_tpu/actions/refresh.py``;
the entries it commits are the reference's apart from timestamps and ids.

A quick-refreshed index serves as the reference's does: the candidate
filter tags the recorded ``Update`` delta and the rewrite compensates for
it through Hybrid Scan's ``Union`` (appended files) and lineage NOT-IN
(deleted files), Hybrid Scan on or off. A later incremental or full
refresh indexes the recorded files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.actions.create import capture_sidecars
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException, NoChangesException
from hyperspace_tpu_torch.indexes.base import UpdateMode
from hyperspace_tpu_torch.indexes.context import IndexerContext
from hyperspace_tpu_torch.metadata.entry import (
    Content,
    FileIdTracker,
    IndexLogEntry,
    Source,
    SourcePlan,
)
from hyperspace_tpu_torch.plan.nodes import Relation as PlanRelation
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.signatures import IndexSignatureProvider
from hyperspace_tpu_torch.telemetry import (
    RefreshActionEvent,
    RefreshIncrementalActionEvent,
    RefreshQuickActionEvent,
)


class RefreshActionBase(Action):
    transient_state = States.REFRESHING
    final_state = States.ACTIVE

    def __init__(self, session, index_name: str, log_manager, data_manager):
        super().__init__(session, log_manager)
        self.index_name = index_name
        self.data_manager = data_manager
        self._resnapshot()

    def _resnapshot(self) -> None:
        """Previous entry, target version dir, tracker and source snapshot
        off the current log tip. Previous = latest (not latest stable): a
        dangling transient state blocks refresh until cancel()."""
        super()._resnapshot()
        self._previous: Optional[IndexLogEntry] = self.log_manager.get_latest_log()
        version = (self.data_manager.get_latest_version_id() or 0) + 1
        self.index_data_path = self.data_manager.get_path(version)
        self.tracker: FileIdTracker = (
            self._previous.file_id_tracker() if self._previous else FileIdTracker()
        )
        self._source_rel = None
        self._current_infos = None

    # -- source reconstruction (RefreshActionBase.df:54-76) -----------------
    def source_relation(self):
        """Current source state, re-listed through the provider."""
        if self._source_rel is None:
            from hyperspace_tpu_torch.rules.rule_utils import parse_arrow_type

            meta = self._previous.relation
            fields = tuple(
                (name, parse_arrow_type(t)) for name, t in json.loads(meta.schema_json)
            )
            stale = PlanRelation(
                root_paths=tuple(meta.root_paths),
                files=(),
                fmt=meta.file_format,
                schema_fields=fields,
                options=tuple(sorted(meta.options.items())),
            )
            provider_rel = self.session.source_manager.get_relation(stale)
            self._source_rel = provider_rel.refresh()
        return self._source_rel

    def current_file_infos(self) -> Dict[str, Tuple[int, int]]:
        """path -> (size, mtime) of the current source, listed once an
        action so validate, op and the log entry see one view."""
        if self._current_infos is None:
            self._current_infos = {
                p: (size, mtime)
                for p, size, mtime in self.source_relation().all_file_infos()
            }
        return self._current_infos

    # -- diffs (RefreshActionBase.deletedFiles/appendedFiles:97-128) --------
    # against the build-time snapshot (relation.content), not the view a
    # quick refresh adjusted: the files it recorded were never indexed, so
    # they still count as appended or deleted here
    def _indexed_data_files(self):
        return dict(self._previous.relation.content.file_infos)

    def appended_files(self) -> List[Tuple[str, int, int]]:
        prev = self._indexed_data_files()
        out = []
        for p, (size, mtime) in sorted(self.current_file_infos().items()):
            info = prev.get(p)
            if info is None or info.size != size or info.modified_time != mtime:
                out.append((p, size, mtime))
        return out

    def deleted_files(self) -> List[Tuple[str, int]]:
        """(path, file_id) of indexed files that are gone or overwritten."""
        current = self.current_file_infos()
        out = []
        for p, info in sorted(self._indexed_data_files().items()):
            cur = current.get(p)
            if cur is None or cur != (info.size, info.modified_time):
                out.append((p, info.id))
        return out

    # -- shared validation --------------------------------------------------
    def validate(self) -> None:
        if self._previous is None:
            raise HyperspaceException(f"Index not found: {self.index_name!r}")
        if self._previous.state != States.ACTIVE:
            raise HyperspaceException(
                f"Refresh requires ACTIVE; index {self.index_name!r} is "
                f"{self._previous.state}"
            )
        if not self.appended_files() and not self.deleted_files():
            raise NoChangesException("Refresh aborted: source is unchanged")

    # -- df construction ----------------------------------------------------
    def _df_over(self, files: List[str]):
        from hyperspace_tpu_torch.dataframe import DataFrame

        rel = dataclasses.replace(self.source_relation().plan_relation, files=tuple(files))
        return DataFrame(self.session, Scan(rel))

    # -- log entry construction ---------------------------------------------
    def _build_entry(self, index, content: Content) -> IndexLogEntry:
        source_rel = self.source_relation()
        index.properties = source_rel.enrich_index_properties(
            index.properties, self.base_id + 2
        )
        meta_relation = source_rel.create_metadata_relation(self.tracker)
        fingerprint = IndexSignatureProvider(self.session.source_manager).fingerprint(
            Scan(source_rel.plan_relation)
        )
        return IndexLogEntry(
            name=self._previous.name,
            derived_dataset=index,
            content=content,
            source=Source(SourcePlan([meta_relation], provider="default")),
            fingerprint=fingerprint,
            properties=dict(self._previous.properties),
        )

    def begin_log_entry(self) -> IndexLogEntry:
        return self._build_entry(self._previous.derived_dataset, self._previous.content)

    def _context(self) -> IndexerContext:
        return IndexerContext(self.session, self.tracker, self.index_data_path)


class RefreshAction(RefreshActionBase):
    """Full rebuild into a new version dir (RefreshAction.scala:33-64)."""

    def op(self) -> None:
        df = self._df_over(list(self.source_relation().plan_relation.files))
        self._index = self._previous.derived_dataset.refresh_full(self._context(), df)
        capture_sidecars(self.session, self.index_data_path, self._index)

    def event(self, success, message=""):
        return RefreshActionEvent(index_name=self.index_name, message=message)

    def log_entry(self) -> IndexLogEntry:
        content = Content.from_directory_scan(self.index_data_path, self.tracker)
        return self._build_entry(self._index, content)


class RefreshIncrementalAction(RefreshActionBase):
    """Index only the delta (RefreshIncrementalAction.scala:52-128)."""

    def validate(self) -> None:
        super().validate()
        if self.deleted_files() and not self._previous.derived_dataset.can_handle_deleted_files:
            raise HyperspaceException(
                "Refresh (incremental) aborted: deleted source files but the "
                "index has no lineage; recreate with "
                "hyperspace.index.lineage.enabled=true"
            )

    def op(self) -> None:
        appended = [p for p, _s, _m in self.appended_files()]
        deleted_ids = [fid for _p, fid in self.deleted_files() if fid != -1]
        appended_df = self._df_over(appended) if appended else None
        self._index, self._mode = self._previous.derived_dataset.refresh_incremental(
            self._context(), appended_df, deleted_ids, self._previous.content
        )
        # the new version dir only: in MERGE mode the earlier dirs keep
        # their own sidecars, so the capture folds the new files alone
        capture_sidecars(self.session, self.index_data_path, self._index)

    def event(self, success, message=""):
        return RefreshIncrementalActionEvent(index_name=self.index_name, message=message)

    def log_entry(self) -> IndexLogEntry:
        new_content = Content.from_directory_scan(self.index_data_path, self.tracker)
        if self._mode == UpdateMode.MERGE:
            content = self._previous.content.merge(new_content)
        else:
            content = new_content
        return self._build_entry(self._index, content)


class RefreshQuickAction(RefreshActionBase):
    """Metadata-only refresh (RefreshQuickAction.scala:32-80): record the
    file-set delta and the new fingerprint."""

    def op(self) -> None:
        pass

    def begin_log_entry(self) -> IndexLogEntry:
        return self.log_entry()

    def event(self, success, message=""):
        return RefreshQuickActionEvent(index_name=self.index_name, message=message)

    def log_entry(self) -> IndexLogEntry:
        appended = Content.from_leaf_files(self.appended_files(), self.tracker)
        # looked up in the view deleted_files() diffs against, the
        # build-time snapshot (an earlier quick refresh already dropped
        # the path from the adjusted one)
        prev = self._indexed_data_files()
        deleted = Content.from_leaf_files(
            [(p, prev[p].size, prev[p].modified_time) for p, _fid in self.deleted_files()],
            self.tracker,
        )
        fingerprint = IndexSignatureProvider(self.session.source_manager).fingerprint(
            Scan(self.source_relation().plan_relation)
        )
        return self._previous.copy_with_update(appended, deleted, fingerprint)
