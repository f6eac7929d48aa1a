"""OptimizeAction — compact small index files bucket by bucket.

Reference: ``actions/OptimizeAction.scala:57-148``: candidates are index
files below ``optimize.fileSizeThreshold`` (quick mode, default 256MB) or
all files (full mode), grouped by the bucket id in the file name
(`:96-114`, ``BucketingUtils.getBucketId``); single-file buckets are left
alone. The op rewrites those files into a new version dir; the final
content is the rewritten files merged with the untouched ("ignored") ones
(`:116-143`). Counterpart of ``hyperspace_tpu/actions/optimize.py``.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.actions.create import capture_sidecars
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException, NoChangesException
from hyperspace_tpu_torch.indexes.context import IndexerContext
from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
from hyperspace_tpu_torch.metadata.entry import Content, IndexLogEntry
from hyperspace_tpu_torch.telemetry import OptimizeActionEvent


class OptimizeAction(Action):
    transient_state = States.OPTIMIZING
    final_state = States.ACTIVE

    def __init__(self, session, index_name, log_manager, data_manager, mode):
        super().__init__(session, log_manager)
        self.index_name = index_name
        self.data_manager = data_manager
        self.mode = mode
        self._resnapshot()

    def _resnapshot(self) -> None:
        super()._resnapshot()
        # latest (not latest stable): a dangling transient state blocks
        # optimize until cancel()
        self._previous: Optional[IndexLogEntry] = self.log_manager.get_latest_log()
        version = (self.data_manager.get_latest_version_id() or 0) + 1
        self.index_data_path = self.data_manager.get_path(version)
        self.tracker = self._previous.file_id_tracker() if self._previous else None

    # -- candidate selection (filesToOptimize:96-114) -----------------------
    def _partition_files(self) -> Tuple[List[str], List[Tuple[str, object]]]:
        """-> (files_to_optimize, ignored (path, FileInfo))."""
        threshold = self.session.conf.optimize_file_size_threshold
        by_bucket: Dict[int, List[Tuple[str, object]]] = collections.defaultdict(list)
        ignored: List[Tuple[str, object]] = []
        for path, info in self._previous.content.file_infos:
            bucket = bucket_id_of_file(path)
            small = self.mode == C.OPTIMIZE_MODE_FULL or info.size < threshold
            if bucket is None or not small:
                ignored.append((path, info))
                continue
            by_bucket[bucket].append((path, info))
        to_optimize: List[str] = []
        for _bucket, files in sorted(by_bucket.items()):
            if len(files) < 2:  # single-file buckets stay as they are
                ignored.extend(files)
                continue
            to_optimize.extend(p for p, _ in files)
        return to_optimize, ignored

    def validate(self) -> None:
        if self._previous is None:
            raise HyperspaceException(f"Index not found: {self.index_name!r}")
        if self._previous.state != States.ACTIVE:
            raise HyperspaceException(
                f"Optimize requires ACTIVE; index {self.index_name!r} is "
                f"{self._previous.state}"
            )
        files, _ignored = self._partition_files()
        if not files:
            raise NoChangesException(
                "Optimize aborted: no index files eligible for compaction "
                f"in mode {self.mode!r}"
            )

    def op(self) -> None:
        ctx = IndexerContext(self.session, self.tracker, self.index_data_path)
        files, self._ignored = self._partition_files()
        index = self._previous.derived_dataset
        index.optimize(ctx, files)
        capture_sidecars(self.session, self.index_data_path, index)

    def event(self, success, message=""):
        return OptimizeActionEvent(index_name=self.index_name, mode=self.mode, message=message)

    def log_entry(self) -> IndexLogEntry:
        new_content = Content.from_directory_scan(self.index_data_path, self.tracker)
        ignored_content = Content.from_leaf_files(
            [(p, i.size, i.modified_time) for p, i in self._ignored], self.tracker
        )
        entry = self._previous.copy()
        entry.content = new_content.merge(ignored_content)
        return entry

    def begin_log_entry(self) -> IndexLogEntry:
        return self._previous.copy()
