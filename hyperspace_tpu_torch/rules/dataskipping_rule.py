"""ApplyDataSkippingIndex — prune source files through the sketch table.

Counterpart of ``hyperspace_tpu/rules/dataskipping_rule.py`` (reference:
``dataskipping/rules/ApplyDataSkippingIndex.scala:33-105``,
``FilterConditionFilter`` and ``DataSkippingIndexRanker``). Score 1, so
any covering or z-order rewrite of the same filter wins (``:76-83``).
The rewritten plan scans the SAME source relation with fewer files,
tagged with the index (``index_info``), and takes the executor's routes
for such a scan (range pruning over the source files' footers, the fused
and metadata routes). The translated predicate is evaluated at rewrite
time against the sketch table, one row a source file; the Bloom filter
sketch probes it with kernel B7 on the session's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np

from hyperspace_tpu_torch.constants import DATA_FILE_NAME_ID
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.metadata.entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Filter, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.plananalysis import filter_reasons as FR
from hyperspace_tpu_torch.rules import tags
from hyperspace_tpu_torch.rules.base import CandidateMap, HyperspaceRule, tag_filter_reason
from hyperspace_tpu_torch.rules.filter_rule import _match


@functools.lru_cache(maxsize=32)
def _load_sketch_table(files: tuple):
    """Sketch tables are immutable a log entry's content (a new version
    gets new file paths), so the parquet read is cached across queries:
    the rule runs in every optimizer pass."""
    return pio.read_table(list(files), None)


class ApplyDataSkippingIndex(HyperspaceRule):
    name = "ApplyDataSkippingIndex"
    base_score = 1

    def apply(self, session, plan, candidates: CandidateMap):
        m = _match(plan)
        if m is None:
            return plan, 0
        project, filt, scan = m
        entries = [
            e
            for e in candidates.get(scan, [])
            if e.derived_dataset.kind == "DataSkippingIndex"
        ]
        best: Optional[IndexLogEntry] = None
        best_files: Optional[List[str]] = None
        for e in sorted(entries, key=lambda e: e.name):
            files = self._pruned_files(session, e, scan, filt)
            if files is None:
                continue
            if best_files is None or len(files) < len(best_files):
                best, best_files = e, files
        if best is None:
            return plan, 0
        # Hybrid Scan's appended files: a file modified in place appears
        # both in the stale keep list and in the appended tag, and is
        # scanned once, unpruned, through the appended list only
        appended = best.get_tag(scan, tags.HYBRIDSCAN_APPENDED) or []
        appended_set = set(appended)
        pruned = [p for p in best_files if p not in appended_set]
        new_rel = dataclasses.replace(
            scan.relation,
            files=tuple(pruned) + tuple(appended),
            index_info=(best.name, best.id, best.derived_dataset.kind_abbr),
        )
        new_plan: LogicalPlan = Filter(filt.condition, Scan(new_rel))
        new_plan = Project(
            project.columns if project is not None else plan.output, new_plan
        )
        return new_plan, self.base_score

    def _pruned_files(self, session, entry, scan, filt) -> Optional[List[str]]:
        index = entry.derived_dataset
        if not entry.content.files:
            return None
        sketch_table = _load_sketch_table(tuple(entry.content.files))
        mask = index.translate_filter(filt.condition, sketch_table, session.device)
        if mask is None:
            tag_filter_reason(
                entry,
                scan,
                FR.ineligible_predicate(
                    f"no sketch matches predicate {filt.condition!r}"
                ),
            )
            return None
        ids = np.asarray(sketch_table.column(DATA_FILE_NAME_ID))
        keep_ids = set(ids[mask].tolist())
        id_to_path = {info.id: path for path, info in entry.relation.content.file_infos}
        current = set(scan.relation.files)
        return [
            p
            for fid, p in sorted(id_to_path.items())
            if fid in keep_ids and p in current
        ]
