"""Typed tag keys on (log entry, plan node) pairs.

Reference: ``index/IndexLogEntryTags.scala:1-85``. Tags carry per-plan
candidate-evaluation results (Hybrid Scan requirements, common bytes,
whyNot reasons) from the candidate filters to the ranking and rewrite
stages without mutating shared state.
"""

COMMON_SOURCE_SIZE_IN_BYTES = "commonSourceSizeInBytes"
HYBRIDSCAN_REQUIRED = "hybridScanRequired"
HYBRIDSCAN_APPENDED = "hybridScanAppendedFiles"
HYBRIDSCAN_DELETED = "hybridScanDeletedFileIds"
FILTER_REASONS = "filterReasons"
INDEX_PLAN_ANALYSIS_ENABLED = "indexPlanAnalysisEnabled"
