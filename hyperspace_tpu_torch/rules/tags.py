"""Typed tag keys on (log entry, plan node) pairs.

Reference: ``index/IndexLogEntryTags.scala:1-85``. Tags carry per-plan
candidate-evaluation results (here: whyNot reasons) from the candidate
filters to the ranking/rewrite stages without mutating shared state.
``HYBRIDSCAN_APPENDED`` is read by the data-skipping rule and stays unset
until Hybrid Scan is ported (ROADMAP queue A item 5).
"""

FILTER_REASONS = "filterReasons"
INDEX_PLAN_ANALYSIS_ENABLED = "indexPlanAnalysisEnabled"
HYBRIDSCAN_APPENDED = "hybridScanAppendedFiles"
