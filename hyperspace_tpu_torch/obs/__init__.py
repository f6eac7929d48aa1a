"""hyperspace_tpu_torch.obs — the observability plane.

Counterpart of ``hyperspace_tpu/obs/``:

* :mod:`obs.trace` — structured tracing: one root span a lifecycle action
  or query, child stage spans mirroring the session's breakdown keys,
  context carried across pool threads; one bool check when
  ``hyperspace.obs.enabled`` is off.
* :mod:`obs.metrics` — the typed counter / gauge / stage-timer registry
  with live views, a Prometheus text exporter and a JSONL sink.
* :mod:`obs.querylog` — the durable per-query JSONL log next to the lake
  (bounded, rotated, one file set a process), in the reference's format.
* :mod:`obs.planspec` — replayable plan specs, JSON-equal to the
  reference's for the same plan.

Every instrumentation site is declared in :mod:`obs.sites` (``OBS_SITES``).
"""

from __future__ import annotations

from hyperspace_tpu_torch.obs import metrics, querylog, sites, trace
from hyperspace_tpu_torch.obs.metrics import merge_snapshots, registry
from hyperspace_tpu_torch.obs.querylog import QueryLog, read_records

__all__ = [
    "trace",
    "metrics",
    "querylog",
    "sites",
    "registry",
    "merge_snapshots",
    "QueryLog",
    "read_records",
]
