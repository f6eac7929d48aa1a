"""The shared read-ahead pool of the pipelined serve.

Counterpart of ``hyperspace_tpu/io/scan.py``'s ``scan_pool``. The
relation-aware reader there (``read_relation_files``, which injects
partition values of hive-partitioned lake sources) comes with the Delta
and Iceberg sources (ROADMAP queue A item 6).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

# double-checked publish under the lock, lock-free reads of the
# published executor
_scan_pool = None
_scan_pool_lock = threading.Lock()


def scan_pool() -> ThreadPoolExecutor:
    """The process-wide read-ahead pool that the pipelined join serve
    submits per-bucket parquet reads to, and that row-group reads of
    several files share. Sized for I/O overlap, not CPU count: parquet
    reads spend most of their time in Arrow's own (GIL-releasing) decode
    and in storage latency. Tasks submitted here must never wait on other
    scan_pool futures (only the consuming threads wait), so the pool
    cannot deadlock."""
    global _scan_pool
    if _scan_pool is None:
        with _scan_pool_lock:
            if _scan_pool is None:
                workers = min(8, max(4, os.cpu_count() or 1))
                _scan_pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="hs-scan"
                )
    return _scan_pool
