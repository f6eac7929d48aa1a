"""Relation-aware file scanning and the shared read-ahead pool of the
pipelined serve.

Counterpart of ``hyperspace_tpu/io/scan.py``. ``read_relation_files``
handles hive-partitioned lake sources (partition column values live in the
source metadata — Delta's ``add.partitionValues`` — not in the data files)
by injecting per-file constants, the role Spark's
``PartitioningAwareFileIndex`` plays for the reference.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import pyarrow as pa

from hyperspace_tpu_torch.io import parquet as pio

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


def read_relation_files(
    relation, files: Sequence[str], columns: Optional[Sequence[str]]
) -> pa.Table:
    """Read ``files`` of ``relation`` projecting ``columns`` (None = all),
    injecting partition-value constants where the relation carries them.
    As in the reference, no caller reads through it yet (ROADMAP C.15)."""
    pv = dict(relation.file_partition_values)
    want = list(columns) if columns is not None else relation.column_names
    if not pv:
        return pio.read_table(list(files), want, relation.fmt)
    schema = relation.schema
    tables = []
    for f in files:
        vals = dict(pv.get(f, ()))
        data_cols = [c for c in want if c not in vals]
        part_cols = [c for c in want if c in vals]
        if data_cols:
            t = pio.read_table([f], data_cols, relation.fmt)
            n = t.num_rows
        else:
            # only partition columns requested: still need the row count
            t = pio.read_table([f], None, relation.fmt)
            n = t.num_rows
            t = t.select([])
        for c in part_cols:
            v = vals[c]
            arr = pa.array([v] * n, type=pa.string()).cast(schema[c])
            t = t.append_column(c, arr)
        tables.append(t.select(want))
    return pa.concat_tables(tables, promote_options="permissive")
