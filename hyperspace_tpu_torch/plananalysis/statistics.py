"""IndexStatistics — the ``hs.indexes()`` / ``hs.index(name)`` tables.

Counterpart of ``hyperspace_tpu/plananalysis/statistics.py`` (reference:
``index/IndexStatistics.scala:41-60``, a summary row per index and the
extended statistics of one index, and
``IndexCollectionManager.scala:119-128,139-149``). The tables are the
reference's column for column.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from hyperspace_tpu_torch.metadata.entry import IndexLogEntry

INDEX_SUMMARY_COLUMNS = [
    "name",
    "indexedColumns",
    "includedColumns",
    "numBuckets",
    "schema",
    "indexLocation",
    "state",
]


def _summary_row(entry: IndexLogEntry) -> dict:
    index = entry.derived_dataset
    stats = index.statistics(extended=False)
    files = entry.content.files
    location = files[0].rsplit("/", 2)[0] if files else ""
    return {
        "name": entry.name,
        "indexedColumns": ",".join(index.indexed_columns),
        "includedColumns": ",".join(index.included_columns),
        "numBuckets": int(stats.get("numBuckets", 0) or 0),
        "schema": index.schema_json if hasattr(index, "schema_json") else "",
        "indexLocation": location,
        "state": entry.state,
    }


def indexes_summary_table(entries: List[IndexLogEntry]) -> pa.Table:
    rows = [_summary_row(e) for e in entries]
    return pa.table({c: [r[c] for r in rows] for c in INDEX_SUMMARY_COLUMNS})


def index_stats_table(entry: IndexLogEntry) -> pa.Table:
    """Extended statistics of one index (IndexStatistics extended mode)."""
    row = _summary_row(entry)
    extended = entry.derived_dataset.statistics(extended=True)
    row["logVersion"] = entry.id
    row["indexContentFileCount"] = len(entry.content.files)
    row["indexContentSizeInBytes"] = entry.content.size_in_bytes
    row["sourceFileCount"] = len(entry.relation.content.files)
    row["sourceSizeInBytes"] = entry.source_files_size_in_bytes
    row["additionalStats"] = str(extended)
    return pa.table({k: [v] for k, v in row.items()})
