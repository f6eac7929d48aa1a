"""Min/max layout-quality analysis.

Counterpart of ``hyperspace_tpu/plananalysis/minmax_analysis.py`` (the
reference's ``util/MinMaxAnalysisUtil.scala:30-780``), host code over
footers and numpy:
for each requested column, collect per-FILE min/max, then measure how many
files a point lookup on that column would have to touch — the figure of
merit for physical layout quality (z-ordering, clustering, partitioning).
A perfectly clustered column touches 1 file per point lookup; a randomly
laid-out column touches all of them.

The reference line-sweeps start/end markers with Catalyst orderings and
renders an ASCII histogram; here the sweep is vectorized numpy over the
per-file [min, max] intervals (closed-interval overlap, ties inclusive —
matching the reference's start-before-end tie sort). Non-numeric columns
are skipped with a note, like the reference.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.plan.nodes import Scan


@dataclasses.dataclass
class MinMaxColumnResult:
    column: str
    min_val: Optional[float]
    max_val: Optional[float]
    total_files: int
    total_bytes: int
    # per value-bin: number of files whose [min,max] intersects the bin
    bin_file_counts: List[int]
    max_files_per_lookup: int  # exact (computed at interval endpoints)
    avg_files_per_lookup: float
    max_bytes_per_lookup: int

    def to_text(self) -> str:
        lines = [f"Column: {self.column}"]
        if self.min_val is None:
            lines += [
                "  all values null",
                f"  Total num of files: {self.total_files}",
                f"  Total byte size of files: {self.total_bytes}",
            ]
            return "\n".join(lines)
        pct_max = 100.0 * self.max_files_per_lookup / max(self.total_files, 1)
        pct_avg = 100.0 * self.avg_files_per_lookup / max(self.total_files, 1)
        pct_bytes = 100.0 * self.max_bytes_per_lookup / max(self.total_bytes, 1)
        lines += [
            f"  min: {self.min_val}  max: {self.max_val}",
            f"  Total num of files: {self.total_files}",
            f"  Total byte size of files: {self.total_bytes}",
            f"  Max files for a point lookup: {self.max_files_per_lookup}"
            f" ({pct_max:.2f}%)",
            f"  Avg files for a point lookup: {self.avg_files_per_lookup:.2f}"
            f" ({pct_avg:.2f}%)",
            f"  Max bytes for a point lookup: {self.max_bytes_per_lookup}"
            f" ({pct_bytes:.2f}%)",
        ]
        if self.bin_file_counts:
            peak = max(self.bin_file_counts) or 1
            width = 40
            lines.append("  files touched per value range:")
            for i, c in enumerate(self.bin_file_counts):
                bar = "#" * max(1 if c else 0, round(width * c / peak))
                lines.append(f"  [{i:3d}] {c:6d} |{bar}")
        return "\n".join(lines)


def _stat_to_float(v) -> float:
    """Float image of a parquet-statistics value (logical types arrive as
    python date/datetime objects). Scale only needs to be consistent
    WITHIN a column: footer and data paths are never mixed per column."""
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        return float(np.datetime64(v, "us").view("int64"))
    if isinstance(v, _dt.date):
        return float(np.datetime64(v, "D").view("int64"))
    if isinstance(v, _dt.time):
        return float(
            ((v.hour * 60 + v.minute) * 60 + v.second) * 10**6 + v.microsecond
        )
    return _norm(v)


def _footer_ranges(files, column: str, metadata_cache: Dict[str, object]):
    """Per-file (lo, hi) from parquet row-group statistics, or None when
    any file lacks min/max stats for the column (caller falls back to a
    data read for the whole column — scales must not mix). Entries are
    None for all-null files. ``metadata_cache`` holds each file's parsed
    footer so N analyzed columns cost one footer parse per file, not N."""
    import pyarrow.parquet as pq

    out = []
    for f in files:
        md = metadata_cache.get(f)
        if md is None:
            md = pq.ParquetFile(f).metadata
            metadata_cache[f] = md
        lo = hi = None
        for rg in range(md.num_row_groups):
            row_group = md.row_group(rg)
            cc = None
            for ci in range(row_group.num_columns):
                c = row_group.column(ci)
                if c.path_in_schema == column:
                    cc = c
                    break
            if cc is None:
                return None
            st = cc.statistics
            if st is None or not st.has_min_max:
                if cc.num_values == 0 or (
                    st is not None and st.null_count == row_group.num_rows
                ):
                    continue  # empty / all-null row group
                return None
            mn, mx = _stat_to_float(st.min), _stat_to_float(st.max)
            lo = mn if lo is None else min(lo, mn)
            hi = mx if hi is None else max(hi, mx)
        out.append(None if lo is None else (lo, hi))
    return out


def _norm(x) -> float:
    """Finite float image of a column value (NaN never reaches here —
    column_value_range excludes NaN rows, matching engine comparison
    semantics)."""
    f = float(x)
    if np.isposinf(f):
        return float(np.finfo(np.float64).max)
    if np.isneginf(f):
        return float(np.finfo(np.float64).min)
    return 0.0 if f == 0.0 else f


def _is_numeric_like(t: pa.DataType) -> bool:
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_boolean(t)
        or pa.types.is_temporal(t)
    )


def analyze_column(
    column: str,
    intervals: List[Tuple[float, float]],
    sizes: List[int],
    total_files: int,
    total_bytes: int,
    num_bins: int = 50,
) -> MinMaxColumnResult:
    """Overlap analysis over per-file [min,max] intervals (all-null files
    excluded by the caller)."""
    if not intervals:
        return MinMaxColumnResult(
            column, None, None, total_files, total_bytes, [], 0, 0.0, 0
        )
    lo = np.array([a for a, _ in intervals])
    hi = np.array([b for _, b in intervals])
    sz = np.array(sizes, dtype=np.int64)
    vmin, vmax = float(lo.min()), float(hi.max())
    # exact max overlap via an O(F log F) line sweep (the reference's
    # start/end marker sort): +1 at each min, -1 after each max; at equal
    # coordinates starts process first so closed intervals sharing an
    # endpoint both count (reference tie order: start before end).
    coords = np.concatenate([lo, hi])
    kinds = np.concatenate(
        [np.zeros(len(lo), np.int8), np.ones(len(hi), np.int8)]
    )
    deltas = np.concatenate([np.ones(len(lo), np.int64), -np.ones(len(hi), np.int64)])
    byte_deltas = np.concatenate([sz, -sz])
    order = np.lexsort((kinds, coords))
    max_files = int(np.cumsum(deltas[order]).max())
    max_bytes = int(np.cumsum(byte_deltas[order]).max())
    # value-range histogram: bin overlap counts (display + avg)
    if vmax > vmin:
        edges = np.linspace(vmin, vmax, num_bins + 1)
        starts, ends = edges[:-1], edges[1:]
        overlap = (lo[None, :] <= ends[:, None]) & (starts[:, None] <= hi[None, :])
        counts = overlap.sum(axis=1).astype(int).tolist()
    else:
        counts = [len(intervals)]
    nonzero = [c for c in counts if c > 0]
    avg = float(sum(nonzero) / len(nonzero)) if nonzero else 0.0
    return MinMaxColumnResult(
        column,
        vmin,
        vmax,
        total_files,
        total_bytes,
        counts,
        max_files,
        avg,
        max_bytes,
    )


def analyze_min_max(
    df, columns: Sequence[str], num_bins: int = 50
) -> List[MinMaxColumnResult]:
    """Per-column layout analysis of a DataFrame's underlying files
    (reference: ``MinMaxAnalysisUtil.analyze(df, cols)``)."""
    leaves = [p for p in df.logical_plan.collect_leaves() if isinstance(p, Scan)]
    if len(leaves) != 1:
        raise HyperspaceException(
            "min/max analysis needs a single-relation DataFrame"
        )
    from hyperspace_tpu_torch.io.columnar import Column, column_value_range

    rel = leaves[0].relation
    schema = rel.schema
    file_sizes = {f: os.path.getsize(f) for f in rel.files}
    total_bytes = sum(file_sizes.values())
    for c in columns:
        if c not in rel.column_names:
            raise HyperspaceException(f"No such column {c!r}")
    numeric_cols = [c for c in columns if _is_numeric_like(schema[c])]
    ranges: Dict[str, List[Tuple[float, float]]] = {c: [] for c in numeric_cols}
    sizes: Dict[str, List[int]] = {c: [] for c in numeric_cols}
    # footer-statistics fast path (no data read) for non-float columns of
    # parquet-like sources; floats need the NaN-aware data read (parquet
    # float stats are writer-dependent around NaN)
    data_cols = []
    footer_md_cache: Dict[str, object] = {}
    for c in numeric_cols:
        footer = None
        if rel.fmt in ("parquet", "delta", "iceberg") and not (
            pa.types.is_floating(schema[c])
        ):
            footer = _footer_ranges(rel.files, c, footer_md_cache)
        if footer is None:
            data_cols.append(c)
            continue
        for f, rng in zip(rel.files, footer):
            if rng is None:
                continue  # all-null file
            ranges[c].append(rng)
            sizes[c].append(file_sizes[f])
    # one read per file for the remaining columns (not one per column)
    if data_cols:
        for f in rel.files:
            t = pio.read_table([f], data_cols, rel.fmt)
            for c in data_cols:
                lo, hi = column_value_range(Column.from_arrow(t.column(c)))
                if lo is None:
                    continue  # all null/NaN in this file
                ranges[c].append((_norm(lo), _norm(hi)))
                sizes[c].append(file_sizes[f])
    results = []
    for c in columns:
        if c not in ranges:
            results.append(
                MinMaxColumnResult(
                    c + " (skipped: non-numeric)",
                    None,
                    None,
                    len(rel.files),
                    total_bytes,
                    [],
                    0,
                    0.0,
                    0,
                )
            )
            continue
        results.append(
            analyze_column(
                c, ranges[c], sizes[c], len(rel.files), total_bytes, num_bins
            )
        )
    return results


def analyze_min_max_string(df, columns: Sequence[str], num_bins: int = 50) -> str:
    return "\n\n".join(r.to_text() for r in analyze_min_max(df, columns, num_bins))
