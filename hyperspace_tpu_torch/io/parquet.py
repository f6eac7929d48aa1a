"""Parquet read/write (host side, Arrow).

The reference reads/writes through Spark's datasource machinery
(``index/DataFrameWriterExtensions.scala:50-80`` for the bucketed index
write, ``FileSourceScanExec`` for reads). Here the host does Arrow I/O and
hands SoA batches to the device ops; the bucketed write emits **one parquet
file per bucket** named like Spark's bucketed layout
(``part-<fileidx>-…_<bucket>.c000.parquet``) so bucket ids are recoverable
from file names at query time (the reference relies on
``BucketingUtils.getBucketId``, ``actions/OptimizeAction.scala:110``).
"""

from __future__ import annotations

import functools as _functools
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pyarrow.parquet as pq

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnarBatch
from hyperspace_tpu_torch.testing import faults

_BUCKET_FILE_RE = re.compile(r"part-\d+-bucket_(\d+)\.parquet$")

#: formats whose data files are parquet: plain parquet and the lake tables
#: (Delta and Iceberg data files are parquet)
PARQUET_FAMILY = ("parquet", "delta", "iceberg")


def _pool_map(fn, items):
    """Footer-metadata reads through a small thread pool (high-latency
    storage pays per-call latency N times otherwise)."""
    if len(items) <= 4:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(16, len(items))) as pool:
        return list(pool.map(fn, items))


def _file_schemas(paths: Sequence[str]) -> List[pa.Schema]:
    return _pool_map(lambda p: pq.ParquetFile(p).schema_arrow, list(paths))


def file_row_counts(paths: Sequence[str]) -> List[int]:
    """Per-file row counts from parquet footers (threaded)."""
    return _pool_map(lambda p: pq.ParquetFile(p).metadata.num_rows, list(paths))


def read_tables(
    paths: Sequence[str], columns: Sequence[str], fmt: str = "parquet",
    memory_map: bool = False,
) -> List[pa.Table]:
    """One table per file, in ``paths`` order (each file's rows in file
    order), read on a small thread pool: the per-bucket reads of a
    bucketed index scan. Files that carry every column literally (index
    data does) are read directly, without a dataset per file;
    ``memory_map`` maps them (``read_table``)."""
    paths = list(paths)
    if (
        fmt not in PARQUET_FAMILY
        or not paths
        or _resolve_nested_columns(paths, columns, fmt)[1]
    ):
        return _pool_map(lambda p: read_table([p], columns, fmt, memory_map=memory_map), paths)
    faults.check("parquet_read", paths)
    return _pool_map(
        lambda p: pq.ParquetFile(p, memory_map=memory_map).read(columns=list(columns)), paths
    )


def _literal_column_names(path: str) -> frozenset:
    """Top-level column names of one parquet file, memoized by the file's
    identity (path, size, mtime_ns) — per-file read loops with nested
    columns would otherwise re-parse the same immutable footer per call."""
    st = os.stat(path)
    return _literal_column_names_cached(path, st.st_size, st.st_mtime_ns)


@_functools.lru_cache(maxsize=4096)
def _literal_column_names_cached(path, _size, _mtime_ns) -> frozenset:
    return frozenset(pq.read_schema(path).names)


def _resolve_nested_columns(paths, columns, fmt):
    """Split requested columns into (physical read list, extraction plan).

    A ``__hs_nested.``-prefixed column is VIRTUAL when the file does not
    carry it as a literal flat column (source tables store the struct;
    index data files store the literal flattened column — reference
    ``util/ResolverUtils.scala:130-234``): the struct ROOT is read instead
    and the leaf extracted post-read. Returns (read_cols, extract) where
    extract maps output name -> (root, leaf_path); extract is empty when
    nothing is virtual."""
    from hyperspace_tpu_torch.constants import NESTED_FIELD_PREFIX

    prefixed = [c for c in columns if c.startswith(NESTED_FIELD_PREFIX)]
    if not prefixed:
        return list(columns), {}
    virtual = prefixed
    if fmt in PARQUET_FAMILY:
        literal = _literal_column_names(paths[0])
        virtual = [c for c in prefixed if c not in literal]
    if not virtual:
        return list(columns), {}
    extract = {}
    read_cols = [c for c in columns if c not in virtual]
    for c in virtual:
        parts = c[len(NESTED_FIELD_PREFIX):].split(".")
        extract[c] = (parts[0], parts[1:])
        if parts[0] not in read_cols:
            read_cols.append(parts[0])
    return read_cols, extract


def read_table(
    paths: Sequence[str],
    columns: Optional[Sequence[str]] = None,
    fmt: str = "parquet",
    filters=None,
    memory_map: bool = False,
) -> pa.Table:
    """Read and concatenate files into one Arrow table (row order follows
    ``paths`` order, file by file). Parquet, Delta and Iceberg data files
    are read as parquet; csv and json through pyarrow's readers with their
    default options (types inferred as the reference infers them), orc
    through pyarrow, text as Spark's one string column ``value``, avro
    through ``utils/avro.py`` typed by its embedded schema.

    ``memory_map`` (parquet-like formats, ``hyperspace.io.mmap.enabled``)
    has pyarrow map the files instead of reading them onto the heap; the
    rows are the same either way.

    ``filters`` (parquet-like formats only) is a pyarrow DNF conjunction.
    REQUIRED INVARIANT: each
    pushed conjunct must keep a **row-level superset** of the rows the
    engine's own mask keeps — pyarrow applies filters per ROW, so a
    conjunct that is only row-group-safe would silently drop matching
    rows. The executor re-applies the full mask afterwards.

    ``__hs_nested.``-prefixed columns that are not literal flat columns
    in the files are served by reading the struct root and extracting
    the leaf (``_resolve_nested_columns``)."""
    # fault-injection seam (testing/faults.py "parquet_read"): every data
    # read funnels through here, read_tables or read_file_row_groups
    faults.check("parquet_read", paths)
    if columns:
        read_cols, extract = _resolve_nested_columns(paths, columns, fmt)
        if extract:
            import pyarrow.compute as pc

            if filters:
                # a filter on a virtual column has no physical column to
                # act on; dropping conjuncts is superset-safe by contract
                filters = [
                    f for f in filters if f[0] not in extract
                ] or None
            t = read_table(paths, read_cols, fmt, filters, memory_map)
            out = {}
            for c in columns:
                if c in extract:
                    root, leaf_path = extract[c]
                    out[c] = pc.struct_field(t.column(root), leaf_path)
                else:
                    out[c] = t.column(c)
            return pa.table(out)
    if fmt in PARQUET_FAMILY and len(paths) > 1:
        # One threaded dataset read beats N sequential reads and keeps the
        # given file order — but it locks the first file's schema, so it
        # is only safe when all schemas match (always true for index
        # data; source tables may widen types across files).
        schemas = _file_schemas(paths)
        if all(s.equals(schemas[0]) for s in schemas[1:]):
            # partitioning=None: explicit file lists; hive inference would
            # read the index version dirs (v__=N) as a partition column
            return pq.read_table(
                list(paths),
                columns=list(columns) if columns else None,
                filters=filters,
                partitioning=None,
                memory_map=memory_map,
            )
    tables = []
    for p in paths:
        if fmt in PARQUET_FAMILY:
            tables.append(
                pq.read_table(
                    p,
                    columns=list(columns) if columns else None,
                    filters=filters,
                    partitioning=None,
                    memory_map=memory_map,
                )
            )
        elif fmt == "csv":
            t = pacsv.read_csv(p)
            tables.append(t.select(list(columns)) if columns else t)
        elif fmt == "json":
            t = pajson.read_json(p)
            tables.append(t.select(list(columns)) if columns else t)
        elif fmt == "orc":
            from pyarrow import orc as paorc

            t = paorc.read_table(p, columns=list(columns) if columns else None)
            tables.append(t)
        elif fmt == "text":
            # Spark's text source shape: one string column named `value`
            with open(p, "r", encoding="utf-8") as fh:
                lines = fh.read().splitlines()
            t = pa.table({"value": pa.array(lines, type=pa.string())})
            tables.append(t.select(list(columns)) if columns else t)
        elif fmt == "avro":
            from hyperspace_tpu_torch.utils.avro import read_avro_with_schema

            avro_schema, records = read_avro_with_schema(p)
            arrow_schema = _avro_to_arrow_schema(avro_schema)
            if arrow_schema is not None:
                t = pa.Table.from_pylist(list(records), schema=arrow_schema)
            else:  # non-record / exotic top-level schema: infer from values
                t = pa.Table.from_pylist(list(records))
            tables.append(t.select(list(columns)) if columns else t)
        else:
            raise HyperspaceException(f"Unsupported format: {fmt}")
    if not tables:
        raise HyperspaceException("No files to read")
    return pa.concat_tables(tables, promote_options="permissive")


def read_batch(
    paths: Sequence[str], columns: Optional[Sequence[str]] = None, fmt: str = "parquet"
) -> ColumnarBatch:
    # Convenience wrapper for out-of-package tooling: the actual
    # materializations happen in read_table / ColumnarBatch.from_arrow,
    # both registered ALLOC_SITES; the bound is the caller's selection.
    # hslint: disable=HS1001
    return ColumnarBatch.from_arrow(read_table(paths, columns, fmt))


def read_table_row_groups(
    paths: Sequence[str],
    row_groups: Sequence[Optional[Sequence[int]]],
    columns: Optional[Sequence[str]] = None,
    fmt: str = "parquet",
) -> pa.Table:
    """Row-group-granular read: per file, only the listed row groups (None
    = the whole file), concatenated in ``paths`` order — the read half of
    zone-map pruning (``executor._range_pruned_scan``). Row order within
    a file follows ascending row-group index, which is the file's own row
    order, so a selection of ALL groups equals ``read_table``. Reads
    overlap on the shared scan pool (``io/scan.scan_pool``) when more than
    one file needs opening; parquet-like formats only (callers gate on
    fmt)."""
    if fmt not in PARQUET_FAMILY:
        raise HyperspaceException(
            f"Row-group reads require a parquet-like format, got {fmt!r}"
        )
    cols = list(columns) if columns else None
    pairs = list(zip(paths, row_groups))
    if len(pairs) <= 1:
        tables = [read_file_row_groups(p, g, cols) for p, g in pairs]
    else:
        from hyperspace_tpu_torch.io.scan import scan_pool

        futs = [scan_pool().submit(read_file_row_groups, p, g, cols) for p, g in pairs]
        tables = [f.result() for f in futs]
    if not tables:
        raise HyperspaceException("No files to read")
    return pa.concat_tables(tables, promote_options="permissive")


def read_file_row_groups(
    path: str, groups: Optional[Sequence[int]], cols: Optional[List[str]]
) -> pa.Table:
    """ONE file's row groups (None = the whole file, () = zero rows with
    the right schema): the per-file unit of :func:`read_table_row_groups`."""
    faults.check("parquet_read", path)
    pf = pq.ParquetFile(path)
    if groups is None:
        return pf.read(columns=cols)
    if len(groups) == 0:
        return pf.schema_arrow.empty_table().select(
            cols if cols is not None else pf.schema_arrow.names
        )
    return pf.read_row_groups(list(groups), columns=cols)


def list_format_files(root: str, fmt: str = "parquet") -> List[str]:
    """Leaf data files of a dataset directory (recursive, with the same
    hidden-path filtering Spark's ``DataPathFilter`` applies)."""
    from hyperspace_tpu_torch.utils.files import list_leaf_files

    ext = {
        "parquet": ".parquet",
        "csv": ".csv",
        "json": ".json",
        "orc": ".orc",
        "avro": ".avro",
        "text": ".txt",
    }[fmt]
    return sorted(p for p, _s, _m in list_leaf_files(root, suffix=ext, data_only=True))


def _avro_to_arrow_schema(avro_schema) -> Optional[pa.Schema]:
    """Arrow schema from an Avro record schema (embedded-schema-driven
    typing, so empty/all-null files concat cleanly with siblings). Returns
    None when the top level is not a record or a field type is beyond the
    primitive/union-with-null set (caller falls back to value inference)."""
    prim = {
        "boolean": pa.bool_(),
        "int": pa.int32(),
        "long": pa.int64(),
        "float": pa.float32(),
        "double": pa.float64(),
        "bytes": pa.binary(),
        "string": pa.string(),
    }

    def field_type(t):
        if isinstance(t, list):  # union: only [null, prim] shapes
            non_null = [x for x in t if x != "null"]
            if len(non_null) != 1:
                return None
            return field_type(non_null[0])
        if isinstance(t, str):
            return prim.get(t)
        return None

    if not isinstance(avro_schema, dict) or avro_schema.get("type") != "record":
        return None
    fields = []
    for f in avro_schema.get("fields", []):
        at = field_type(f["type"])
        if at is None:
            return None
        fields.append(pa.field(f["name"], at))
    return pa.schema(fields)


def has_glob_magic(path: str) -> bool:
    """True when the path is a glob pattern (single home of the
    magic-character rule — session reader and expansion must agree)."""
    return any(ch in path for ch in "*?[")


def expand_path(path: str, fmt: str) -> List[str]:
    """Data files for one reader path: a file, a directory, or a glob
    pattern (the reference validates globbed roots against their current
    expansion, DefaultFileBasedRelation.scala:159-187 — keeping the
    PATTERN as the root path and re-expanding on every listing gives the
    same always-current semantics)."""
    import glob as _glob
    import os

    if has_glob_magic(path):
        out: List[str] = []
        for m in sorted(_glob.glob(path)):
            if os.path.isfile(m):
                out.append(m)
            else:
                out.extend(list_format_files(m, fmt))
        return out
    if os.path.isfile(path):
        return [path]
    return list_format_files(path, fmt)


def bucket_file_name(file_idx: int, bucket: int) -> str:
    return f"part-{file_idx:05d}-bucket_{bucket:05d}.parquet"


def bucket_id_of_file(path: str) -> Optional[int]:
    m = _BUCKET_FILE_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def bucket_runs(bucket_ids: np.ndarray):
    """Yield ``(bucket_id, row_indices)`` per distinct bucket id.

    bucket_ids need not be globally sorted (shards interleave); runs are
    found via one stable argsort, and each run's indices are re-sorted
    ascending so rows keep their (key-sorted) relative order."""
    if len(bucket_ids) == 0:
        return
    order = np.argsort(bucket_ids, kind="stable")
    sorted_ids = bucket_ids[order]
    boundaries = np.nonzero(np.diff(sorted_ids))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(sorted_ids)]])
    for s, e in zip(starts, ends):
        yield int(sorted_ids[s]), np.sort(order[s:e])


# Row-group size for index data files. Bucket files are KEY-SORTED, so
# each row group's min/max statistics cover a narrow key range — the
# serve-side predicate pushdown (executor._pushdown_filters) then reads
# only the row group(s) a point lookup can touch. Smaller groups prune
# tighter but cost more metadata; 64k rows balances both.
INDEX_ROW_GROUP_SIZE = 1 << 16


_DICT_SAMPLE_ROWS = 4096


def _dictionary_columns(table: pa.Table):
    """Columns that should keep parquet dictionary encoding.

    For HIGH-cardinality numeric columns (index keys) dictionary encoding
    is pure CPU overhead — pyarrow builds the dictionary, overflows it,
    and falls back — measured 2.4x slower writes at identical file size.
    But LOW-cardinality numerics (dates, flags, quantities) genuinely
    shrink under RLE_DICTIONARY (~2x on such columns), so the opt-out is
    gated on sampled cardinality: a column keeps dictionary encoding when
    a STRIDED sample repeats values at least 4x. The stride matters —
    index tables arrive key-sorted, so a prefix sample would see only the
    clustered duplicates of the first few keys and re-enable dictionary
    encoding for globally high-cardinality columns. Strings/binary always
    keep it."""
    cols = []
    n = table.num_rows
    sample_idx = None
    if n > _DICT_SAMPLE_ROWS:
        sample_idx = pa.array(
            np.linspace(0, n - 1, _DICT_SAMPLE_ROWS).astype(np.int64)
        )
    for i, f in enumerate(table.schema):
        if (
            pa.types.is_string(f.type)
            or pa.types.is_large_string(f.type)
            or pa.types.is_binary(f.type)
            or pa.types.is_dictionary(f.type)
        ):
            cols.append(f.name)
            continue
        if n == 0:
            continue
        col = table.column(i)
        sample = col.take(sample_idx) if sample_idx is not None else col
        try:
            distinct = len(sample.unique())
        except pa.ArrowNotImplementedError:
            continue
        if distinct * 4 <= len(sample):
            cols.append(f.name)
    return cols if cols else False


def dictionary_columns_for_batch(batch: ColumnarBatch):
    """The dictionary-encoding decision of ``_dictionary_columns``
    computed from a strided sample of a :class:`ColumnarBatch` in its
    CURRENT row order — computed on the pre-sort input, as the reference
    does, so both packages' bucket files stay byte-identical."""
    n = batch.num_rows
    if n > _DICT_SAMPLE_ROWS:
        idx = np.linspace(0, n - 1, _DICT_SAMPLE_ROWS).astype(np.int64)
        batch = batch.take(idx)
    return _dictionary_columns(batch.to_arrow())


def write_bucket_file(
    out_dir: str,
    bucket: int,
    file_idx_offset: int,
    table: pa.Table,
    idx: np.ndarray,
    use_dictionary,
) -> str:
    """One bucket's parquet file from rows ``idx`` of ``table`` — the
    per-bucket unit of work of :func:`write_bucket_files`."""
    path = os.path.join(out_dir, bucket_file_name(file_idx_offset + bucket, bucket))
    # crash seam (testing/faults.py "mid_data_write", at=N picks the Nth
    # file): a build that dies here leaves a partly written version dir
    # under a transient log entry, the orphans recovery's GC quarantines
    faults.crash("mid_data_write", path)
    if (
        len(idx)
        and len(idx) == int(idx[-1]) - int(idx[0]) + 1
        and bool(np.all(idx[1:] > idx[:-1]))
    ):
        # contiguous ascending run (the globally sorted layout):
        # zero-copy slice instead of a gather. The span test alone is not
        # enough — a permutation of a span is not the span.
        sub = table.slice(int(idx[0]), len(idx))
    else:
        sub = table.take(pa.array(idx))
    pq.write_table(
        sub,
        path,
        row_group_size=INDEX_ROW_GROUP_SIZE,
        use_dictionary=use_dictionary,
    )
    return path


def write_bucket_files(
    out_dir: str,
    bucket_ids: np.ndarray,
    batch: ColumnarBatch,
    num_buckets: int,
    file_idx_offset: int = 0,
    use_dictionary=None,
) -> List[str]:
    """Write rows (already grouped by bucket and key-sorted, see
    ``ops/sort.py``) as one parquet file per non-empty bucket.
    ``use_dictionary`` overrides the per-table encoding decision (the
    build passes one decision computed on the pre-sort input, as the
    reference does, so both packages emit identical bytes)."""
    os.makedirs(out_dir, exist_ok=True)
    table = batch.to_arrow()
    use_dict = (
        _dictionary_columns(table) if use_dictionary is None else use_dictionary
    )
    written = []
    for b, idx in bucket_runs(bucket_ids):
        written.append(
            write_bucket_file(
                out_dir, b, file_idx_offset, table, idx, use_dict
            )
        )
    return written


def write_table(path: str, table: pa.Table) -> None:
    """One index data file with the bucket files' 64k-row groups and the
    encoding decision made on ``table`` itself (the z-order index's files;
    the reference's ``write_table``)."""
    faults.crash("mid_data_write", path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(
        table,
        path,
        row_group_size=INDEX_ROW_GROUP_SIZE,
        use_dictionary=_dictionary_columns(table),
    )
