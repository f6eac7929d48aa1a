"""Device-friendly columnar batches (SoA).

Counterpart of ``hyperspace_tpu/io/columnar.py``, held to it bit for bit.
The device data plane cannot operate on Arrow's variable-width layouts
directly: strings are dictionary-encoded at ingest (codes can move to the
device, dictionary bytes stay host-side), fixed-width columns become
numpy arrays (moved to the session's device as tensors by the ops), and
nulls become validity masks. This replaces the role Spark's
``ColumnarBatch``/``UnsafeRow`` plays under the reference's scan and shuffle
(e.g. ``index/covering/CoveringIndex.scala:56-71`` writes via Spark's row
pipeline; our equivalent pipeline consumes these batches).

Key-representation ("key rep") contract
---------------------------------------
Bucketing and sorting on device need a stable ``int64`` per value that is
*identical across files, sessions and refreshes*:

* numeric / bool / date / timestamp → the value's 64-bit pattern
  (floats via bit view so NaN groups deterministically);
* strings → murmur3-128-derived 64-bit hash of the utf-8 bytes, computed
  host-side **per dictionary entry** (O(unique), not O(rows)) then gathered
  through the codes on device;
* null → a fixed sentinel.

Equality of key reps implies equality of values except for string hash
collisions, which consumers (merge join) must verify against the actual
bytes; ordering of reps is an arbitrary-but-consistent total order, which
is all hash bucketing and sort-merge joins require.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.utils.hashing import murmur3_64_bytes

# Key rep assigned to nulls: an arbitrary-but-consistent VALUE so nulls
# bucket/sort deterministically. It is NOT a detection mechanism — a real
# int64 key may legitimately equal it, so consumers that must distinguish
# null rows (joins, group-by) read the explicit null masks
# (Column.null_mask / ColumnarBatch.null_any), never compare reps to this.
NULL_KEY_REP = np.int64(-0x7FFF_FFFF_FFFF_FF13)


def _is_string(t: pa.DataType) -> bool:
    if pa.types.is_dictionary(t):
        t = t.value_type
    return pa.types.is_string(t) or pa.types.is_large_string(t)


def flatten_schema_fields(fields):
    """Replace struct-typed fields by their scalar leaf paths as flat
    ``__hs_nested.<path>`` columns (depth-first).

    The engine's data plane is SoA over fixed-width/dictionary columns —
    struct trees cannot live on device. The reference solves the same
    problem by indexing nested fields as prefix-flattened columns
    (``util/ResolverUtils.scala:130-234``); here the flattening happens at
    relation construction, so nested leaves are first-class columns
    everywhere (planner, rules, executor) and the struct root disappears.
    Non-scalar leaves (lists, maps) are dropped — same indexing
    restriction as the reference."""
    from hyperspace_tpu_torch.constants import NESTED_FIELD_PREFIX

    def leaves(path, t):
        for i in range(t.num_fields):
            f = t.field(i)
            if "." in f.name:
                # a dot inside a field name cannot round-trip through the
                # dotted flattened name (the read path re-splits on ".");
                # drop it like other unindexable leaves
                continue
            if pa.types.is_struct(f.type):
                yield from leaves(path + "." + f.name, f.type)
            elif not pa.types.is_nested(f.type):
                # is_nested covers list/large_list/fixed_size_list/
                # list_view/map/union — none of them are scalar leaves
                yield (NESTED_FIELD_PREFIX + path + "." + f.name, f.type)

    out = []
    for name, t in fields:
        if pa.types.is_struct(t) and "." not in name:
            out.extend(leaves(name, t))
        else:
            out.append((name, t))
    return tuple(out)


@dataclasses.dataclass
class Column:
    """One column of a :class:`ColumnarBatch`.

    kind:
      * ``numeric`` — ``values`` holds the numpy array (ints/floats/bool/
        date/timestamp as their natural numpy dtype);
      * ``string`` — ``codes`` holds int32 dictionary codes (-1 = null)
        and ``dictionary`` the host-side list of Python strings.
    ``validity`` is None (no nulls) or a bool mask (True = valid).
    ``arrow_type`` preserves the logical type for lossless round-trip.
    """

    kind: str
    arrow_type: pa.DataType
    values: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    dictionary: Optional[List[str]] = None
    validity: Optional[np.ndarray] = None

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_arrow(arr: pa.ChunkedArray | pa.Array) -> "Column":
        if isinstance(arr, pa.ChunkedArray):
            # combine_chunks COPIES even with exactly one chunk, which
            # would detach a memory-mapped column from its registered
            # region — take the lone chunk's zero-copy view instead.
            arr = arr.chunk(0) if arr.num_chunks == 1 else arr.combine_chunks()
        t = arr.type
        if _is_string(t):
            atype = t.value_type if pa.types.is_dictionary(t) else t
            if not pa.types.is_dictionary(t):
                arr = arr.dictionary_encode()
            codes = arr.indices.to_numpy(zero_copy_only=False)
            codes = np.where(np.asarray(arr.indices.is_valid()), codes, -1).astype(
                np.int32
            )
            dictionary = arr.dictionary.to_pylist()
            return Column("string", atype, codes=codes, dictionary=dictionary)
        if pa.types.is_dictionary(t):
            # dictionary-of-non-string (e.g. parquet read_dictionary on an
            # int column): decode and treat as a plain fixed-width column.
            arr = arr.cast(t.value_type)
            t = arr.type
        if pa.types.is_time(t):
            # time32/time64 decode to python datetime.time objects via
            # to_numpy; go through the integer representation instead
            # (``to_arrow`` restores the logical type). ``t`` stays the
            # logical arrow_type.
            arr = arr.cast(
                pa.int32() if pa.types.is_time32(t) else pa.int64()
            )
        validity = None
        if arr.null_count:
            validity = np.asarray(arr.is_valid())
            # Fill nulls with a typed zero so to_numpy keeps the natural
            # dtype (nullable ints would otherwise decode as float64 and
            # break the cross-file key-rep stability contract). Typed by
            # arr.type, not t: time columns were just cast to ints above.
            fill = pa.scalar(
                False if pa.types.is_boolean(arr.type) else 0, type=arr.type
            )
            arr = arr.fill_null(fill)
        vals = arr.to_numpy(zero_copy_only=False)
        if vals.dtype == object:
            vals = vals.astype(_numpy_dtype_for(t))
        if vals.dtype.kind in "Mm":
            # datetime64 AND timedelta64 → int64 for device friendliness
            # (durations compare/lower through the same int64-tick path)
            vals = vals.view(np.int64)
        return Column("numeric", t, values=vals, validity=validity)

    # -- basic properties ---------------------------------------------------
    def __len__(self) -> int:
        n = self.values if self.kind == "numeric" else self.codes
        return len(n)

    @property
    def null_mask(self) -> Optional[np.ndarray]:
        """True where the value is null, or None when there are no nulls."""
        if self.kind == "string":
            if (self.codes < 0).any():
                return self.codes < 0
            return None
        if self.validity is not None:
            return ~self.validity
        return None

    # -- conversion ---------------------------------------------------------
    def to_arrow(self) -> pa.Array:
        if self.kind == "string":
            codes = self.codes
            mask = codes < 0
            safe = np.where(mask, 0, codes)
            arr = pa.DictionaryArray.from_arrays(
                pa.array(safe, type=pa.int32(), mask=mask),
                pa.array(self.dictionary, type=self.arrow_type),
            )
            return arr.cast(self.arrow_type)
        vals = self.values
        mask = None if self.validity is None else ~self.validity
        t = self.arrow_type
        if (
            pa.types.is_timestamp(t)
            or pa.types.is_date(t)
            or pa.types.is_time(t)
            or pa.types.is_duration(t)
        ):
            # stored as int64 epoch/tick units; 32-bit temporal types cast
            # via int32
            width = 32 if t in (pa.date32(), pa.time32("s"), pa.time32("ms")) else 64
            itype = pa.int32() if width == 32 else pa.int64()
            ivals = vals.astype(np.int32) if width == 32 else vals
            return pa.array(ivals, type=itype, mask=mask).cast(t)
        return pa.array(vals, type=t, mask=mask)

    def key_rep(self) -> np.ndarray:
        """Stable int64 representation for bucketing/sorting (see module
        docstring)."""
        if self.kind == "string":
            dict_reps = np.array(
                [murmur3_64_bytes(s.encode("utf-8")) for s in self.dictionary],
                dtype=np.int64,
            )
            if len(dict_reps) == 0:
                dict_reps = np.zeros(1, dtype=np.int64)
            reps = dict_reps[np.where(self.codes < 0, 0, self.codes)]
            return np.where(self.codes < 0, NULL_KEY_REP, reps)
        v = self.values
        if v.dtype.kind == "f":
            rep = v.astype(np.float64).view(np.int64)
            # canonicalize NaNs and -0.0 so equal-by-value keys group
            rep = np.where(np.isnan(v), np.int64(0x7FF8000000000000), rep)
            rep = np.where(v == 0.0, np.int64(0), rep)
        elif v.dtype.kind == "b":
            rep = v.astype(np.int64)
        elif v.dtype.kind == "u":
            rep = v.astype(np.uint64).view(np.int64)
        else:
            rep = v.astype(np.int64)
        if self.validity is not None:
            rep = np.where(self.validity, rep, NULL_KEY_REP)
        return rep

    # -- row ops ------------------------------------------------------------
    def take(self, idx: np.ndarray) -> "Column":
        if self.kind == "string":
            return Column(
                "string", self.arrow_type, codes=self.codes[idx],
                dictionary=self.dictionary,
            )
        return Column(
            "numeric",
            self.arrow_type,
            values=self.values[idx],
            validity=None if self.validity is None else self.validity[idx],
        )

    @staticmethod
    def concat(cols: Sequence["Column"]) -> "Column":
        first = cols[0]
        if len(cols) == 1:
            return first
        if first.kind == "string":
            # Re-map codes into a shared dictionary.
            merged: Dict[str, int] = {}
            parts = []
            for c in cols:
                remap = np.empty(max(len(c.dictionary), 1), dtype=np.int32)
                for i, s in enumerate(c.dictionary):
                    remap[i] = merged.setdefault(s, len(merged))
                part = np.where(c.codes < 0, -1, remap[np.maximum(c.codes, 0)])
                parts.append(part.astype(np.int32))
            return Column(
                "string",
                first.arrow_type,
                codes=np.concatenate(parts),
                dictionary=list(merged.keys()),
            )
        any_validity = any(c.validity is not None for c in cols)
        validity = (
            np.concatenate(
                [
                    c.validity
                    if c.validity is not None
                    else np.ones(len(c), dtype=bool)
                    for c in cols
                ]
            )
            if any_validity
            else None
        )
        return Column(
            "numeric",
            first.arrow_type,
            values=np.concatenate([c.values for c in cols]),
            validity=validity,
        )


def column_value_range(col: "Column"):
    """(min, max) of the column's valid values, or (None, None) when none.

    Floats are NaN-aware: NaN rows are excluded from the range entirely.
    This matches the engine's comparison semantics (IEEE): a NaN row can
    never satisfy an =, range or IN predicate, so excluding it from
    min/max sketches is exact, not approximate. (Spark instead orders NaN
    greatest; the engine diverges deliberately and consistently.) Strings
    use lexical order over present dictionary entries.
    """
    if col.kind == "string":
        mask = col.codes >= 0
        if not mask.any():
            return None, None
        present = sorted({col.dictionary[c] for c in col.codes[mask]})
        return present[0], present[-1]
    v = col.values
    if col.validity is not None:
        v = v[col.validity]
    if len(v) and v.dtype.kind == "f":
        v = v[~np.isnan(v)]
    if len(v) == 0:
        return None, None
    return v.min().item(), v.max().item()


def open_mmap_table(path: str) -> pa.Table:
    """Zero-copy memory-mapped read of an Arrow IPC file: the table's
    buffers are views into the OS file mapping, not heap copies, and the
    mapping is registered with the serve cache's residency accounting
    (``execution/serve_cache.register_mapped_region``), so
    ``estimate_nbytes`` charges these columns as file-backed views. The
    region unregisters itself when the table is collected."""
    import pyarrow.ipc as ipc

    from hyperspace_tpu_torch.execution.serve_cache import register_mapped_region

    source = pa.memory_map(path, "r")
    size = source.size()
    buf = source.read_buffer(size) if size else None
    table = ipc.open_file(source).read_all()
    if buf is not None and buf.size:
        register_mapped_region(buf.address, buf.size, owner=table)
    return table


def remap_codes(target_dictionary: List[str], col: "Column") -> np.ndarray:
    """A string column's codes re-expressed in another dictionary's space.

    Entries absent from ``target_dictionary`` map to -2, nulls to -3, so
    the result is directly comparable against the target column's codes
    (equal ⟺ same non-null string). Shared by cross-column string equality
    (plan/expressions) and join key verification (execution/join_exec).
    """
    lut = {s: i for i, s in enumerate(target_dictionary)}
    remap = np.array(
        [lut.get(s, -2) for s in col.dictionary] or [-2], dtype=np.int64
    )
    return np.where(col.codes < 0, -3, remap[np.maximum(col.codes, 0)])


def _numpy_dtype_for(t: pa.DataType):
    try:
        return t.to_pandas_dtype()
    except (NotImplementedError, TypeError):
        # pyarrow has no numpy analogue for this type (decimal, nested…)
        return np.int64


class ColumnarBatch:
    """Ordered name → :class:`Column` mapping with row-aligned columns."""

    def __init__(self, columns: Dict[str, Column]):
        self.columns: Dict[str, Column] = dict(columns)
        lens = {len(c) for c in self.columns.values()}
        if len(lens) > 1:
            raise HyperspaceException(f"Ragged columnar batch: lengths {lens}")

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_arrow(table: pa.Table) -> "ColumnarBatch":
        return ColumnarBatch(
            {name: Column.from_arrow(table.column(name)) for name in table.column_names}
        )

    def to_arrow(self) -> pa.Table:
        return pa.table({n: c.to_arrow() for n, c in self.columns.items()})

    # -- properties ---------------------------------------------------------
    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> Column:
        if name not in self.columns:
            raise HyperspaceException(
                f"Column {name!r} not in batch ({self.column_names})"
            )
        return self.columns[name]

    # -- ops ----------------------------------------------------------------
    def select(self, names: Sequence[str]) -> "ColumnarBatch":
        return ColumnarBatch({n: self.column(n) for n in names})

    def with_column(self, name: str, col: Column) -> "ColumnarBatch":
        d = dict(self.columns)
        d[name] = col
        return ColumnarBatch(d)

    def take(self, idx: np.ndarray) -> "ColumnarBatch":
        return ColumnarBatch({n: c.take(idx) for n, c in self.columns.items()})

    def filter(self, mask: np.ndarray) -> "ColumnarBatch":
        return self.take(np.nonzero(np.asarray(mask))[0])

    def key_reps(self, names: Sequence[str]) -> np.ndarray:
        """[num_keys, num_rows] int64 key representations."""
        return np.stack([self.column(n).key_rep() for n in names])

    def null_any(self, names: Sequence[str]) -> np.ndarray:
        """[num_rows] bool: True where ANY named column is null. The
        correct null-row detector for join semantics (reps encode null as
        an in-band value; see NULL_KEY_REP)."""
        out = np.zeros(self.num_rows, dtype=bool)
        for n in names:
            m = self.column(n).null_mask
            if m is not None:
                out |= m
        return out

    @staticmethod
    def concat(batches: Sequence["ColumnarBatch"]) -> "ColumnarBatch":
        if not batches:
            raise HyperspaceException("Cannot concat zero batches")
        non_empty = [b for b in batches if b.num_rows]
        batches = non_empty or [batches[0]]
        names = batches[0].column_names
        for b in batches[1:]:
            if b.column_names != names:
                raise HyperspaceException(
                    f"Schema mismatch in concat: {names} vs {b.column_names}"
                )
        return ColumnarBatch(
            {n: Column.concat([b.column(n) for b in batches]) for n in names}
        )
