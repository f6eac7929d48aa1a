"""Sketches for the data-skipping index.

Counterpart of ``hyperspace_tpu/indexes/sketches.py`` (reference:
``dataskipping/sketches/`` — ``Sketch.scala:36-119``, the
expressions/aggregate/convertPredicate contract; ``MinMaxSketch.scala``,
range pruning for =, <, <=, >, >= and IN; ``BloomFilterSketch.scala``,
membership pruning for = and IN; ``PartitionSketch.scala``,
constant-per-file columns). A sketch aggregates one source file into a
few cells of the sketch table and converts query conjuncts into
keep-masks over its rows.

The Bloom filter sketch runs kernel B7 (``ops/bloom.py``) on the device
it is handed: once a source file at create (the filter's packed words)
and once a probed conjunct (the literal reps' bit indices). A kernel
fault raises; it never turns into an abstention (``None``), which would
hide the kernel behind a plan that is simply not rewritten.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnarBatch, column_value_range
from hyperspace_tpu_torch.ops import bloom
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.utils.hashing import murmur3_64_bytes

_SKETCH_REGISTRY: Dict[str, Type["Sketch"]] = {}


def register_sketch(cls):
    _SKETCH_REGISTRY[cls.kind] = cls
    return cls


def sketch_from_dict(d: dict) -> "Sketch":
    cls = _SKETCH_REGISTRY.get(d.get("type"))
    if cls is None:
        raise HyperspaceException(f"Unknown sketch kind: {d.get('type')!r}")
    return cls.from_dict(d)


def _col_matches(expr: E.Expr, column: str) -> bool:
    """``expr`` is a reference to ``column`` (case-insensitively)."""
    return isinstance(expr, E.Col) and expr.name.lower() == column.lower()


class Sketch:
    kind = "Sketch"

    def __init__(self, column: str):
        self.column = column
        # arrow type string of the source column, resolved at index
        # creation; literals are coerced against it at probe time
        self.source_type: Optional[str] = None

    # -- identity / serialization ------------------------------------------
    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __repr__(self):
        return f"{self.kind}({self.column})"

    def to_dict(self) -> dict:
        d = {"type": self.kind, "column": self.column}
        if self.source_type is not None:
            d["sourceType"] = self.source_type
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Sketch":
        s = cls(d["column"])
        s.source_type = d.get("sourceType")
        return s

    # -- contract -----------------------------------------------------------
    def referenced_columns(self) -> List[str]:
        return [self.column]

    def output_fields(self, source_type: pa.DataType) -> List[Tuple[str, pa.DataType]]:
        raise NotImplementedError

    def aggregate(self, batch: ColumnarBatch, device) -> Dict[str, Any]:
        """One source file's batch -> sketch cell values (device work, if
        any, on ``device``)."""
        raise NotImplementedError

    def convert_predicate(self, expr: E.Expr, table: pa.Table, device) -> Optional[np.ndarray]:
        """Keep-mask over sketch rows for one conjunct, or None if this
        sketch cannot decide it (Sketch.convertPredicate contract)."""
        return None


@register_sketch
class MinMaxSketch(Sketch):
    kind = "MinMaxSketch"

    def output_fields(self, source_type):
        return [
            (f"MinMax_{self.column}__min", source_type),
            (f"MinMax_{self.column}__max", source_type),
        ]

    def aggregate(self, batch, device):
        lo, hi = column_value_range(batch.column(self.column))
        return {
            f"MinMax_{self.column}__min": lo,
            f"MinMax_{self.column}__max": hi,
        }

    def _arrow_type(self):
        """The recorded source type, or None where it does not parse (a
        ``decimal128`` among them: the sketch then abstains, as the
        reference's does)."""
        if self.source_type is None:
            return None
        from hyperspace_tpu_torch.rules.rule_utils import parse_arrow_type

        try:
            return parse_arrow_type(self.source_type)
        except (ValueError, HyperspaceException):
            return None

    def _cell_zones(self, table: pa.Table, t):
        """The sketch table's min/max cells as a zone-map column
        (``indexes/zonemaps.ColZones``), memoized per table identity:
        ``translate_filter`` probes once a conjunct against one table."""
        cached = getattr(self, "_zone_cache", None)
        if cached is not None and cached[0] is table:
            return cached[1]
        from hyperspace_tpu_torch.indexes import zonemaps as zm

        lo_cells = table.column(f"MinMax_{self.column}__min").to_pylist()
        hi_cells = table.column(f"MinMax_{self.column}__max").to_pylist()
        cells = [
            "allnull" if lo is None and hi is None else (lo, hi)
            for lo, hi in zip(lo_cells, hi_cells)
        ]
        cz = zm.column_zones(cells, t)
        self._zone_cache = (table, cz)
        return cz

    def convert_predicate(self, expr, table, device):
        """Keep-mask over sketch rows for all files in one pass through the
        zone-map overlap test (``indexes/zonemaps``), whose interval
        extraction and literal lowering the range pruning of a scan
        shares."""
        from hyperspace_tpu_torch.indexes import zonemaps as zm

        if f"MinMax_{self.column}__min" not in table.column_names:
            return None
        t = self._arrow_type()
        if t is None:
            return None  # no recorded type: abstain
        if isinstance(expr, E.In):
            if not _col_matches(expr.child, self.column):
                return None
            cz = self._cell_zones(table, t)
            masks = []
            for v in expr.values:
                if v is None:
                    continue
                iv = zm.interval_for("=", v, t)
                if iv is None:
                    return None  # incomparable literal type: abstain
                masks.append(zm.zone_keep_mask(cz, iv))
            if not masks:
                return np.zeros(len(cz.has), dtype=bool)
            return np.logical_or.reduce(masks)
        norm = E.normalize_comparison(expr)
        if norm is None:
            return None
        op, col, lit = norm
        if col.lower() != self.column.lower() or op == "!=":
            return None
        iv = zm.interval_for(op, lit, t)
        if iv is None:
            return None  # incomparable literal type: abstain
        return zm.zone_keep_mask(self._cell_zones(table, t), iv)


@register_sketch
class BloomFilterSketch(Sketch):
    kind = "BloomFilterSketch"

    def __init__(self, column: str, fpp: float = 0.01, expected_items: int = 10000):
        super().__init__(column)
        self.fpp = float(fpp)
        self.expected_items = int(expected_items)
        self.m, self.k = bloom.optimal_params(self.expected_items, self.fpp)

    def to_dict(self):
        d = {
            "type": self.kind,
            "column": self.column,
            "fpp": self.fpp,
            "expectedItems": self.expected_items,
        }
        if self.source_type is not None:
            d["sourceType"] = self.source_type
        return d

    @classmethod
    def from_dict(cls, d):
        s = cls(d["column"], d.get("fpp", 0.01), d.get("expectedItems", 10000))
        s.source_type = d.get("sourceType")
        return s

    def output_fields(self, source_type):
        return [(f"BloomFilter_{self.column}__bits", pa.binary())]

    def aggregate(self, batch, device):
        """The file's filter over its non-null key reps, built by B7 on
        ``device`` (one launch; none for a file without a valid row)."""
        col = batch.column(self.column)
        reps = col.key_rep()
        nulls = col.null_mask
        if nulls is not None:
            reps = reps[~nulls]
        words = bloom.build_bloom(
            torch.from_numpy(np.ascontiguousarray(reps, dtype=np.int64)).to(device),
            self.m,
            self.k,
        )
        return {f"BloomFilter_{self.column}__bits": bloom.to_host(words).numpy().tobytes()}

    def _probe(self, table: pa.Table, values, device) -> Optional[np.ndarray]:
        name = f"BloomFilter_{self.column}__bits"
        if name not in table.column_names:
            return None
        reps = []
        for v in values:
            rep = _value_rep(v, self.source_type)
            if rep is _ABSTAIN:
                return None  # un-coercible literal: this sketch can't decide
            if rep is not _NO_MATCH:
                reps.append(rep)
        blobs = table.column(name).to_pylist()
        if not reps:  # every literal is outside the column's value domain
            return np.zeros(len(blobs), dtype=bool)
        blooms = np.stack(
            [
                np.frombuffer(b, dtype=np.uint64)
                if b
                else np.zeros(self.m // 64, dtype=np.uint64)
                for b in blobs
            ]
        )
        hits = bloom.might_contain(
            torch.from_numpy(blooms.view(np.int64)),
            torch.tensor(reps, dtype=torch.int64, device=device),
            self.m,
            self.k,
        )  # hits[f, j] = all k bits of value j set in bloom f
        return hits.any(dim=1).numpy()

    def convert_predicate(self, expr, table, device):
        if isinstance(expr, E.In):
            if _col_matches(expr.child, self.column):
                vals = [v for v in expr.values if v is not None]
                return self._probe(table, vals, device)
            return None
        norm = E.normalize_comparison(expr)
        if norm is None:
            return None
        op, col, lit = norm
        if col.lower() != self.column.lower() or op != "=":
            return None
        return self._probe(table, [lit], device)


_ABSTAIN = object()  # literal un-coercible -> sketch cannot decide
_NO_MATCH = object()  # literal outside the column's domain -> matches nothing


def _value_rep(v, source_type: Optional[str]):
    """Literal -> the int64 key rep ``io/columnar`` assigns to the COLUMN's
    values, coercing the literal to the column's type first (an int column
    probed with 2050.0 must hash the integer 2050; a probe the executor
    would match must never be pruned away)."""
    if source_type is None:
        return _ABSTAIN
    t = source_type
    if t in ("string", "large_string"):
        if not isinstance(v, str):
            return _ABSTAIN
        return murmur3_64_bytes(v.encode("utf-8"))
    if t == "bool":
        return int(bool(v))
    if t.startswith("int") or t.startswith("uint"):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return _ABSTAIN
        if isinstance(v, float):
            if not v.is_integer():
                return _NO_MATCH
            v = int(v)
        if t.startswith("uint"):
            # the column key rep of uint64 is the int64 bit-view (values
            # >= 2^63 appear negative); the probe must match bit for bit
            if v < 0 or v >= 1 << 64:
                return _NO_MATCH
            return int(np.uint64(v).view(np.int64))
        if v < -(1 << 63) or v >= 1 << 63:
            return _NO_MATCH
        return int(v)
    if t in ("float", "double", "halffloat"):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return _ABSTAIN
        f = np.float64(v)
        if f == 0.0:
            return 0
        return int(f.view(np.int64))
    return _ABSTAIN


@register_sketch
class PartitionSketch(Sketch):
    """Constant-per-file column values (the reference auto-adds this for
    hive-partitioned sources, PartitionSketch.scala:38-74; constancy is
    detected per file at build time, which also covers partition dirs)."""

    kind = "PartitionSketch"

    def output_fields(self, source_type):
        return [
            (f"Partition_{self.column}__val", source_type),
            (f"Partition_{self.column}__const", pa.bool_()),
        ]

    def aggregate(self, batch, device):
        col = batch.column(self.column)
        val, const = None, False
        if batch.num_rows:
            if col.kind == "string":
                codes = np.unique(col.codes)
                const = len(codes) == 1
                if const and codes[0] >= 0:
                    val = col.dictionary[codes[0]]
            else:
                v = col.values
                if col.validity is None or col.validity.all():
                    const = bool((v == v[0]).all()) if len(v) else False
                    if const:
                        val = v[0].item()
        return {
            f"Partition_{self.column}__val": val,
            f"Partition_{self.column}__const": const,
        }

    def convert_predicate(self, expr, table, device):
        name = f"Partition_{self.column}__val"
        if name not in table.column_names:
            return None
        vals = table.column(name).to_pylist()
        const = np.asarray(table.column(f"Partition_{self.column}__const"))

        def eq_mask(lit):
            return np.array(
                [(not c) or (v is not None and v == lit) for v, c in zip(vals, const)]
            )

        if isinstance(expr, E.In):
            if _col_matches(expr.child, self.column):
                masks = [eq_mask(v) for v in expr.values if v is not None]
                if not masks:
                    return np.zeros(len(vals), dtype=bool)
                return np.logical_or.reduce(masks)
            return None
        norm = E.normalize_comparison(expr)
        if norm is None:
            return None
        op, col, lit = norm
        if col.lower() != self.column.lower() or op != "=":
            return None
        return eq_mask(lit)
