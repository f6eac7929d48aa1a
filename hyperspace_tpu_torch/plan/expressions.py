"""Typed expression tree + null-aware columnar evaluation.

Plays the role of Catalyst expressions in the reference (predicates reach
its rules as Spark ``Expression`` trees, e.g.
``covering/FilterIndexRule.scala:62-103`` walks them for column coverage).
Nodes are frozen dataclasses: hashable (planner memoization) and
comparable structurally.

Evaluation is SQL three-valued logic over :class:`ColumnarBatch` columns:
``evaluate`` returns ``(values, valid)`` numpy arrays; a filter keeps rows
where ``values & valid``. String comparisons never touch bytes row-wise —
equality/In compare dictionary codes, ordering comparisons compare
per-batch *rank* arrays (dictionary sorted host-side once, O(unique)), so
the same arithmetic runs on device codes (see ``ops/filter.py``, the
device twin of this evaluator).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, List, Optional, Set, Tuple, Union

import numpy as np

from hyperspace_tpu_torch.exceptions import HyperspaceException

# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    def __and__(self, other: "Expr") -> "Expr":
        return And(self, _lit(other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, _lit(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def __bool__(self):
        # Col.__eq__ builds an Eq expression (DataFrame API), so Python
        # equality on expression trees is NOT structural equality. Fail
        # loudly instead of silently treating every comparison as truthy.
        raise TypeError(
            "Expression has no truth value; use semantic_equals() or repr()"
        )


def semantic_equals(a: Optional["Expr"], b: Optional["Expr"]) -> bool:
    """Structural equality (repr is canonical for these frozen trees)."""
    return repr(a) == repr(b)


def _lit(v: Union["Expr", Any]) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str

    def __repr__(self):
        return self.name

    # comparison builders (DataFrame API surface)
    def __eq__(self, other):  # type: ignore[override]
        return Eq(self, _lit(other))

    def __ne__(self, other):  # type: ignore[override]
        return Ne(self, _lit(other))

    def __lt__(self, other):
        return Lt(self, _lit(other))

    def __le__(self, other):
        return Le(self, _lit(other))

    def __gt__(self, other):
        return Gt(self, _lit(other))

    def __ge__(self, other):
        return Ge(self, _lit(other))

    def __hash__(self):
        return hash(("Col", self.name))

    def isin(self, *values) -> "In":
        vals = values[0] if len(values) == 1 and isinstance(
            values[0], (list, tuple, set)
        ) else values
        return In(self, tuple(sorted(set(vals), key=repr)))

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "Not":
        return Not(IsNull(self))


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    value: Any

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True, repr=False)
class _Binary(Expr):
    left: Expr
    right: Expr

    op = "?"

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


class Eq(_Binary):
    op = "="


class Ne(_Binary):
    op = "!="


class Lt(_Binary):
    op = "<"


class Le(_Binary):
    op = "<="


class Gt(_Binary):
    op = ">"


class Ge(_Binary):
    op = ">="


class And(_Binary):
    op = "AND"


class Or(_Binary):
    op = "OR"


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    child: Expr

    def __repr__(self):
        return f"NOT {self.child!r}"


@dataclasses.dataclass(frozen=True)
class In(Expr):
    child: Expr
    values: Tuple[Any, ...]

    def __repr__(self):
        return f"{self.child!r} IN {list(self.values)}"


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    child: Expr

    def __repr__(self):
        return f"{self.child!r} IS NULL"


# ---------------------------------------------------------------------------
# Tree utilities (planner surface)
# ---------------------------------------------------------------------------


def references(expr: Expr) -> Set[str]:
    """Column names referenced by the expression
    (Catalyst ``Expression.references``)."""
    if isinstance(expr, Col):
        return {expr.name}
    if isinstance(expr, Lit):
        return set()
    if isinstance(expr, _Binary):
        return references(expr.left) | references(expr.right)
    if isinstance(expr, (Not, IsNull)):
        return references(expr.child)
    if isinstance(expr, In):
        return references(expr.child)
    raise HyperspaceException(f"Unknown expression: {expr!r}")


def split_conjuncts(expr: Optional[Expr]) -> List[Expr]:
    """CNF top level: flatten nested ANDs
    (``JoinIndexRule`` CNF handling, JoinIndexRule.scala:164-170)."""
    if expr is None:
        return []
    if isinstance(expr, And):
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]


def conjunction(exprs: List[Expr]) -> Optional[Expr]:
    out: Optional[Expr] = None
    for e in exprs:
        out = e if out is None else And(out, e)
    return out


def lower_literal(value, arrow_type, op: Optional[str] = None):
    """Engine-internal image of a literal for a column of ``arrow_type``.

    Temporal columns are stored as int64 epoch units (io/columnar ingest
    views datetime64 as int64), so temporal literals — np.datetime64,
    datetime.date/datetime, ISO strings — are lowered through the same
    arrow ingestion path the data took, landing in the column's exact
    unit. Non-temporal types pass through unchanged. Returns None when
    the literal cannot represent a value of the column's type (a
    comparison against it can then never be true).
    """
    import pyarrow as pa

    if arrow_type is None or not pa.types.is_temporal(arrow_type):
        return value
    unit = _temporal_storage_unit(arrow_type)
    if unit is None:
        if pa.types.is_time(arrow_type):
            return _lower_time_literal(value, arrow_type, op)
        if pa.types.is_duration(arrow_type):
            return _lower_duration_literal(value, arrow_type, op)
        return value  # interval types beyond duration: untouched
    dt64 = _as_datetime64(value)
    if dt64 is None:
        return None
    # exact python-int arithmetic: NEVER let numpy overflow silently.
    # A literal beyond the column unit's representable range still has a
    # definite ordering answer, so it clamps to ±inf (int64-vs-float
    # comparisons give the right result; equality against ±inf is False).
    src_unit = np.datetime_data(dt64.dtype)[0]
    if src_unit in ("Y", "M", "W"):
        dt64 = dt64.astype("datetime64[D]")  # exact calendar conversion
        src_unit = "D"
    if src_unit not in _NS_PER:
        return None  # sub-ns units (ps/fs/as): beyond engine precision
    v_ns = int(dt64.view("int64")) * _NS_PER[src_unit]
    return _clamp_ticks(_snap_between_tick(*divmod(v_ns, _NS_PER[unit]), op))


def _snap_between_tick(q, r, op):
    """Boundary snap for a literal BETWEEN column ticks q and q+1 (divmod
    floors): col < lit ⟺ col <= q ⟺ col < q+1 and col >= lit ⟺
    col >= q+1; col <= lit ⟺ col <= q, col > lit ⟺ col > q. Equality
    can never hold — op None / = / != return None (callers treat that as
    never-true, != as true-for-valid). Shared by the timestamp/date and
    time-of-day lowering paths so their semantics can't diverge."""
    if r == 0:
        return q
    if op in ("<", ">="):
        return q + 1
    if op in ("<=", ">"):
        return q
    return None


# Nanoseconds per fixed-length unit — ONE table shared by every temporal
# lowering path (datetime, time-of-day, duration). Calendar units (Y/M)
# are deliberately absent: they have no fixed length.
_NS_PER = {
    "W": 604_800_000_000_000,
    "D": 86_400_000_000_000,
    "h": 3_600_000_000_000,
    "m": 60_000_000_000,
    "s": 1_000_000_000,
    "ms": 1_000_000,
    "us": 1_000,
    "ns": 1,
}


def _clamp_ticks(q):
    """Snap-result -> engine literal: int64 ticks, or ±inf when the exact
    tick count overflows int64 (ordering against ±inf stays correct;
    equality is False). Shared by the datetime and duration paths."""
    if q is None:
        return None
    if q > np.iinfo(np.int64).max:
        return np.float64("inf")
    if q < np.iinfo(np.int64).min:
        return np.float64("-inf")
    return np.int64(q)


def _lower_time_literal(value, arrow_type, op):
    """datetime.time / ISO string -> int64 in the time column's unit
    (time-of-day columns ingest as their integer representation)."""
    import datetime as _dt

    if isinstance(value, str):
        try:
            value = _dt.time.fromisoformat(value)
        except ValueError:
            return None
    if not isinstance(value, _dt.time):
        return None
    if value.tzinfo is not None:
        # a zoned time-of-day cannot be compared to naive column values
        # (the timestamp path CONVERTS offsets; here there is no date to
        # anchor the conversion) — unrepresentable, never matches
        return None
    ns = (
        ((value.hour * 60 + value.minute) * 60 + value.second) * 10**9
        + value.microsecond * 1000
    )
    q = _snap_between_tick(*divmod(ns, _NS_PER[arrow_type.unit]), op)
    return None if q is None else np.int64(q)


def _temporal_storage_unit(arrow_type):
    """numpy datetime64 unit matching io/columnar's int64 storage of the
    arrow type (date32→days, date64→ms, timestamp→its own unit)."""
    import pyarrow as pa

    if pa.types.is_date32(arrow_type):
        return "D"
    if pa.types.is_date64(arrow_type):
        return "ms"
    if pa.types.is_timestamp(arrow_type):
        return arrow_type.unit
    return None


def _as_datetime64(value):
    """np.datetime64 image of a literal at its OWN precision (so lossy
    conversions are detectable), or None."""
    import datetime as _dt

    if isinstance(value, np.datetime64):
        return value
    if isinstance(value, str):
        try:
            return np.datetime64(value)
        except ValueError:
            return None
    if isinstance(value, _dt.datetime):
        return np.datetime64(value, "us")
    if isinstance(value, _dt.date):
        return np.datetime64(value, "D")
    return None


def _duration_ns(value):
    """Exact nanosecond count of a duration literal as a python int
    (arbitrary precision — overflow must clamp, never wrap), or None for
    anything that is not a fixed-length duration. Calendar-length numpy
    units (Y/M) have no fixed nanosecond value and return None, matching
    numpy's own refusal to compare them against fixed units."""
    import datetime as _dt

    if isinstance(value, np.timedelta64):
        if np.isnat(value):
            return None  # NaT comparisons are never true (numpy/pyarrow)
        unit = np.datetime_data(value.dtype)[0]
        if unit not in _NS_PER:
            return None  # Y/M (calendar) or sub-ns precision
        return int(value.view("int64")) * _NS_PER[unit]
    if isinstance(value, _dt.timedelta):
        # python timedelta is exact at microsecond resolution
        return (
            (value.days * 86_400_000_000 + value.seconds * 1_000_000)
            + value.microseconds
        ) * 1_000
    return None


def _lower_duration_literal(value, arrow_type, op):
    """int64 ticks of the duration column's storage unit (io/columnar
    views timedelta64 as int64), with the same between-tick snapping and
    ±inf overflow clamping as datetime lowering. The reference gets
    interval casts from Catalyst; here the literal is lowered through
    exact python-int arithmetic."""
    ns = _duration_ns(value)
    if ns is None:
        return None
    q = _snap_between_tick(*divmod(ns, _NS_PER[arrow_type.unit]), op)
    return _clamp_ticks(q)


def normalize_temporal_literal(value, arrow_type):
    """Python date/datetime image of a temporal literal, or None when
    unrepresentable — for consumers comparing against python-object cells
    (the min/max sketch probe). A sub-day instant can never represent a
    date; sub-microsecond precision cannot round-trip through python
    datetime, so such literals return None (callers fall back to no
    pruning, which is sound)."""
    import datetime as _dt

    import pyarrow as pa

    dt64 = _as_datetime64(value)
    if dt64 is None:
        return None
    us = dt64.astype("datetime64[us]")
    if us.astype(dt64.dtype) != dt64:
        return None
    value = us.item()  # datetime.datetime
    if pa.types.is_date(arrow_type):
        if value.time() != _dt.time(0):
            return None
        value = value.date()
    return value


def lower_in_literals(values, arrow_type) -> List[Any]:
    """IN-list literals in engine-internal form for a numeric column:
    temporal literals lower to the column's int64 units (unrepresentable
    ones can never match and are dropped); otherwise only type-compatible
    plain literals survive. Shared by the host evaluator and the device
    filter so both paths agree."""
    import pyarrow as pa

    if arrow_type is not None and pa.types.is_temporal(arrow_type):
        out = []
        for v in values:
            if v is None:
                continue
            lv = lower_literal(v, arrow_type)
            # only exact column ticks can match equality: drop ±inf
            # (out-of-range) and x.5 (between ticks) — a float in the
            # list would also upcast the whole array and break int64
            # equality beyond 2^53
            if lv is not None and isinstance(lv, np.int64):
                out.append(lv)
        return out
    out = []
    for v in values:
        # numpy scalars are first-class literals (df['k'].isin(arr[0]))
        if isinstance(v, (np.integer, np.floating, np.bool_)):
            v = v.item()
        if isinstance(v, (int, float, bool)):
            out.append(v)
    return out


def normalize_comparison(expr: Expr) -> Optional[Tuple[str, str, Any]]:
    """-> (op, column_name, literal) for Col-vs-Lit comparisons (either
    operand order; never a None literal), else None. The single home of
    the operand-swap rule (shared by sketch predicate translation and
    executor bucket pruning)."""
    if not isinstance(expr, (Eq, Ne, Lt, Le, Gt, Ge)):
        return None
    left, right, op = expr.left, expr.right, expr.op
    flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
    if isinstance(left, Lit) and isinstance(right, Col):
        left, right, op = right, left, flipped[op]
    if isinstance(left, Col) and isinstance(right, Lit):
        if right.value is None:
            return None
        return op, left.name, right.value
    return None


# ---------------------------------------------------------------------------
# Evaluation (host numpy; the device twin lives in ops/filter.py)
# ---------------------------------------------------------------------------


class _StringRef:
    """A string column's evaluation view: codes + dictionary rank tables."""

    __slots__ = ("codes", "dictionary", "sorted_dict", "rank")

    def __init__(self, codes: np.ndarray, dictionary: List[str]):
        self.codes = codes
        self.dictionary = dictionary
        order = sorted(range(len(dictionary)), key=lambda i: dictionary[i])
        self.sorted_dict = [dictionary[i] for i in order]
        rank = np.empty(max(len(dictionary), 1), dtype=np.int64)
        for r, i in enumerate(order):
            rank[i] = r
        self.rank = rank

    @property
    def valid(self) -> np.ndarray:
        return self.codes >= 0

    def code_of(self, value: str) -> int:
        """Dictionary code of value, or -2 if absent (never matches)."""
        try:
            return self.dictionary.index(value)
        except ValueError:
            return -2

    def rank_values(self) -> np.ndarray:
        return self.rank[np.maximum(self.codes, 0)]

    def rank_bounds(self, value: str) -> Tuple[int, int]:
        """(bisect_left, bisect_right) of value in the sorted dictionary —
        turns string ordering comparisons into integer rank comparisons."""
        return (
            bisect.bisect_left(self.sorted_dict, value),
            bisect.bisect_right(self.sorted_dict, value),
        )


_Val = Tuple[Any, Optional[np.ndarray]]  # (values-or-_StringRef, valid|None)


def _column_ref(batch, name: str) -> _Val:
    col = batch.column(name)
    if col.kind == "string":
        ref = _StringRef(col.codes, col.dictionary)
        v = ref.valid
        return ref, None if v.all() else v
    if col.validity is not None:
        return col.values, col.validity
    return col.values, None


def _both_valid(a: Optional[np.ndarray], b: Optional[np.ndarray]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _cmp(expr: Expr, batch, op_name: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    left, right = expr.left, expr.right
    # Normalize Lit-on-left
    flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
    if isinstance(left, Lit) and not isinstance(right, Lit):
        left, right = right, left
        op_name = flipped[op_name]
    if isinstance(left, Col) and isinstance(right, Lit):
        vref, valid = _column_ref(batch, left.name)
        lit = right.value
        if lit is None:
            n = batch.num_rows
            return np.zeros(n, bool), np.zeros(n, bool)
        if isinstance(vref, _StringRef):
            if op_name in ("=", "!="):
                code = vref.code_of(str(lit))
                vals = vref.codes == code
                if op_name == "!=":
                    vals = ~vals & vref.valid
                valid = _both_valid(valid, None)
                return vals, vref.valid if valid is None else valid
            lo, hi = vref.rank_bounds(str(lit))
            r = vref.rank_values()
            vals = {"<": r < lo, "<=": r < hi, ">": r >= hi, ">=": r >= lo}[op_name]
            return vals, vref.valid
        lit = lower_literal(lit, batch.column(left.name).arrow_type, op_name)
        if lit is None:
            # literal unrepresentable in the column's type: equality and
            # orderings can never hold; != holds for every non-null row
            n = batch.num_rows
            return np.full(n, op_name == "!="), valid
        v = vref
        with np.errstate(invalid="ignore"):
            vals = {
                "=": v == lit,
                "!=": v != lit,
                "<": v < lit,
                "<=": v <= lit,
                ">": v > lit,
                ">=": v >= lit,
            }[op_name]
        return np.asarray(vals, dtype=bool), valid
    if isinstance(left, Col) and isinstance(right, Col):
        lv, lvalid = _column_ref(batch, left.name)
        rv, rvalid = _column_ref(batch, right.name)
        if isinstance(lv, _StringRef) or isinstance(rv, _StringRef):
            if not (isinstance(lv, _StringRef) and isinstance(rv, _StringRef)):
                raise HyperspaceException(
                    f"Type mismatch comparing {left!r} and {right!r}"
                )
            # col-col string compare: remap right codes into left dictionary
            from hyperspace_tpu_torch.io.columnar import Column as _C
            from hyperspace_tpu_torch.io.columnar import remap_codes

            rcol = _C("string", None, codes=rv.codes, dictionary=rv.dictionary)
            rcodes = remap_codes(lv.dictionary, rcol)
            if op_name == "=":
                vals = lv.codes == rcodes
            elif op_name == "!=":
                vals = lv.codes != rcodes
            else:
                raise HyperspaceException(
                    "Ordering comparison between two string columns is not supported"
                )
            return vals, _both_valid(lv.valid, rv.valid)
        with np.errstate(invalid="ignore"):
            vals = {
                "=": lv == rv,
                "!=": lv != rv,
                "<": lv < rv,
                "<=": lv <= rv,
                ">": lv > rv,
                ">=": lv >= rv,
            }[op_name]
        return np.asarray(vals, dtype=bool), _both_valid(lvalid, rvalid)
    raise HyperspaceException(f"Unsupported comparison operands: {expr!r}")


def evaluate(expr: Expr, batch) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Null-aware evaluation -> (bool values, valid mask|None).

    A row passes a filter iff values & (valid if not None else True).
    """
    n = batch.num_rows
    if isinstance(expr, Lit):
        if expr.value is None:
            return np.zeros(n, bool), np.zeros(n, bool)
        return np.full(n, bool(expr.value)), None
    if isinstance(expr, (Eq, Ne, Lt, Le, Gt, Ge)):
        return _cmp(expr, batch, expr.op)
    if isinstance(expr, And):
        lv, lk = evaluate(expr.left, batch)
        rv, rk = evaluate(expr.right, batch)
        vals = lv & rv
        if lk is None and rk is None:
            return vals, None
        lk = np.ones(n, bool) if lk is None else lk
        rk = np.ones(n, bool) if rk is None else rk
        # Kleene: known if both known, or either side is known-false
        known = (lk & rk) | (lk & ~lv) | (rk & ~rv)
        return vals & lk & rk, known
    if isinstance(expr, Or):
        lv, lk = evaluate(expr.left, batch)
        rv, rk = evaluate(expr.right, batch)
        lk = np.ones(n, bool) if lk is None else lk
        rk = np.ones(n, bool) if rk is None else rk
        vals = (lv & lk) | (rv & rk)
        known = (lk & rk) | (lk & lv) | (rk & rv)
        return vals, known
    if isinstance(expr, Not):
        v, k = evaluate(expr.child, batch)
        return ~v, k
    if isinstance(expr, IsNull):
        if isinstance(expr.child, Col):
            _vref, valid = _column_ref(batch, expr.child.name)
            if isinstance(_vref, _StringRef):
                return ~_vref.valid, None
            if valid is None:
                return np.zeros(n, bool), None
            return ~valid, None
        v, k = evaluate(expr.child, batch)
        return (np.zeros(n, bool) if k is None else ~k), None
    if isinstance(expr, In):
        if not isinstance(expr.child, Col):
            raise HyperspaceException("IN requires a column operand")
        vref, valid = _column_ref(batch, expr.child.name)
        # SQL: a NULL in the list makes non-matching rows UNKNOWN (x IN
        # (1, NULL) is TRUE iff x=1, else NULL) — so NOT IN with a NULL
        # returns no rows
        has_null = any(v is None for v in expr.values)

        def with_null(vals, valid):
            if not has_null:
                return vals, valid
            valid = np.ones(n, bool) if valid is None else valid
            return vals, valid & vals

        if isinstance(vref, _StringRef):
            codes = {
                vref.code_of(v) for v in expr.values if isinstance(v, str)
            }
            codes.discard(-2)
            vals = np.isin(vref.codes, np.array(sorted(codes), dtype=np.int64))
            return with_null(vals, vref.valid)
        # type-compatible literals only: 5 matches isin(5, "a") on an int
        # column, the string can never match and must not poison the
        # comparison dtype; temporal literals lower to int64 units
        lits = lower_in_literals(
            expr.values, batch.column(expr.child.name).arrow_type
        )
        if not lits:
            return with_null(np.zeros(n, bool), valid)
        vals = np.isin(vref, np.array(lits))
        return with_null(vals, valid)
    raise HyperspaceException(f"Cannot evaluate expression: {expr!r}")


def filter_mask(expr: Expr, batch) -> np.ndarray:
    vals, valid = evaluate(expr, batch)
    return vals if valid is None else (vals & valid)
