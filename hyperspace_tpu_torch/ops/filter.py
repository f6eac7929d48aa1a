"""Columnar predicate evaluation on the session's device.

Counterpart of ``hyperspace_tpu/ops/filter.py`` (``_Prep``, ``_eval_spec``,
``_apply_cmp``, ``device_filter_mask``): the device twin of
``plan/expressions.evaluate``. The host lowers the expression over one
batch into a *spec* (nested tuples) plus argument arrays:

* numeric columns -> their values (+ validity), cast on the host to the
  comparison's common type (numpy promotion rules, so an int64 column
  against a float literal compares in float64 exactly as the host path
  does, never in PyTorch's float32 default);
* string columns -> dictionary codes plus the per-batch rank table of
  the dictionary (sorted once on the host, O(unique)); the rows' ranks
  are gathered on the device, and string literals become
  ``(bisect_left, bisect_right)`` rank bounds, so every string predicate
  is integer arithmetic on the device.

Unsigned columns take part without a loss: uint16 and uint32 values
widen exactly to int64, and uint64 values (the common type of a uint64
comparison) become int64 with the sign bit flipped, which keeps their
order and equality. A comparison whose common type is float64 (a uint64
column against a float or an int64 literal) casts on the host, as numpy
does.

The spec then evaluates with SQL three-valued logic on the device; the
mask is ``values & known``. What cannot lower raises :class:`Unsupported`
and the executor evaluates it on the host.

A conjunction of numeric range terms (``=``, ``<``, ``<=``, ``>``, ``>=``
against literals) over 8-byte int or float64 columns has a fused route
instead (:func:`fused_range_mask`): its bounds lower once to exact int64
or float64 form (:func:`native_range_bounds`) and one pass of kernel B3a
(``csrc/range_mask.cu``) computes the AND of the bounds and validity
over all its terms, reading each distinct column once. A CPU tensor
takes the plain version :func:`range_mask_torch`.

The fused select (:func:`fused_filter_select`) lowers the same terms and
returns the passing rows' indices in ascending order, ``np.nonzero`` of
that mask, in one pass of kernel B3b (``csrc/fused_select.cu``) on the
card; a CPU tensor takes the plain version :func:`select_torch`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import warnings
from typing import Any, List, Optional

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.kernels import KernelLaunchError
from hyperspace_tpu_torch.plan import expressions as E


class Unsupported(HyperspaceException):
    """Expression not lowerable to the device; the caller evaluates it on
    the host."""


# numpy dtypes the device path takes as they are (PyTorch lacks most
# arithmetic on the wider unsigned types; those are mapped to int64 on
# the host by :func:`_device_array`)
_TORCH_OK = {
    np.dtype(t)
    for t in (
        np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
        np.float16, np.float32, np.float64,
    )
}
_SIGN_BIT = np.int64(-(1 << 63))


class _Prep:
    """Lowers an Expr over a given batch into (spec, args)."""

    def __init__(self, batch):
        self.batch = batch
        self.args: List[Any] = []
        self._col_slots = {}

    def _arg(self, v) -> int:
        self.args.append(v)
        return len(self.args) - 1

    def _col(self, name: str):
        """-> (("col", values_slot, valid_slot|-1, kind, name), ref|None).
        A string column's values slot holds its codes and its ref slot
        the rank table; ranks are gathered on the device."""
        if name in self._col_slots:
            return self._col_slots[name]
        col = self.batch.column(name)
        if col.kind == "string":
            ref = E._StringRef(col.codes, col.dictionary)
            codes = self._arg(col.codes)
            rank = self._arg(ref.rank)
            spec = ("col", codes, rank, "string", name)
            self._col_slots[name] = (spec, ref)
            return self._col_slots[name]
        vals = self._arg(col.values)
        valid = -1 if col.validity is None else self._arg(col.validity)
        spec = ("col", vals, valid, "numeric", name)
        self._col_slots[name] = (spec, None)
        return self._col_slots[name]

    def lower(self, e: E.Expr):
        if isinstance(e, E.Lit):
            if e.value is None:
                return ("null",)
            if not isinstance(e.value, (bool, np.bool_)):
                raise Unsupported(f"Bare non-bool literal: {e!r}")
            return ("const", bool(e.value))
        if isinstance(e, (E.Eq, E.Ne, E.Lt, E.Le, E.Gt, E.Ge)):
            op = e.op
            left, right = e.left, e.right
            flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
            if isinstance(left, E.Lit) and not isinstance(right, E.Lit):
                left, right = right, left
                op = flipped[op]
            if isinstance(left, E.Col) and isinstance(right, E.Lit):
                if right.value is None:
                    return ("null",)
                cspec, ref = self._col(left.name)
                if ref is not None:  # string: literal -> rank bounds
                    lo, hi = ref.rank_bounds(str(right.value))
                    return ("cmp_str", op, cspec, lo, hi)
                lit = E.lower_literal(
                    right.value, self.batch.column(left.name).arrow_type, op
                )
                if lit is None:
                    # unrepresentable literal: constant truth value but
                    # UNKNOWN on null rows (the host path's semantics)
                    return ("unrep", op == "!=", cspec)
                col = self.batch.column(left.name)
                lit = _literal_array(col.values.dtype, lit)
                if lit is None:
                    raise Unsupported(f"Non-numeric literal: {e!r}")
                return ("cmp_lit", op, cspec, self._arg(lit))
            if isinstance(left, E.Col) and isinstance(right, E.Col):
                lspec, lref = self._col(left.name)
                rspec, rref = self._col(right.name)
                if (lref is None) != (rref is None):
                    raise Unsupported(f"Mixed-type column comparison: {e!r}")
                if lref is not None:
                    # ranks are per-column orders; cross-column string
                    # comparison needs the host path
                    raise Unsupported(f"String col-col comparison: {e!r}")
                return ("cmp_col", op, lspec, rspec)
            raise Unsupported(f"Comparison operands: {e!r}")
        if isinstance(e, E.And):
            return ("and", self.lower(e.left), self.lower(e.right))
        if isinstance(e, E.Or):
            return ("or", self.lower(e.left), self.lower(e.right))
        if isinstance(e, E.Not):
            return ("not", self.lower(e.child))
        if isinstance(e, E.IsNull):
            if not isinstance(e.child, E.Col):
                raise Unsupported(f"IS NULL on non-column: {e!r}")
            cspec, _ref = self._col(e.child.name)
            return ("isnull", cspec)
        if isinstance(e, E.In):
            if not isinstance(e.child, E.Col):
                raise Unsupported(f"IN on non-column: {e!r}")
            cspec, ref = self._col(e.child.name)
            # a NULL in the list makes non-matching rows UNKNOWN
            has_null = any(v is None for v in e.values)
            vals = [v for v in e.values if v is not None]
            if not vals:
                # x IN (NULL) is unknown on every row; x IN () never true
                return ("null",) if has_null else ("const", False)
            if ref is not None:
                ranks = []
                for v in vals:
                    if not isinstance(v, str):
                        continue  # non-string literal never matches
                    lo, hi = ref.rank_bounds(v)
                    if hi > lo:
                        ranks.append(lo)
                arr = np.array(sorted(ranks) or [-1], dtype=np.int64)
            else:
                lits = E.lower_in_literals(
                    vals, self.batch.column(e.child.name).arrow_type
                )
                if not lits:
                    return ("null",) if has_null else ("const", False)
                arr = np.sort(np.array(lits))
                if arr.dtype.kind not in "biuf":
                    raise Unsupported(f"IN literal set: {e!r}")
                if arr.dtype.kind == "f":
                    # NaN equals nothing; left in, it would break the
                    # binary search's ordering
                    arr = arr[~np.isnan(arr)]
                    if len(arr) == 0:
                        return ("in_none", cspec, has_null)
            return ("in", cspec, self._arg(arr), has_null)
        raise Unsupported(f"Expression not device-compilable: {e!r}")


def _literal_array(col_dtype: np.dtype, lit):
    """The literal as a 0-d array of the type the host path compares in.

    The host path compares ``values OP lit`` in numpy, where a Python
    scalar is weak (a float32 column against 0.1 compares in float32) and
    a numpy scalar is not; an int literal outside the column's integer
    range compares exactly, as in a wider type. None for a literal that
    is not a number."""
    if isinstance(lit, (bool, int, float)) and not isinstance(lit, np.generic):
        if isinstance(lit, int) and not isinstance(lit, bool):
            if not -(2**63) <= lit < 2**64:
                return None
            if col_dtype.kind in "iu":
                info = np.iinfo(col_dtype)
                if not info.min <= lit <= info.max:
                    return np.asarray(lit)
        try:
            return np.asarray(lit).astype(np.result_type(col_dtype, lit))
        except (OverflowError, TypeError):
            return None
    arr = np.asarray(lit)
    return arr if arr.dtype.kind in "biuf" else None


def _device_array(a: np.ndarray) -> np.ndarray:
    """``a`` in a dtype the device compares, with order and equality kept:
    uint16 and uint32 widen to int64; uint64 becomes int64 with the sign
    bit flipped (u < v exactly when u ^ 2^63 < v ^ 2^63 as signed). Both
    operands of a comparison share one dtype (the common type), so both
    are mapped alike."""
    if a.dtype in (np.uint16, np.uint32):
        return a.astype(np.int64)
    if a.dtype == np.uint64:
        return a.view(np.int64) ^ _SIGN_BIT
    return a


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = _device_array(np.ascontiguousarray(a))
    if a.dtype not in _TORCH_OK:
        raise Unsupported(f"dtype {a.dtype} has no device comparison")
    with warnings.catch_warnings():
        # read-only Arrow buffers: nothing here writes a tensor in place
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(a)
    return t.to(device)


class _Args:
    """Device tensors for the lowered argument arrays, moved once each
    (or once per common type a comparison needs)."""

    def __init__(self, args: List[Any], device: torch.device):
        self.host = args
        self.device = device
        self._cache = {}

    def get(self, slot: int, dtype=None) -> torch.Tensor:
        a = np.asarray(self.host[slot])
        dtype = a.dtype if dtype is None else np.dtype(dtype)
        key = (slot, dtype)
        t = self._cache.get(key)
        if t is None:
            t = _to_device(a.astype(dtype, copy=False), self.device)
            self._cache[key] = t
        return t

    def dtype(self, slot: int) -> np.dtype:
        return np.asarray(self.host[slot]).dtype


def _valid(args: _Args, cspec, n: int) -> torch.Tensor:
    _c, vslot, valslot, kind, _name = cspec
    if kind == "string":
        return args.get(vslot) >= 0
    if valslot == -1:
        return torch.ones(n, dtype=torch.bool, device=args.device)
    return args.get(valslot)


def _ranks(args: _Args, cspec) -> torch.Tensor:
    _c, vslot, rslot, _kind, _name = cspec
    codes = args.get(vslot).to(torch.int64)
    return args.get(rslot)[codes.clamp(min=0)]


def _common(*dtypes) -> np.dtype:
    return np.result_type(*dtypes)


def _eval_spec(spec, args: _Args, n: int):
    """Recursive evaluation on the device -> (values[bool n], known[bool n])."""
    kind = spec[0]
    dev = args.device

    def t():
        return torch.ones(n, dtype=torch.bool, device=dev)

    def f():
        return torch.zeros(n, dtype=torch.bool, device=dev)

    if kind == "null":
        return f(), f()
    if kind == "const":
        return (t() if spec[1] else f()), t()
    if kind == "cmp_lit":
        op, cspec, lslot = spec[1], spec[2], spec[3]
        dt = _common(args.dtype(cspec[1]), args.dtype(lslot))
        v = args.get(cspec[1], dt)
        lit = args.get(lslot, dt)
        return _apply_cmp(op, v, lit), _valid(args, cspec, n)
    if kind == "cmp_str":
        op, cspec, lo, hi = spec[1], spec[2], spec[3], spec[4]
        r = _ranks(args, cspec)
        vals = {
            "=": (r >= lo) & (r < hi),
            "!=": ~((r >= lo) & (r < hi)),
            "<": r < lo,
            "<=": r < hi,
            ">": r >= hi,
            ">=": r >= lo,
        }[op]
        return vals, _valid(args, cspec, n)
    if kind == "cmp_col":
        op, lspec, rspec = spec[1], spec[2], spec[3]
        dt = _common(args.dtype(lspec[1]), args.dtype(rspec[1]))
        vals = _apply_cmp(op, args.get(lspec[1], dt), args.get(rspec[1], dt))
        return vals, _valid(args, lspec, n) & _valid(args, rspec, n)
    if kind == "and":
        lv, lk = _eval_spec(spec[1], args, n)
        rv, rk = _eval_spec(spec[2], args, n)
        vals = lv & rv & lk & rk
        known = (lk & rk) | (lk & ~lv) | (rk & ~rv)
        return vals, known
    if kind == "or":
        lv, lk = _eval_spec(spec[1], args, n)
        rv, rk = _eval_spec(spec[2], args, n)
        vals = (lv & lk) | (rv & rk)
        known = (lk & rk) | (lk & lv) | (rk & rv)
        return vals, known
    if kind == "not":
        v, k = _eval_spec(spec[1], args, n)
        return ~v, k
    if kind == "isnull":
        return ~_valid(args, spec[1], n), t()
    if kind == "unrep":
        # constant truth value, unknown on null rows
        return (t() if spec[1] else f()), _valid(args, spec[2], n)
    if kind in ("in", "in_none"):
        cspec = spec[1]
        valid = _valid(args, cspec, n)
        if kind == "in_none":
            vals, has_null = f(), spec[2]
        else:
            lslot, has_null = spec[2], spec[3]
            if cspec[3] == "string":
                v = _ranks(args, cspec)
                lits = args.get(lslot)
            else:
                dt = _common(args.dtype(cspec[1]), args.dtype(lslot))
                v = args.get(cspec[1], dt)
                lits = args.get(lslot, dt)
            # binary-search membership: searchsorted plus a clamp
            pos = torch.searchsorted(lits, v).clamp(0, lits.shape[0] - 1)
            vals = lits[pos] == v
        if has_null:  # NULL in the list: non-matches are unknown
            valid = valid & vals
        return vals, valid
    raise HyperspaceException(f"Bad spec node: {spec!r}")


def _apply_cmp(op, a, b):
    return {
        "=": lambda: a == b,
        "!=": lambda: a != b,
        "<": lambda: a < b,
        "<=": lambda: a <= b,
        ">": lambda: a > b,
        ">=": lambda: a >= b,
    }[op]()


def device_filter_mask(expr: E.Expr, batch, device) -> np.ndarray:
    """Evaluate a predicate over ``batch`` on ``device``; returns the host
    bool mask. Raises :class:`Unsupported` when the expression needs the
    host path (``plan/expressions.filter_mask``)."""
    n = batch.num_rows
    if n == 0:
        return np.zeros(0, dtype=bool)
    p = _Prep(batch)
    spec = p.lower(expr)
    args = _Args(p.args, torch.device(device))
    vals, known = _eval_spec(spec, args, n)
    return (vals & known).cpu().numpy()


# -- the fused range mask (kernel B3a) ------------------------------------------


class _BatchColTypes:
    """Lazy ``{name: (dtype_kind, arrow_type)}`` view of a batch for
    :func:`lower_range_terms_typed`: only the columns the condition
    references are inspected."""

    def __init__(self, batch):
        self._batch = batch

    def __contains__(self, name) -> bool:
        return name in self._batch.columns

    def __getitem__(self, name):
        col = self._batch.columns[name]
        return (
            "S" if col.kind == "string" else col.values.dtype.kind,
            col.arrow_type,
        )


def lower_range_terms(expr: E.Expr, batch):
    """[(name, lo, lo_strict, hi, hi_strict, empty)] when EVERY conjunct
    is a numeric col-vs-lit comparison in =,<,<=,>,>= with a literal the
    engine can compare (temporal literals lowered with the same op-aware
    snapping the host evaluator uses), else None. ``empty`` marks a
    conjunct whose lowered literal can never match (all-False mask)."""
    return lower_range_terms_typed(expr, _BatchColTypes(batch))


def lower_range_terms_typed(expr: E.Expr, cols):
    """:func:`lower_range_terms` against a ``{name: (dtype_kind,
    arrow_type)}`` mapping instead of a batch."""
    terms = []
    for cj in E.split_conjuncts(expr):
        norm = E.normalize_comparison(cj)
        if norm is None:
            return None
        op, name, lit = norm
        if op == "!=":
            return None
        if name not in cols:
            return None
        kind, arrow_type = cols[name]
        if kind == "S":
            return None
        if kind not in "if":
            return None  # uint/bool columns keep the general device mask
        lv = E.lower_literal(lit, arrow_type, op)
        if lv is None:
            terms.append((name, None, False, None, False, True))
            continue
        if isinstance(lv, (np.integer, np.floating)):
            pass  # engine-lowered scalar, compares exactly
        elif isinstance(lv, bool):
            lv = int(lv)
        elif isinstance(lv, int):
            if kind == "i" and not (-(2**63) <= lv < 2**63):
                return None  # out-of-range python int: the general mask decides
        elif not isinstance(lv, float):
            return None  # non-numeric literal on a numeric column
        if op == "=":
            terms.append((name, lv, False, lv, False, False))
        elif op == "<":
            terms.append((name, None, False, lv, True, False))
        elif op == "<=":
            terms.append((name, None, False, lv, False, False))
        elif op == ">":
            terms.append((name, lv, True, None, False, False))
        else:  # >=
            terms.append((name, lv, False, None, False, False))
    if not terms or len(terms) > MAX_RANGE_TERMS:
        return None
    return terms


#: terms one B3a launch takes (``kMaxTerms`` in ``csrc/range_mask.cu``)
MAX_RANGE_TERMS = 16

NEVER_MATCH = "never"


def native_range_bounds(terms, f64_flags):
    """Lower range-term bounds into the exact int64/float64 form B3a
    compares with.

    ``f64_flags``: per-term bool, True when the column is float64 (else
    an int64-view column). Returns ``(lo_i, hi_i, lo_f, hi_f, flags)``
    lists aligned with ``terms`` (``flags`` per term: has_lo, has_hi,
    lo_strict, hi_strict), :data:`NEVER_MATCH` when some bound can never
    hold (all-False mask), or None when a bound is not exactly
    representable (the general device mask must decide). Integer bounds
    given as floats tighten to the enclosing integers (exact on integer
    domains)."""
    lo_i, hi_i, lo_f, hi_f, flags = [], [], [], [], []
    for (_name, lo, lo_strict, hi, hi_strict, empty), f64 in zip(terms, f64_flags):
        if empty:
            return NEVER_MATCH

        def int_bound(b, is_lo):
            """(bound, strict) in exact int64, "never", "unbounded", or
            None to refuse."""
            strict = lo_strict if is_lo else hi_strict
            if isinstance(b, np.integer):
                b = int(b)
            if isinstance(b, (float, np.floating)):
                fb = float(b)
                if math.isnan(fb):
                    return "never"
                if math.isinf(fb):
                    # -inf lo / +inf hi: unbounded; +inf lo / -inf hi:
                    # nothing can pass
                    if (fb > 0) == is_lo:
                        return "never"
                    return "unbounded"
                if abs(fb) >= 2.0**53:
                    # the host compares int64 values against a FLOAT
                    # bound by promoting the column to float64; an exact
                    # int64 compare diverges for values beyond 2^53
                    return None
                if fb != int(fb):
                    # v > 2.5 == v >= 3; v < 2.5 == v <= 2 on integers
                    return (math.ceil(fb), False) if is_lo else (math.floor(fb), False)
                b = int(fb)
            if not isinstance(b, int):
                return None
            if not (-(2**63) <= b < 2**63):
                return None
            return (b, strict)

        if f64:
            def f_bound(b):
                if isinstance(b, (int, np.integer)) and not isinstance(b, bool):
                    fb = np.float64(b)
                    if int(fb) != int(b):
                        return None  # not exactly representable: refuse
                    return float(fb)
                return float(b)

            flo = f_bound(lo) if lo is not None else None
            fhi = f_bound(hi) if hi is not None else None
            if (lo is not None and flo is None) or (hi is not None and fhi is None):
                return None
            lo_f.append(flo if flo is not None else 0.0)
            hi_f.append(fhi if fhi is not None else 0.0)
            lo_i.append(0)
            hi_i.append(0)
            flags.append((lo is not None, hi is not None, lo_strict, hi_strict))
        else:
            ilo = int_bound(lo, True) if lo is not None else "unbounded"
            ihi = int_bound(hi, False) if hi is not None else "unbounded"
            if ilo is None or ihi is None:
                return None
            if ilo == "never" or ihi == "never":
                return NEVER_MATCH
            has_lo = ilo != "unbounded"
            has_hi = ihi != "unbounded"
            lo_i.append(ilo[0] if has_lo else 0)
            hi_i.append(ihi[0] if has_hi else 0)
            lo_f.append(0.0)
            hi_f.append(0.0)
            flags.append(
                (has_lo, has_hi, ilo[1] if has_lo else False, ihi[1] if has_hi else False)
            )
    return lo_i, hi_i, lo_f, hi_f, flags


@dataclasses.dataclass
class RangeArgs:
    """B3a's inputs on one device: the distinct columns the terms read
    (``[n]`` int64, a view of an int64 or temporal column, or float64),
    each column's validity (``[n]`` bool, or None without nulls), and per
    term its column's slot and exact bounds (``native_range_bounds``)."""

    cols: List[torch.Tensor]
    valids: List[Optional[torch.Tensor]]
    term_col: List[int]
    lo_i: List[int]
    hi_i: List[int]
    lo_f: List[float]
    hi_f: List[float]
    flags: List[tuple]

    @property
    def n(self) -> int:
        return int(self.cols[0].shape[0])


def range_args(batch, terms, device):
    """:class:`RangeArgs` for ``terms`` over ``batch`` on ``device`` (each
    distinct column moved once), :data:`NEVER_MATCH` (all-False), or None
    when a column is not an 8-byte int or float64 array or a bound does
    not lower exactly (the general device mask decides)."""
    slot_of, host_cols, host_valids, is_f64, term_col = {}, [], [], [], []
    for name, _lo, _ls, _hi, _hs, _empty in terms:
        if name not in slot_of:
            col = batch.columns[name]
            v = col.values
            if v is None or v.ndim != 1 or v.dtype.itemsize != 8:
                return None
            if v.dtype.kind == "f":
                if v.dtype != np.float64:
                    return None
            elif v.dtype.kind in "iMm":
                v = v.view(np.int64)
            else:
                return None
            slot_of[name] = len(host_cols)
            host_cols.append(v)
            host_valids.append(col.validity)
        is_f64.append(host_cols[slot_of[name]].dtype.kind == "f")
        term_col.append(slot_of[name])
    bounds = native_range_bounds(terms, is_f64)
    if bounds is None or bounds == NEVER_MATCH:
        return bounds
    dev = torch.device(device)
    return RangeArgs(
        [_to_device(v, dev) for v in host_cols],
        [None if m is None else _to_device(m, dev) for m in host_valids],
        term_col,
        *bounds,
    )


def range_mask_numpy(batch, terms) -> np.ndarray:
    """The host mask of ``terms`` over ``batch``: per term the comparisons
    the host evaluator runs (numpy promotion, NaN and uint semantics),
    ANDed, validity included. The interpreted twin of the fused routes
    (``execution/pipeline_compiler``), as the JAX package's own."""
    n = batch.num_rows
    out = np.ones(n, dtype=bool)
    with np.errstate(invalid="ignore"):
        for name, lo, lo_strict, hi, hi_strict, empty in terms:
            col = batch.columns[name]
            if empty:
                vals = np.zeros(n, dtype=bool)
            else:
                v = col.values
                vals = np.ones(n, dtype=bool)
                if lo is not None:
                    vals &= (v > lo) if lo_strict else (v >= lo)
                if hi is not None:
                    vals &= (v < hi) if hi_strict else (v <= hi)
            if col.validity is not None:
                vals = vals & col.validity
            out &= vals
    return out


def range_mask_torch(args: RangeArgs) -> torch.Tensor:
    """Plain PyTorch version of B3a, on the tensors' own device: per term
    the bound compares on its column (NaN fails every compare, -0.0
    equals 0.0), ANDed with the column's validity, ANDed over terms."""
    out = torch.ones(args.n, dtype=torch.bool, device=args.cols[0].device)
    for t, c in enumerate(args.term_col):
        v = args.cols[c]
        has_lo, has_hi, lo_strict, hi_strict = args.flags[t]
        f64 = v.dtype == torch.float64
        if has_lo:
            lo = torch.tensor(args.lo_f[t] if f64 else args.lo_i[t], dtype=v.dtype)
            out &= (v > lo) if lo_strict else (v >= lo)
        if has_hi:
            hi = torch.tensor(args.hi_f[t] if f64 else args.hi_i[t], dtype=v.dtype)
            out &= (v < hi) if hi_strict else (v <= hi)
        if args.valids[c] is not None:
            out &= args.valids[c]
    return out


#: B3a launches made by :func:`range_mask_kernel` (never by the plain version)
launches = 0

#: B3b kernel launches made by :func:`select_kernel` (one a call with rows)
select_launches = 0


@functools.cache
def _kernel_fn():
    from hyperspace_tpu_torch import kernels

    fn = kernels.load("range_mask").hs_range_mask
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # cols [ncols]
        ctypes.POINTER(ctypes.c_void_p),  # valids [ncols], NULL = no nulls
        ctypes.c_int,  # ncols
        ctypes.POINTER(ctypes.c_int),  # term_col [nterms], ascending
        ctypes.POINTER(ctypes.c_int64),  # lo_i
        ctypes.POINTER(ctypes.c_int64),  # hi_i
        ctypes.POINTER(ctypes.c_double),  # lo_f
        ctypes.POINTER(ctypes.c_double),  # hi_f
        ctypes.POINTER(ctypes.c_int),  # flags
        ctypes.c_int,  # nterms
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # n
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _select_lib():
    from hyperspace_tpu_torch import kernels

    lib = kernels.load("fused_select")
    p = ctypes.c_void_p
    lib.hs_fused_select.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int64, p, p, p, p,
    ]
    lib.hs_fused_select.restype = ctypes.c_int
    lib.hs_select_scratch_bytes.argtypes = [ctypes.c_int64]
    lib.hs_select_scratch_bytes.restype = ctypes.c_int64
    return lib


def term_arrays(args: RangeArgs):
    """The C interface's term arrays, terms grouped by column (so a kernel
    reads each column once a row): (cols, valids, ncols, term_col, lo_i,
    hi_i, lo_f, hi_f, flags, nterms), shared by B3a, B3b and B5f."""
    order = sorted(range(len(args.term_col)), key=lambda t: args.term_col[t])
    nt, nc = len(order), len(args.cols)
    return (
        (ctypes.c_void_p * nc)(*[c.data_ptr() for c in args.cols]),
        (ctypes.c_void_p * nc)(*[None if m is None else m.data_ptr() for m in args.valids]),
        nc,
        (ctypes.c_int * nt)(*[args.term_col[t] for t in order]),
        (ctypes.c_int64 * nt)(*[args.lo_i[t] for t in order]),
        (ctypes.c_int64 * nt)(*[args.hi_i[t] for t in order]),
        (ctypes.c_double * nt)(*[args.lo_f[t] for t in order]),
        (ctypes.c_double * nt)(*[args.hi_f[t] for t in order]),
        (ctypes.c_int * nt)(*[term_flags(args, t) for t in order]),
        nt,
    )


def term_flags(args: RangeArgs, t: int) -> int:
    """Term ``t``'s flag word for the kernel: bit 0 has_lo, 1 has_hi,
    2 lo_strict, 3 hi_strict, 4 float64 column."""
    has_lo, has_hi, lo_strict, hi_strict = args.flags[t]
    f64 = args.cols[args.term_col[t]].dtype == torch.float64
    return int(has_lo) | int(has_hi) << 1 | int(lo_strict) << 2 | int(hi_strict) << 3 | int(f64) << 4


def _check_args(args: RangeArgs) -> None:
    n, dev = args.n, args.cols[0].device
    if not 1 <= len(args.cols) <= MAX_RANGE_TERMS or not 1 <= len(args.term_col) <= MAX_RANGE_TERMS:
        raise ValueError("the range mask takes 1 to 16 columns and terms")
    if sorted(set(args.term_col)) != list(range(len(args.cols))):
        raise ValueError("every column needs a term and every term a column")
    for c in args.cols:
        if c.device != dev or c.shape != (n,) or not c.is_contiguous() or c.dtype not in (
            torch.int64, torch.float64
        ):
            raise ValueError("range mask columns must be contiguous [n] int64 or float64 "
                             "tensors on one device")
    for m in args.valids:
        if m is not None and (m.device != dev or m.shape != (n,) or not m.is_contiguous()
                              or m.dtype != torch.bool):
            raise ValueError("range mask validity must be a contiguous [n] bool tensor")


def _launch(args: RangeArgs, out: torch.Tensor, stream: int) -> None:
    """Hand the columns, validity masks and terms (grouped by column, so
    the kernel reads each column once a row) to the C function on
    ``stream``; raise on any error code it returns."""
    global launches
    _check_args(args)
    err = _kernel_fn()(*term_arrays(args), out.data_ptr(), args.n, stream)
    if err != 0:
        raise KernelLaunchError(f"range mask kernel launch failed: CUDA error {err}")
    if args.n:  # the C side launches nothing for n = 0
        launches += 1


def range_mask_kernel(args: RangeArgs) -> torch.Tensor:
    """Launch ``csrc/range_mask.cu`` on the current stream over contiguous
    CUDA columns; returns the ``[n]`` bool mask on the card."""
    dev = args.cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"range_mask_kernel needs CUDA tensors, got {dev}")
    _check_args(args)
    out = torch.empty(args.n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _launch(args, out, torch.cuda.current_stream(dev).cuda_stream)
    return out


def range_mask(args: RangeArgs) -> torch.Tensor:
    """The fused range mask on the columns' device: the plain version for
    CPU tensors, kernel B3a for CUDA tensors (it raises on what it cannot
    take; there is no fallback)."""
    dev = args.cols[0].device
    if dev.type == "cpu":
        return range_mask_torch(args)
    if dev.type == "cuda":
        return range_mask_kernel(args)
    raise ValueError(f"range_mask: unsupported device {dev}")


def fused_range_mask(expr: E.Expr, batch, device) -> Optional[np.ndarray]:
    """The executor's fused route: the host bool mask when the whole
    predicate lowers to numeric range terms over 8-byte int or float64
    columns with exactly representable bounds, else None (the caller
    takes :func:`device_filter_mask`)."""
    n = batch.num_rows
    if n == 0:
        return None
    terms = lower_range_terms(expr, batch)
    if terms is None:
        return None
    args = range_args(batch, terms, device)
    if args is None:
        return None
    if args == NEVER_MATCH:
        return np.zeros(n, dtype=bool)
    return range_mask(args).cpu().numpy()


# -- the fused select (kernel B3b) -----------------------------------------------


def select_torch(args: RangeArgs) -> torch.Tensor:
    """Plain version of B3b, on the tensors' own device: the indices of
    the rows :func:`range_mask_torch` passes, ascending, as int64."""
    return torch.nonzero(range_mask_torch(args)).flatten()


def select_kernel(args: RangeArgs) -> torch.Tensor:
    """Launch ``csrc/fused_select.cu`` on the current stream over
    contiguous CUDA columns; returns the passing rows' indices
    (``[count]`` int64 on the card, ascending). Reads the count back to
    size the result."""
    global select_launches
    dev = args.cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"select_kernel needs CUDA tensors, got {dev}")
    _check_args(args)
    n = args.n
    lib = _select_lib()
    out = torch.empty(n, dtype=torch.int64, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        scratch = torch.empty(int(lib.hs_select_scratch_bytes(n)), dtype=torch.uint8, device=dev)
        err = lib.hs_fused_select(*term_arrays(args), n, out.data_ptr(), total.data_ptr(),
                                  scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"fused select kernel launch failed: CUDA error {err}")
    if n:  # one kernel (decoupled look-back); nothing for n = 0
        select_launches += 1
    return out[: int(total.item())]


def select_rows(args: RangeArgs) -> torch.Tensor:
    """The passing rows' indices on the columns' device: the plain version
    for CPU tensors, kernel B3b for CUDA tensors (no fallback)."""
    dev = args.cols[0].device
    if dev.type == "cpu":
        return select_torch(args)
    if dev.type == "cuda":
        return select_kernel(args)
    raise ValueError(f"select_rows: unsupported device {dev}")


def fused_filter_select(terms, batch, device) -> Optional[np.ndarray]:
    """The passing row indices of ``terms`` over ``batch`` (host int64,
    ascending: exactly ``np.nonzero`` of their mask), computed on
    ``device``; an empty array when a bound can never hold
    (:data:`NEVER_MATCH`, before any launch), or None when a term column
    is not an 8-byte int or float64 array or a bound does not lower
    exactly (the caller takes the mask route)."""
    n = batch.num_rows
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    args = range_args(batch, terms, device)
    if args is None:
        return None
    if args == NEVER_MATCH:
        return np.zeros(0, dtype=np.int64)
    return select_rows(args).cpu().numpy()
