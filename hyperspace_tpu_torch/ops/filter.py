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

The spec then evaluates with SQL three-valued logic on the device; the
mask is ``values & known``. What cannot lower raises :class:`Unsupported`
and the executor evaluates it on the host.
"""

from __future__ import annotations

import warnings
from typing import Any, List

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import expressions as E


class Unsupported(HyperspaceException):
    """Expression not lowerable to the device; the caller evaluates it on
    the host."""


# numpy dtypes the device path takes as they are (PyTorch lacks most
# arithmetic on the wider unsigned types; those are widened on the host
# by the common-type cast, or refused)
_TORCH_OK = {
    np.dtype(t)
    for t in (
        np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
        np.float16, np.float32, np.float64,
    )
}


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


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
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
