"""Fused serve pipeline: the filter→aggregate and filter→select routes,
and the metadata aggregate over the aggregate index plane.

Counterpart of ``hyperspace_tpu/execution/pipeline_compiler.py``. A
``Filter(→Project)→Aggregate`` over a pruned index scan runs as one fused
pass a row-group chunk (``try_fused_aggregate``): the chunk's columns go
to the session's device once, and the range terms, the grouping and the
partial COUNT/SUM/MIN/MAX stay there (``ops/fused_agg.py``, kernel B5f
with B5 on the card), carried across chunks in file order and finalized
once. A plain ``Filter`` over a scan compacts its passing rows in one
pass (``fused_filter_batch``: ``ops/filter.fused_filter_select``, kernel
B3b on the card). An aggregate whose predicate's intervals decide whole
row groups answers those from the persisted partials of
``_aggstate.json`` without reading them and scans only the boundary row
groups (``try_metadata_aggregate``, sidecars in ``indexes/aggindex.py``).

Every route gives the interpreted chain's rows bit for bit (float sums
included: the fold is sequential in row order, as ``np.add.at``), group
order ascending key-rep planes, first-occurrence group key values; the
twins ``interpreted_filter_aggregate`` and ``filter_select_interpreted``
stay as the differential references. ``hyperspace.serve.fusedpipeline.
enabled`` and ``hyperspace.index.agg.enabled`` turn the routes off.
Hybrid Scan's shapes decline both routes, as in the reference: a
``Union`` is no ``Filter(Scan)``, and a scan with delete compensation
(``excluded_file_ids``) fails ``executor._cacheable_scan``.

Two differences from the reference change which route runs, never a
result (``ROADMAP.md``): the dispatch threshold is the module constant
``_NATIVE_FUSED_PIPELINE_MIN_ROWS`` (the reference calibrates it per
machine, queue A item 10), and ``fused_filter_batch`` has no
device-regime gate (the port has no host regime for masks).

With serve-server mode on (``execution/serve_cache.py``) the fused
aggregate folds the cached scan batch in one pass instead of reading
parquet chunks, lowered plans are kept under ``("fusedplan", fp, ...)``,
and the metadata route leaves boundary row groups to the fused pass when
their columns are already cached.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.ops import fused_agg as FA
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    Project,
    Scan,
    _agg_output_type,
)

# Telemetry of the LAST fused execution in this process: mode "agg" |
# "select", rows scanned vs passed, groups, chunks, wall seconds.
last_fused_stats: Dict[str, Any] = {}

# Telemetry of the LAST metadata-plane aggregate: row groups answered from
# persisted partials vs scanned vs provably empty, rows the boundary
# chunks read.
last_aggplane_stats: Dict[str, Any] = {}

#: scanned rows at or above which the fused routes dispatch (tests and
#: scripts may override it)
_NATIVE_FUSED_PIPELINE_MIN_ROWS = C.NATIVE_FUSED_PIPELINE_MIN_ROWS_DEFAULT

#: rows the chunked fused pass folds at once: consecutive files' tables are
#: joined up to this many rows before one fold. The fold of a
#: concatenation equals the folds of its parts in order (the sweep is in
#: row order), and a fold costs a few host round trips whatever its size.
_FUSED_FOLD_ROWS = 1 << 23

_OP_COUNT_STAR = FA.OP_COUNT_STAR
_OP_COUNT_COL = FA.OP_COUNT_COL
_OP_SUM_I64 = FA.OP_SUM_I64
_OP_SUM_F64 = FA.OP_SUM_F64
_OP_MIN_I64 = FA.OP_MIN_I64
_OP_MAX_I64 = FA.OP_MAX_I64
_OP_MIN_F64 = FA.OP_MIN_F64
_OP_MAX_F64 = FA.OP_MAX_F64


def _resolve(device) -> torch.device:
    """The session module's device rule: None is cuda (raising without a
    card); an explicit device as given."""
    from hyperspace_tpu_torch.session import resolve_device

    return resolve_device(device)


def fused_pipeline_on(session) -> bool:
    """``hyperspace.serve.fusedpipeline.enabled`` (default on)."""
    return session.conf.serve_fusedpipeline_enabled


# ---------------------------------------------------------------------------
# Type lowering
# ---------------------------------------------------------------------------


def _np_kind(t: pa.DataType) -> str:
    """The numpy dtype kind a column of arrow type ``t`` decodes to
    (``Column.from_arrow``), for lowering the terms before a read."""
    if pa.types.is_dictionary(t):
        t = t.value_type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return "S"
    if pa.types.is_boolean(t):
        return "b"
    if pa.types.is_unsigned_integer(t):
        return "u"
    if pa.types.is_integer(t):
        return "i"
    if pa.types.is_floating(t):
        return "f"
    if pa.types.is_temporal(t):
        return "i"
    return "O"


def _fusable_f64(t: pa.DataType) -> Optional[bool]:
    """True: decodes to float64; False: to an 8-byte int64 view (int64,
    timestamp, date, duration, time64); None: not fusable (the
    interpreted chain keeps the column)."""
    if pa.types.is_float64(t):
        return True
    if pa.types.is_int64(t):
        return False
    if (
        pa.types.is_timestamp(t)
        or pa.types.is_date(t)
        or pa.types.is_duration(t)
        or pa.types.is_time64(t)
    ):
        return False
    return None


def _col_arr_8b(col: Column) -> Optional[np.ndarray]:
    """The contiguous 8-byte view of a numeric column (float64 as it is,
    int64/temporal as int64), or None."""
    if col.kind != "numeric":
        return None
    v = col.values
    if v.ndim != 1 or v.dtype.itemsize != 8:
        return None
    if v.dtype.kind == "f":
        if v.dtype != np.float64:
            return None
        arr = v
    elif v.dtype.kind in "iMm":
        arr = v.view(np.int64)
    else:
        return None
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return arr


# ---------------------------------------------------------------------------
# Interpreted twins
# ---------------------------------------------------------------------------


def filter_select_interpreted(batch: ColumnarBatch, terms) -> np.ndarray:
    """The chain the fused select replaces: the host mask, then
    ``np.nonzero``."""
    from hyperspace_tpu_torch.ops.filter import range_mask_numpy

    return np.nonzero(range_mask_numpy(batch, terms))[0]


def interpreted_filter_aggregate(
    batch: ColumnarBatch, terms, group_by, aggs, child_schema, device=None
) -> ColumnarBatch:
    """The chain the fused aggregate replaces: the host mask, the filtered
    batch, then the hash aggregate (factorize and B5 on ``device``; None
    is cuda)."""
    from hyperspace_tpu_torch.execution.aggregate_exec import execute_aggregate
    from hyperspace_tpu_torch.ops.filter import range_mask_numpy

    fb = batch.filter(range_mask_numpy(batch, terms))
    return execute_aggregate(fb, list(group_by), list(aggs), child_schema, _resolve(device))


# ---------------------------------------------------------------------------
# Plan lowering
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedAggPlan:
    """A lowered Filter→Aggregate: everything derivable from (condition,
    group_by, aggs, schema), no row state."""

    read_cols: Tuple[str, ...]
    terms: Tuple  # lower_range_terms output
    term_f64: Tuple[bool, ...]
    bounds: Tuple  # (lo_i, hi_i, lo_f, hi_f, flags): native_range_bounds
    group_by: Tuple[str, ...]
    key_f64: Tuple[bool, ...]
    key_types: Tuple
    agg_ops: Tuple[Tuple[int, Optional[str]], ...]
    aggs: Tuple
    out_types: Tuple

    # what the serve cache's LRU charges: the symbolic lowering only
    nbytes: int = 2048


def _lower_from_terms(
    terms,
    group_by: Sequence[str],
    aggs,
    child_schema,
    rel_col_order: Optional[Sequence[str]] = None,
) -> Optional[FusedAggPlan]:
    """FusedAggPlan from already lowered range terms, or None when a group
    key, an aggregate input or a term column is outside the fused type
    set, or a bound is unrepresentable or never holds (the interpreted
    chain decides those)."""
    if terms is None or len(group_by) > FA.MAX_KEYS:
        return None
    term_f64 = []
    for name, *_rest in terms:
        if name not in child_schema:
            return None
        f64 = _fusable_f64(child_schema[name])
        if f64 is None:
            return None
        term_f64.append(f64)
    from hyperspace_tpu_torch.ops.filter import NEVER_MATCH, native_range_bounds

    bounds = native_range_bounds(terms, term_f64)
    if bounds is None or bounds == NEVER_MATCH:
        return None
    key_f64 = []
    key_types = []
    for c in group_by:
        f64 = _fusable_f64(child_schema[c])
        if f64 is None:
            return None
        key_f64.append(f64)
        key_types.append(child_schema[c])
    agg_ops: List[Tuple[int, Optional[str]]] = []
    out_types = []
    for spec in aggs:
        out_types.append(_agg_output_type(spec, child_schema))
        if spec.func == "count":
            if spec.column is None:
                agg_ops.append((_OP_COUNT_STAR, None))
            else:
                # COUNT(col) reads only the validity: any column type counts
                agg_ops.append((_OP_COUNT_COL, spec.column))
            continue
        f64 = _fusable_f64(child_schema[spec.column])
        if f64 is None:
            return None
        if spec.func in ("sum", "avg"):
            agg_ops.append((_OP_SUM_F64 if f64 else _OP_SUM_I64, spec.column))
        elif spec.func == "min":
            agg_ops.append((_OP_MIN_F64 if f64 else _OP_MIN_I64, spec.column))
        else:  # max
            agg_ops.append((_OP_MAX_F64 if f64 else _OP_MAX_I64, spec.column))
    needed = set(group_by) | {t[0] for t in terms} | {
        c for _op, c in agg_ops if c is not None
    }
    order = rel_col_order if rel_col_order is not None else sorted(needed)
    read_cols = tuple(c for c in order if c in needed)
    return FusedAggPlan(
        read_cols=read_cols,
        terms=tuple(terms),
        term_f64=tuple(term_f64),
        bounds=tuple(bounds),
        group_by=tuple(group_by),
        key_f64=tuple(key_f64),
        key_types=tuple(key_types),
        agg_ops=tuple(agg_ops),
        aggs=tuple(aggs),
        out_types=tuple(out_types),
    )


def _lower_fused_agg(
    cond: E.Expr, group_by, aggs, child_schema, rel_col_order=None
) -> Optional[FusedAggPlan]:
    from hyperspace_tpu_torch.ops.filter import lower_range_terms_typed

    cols = {name: (_np_kind(t), t) for name, t in child_schema.items()}
    terms = lower_range_terms_typed(cond, cols)
    if terms is None:
        return None
    return _lower_from_terms(terms, group_by, aggs, child_schema, rel_col_order)


# ---------------------------------------------------------------------------
# Accumulator state (carried across row-group chunks)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AggPartials:
    """The host snapshot of one fused aggregation's carried state: the
    one layout the sidecar capture (``indexes/aggindex.py``), the
    metadata merge and the fused sweep share. Arrays are sliced to the
    live group count ``G``, groups in the producer's first-occurrence
    order. Per aggregate slot: ``acc_cnt`` valid rows (passing rows for
    COUNT(*)), ``acc_i`` wrapped int64 sums or int min/max (identity
    without valid rows), ``acc_f`` float sums or min/max over clean
    values, ``acc_aux`` clean rows (float MIN) or NaN rows (float MAX)."""

    n_groups: int
    rows_scanned: int
    rows_passed: int
    g_reps: np.ndarray  # (nk, G) canonical key reps (Column.key_rep)
    g_nulls: np.ndarray  # (nk, G) uint8 null plane
    g_kvals: np.ndarray  # (nk, G) first-occurrence raw key bits (int64 view)
    g_kvalid: np.ndarray  # (nk, G) uint8 validity of the stored key value
    key_has_validity: Tuple[bool, ...]
    acc_i: np.ndarray  # (na, G) int64 accumulators
    acc_f: np.ndarray  # (na, G) float64 accumulators
    acc_cnt: np.ndarray  # (na, G) valid/pass counts
    acc_aux: np.ndarray  # (na, G) float min/max aux counts


def _device_col(arr: np.ndarray, device) -> torch.Tensor:
    from hyperspace_tpu_torch.ops.filter import _to_device

    return _to_device(arr, torch.device(device))


class AggState:
    """One fused aggregation's state on the session's device
    (``ops/fused_agg.FusedAggState``), folded a chunk at a time. ``plan``
    needs ``group_by`` and ``agg_ops``, and for a filter ``terms``,
    ``term_f64`` and ``bounds`` (a FusedAggPlan or a ``_PartialsSpec``).
    ``device`` None is cuda."""

    def __init__(self, plan, device=None):
        self.plan = plan
        self.device = _resolve(device)
        self.state = FA.FusedAggState.empty(
            len(plan.group_by), [op for op, _c in plan.agg_ops], self.device)
        self.rows_scanned = 0
        self.chunks = 0
        self.key_has_validity = [False] * len(plan.group_by)

    @property
    def n_groups(self) -> int:
        return self.state.n_groups

    @property
    def rows_passed(self) -> int:
        return self.state.rows_passed

    def _chunk(self, batch: ColumnarBatch) -> Optional[FA.FusedChunk]:
        """The batch's device inputs, each column moved once, or None when
        a column falls outside the fused set."""
        from hyperspace_tpu_torch.ops.filter import RangeArgs

        plan, dev = self.plan, self.device
        moved: Dict[str, tuple] = {}

        def col8(name: str, f64: Optional[bool]):
            if name not in moved:
                col = batch.column(name)
                arr = _col_arr_8b(col)
                moved[name] = None if arr is None else (
                    _device_col(arr, dev),
                    None if col.validity is None else _device_col(col.validity, dev),
                )
            got = moved[name]
            if got is None or (f64 is not None and (got[0].dtype == torch.float64) != f64):
                return None
            return got

        terms = None
        terms_spec = getattr(plan, "terms", ())
        if terms_spec:
            slot_of: Dict[str, int] = {}
            cols, valids, term_col = [], [], []
            for (name, *_rest), f64 in zip(terms_spec, plan.term_f64):
                got = col8(name, f64)
                if got is None:
                    return None
                if name not in slot_of:
                    slot_of[name] = len(cols)
                    cols.append(got[0])
                    valids.append(got[1])
                term_col.append(slot_of[name])
            terms = RangeArgs(cols, valids, term_col, *[list(b) for b in plan.bounds])
        keys = []
        for name in plan.group_by:
            got = col8(name, None)
            if got is None:
                return None
            bits, valid = got
            f64 = bits.dtype == torch.float64
            keys.append((bits.view(torch.int64) if f64 else bits, valid, f64))
        aggs = []
        for op, cname in plan.agg_ops:
            if cname is None:
                aggs.append((op, None, None))
                continue
            col = batch.column(cname)
            if op >= _OP_SUM_I64:
                got = col8(cname, op in (_OP_SUM_F64, _OP_MIN_F64, _OP_MAX_F64))
                if got is None:
                    return None
                aggs.append((op, got[0], got[1]))
            elif col.kind == "numeric":
                valid = None if col.validity is None else _device_col(col.validity, dev)
                aggs.append((op, None, valid))
            else:  # string COUNT(col): valid rows from the codes
                nm = col.null_mask
                aggs.append((op, None, None if nm is None else _device_col(~nm, dev)))
        return FA.FusedChunk(batch.num_rows, terms, keys, aggs, self.state.device)

    def accumulate(self, batch: ColumnarBatch) -> bool:
        """Fold one chunk into the state (False: a column fell outside the
        fused set; the caller runs the interpreted chain instead)."""
        n = batch.num_rows
        self.rows_scanned += n
        self.chunks += 1
        if n == 0:
            return True
        chunk = self._chunk(batch)
        if chunk is None:
            return False
        for j, name in enumerate(self.plan.group_by):
            if batch.column(name).validity is not None:
                self.key_has_validity[j] = True
        self.state = FA.fused_filter_agg(self.state, chunk)
        return True

    def partials(self) -> AggPartials:
        """The carried state as host :class:`AggPartials` (one copy from
        the device for all its arrays)."""
        st = self.state
        parts = [st.g_reps, st.g_nulls.to(torch.int64), st.g_kvals,
                 st.g_kvalid.to(torch.int64), st.acc_i, st.acc_f.view(torch.int64),
                 st.acc_cnt, st.acc_aux]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        host, at = [], 0
        for p in parts:
            host.append(flat[at: at + p.numel()].reshape(tuple(p.shape)))
            at += p.numel()
        reps, nulls, kvals, kvalid, acc_i, acc_f, acc_cnt, acc_aux = host
        return AggPartials(
            n_groups=st.n_groups,
            rows_scanned=self.rows_scanned,
            rows_passed=st.rows_passed,
            g_reps=reps,
            g_nulls=nulls.astype(np.uint8),
            g_kvals=kvals,
            g_kvalid=kvalid.astype(np.uint8),
            key_has_validity=tuple(self.key_has_validity),
            acc_i=acc_i,
            acc_f=acc_f.view(np.float64),
            acc_cnt=acc_cnt,
            acc_aux=acc_aux,
        )


#: the reference's private name of the chunk-state carrier
_AggState = AggState


def _factorize_order(reps: np.ndarray, nulls: np.ndarray) -> np.ndarray:
    """Group order of ``aggregate_exec._factorize`` over ``[nk, G]`` rep
    and null planes: ascending (rep, null), keys major to minor."""
    planes: List[np.ndarray] = []
    for j in range(reps.shape[0]):
        planes.append(reps[j])
        planes.append(nulls[j].astype(np.int64))
    if not planes:
        return np.arange(reps.shape[1], dtype=np.int64)
    return np.lexsort(planes[::-1])


def partials_from_batch(
    plan, batch: ColumnarBatch, rows_scanned: Optional[int] = None, device=None
) -> Optional[AggPartials]:
    """One already filtered batch as :class:`AggPartials`, its groups in
    ``_factorize``'s order (ascending rep and null planes), as the JAX
    package's numpy twin gives them: the fused route with no terms on
    ``device`` (None is cuda; kernel B5f on the card, its plain version on
    the CPU),
    then the groups reordered. Shared by the sidecar capture and the
    metadata plane's boundary chunks. ``plan`` needs ``group_by`` and
    ``agg_ops``. None when a column falls outside the fused set."""
    spec = _PartialsSpec(plan.group_by, plan.agg_ops)
    state = AggState(spec, device)
    if not state.accumulate(batch):
        return None
    pt = state.partials()
    order = _factorize_order(pt.g_reps, pt.g_nulls)
    take = lambda a: np.ascontiguousarray(a[:, order])  # noqa: E731
    return dataclasses.replace(
        pt,
        rows_scanned=batch.num_rows if rows_scanned is None else rows_scanned,
        key_has_validity=tuple(batch.column(c).validity is not None for c in plan.group_by),
        g_reps=take(pt.g_reps), g_nulls=take(pt.g_nulls), g_kvals=take(pt.g_kvals),
        g_kvalid=take(pt.g_kvalid), acc_i=take(pt.acc_i), acc_f=take(pt.acc_f),
        acc_cnt=take(pt.acc_cnt), acc_aux=take(pt.acc_aux),
    )


class _PartialsSpec:
    """What :class:`AggState` reads of a plan: ``group_by`` and
    ``agg_ops``, and the range terms with their ``term_f64`` and
    ``bounds`` (none: every row passes)."""

    def __init__(self, group_by, agg_ops, terms=(), term_f64=(), bounds=()):
        self.group_by = tuple(group_by)
        self.agg_ops = tuple(agg_ops)
        self.terms, self.term_f64, self.bounds = tuple(terms), tuple(term_f64), tuple(bounds)


class PartialsAccumulator:
    """Order-preserving fold of :class:`AggPartials` snapshots into one
    group table: where sidecar partials and scanned boundary-chunk
    partials meet. Bit-exact only for COUNT, int SUM (wraps mod 2^64) and
    MIN/MAX (``np.minimum``/``maximum``, replace on equal), the ops the
    metadata plane admits; float SUM never reaches a fold. Callers fold in
    the interpreted chain's row order (file order, row-group order within
    a file)."""

    _INIT_CAP = 64

    def __init__(self, plan):
        self.plan = plan
        self._nk = len(plan.group_by)
        self._na = len(plan.agg_ops)
        self._slots: Dict[tuple, int] = {}
        self._n = 0
        self._alloc(self._INIT_CAP)
        self.rows_scanned = 0
        self.rows_passed = 0
        self.key_has_validity = [False] * self._nk
        if not plan.group_by:
            # an ungrouped aggregation always yields one global group
            self._slots[()] = 0
            self._n = 1

    def _alloc(self, cap: int) -> None:
        nk, na = self._nk, self._na
        n = self._n
        old = getattr(self, "_g_reps", None)
        self._cap = cap
        for name, dt, fill in (
            ("_g_reps", np.int64, 0),
            ("_g_nulls", np.uint8, 0),
            ("_g_kvals", np.int64, 0),
            ("_g_kvalid", np.uint8, 1),
        ):
            arr = np.full((nk, cap), fill, dtype=dt)
            if old is not None:
                arr[:, :n] = getattr(self, name)[:, :n]
            setattr(self, name, arr)
        acc_i = np.zeros((na, cap), dtype=np.int64)
        acc_f = np.zeros((na, cap), dtype=np.float64)
        acc_cnt = np.zeros((na, cap), dtype=np.int64)
        acc_aux = np.zeros((na, cap), dtype=np.int64)
        for a, (op, _c) in enumerate(self.plan.agg_ops):
            if op == _OP_MIN_I64:
                acc_i[a] = np.iinfo(np.int64).max
            elif op == _OP_MAX_I64:
                acc_i[a] = np.iinfo(np.int64).min
            elif op == _OP_MIN_F64:
                acc_f[a] = np.inf
            elif op == _OP_MAX_F64:
                acc_f[a] = -np.inf
        if old is not None:
            acc_i[:, :n] = self._acc_i[:, :n]
            acc_f[:, :n] = self._acc_f[:, :n]
            acc_cnt[:, :n] = self._acc_cnt[:, :n]
            acc_aux[:, :n] = self._acc_aux[:, :n]
        self._acc_i, self._acc_f = acc_i, acc_f
        self._acc_cnt, self._acc_aux = acc_cnt, acc_aux

    def fold(self, p: Optional[AggPartials]) -> None:
        if p is None:
            return
        self.rows_scanned += p.rows_scanned
        self.rows_passed += p.rows_passed
        for j, hv in enumerate(p.key_has_validity):
            self.key_has_validity[j] |= hv
        G = p.n_groups
        if G == 0:
            return
        while self._n + G > self._cap:
            self._alloc(self._cap * 4)
        # group keys within one snapshot are distinct, so ``idx`` never
        # repeats a destination and the indexed updates below are exact
        nk = self._nk
        idx = np.empty(G, dtype=np.int64)
        for g in range(G):
            key = tuple(
                (int(p.g_reps[j, g]), int(p.g_nulls[j, g])) for j in range(nk)
            )
            gi = self._slots.get(key)
            if gi is None:
                gi = self._n
                self._slots[key] = gi
                self._n += 1
                for j in range(nk):
                    self._g_reps[j, gi] = p.g_reps[j, g]
                    self._g_nulls[j, gi] = p.g_nulls[j, g]
                    self._g_kvals[j, gi] = p.g_kvals[j, g]
                    self._g_kvalid[j, gi] = p.g_kvalid[j, g]
            idx[g] = gi
        for a, (op, _c) in enumerate(self.plan.agg_ops):
            self._acc_cnt[a][idx] += p.acc_cnt[a]
            if op == _OP_SUM_I64:
                self._acc_i[a][idx] += p.acc_i[a]  # int64 adds wrap
            elif op == _OP_SUM_F64:
                self._acc_f[a][idx] += p.acc_f[a]
            elif op == _OP_MIN_I64:
                self._acc_i[a][idx] = np.minimum(self._acc_i[a][idx], p.acc_i[a])
            elif op == _OP_MAX_I64:
                self._acc_i[a][idx] = np.maximum(self._acc_i[a][idx], p.acc_i[a])
            elif op == _OP_MIN_F64:
                self._acc_f[a][idx] = np.minimum(self._acc_f[a][idx], p.acc_f[a])
                self._acc_aux[a][idx] += p.acc_aux[a]
            elif op == _OP_MAX_F64:
                self._acc_f[a][idx] = np.maximum(self._acc_f[a][idx], p.acc_f[a])
                self._acc_aux[a][idx] += p.acc_aux[a]

    def snapshot(self) -> AggPartials:
        G = self._n
        return AggPartials(
            n_groups=G,
            rows_scanned=self.rows_scanned,
            rows_passed=self.rows_passed,
            g_reps=self._g_reps[:, :G].copy(),
            g_nulls=self._g_nulls[:, :G].copy(),
            g_kvals=self._g_kvals[:, :G].copy(),
            g_kvalid=self._g_kvalid[:, :G].copy(),
            key_has_validity=tuple(self.key_has_validity),
            acc_i=self._acc_i[:, :G].copy(),
            acc_f=self._acc_f[:, :G].copy(),
            acc_cnt=self._acc_cnt[:, :G].copy(),
            acc_aux=self._acc_aux[:, :G].copy(),
        )


def finalize_partials(plan, pt: AggPartials) -> ColumnarBatch:
    """The output batch from a partials snapshot: ``aggregate_exec``'s
    finalization, groups ordered as ``_factorize`` orders them (ascending
    key-rep planes, rep major and null plane minor per key). The one
    finalization of the fused sweep and the metadata merge."""
    from hyperspace_tpu_torch.execution import aggregate_exec as AE

    G = pt.n_groups
    out: Dict[str, Column] = {}
    if plan.group_by:
        order = _factorize_order(pt.g_reps, pt.g_nulls)
        for j, name in enumerate(plan.group_by):
            raw = pt.g_kvals[j][order]
            vals = raw.view(np.float64) if plan.key_f64[j] else raw
            validity = (
                pt.g_kvalid[j][order].astype(bool)
                if pt.key_has_validity[j]
                else None
            )
            out[name] = Column(
                "numeric", plan.key_types[j], values=vals, validity=validity
            )
    else:
        order = np.arange(G, dtype=np.int64)  # exactly one global group
    for a, (spec, (op, _c), out_type) in enumerate(
        zip(plan.aggs, plan.agg_ops, plan.out_types)
    ):
        cnt = pt.acc_cnt[a][order]
        if op in (_OP_COUNT_STAR, _OP_COUNT_COL):
            out[spec.name] = AE.finalize_count(out_type, cnt)
        elif op in (_OP_SUM_I64, _OP_SUM_F64):
            sums = (pt.acc_i if op == _OP_SUM_I64 else pt.acc_f)[a][order]
            if spec.func == "avg":
                out[spec.name] = AE.finalize_avg(out_type, sums, cnt)
            else:
                out[spec.name] = AE.finalize_sum(out_type, sums, cnt)
        elif op in (_OP_MIN_I64, _OP_MAX_I64):
            red = pt.acc_i[a][order]
            out[spec.name] = AE.finalize_minmax(
                out_type, red, cnt, np.dtype(np.int64)
            )
        elif op == _OP_MIN_F64:
            acc = pt.acc_f[a][order]
            has_clean = pt.acc_aux[a][order] > 0
            red = np.where(has_clean, acc, np.float64(np.nan))
            out[spec.name] = AE.finalize_minmax(
                out_type, red, cnt, np.dtype(np.float64)
            )
        else:  # _OP_MAX_F64
            acc = pt.acc_f[a][order]
            has_nan = pt.acc_aux[a][order] > 0
            red = np.where(has_nan, np.float64(np.nan), acc)
            out[spec.name] = AE.finalize_minmax(
                out_type, red, cnt, np.dtype(np.float64)
            )
    return ColumnarBatch(out)


def _finalize(state: AggState) -> ColumnarBatch:
    return finalize_partials(state.plan, state.partials())


def kernel_filter_aggregate(
    batches, terms, group_by, aggs, child_schema, device=None
) -> Optional[ColumnarBatch]:
    """The fused pass over one batch or an ordered list of chunk batches
    on ``device`` (None is cuda): the counterpart of :func:`interpreted_filter_aggregate`
    for differential tests. None when the shape is outside the fused set."""
    if isinstance(batches, ColumnarBatch):
        batches = [batches]
    plan = _lower_from_terms(terms, group_by, aggs, child_schema)
    if plan is None:
        return None
    state = AggState(plan, device)
    for b in batches:
        if not state.accumulate(b):
            return None
    return _finalize(state)


# ---------------------------------------------------------------------------
# Executor entry points
# ---------------------------------------------------------------------------


def fused_filter_batch(cond: E.Expr, batch: ColumnarBatch, session):
    """The fused Filter(→Project) over an in-memory batch: the passing row
    indices of the range conjunction in one pass on the session's device
    (kernel B3b on the card), then the rows gathered through them; equal
    to ``batch.filter(mask)``, which is ``take(nonzero(mask))``. None
    (the caller takes the mask route) off the fused shape or below the
    dispatch threshold."""
    global last_fused_stats
    n = batch.num_rows
    if n == 0 or n < _NATIVE_FUSED_PIPELINE_MIN_ROWS:
        return None
    from hyperspace_tpu_torch.ops import filter as F

    terms = F.lower_range_terms(cond, batch)
    if terms is None:
        return None
    t0 = time.perf_counter()
    idx = F.fused_filter_select(terms, batch, session.device)
    if idx is None:
        return None
    out = batch.take(idx)
    last_fused_stats = {
        "mode": "select",
        "rows_scanned": n,
        "rows_passed": int(len(idx)),
        "rows_materialized": int(len(idx)),
        "chunks": 1,
        "wall_s": time.perf_counter() - t0,
    }
    return out


def try_fused_aggregate(plan: Aggregate, session) -> Optional[ColumnarBatch]:
    """Serve ``Aggregate(…, [Project(…,)] Filter(cond, Scan))`` over a
    pruned index scan as the fused pipeline. None when any gate fails;
    the caller runs the interpreted chain (the same rows either way)."""
    if not fused_pipeline_on(session):
        return None
    node = plan.child
    while isinstance(node, Project):
        node = node.child
    if not isinstance(node, Filter) or not isinstance(node.child, Scan):
        return None
    from hyperspace_tpu_torch.execution import executor as X

    pruned = X._bucket_pruned_scan(node.child, node.condition, session)
    pruned = X._range_pruned_scan(pruned, node.condition, session)
    if not isinstance(pruned, Scan):
        return None
    rel = pruned.relation
    if not X._cacheable_scan(rel):
        return None
    # the Project above the Filter prunes to the aggregate's inputs, so
    # the condition's columns live in the scan's schema
    child_schema = dict(rel.schema)
    child_schema.update(plan.child.schema())
    fplan = _compiled_plan(node.condition, plan, rel, child_schema, session)
    if fplan is None:
        return None
    cache = X._serve_cache(session)
    if cache is not None:  # rel passed _cacheable_scan above
        # serve-server mode keeps the decoded scan in RAM: one fused pass
        # over the cached batch (no read at all) instead of streaming
        # parquet chunks past a warm cache
        return _run_cached(fplan, rel, session)
    if _scan_row_total(rel) < _NATIVE_FUSED_PIPELINE_MIN_ROWS:
        return None
    return _run_chunked(fplan, rel, session)


def _run_cached(fplan: FusedAggPlan, rel, session) -> Optional[ColumnarBatch]:
    """The fused pass over the serve cache's batch of ``rel`` (read and
    cached on a miss) as one chunk; None below the dispatch threshold or
    when a column falls outside the fused set."""
    global last_fused_stats
    from hyperspace_tpu_torch.execution import executor as X
    from hyperspace_tpu_torch.execution.join_exec import _stats_add

    t_read = time.perf_counter()
    hit = X._scan_cache_entry(rel, set(fplan.read_cols), session)
    if hit is None:
        return None
    entry, _cols = hit
    batch = entry.batch_for(fplan.read_cols)
    _stats_add(session.agg_stats, "scan", t_read)
    if batch is None or batch.num_rows < _NATIVE_FUSED_PIPELINE_MIN_ROWS:
        return None
    t0 = time.perf_counter()
    state = AggState(fplan, session.device)
    if not state.accumulate(batch):
        return None
    out = _finalize(state)
    last_fused_stats = _agg_stats(state, t0)
    return out


def _agg_stats(state: AggState, t0: float) -> Dict[str, Any]:
    return {
        "mode": "agg",
        "rows_scanned": state.rows_scanned,
        "rows_passed": state.rows_passed,
        # the fused pass materializes groups, never filtered rows
        "rows_materialized": int(state.n_groups if state.plan.group_by else 1),
        "groups": int(state.n_groups),
        "chunks": state.chunks,
        # the port's own: the plan's route on the card, and the chunks a
        # block's table overflow sent from the one pass to the ordered route
        "fused_route": FA.route(state.state.ops),
        "overflowed_chunks": state.state.overflowed,
        "wall_s": time.perf_counter() - t0,
    }


def _compiled_plan(
    cond: E.Expr, plan: Aggregate, rel, child_schema, session
) -> Optional[FusedAggPlan]:
    """The lowered plan, from the serve cache when it is on
    (``("fusedplan", fp, ...)``, evictable with ``ServeCache.evict_kind``)."""
    from hyperspace_tpu_torch.execution import executor as X

    cache = X._serve_cache(session)
    key = None
    if cache is not None:
        from hyperspace_tpu_torch.execution.serve_cache import file_fingerprint

        fp = file_fingerprint(rel.files)
        if fp is not None:
            key = ("fusedplan", fp, repr(cond), tuple(plan.group_by), tuple(plan.aggs))
            hit = cache.get(key)
            if hit is not None:
                return hit
    fplan = _lower_fused_agg(
        cond, plan.group_by, plan.aggs, child_schema, rel.column_names
    )
    if fplan is not None and key is not None:
        cache.put(key, fplan, fplan.nbytes)
    return fplan


# ---------------------------------------------------------------------------
# Chunked execution (reads overlap the fused compute on scan_pool)
# ---------------------------------------------------------------------------


def _scan_row_total(rel) -> int:
    """Rows the fused pass would scan (surviving row groups), from the
    zone-map plane's memoized footers. Unreadable footers count as large:
    the read raises the interpreted path's own error."""
    from hyperspace_tpu_torch.indexes import zonemaps

    total = 0
    groups = rel.file_row_groups or (None,) * len(rel.files)
    for f, g in zip(rel.files, groups):
        zones = zonemaps.footer_zones(f)
        if zones is None:
            return 1 << 62
        rows = zones["rg_rows"]
        if g is None:
            total += sum(rows)
        else:
            total += sum(rows[i] for i in g if i < len(rows))
    return total


def _read_chunk(path: str, groups, cols: List[str]) -> pa.Table:
    """One file's surviving row groups, by the interpreted chain's own
    per-file read, so the two routes read the same bytes."""
    from hyperspace_tpu_torch.io.parquet import read_file_row_groups

    return read_file_row_groups(path, groups, cols)


def _read_row_groups_apart(path: str, groups, cols: List[str]) -> List[pa.Table]:
    """One file's row groups ``groups`` (ascending) in one read, as one
    table each: the rows ``_read_chunk`` gives for each alone."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    table = pf.read_row_groups(list(groups), columns=cols)
    out, at = [], 0
    for g in groups:
        n = pf.metadata.row_group(g).num_rows
        out.append(table.slice(at, n))
        at += n
    return out


def _run_chunked(fplan: FusedAggPlan, rel, session) -> Optional[ColumnarBatch]:
    """Stream the pruned scan through the fused pass file by file: the
    reads go to the shared scan pool up front; here the tables join into
    folds of up to ``_FUSED_FOLD_ROWS`` rows, each decoded and passed to
    the device while later files still read (the reference folds each
    file apart; ``chunks`` still counts files). Accumulation order is
    file order, which keeps float sums bit-identical to the interpreted
    chain. ``session.agg_stats["scan"]`` gains the seconds spent waiting
    for the reads and decoding them."""
    global last_fused_stats
    from hyperspace_tpu_torch.execution.join_exec import _stats_add
    from hyperspace_tpu_torch.io.scan import scan_pool

    t0 = time.perf_counter()
    cols = list(fplan.read_cols)
    groups = (
        list(rel.file_row_groups)
        if rel.file_row_groups is not None
        else [None] * len(rel.files)
    )
    state = AggState(fplan, session.device)
    if len(rel.files) > 1:
        futs = [
            scan_pool().submit(_read_chunk, f, g, cols)
            for f, g in zip(rel.files, groups)
        ]
        tables = (fut.result() for fut in futs)
    else:
        tables = (_read_chunk(f, g, cols) for f, g in zip(rel.files, groups))
    stats = session.agg_stats
    pending: List[pa.Table] = []
    t_read = time.perf_counter()
    for i, table in enumerate(tables, 1):
        pending.append(table)
        if i < len(rel.files) and sum(t.num_rows for t in pending) < _FUSED_FOLD_ROWS:
            continue
        batch = ColumnarBatch.from_arrow(pending[0] if len(pending) == 1 else pa.concat_tables(
            pending, promote_options="permissive"))
        pending = []
        _stats_add(stats, "scan", t_read)
        if not state.accumulate(batch):
            return None  # the executor falls back to the interpreted chain
        t_read = time.perf_counter()
    state.chunks = len(rel.files)
    out = _finalize(state)
    last_fused_stats = _agg_stats(state, t0)
    return out


# ---------------------------------------------------------------------------
# Metadata plane: answer aggregates from persisted partials
# ---------------------------------------------------------------------------


def agg_plane_on(session) -> bool:
    """``hyperspace.index.agg.enabled`` (default on)."""
    return session.conf.index_agg_enabled


#: ops whose partials fold bit for bit (see PartialsAccumulator): float
#: SUM/AVG is excluded, since merging per-row-group float sums would
#: reassociate against the row-sequential chain
_METADATA_MERGE_OPS = frozenset(
    {
        _OP_COUNT_STAR,
        _OP_COUNT_COL,
        _OP_SUM_I64,
        _OP_MIN_I64,
        _OP_MAX_I64,
        _OP_MIN_F64,
        _OP_MAX_F64,
    }
)


_CELL = "__hs_cell"


def partials_per_chunk(plan, tables: List[pa.Table], device, group_order: bool = False,
                       stats: Optional[dict] = None) -> Optional[List[AggPartials]]:
    """Each table's partials as a fused pass over it alone gives them
    (``plan``: a FusedAggPlan or a ``_PartialsSpec``), from few fused
    passes on ``device``: the tables joined, up to ``_FUSED_FOLD_ROWS``
    rows a pass, with their index as a leading group key and a COUNT(*)
    for their passing rows, then split back. A table's groups are its own,
    their first rows and folds in its row order, so folding the results
    in table order equals a pass a table; the reference passes each chunk
    apart, which on the card costs a few host round trips a chunk. Groups
    in first-occurrence order, or with ``group_order`` in ``_factorize``'s
    (as :func:`partials_from_batch`). A table without a passing row has no
    group. None when a column falls outside the fused set. ``stats``,
    when given, gains the fused passes ("passes") and their chunks a
    block's table overflow sent to B5f's ordered route ("overflowed").
    Shared by the metadata route's boundary chunks and the sidecar
    capture."""
    spec = _PartialsSpec((_CELL,) + tuple(plan.group_by),
                         tuple(plan.agg_ops) + ((_OP_COUNT_STAR, None),),
                         getattr(plan, "terms", ()), getattr(plan, "term_f64", ()),
                         getattr(plan, "bounds", ()))
    out: List[AggPartials] = []
    todo = list(tables)
    while todo:
        take, rows = [], 0
        while todo and (not take or rows + todo[0].num_rows <= _FUSED_FOLD_ROWS):
            rows += todo[0].num_rows
            take.append(todo.pop(0))
        joined = pa.concat_tables(
            [t.append_column(_CELL, pa.array(np.full(t.num_rows, c, dtype=np.int64)))
             for c, t in enumerate(take)],
            promote_options="permissive",
        )
        state = AggState(spec, device)
        if not state.accumulate(ColumnarBatch.from_arrow(joined)):
            return None
        if stats is not None:
            stats["passes"] += 1
            stats["overflowed"] += state.state.overflowed
        pt = state.partials()
        for c, t in enumerate(take):
            sel = np.nonzero(pt.g_reps[0] == c)[0]
            if group_order:
                sel = sel[_factorize_order(pt.g_reps[1:, sel], pt.g_nulls[1:, sel])]
            out.append(AggPartials(
                n_groups=len(sel), rows_scanned=t.num_rows,
                rows_passed=int(pt.acc_cnt[-1, sel].sum()),
                g_reps=pt.g_reps[1:, sel], g_nulls=pt.g_nulls[1:, sel],
                g_kvals=pt.g_kvals[1:, sel], g_kvalid=pt.g_kvalid[1:, sel],
                key_has_validity=tuple(t.column(k).null_count > 0 for k in plan.group_by),
                acc_i=pt.acc_i[:-1, sel], acc_f=pt.acc_f[:-1, sel],
                acc_cnt=pt.acc_cnt[:-1, sel], acc_aux=pt.acc_aux[:-1, sel]))
    return out


def try_metadata_aggregate(plan: Aggregate, session) -> Optional[ColumnarBatch]:
    """Serve ``Aggregate(…, [Project] [Filter(cond,)] Scan)`` over a clean
    index scan from the persisted partials (``_aggstate.json``): row
    groups whose zone provably satisfies every conjunct fold their stored
    partials without opening a parquet file, boundary row groups are
    scanned through the fused route for just those chunks, and all of it
    merges through :class:`PartialsAccumulator` and
    :func:`finalize_partials`, the interpreted chain's rows bit for bit.
    None when any gate fails; the caller tries the fused pass, then the
    interpreted chain."""
    global last_aggplane_stats
    if not agg_plane_on(session):
        return None
    node = plan.child
    while isinstance(node, Project):
        node = node.child
    if isinstance(node, Filter) and isinstance(node.child, Scan):
        cond, scan = node.condition, node.child
    elif isinstance(node, Scan):
        cond, scan = None, node
    else:
        return None
    if len(plan.group_by) > 1:
        return None  # grouped partials are captured per single key column
    from hyperspace_tpu_torch.execution import executor as X

    if cond is not None:
        pruned = X._bucket_pruned_scan(scan, cond, session)
        pruned = X._range_pruned_scan(pruned, cond, session)
        if not isinstance(pruned, Scan):
            return None
    else:
        pruned = scan
    rel = pruned.relation
    if not X._cacheable_scan(rel):
        return None
    t0 = time.perf_counter()
    child_schema = dict(rel.schema)
    child_schema.update(plan.child.schema())
    if cond is None:
        ivs: Dict[str, Any] = {}
        fplan = _lower_from_terms(
            (), plan.group_by, plan.aggs, child_schema, rel.column_names
        )
    else:
        from hyperspace_tpu_torch.indexes import zonemaps

        # strict lowering: full coverage is sound only when the intervals
        # ARE the predicate (IN hulls, OR trees, != abstain)
        ivs = zonemaps.predicate_intervals_complete(cond, rel.schema)
        if ivs is None:
            return None
        fplan = _lower_fused_agg(
            cond, plan.group_by, plan.aggs, child_schema, rel.column_names
        )
    if fplan is None:
        return None
    for op, _c in fplan.agg_ops:
        if op not in _METADATA_MERGE_OPS:
            return None
    from hyperspace_tpu_torch.indexes import aggindex

    key = plan.group_by[0] if plan.group_by else None
    cache = X._serve_cache(session)
    data = aggindex.agg_data_for(rel, session.conf, key, session.device, cache)
    if data is None:
        return None
    cells = aggindex.classify_row_groups(data, rel, ivs, key, fplan)
    if cells is None:
        return None
    n_full = sum(1 for _f, _g, kind in cells if kind == "full")
    if n_full == 0:
        # nothing answerable from metadata: no win over the fused pass
        return None
    cols = list(fplan.read_cols)
    partial_cells = [
        (i, fi, gi)
        for i, (fi, gi, kind) in enumerate(cells)
        if kind == "partial"
    ]
    if partial_cells and cache is not None:
        # serve-server mode with a WARM decoded scan: the fused pass serves
        # the boundary rows from RAM, where reading them from parquet here
        # would make partial coverage slower than the route it preempts (a
        # cold cache still favours metadata and boundary reads; full
        # coverage never reads)
        from hyperspace_tpu_torch.execution.serve_cache import file_fingerprint

        fp = file_fingerprint(rel.files)
        if fp is not None:
            entry = cache.peek(("scan", fp))
            if entry is not None and entry.batch_for(cols) is not None:
                return None
    # the boundary row groups read on the scan pool, a file's in one read,
    # and passed in one fused pass; folding stays in (file, row group)
    # order, the interpreted chain's row order
    from hyperspace_tpu_torch.io.scan import scan_pool

    per_file: Dict[int, list] = {}
    for _i, fi, gi in partial_cells:
        per_file.setdefault(fi, []).append(gi)

    def read(fi):
        groups = per_file[fi]
        if groups == [None]:  # the whole file: it has no usable state
            return [_read_chunk(rel.files[fi], None, cols)]
        return _read_row_groups_apart(rel.files[fi], groups, cols)

    if len(per_file) > 1:
        futs = {fi: scan_pool().submit(read, fi) for fi in per_file}
        parts = {fi: iter(f.result()) for fi, f in futs.items()}
    else:
        parts = {fi: iter(read(fi)) for fi in per_file}
    tables = [next(parts[fi]) for _i, fi, _g in partial_cells]
    boundary = partials_per_chunk(fplan, tables, session.device)
    if boundary is None:
        return None  # a column outside the fused set: the interpreted chain answers
    by_cell = dict(zip((i for i, _f, _g in partial_cells), boundary))
    acc = PartialsAccumulator(fplan)
    n_empty = 0
    for i, (fi, gi, kind) in enumerate(cells):
        if kind == "empty":
            n_empty += 1
        elif kind == "full":
            acc.fold(aggindex.rg_partials(data, fi, gi, fplan, key))
        else:
            acc.fold(by_cell[i])
    out = finalize_partials(fplan, acc.snapshot())
    last_aggplane_stats = {
        "mode": "agg_metadata",
        "row_groups_total": len(cells),
        "row_groups_metadata": n_full,
        "row_groups_empty": n_empty,
        "row_groups_scanned": len(partial_cells),
        "rows_scanned": sum(t.num_rows for t in tables),
        "groups": int(out.num_rows),
        "wall_s": time.perf_counter() - t0,
    }
    return out
