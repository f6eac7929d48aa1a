"""Hash-aggregate execution: device factorize + device segment reductions.

Counterpart of ``hyperspace_tpu/execution/aggregate_exec.py``. The
reference's aggregates run inside Spark's HashAggregateExec; here the
engine is the serve path. The group keys are factorized on the session's
device (a stable sort of their int64 planes, ``ops/sort.sort_permutation``,
then the group boundaries), and every aggregate is a segment reduction
over the sorted groups (``ops/aggregate.py``, kernel B5 on the card).
Finalization (output types, zero fills, validity) is the reference's
numpy, on the host, so the output columns are the reference's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.execution.join_exec import _stats_add, _sync
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.ops import aggregate as agg_ops
from hyperspace_tpu_torch.ops.sort import order_rep, sort_permutation
from hyperspace_tpu_torch.plan.nodes import AggSpec, _agg_output_type


@contextlib.contextmanager
def stage(stats: Optional[Dict[str, float]], name: str, device: torch.device):
    """Add the block's wall seconds, its device work included, to
    ``stats[name]``."""
    t0 = time.perf_counter()
    yield
    _sync(device)
    _stats_add(stats, name, t0)


def _grouping_planes(col: Column) -> List[np.ndarray]:
    """Per-column int64 plane(s) where row equality == SQL group-by
    equality.

    Strings use dictionary codes (exact within a batch — no hash
    collisions; code -1 is null, one group as SQL requires). Numerics use
    ``key_rep`` (canonicalizes NaN/-0.0) plus, when the column has nulls,
    an explicit null plane — the rep maps null to an in-band value a real
    key could equal, so the plane is what keeps nulls a separate group.
    """
    if col.kind == "string":
        return [col.codes.astype(np.int64)]
    planes = [col.key_rep()]
    null = col.null_mask
    if null is not None:
        planes.append(null.astype(np.int64))
    return planes


def _factorize(
    batch: ColumnarBatch, group_by: List[str], device: torch.device
) -> Tuple[Optional[torch.Tensor], torch.Tensor, np.ndarray, int]:
    """-> (perm, offs, first_occurrence_row_per_group, num_groups).

    Sort-based grouping on ``device``, as the reference's: a stable sort
    of the grouping planes, then group boundaries from adjacent-row
    inequality. Group g is rows ``perm[offs[g]:offs[g + 1]]``, in row
    order (the sort is stable), so ``first`` holds each group's true first
    occurrence; groups come out ordered by key rep. A global aggregate is
    one group over the identity (``perm`` None)."""
    n = batch.num_rows
    if not group_by or n == 0:
        num = 0 if (group_by and n == 0) else 1
        offs = torch.tensor([0, n][: num + 1], dtype=torch.int64, device=device)
        return None, offs, np.zeros(0, dtype=np.int64), num
    planes: List[np.ndarray] = []
    for c in group_by:
        planes.extend(_grouping_planes(batch.column(c)))
    reps = torch.from_numpy(np.stack(planes)).to(device)
    perm = sort_permutation(reps)
    srt = reps[:, perm]
    neq = (srt[:, 1:] != srt[:, :-1]).any(dim=0)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                        torch.nonzero(neq).flatten() + 1])
    offs = torch.cat([starts, torch.full((1,), n, dtype=torch.int64, device=device)])
    return perm, offs, perm[starts].cpu().numpy(), int(starts.numel())


def _valid_mask(col: Column) -> Optional[np.ndarray]:
    null = col.null_mask
    return None if null is None else ~null


def _numeric_values(col: Column, spec: AggSpec) -> np.ndarray:
    if col.kind != "numeric":
        raise HyperspaceException(
            f"{spec.func}() over non-numeric column {spec.column!r}"
        )
    return col.values


def _int_fill(dtype: np.dtype, mode: str):
    """The reference's MIN/MAX fill of an integer or bool column."""
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return int(info.max if mode == "min" else info.min)
    return mode == "min"


class _DeviceColumns:
    """Each column's values and validity on the device, moved once per
    aggregate however many aggregates read them."""

    def __init__(self, batch: ColumnarBatch, device: torch.device):
        self.batch, self.device = batch, device
        self._vals: dict = {}
        self._valid: dict = {}

    def valid(self, name: str) -> Optional[torch.Tensor]:
        if name not in self._valid:
            m = _valid_mask(self.batch.column(name))
            self._valid[name] = None if m is None else torch.from_numpy(m).to(self.device)
        return self._valid[name]

    def values(self, name: str, host: np.ndarray) -> Tuple[torch.Tensor, bool]:
        if name not in self._vals:
            self._vals[name] = agg_ops.device_values(host, self.device)
        return self._vals[name]


def _string_minmax(
    col: Column, name: str, groups, dcols: _DeviceColumns, mode: str
) -> Column:
    """min/max over a string column: reduce per-batch dictionary ranks on
    the device, then map winning ranks back to strings."""
    perm, offs = groups
    sorted_dict = sorted(col.dictionary)
    ranks, _ = agg_ops.device_values(order_rep(col), dcols.device)
    valid = dcols.valid(name)
    win = agg_ops.segment_minmax(
        perm, offs, ranks, valid, mode, _int_fill(np.dtype(np.int64), mode)
    ).cpu().numpy()
    counts = agg_ops.segment_count(perm, offs, valid).cpu().numpy()
    has = counts > 0
    codes = np.where(has, np.clip(win, 0, max(len(sorted_dict) - 1, 0)), -1)
    return Column(
        "string",
        col.arrow_type,
        codes=codes.astype(np.int32),
        dictionary=sorted_dict,
    )


# -- per-spec finalization (the reference's, on the host) ------------------------


def finalize_count(out_type, counts: np.ndarray) -> Column:
    return Column("numeric", out_type, values=counts)


def finalize_minmax(out_type, red: np.ndarray, counts: np.ndarray, vals_dtype) -> Column:
    """``red`` = raw per-group reduction (NaN rules already applied for
    floats), ``counts`` = per-group count of VALID input rows."""
    has = counts > 0
    red = red.astype(vals_dtype, copy=False)
    return Column(
        "numeric",
        out_type,
        values=np.where(has, red, np.zeros_like(red)),
        validity=None if has.all() else has,
    )


def finalize_sum(out_type, sums: np.ndarray, counts: np.ndarray) -> Column:
    has = counts > 0
    target = np.float64 if pa.types.is_floating(out_type) else np.int64
    sums = sums.astype(target, copy=False)
    return Column(
        "numeric",
        out_type,
        values=np.where(has, sums, np.zeros_like(sums)),
        validity=None if has.all() else has,
    )


def finalize_avg(out_type, sums: np.ndarray, counts: np.ndarray) -> Column:
    has = counts > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = sums.astype(np.float64) / np.maximum(counts, 1)
    return Column(
        "numeric",
        out_type,
        values=np.where(has, avg, 0.0),
        validity=None if has.all() else has,
    )


def execute_aggregate(
    batch: ColumnarBatch,
    group_by: List[str],
    aggs: List[AggSpec],
    child_schema,
    device,
    stats: Optional[Dict[str, float]] = None,
) -> ColumnarBatch:
    """The Aggregate node over ``batch`` on ``device``; ``stats`` (when
    given) gains the seconds of the stages ``factorize`` (group ids),
    ``reduce`` (values to the device, the reductions, results back) and
    ``finalize`` (output columns on the host)."""
    dev = torch.device(device)
    with stage(stats, "factorize", dev):
        perm, offs, first, _num_groups = _factorize(batch, group_by, dev)
    groups = (perm, offs)
    dcols = _DeviceColumns(batch, dev)

    out = {}
    if group_by:
        keys = batch.take(first)
        for c in group_by:
            out[c] = keys.column(c)

    for spec in aggs:
        out_type = _agg_output_type(spec, child_schema)
        if spec.func == "count":
            with stage(stats, "reduce", dev):
                valid = None if spec.column is None else dcols.valid(spec.column)
                counts = agg_ops.segment_count(perm, offs, valid).cpu().numpy()
            with stage(stats, "finalize", dev):
                out[spec.name] = finalize_count(out_type, counts)
            continue

        col = batch.column(spec.column)
        if spec.func in ("min", "max") and col.kind == "string":
            with stage(stats, "reduce", dev):
                out[spec.name] = _string_minmax(col, spec.column, groups, dcols, spec.func)
            continue
        vals = _numeric_values(col, spec)
        if spec.func in ("min", "max"):
            with stage(stats, "reduce", dev):
                v, unsigned = dcols.values(spec.column, vals)
                valid = dcols.valid(spec.column)
                fill = None if vals.dtype.kind == "f" else _int_fill(vals.dtype, spec.func)
                red = agg_ops.segment_minmax(
                    perm, offs, v, valid, spec.func, fill, unsigned
                ).cpu().numpy()
                counts = agg_ops.segment_count(perm, offs, valid).cpu().numpy()
            with stage(stats, "finalize", dev):
                if unsigned:
                    red = red.view(np.uint64)
                out[spec.name] = finalize_minmax(out_type, red, counts, vals.dtype)
            continue

        # sum / avg
        with stage(stats, "reduce", dev):
            v, _unsigned = dcols.values(spec.column, vals)
            sums, counts = agg_ops.segment_sum_count(perm, offs, v, dcols.valid(spec.column))
            sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        with stage(stats, "finalize", dev):
            if vals.dtype.kind == "u":
                sums = sums.view(np.uint64)  # the reference accumulates unsigned in uint64
            if spec.func == "sum":
                out[spec.name] = finalize_sum(out_type, sums, counts)
            else:  # avg
                out[spec.name] = finalize_avg(out_type, sums, counts)
    return ColumnarBatch(out)
