"""Approximate serve plane: sample-based COUNT/SUM with error bounds.

Counterpart of ``hyperspace_tpu/execution/approx_exec.py``. Ungrouped and
single-key grouped COUNT / COUNT(col) / SUM estimates come from the
stratified per-row-group row sample the aggregate index plane captures
(``indexes/aggindex.py``, ``_aggsample.parquet``), with 95 % confidence
intervals from classical stratified-sampling theory:

* strata are (file, row group); within stratum ``h`` of ``N_h`` rows,
  ``n_h`` rows were sampled uniformly without replacement;
* a COUNT estimate is ``Σ_h N_h·p_h`` with variance
  ``Σ_h N_h²·p_h(1-p_h)/n_h·(1-n_h/N_h)`` (finite-population
  correction: a fully sampled stratum contributes zero variance);
* a SUM estimate uses ``y_i = v_i·1{row passes}`` (nulls contribute 0)
  with the stratified mean estimator ``Σ_h N_h·ȳ_h`` and variance
  ``Σ_h N_h²·s²_h/n_h·(1-n_h/N_h)``.

The sample's predicate mask runs on the session's device through the
executor's ``_filter_mask`` (kernel B3a or the B3 torch ops on the card);
the estimates stay float64 numpy on the host, as in the reference, so they
match it bit for bit.

Approximate answers come only through the explicit
``DataFrame.collect_approx()`` behind ``hyperspace.serve.approx.enabled``
(the exact serve path never reads samples), and an estimate whose interval
is wider than the query's error budget
(``hyperspace.serve.approx.maxRelativeError`` or ``max_rel_error=``)
raises :class:`~hyperspace_tpu_torch.exceptions.ApproximationError`.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import pyarrow as pa

from hyperspace_tpu_torch.exceptions import ApproximationError
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Project, Scan

#: 97.5th percentile of the standard normal — two-sided 95% interval
_Z95 = 1.959963984540054

# Telemetry of the LAST approximate serve (rebind-only, like the fused
# stats): strata counts, sample size, per-agg relative half-widths.
last_approx_stats: Dict[str, Any] = {}


def _match_plan(plan):
    """(cond | None, scan, group key | None) when the optimized plan is
    an ungrouped or SINGLE-KEY grouped Aggregate over [Project] [Filter]
    Scan, else None."""
    if not isinstance(plan, Aggregate) or len(plan.group_by) > 1:
        return None
    key = plan.group_by[0] if plan.group_by else None
    node = plan.child
    while isinstance(node, Project):
        node = node.child
    if isinstance(node, Filter) and isinstance(node.child, Scan):
        return node.condition, node.child, key
    if isinstance(node, Scan):
        return None, node, key
    return None


def approx_aggregate(
    session, plan, max_rel_error: Optional[float] = None
) -> pa.Table:
    """Estimate an ungrouped — or single-key GROUPED — COUNT/SUM
    aggregate from the stratified index sample. Ungrouped: one row
    with, per aggregate ``x``, columns ``x`` (the estimate), ``x_lo``
    and ``x_hi`` (the 95% CI). Grouped: one row per group OBSERVED in
    the passing sample (key-sorted, nulls last), the key column first,
    then the same ``x``/``x_lo``/``x_hi`` triple per aggregate — each
    group gets its own interval from the same stratified estimator
    (``y`` restricted to the group's rows; zeros elsewhere count toward
    the variance, exactly the theory asks). Estimates are float64, so
    an approximate answer can never be mistaken for the exact integer
    result; groups too rare for the sample to see are absent (the
    per-group budget check bounds what CAN be returned — a group whose
    interval blows the budget raises instead). Raises
    :class:`ApproximationError` whenever an honest bounded estimate is
    impossible."""
    global last_approx_stats
    if session is None or not session.conf.serve_approx_enabled:
        raise ApproximationError(
            "approximate serving is disabled; set "
            "hyperspace.serve.approx.enabled=true to opt in"
        )
    budget = (
        session.conf.serve_approx_max_rel_error
        if max_rel_error is None
        else float(max_rel_error)
    )
    t0 = time.perf_counter()
    optimized = session.optimize(plan)
    m = _match_plan(optimized)
    if m is None:
        raise ApproximationError(
            "only ungrouped or single-key grouped Filter→Aggregate "
            "plans are approximable"
        )
    cond, scan, group_key = m
    rel = scan.relation
    from hyperspace_tpu_torch.execution import executor as X

    if rel.index_info is None or not X._cacheable_scan(rel):
        raise ApproximationError(
            "the plan is not served by a clean covering-index scan "
            "(no index, or query-shaped compensation is in play) — "
            "run exact instead"
        )
    for spec in plan.aggs:
        if spec.func not in ("count", "sum"):
            raise ApproximationError(
                f"{spec.func}() is not estimable from a sample; "
                "approximable aggregates are COUNT and SUM"
            )
    from hyperspace_tpu_torch.indexes import aggindex

    sample = aggindex.sample_data_for(rel, session.conf, session.device)
    if sample is None:
        raise ApproximationError(
            "no stratified sample is available for this index "
            "(capture disabled, or a file is unreadable)"
        )
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch

    batch = ColumnarBatch.from_arrow(sample["table"])
    ns = batch.num_rows
    if cond is not None:
        passing = X._filter_mask(cond, batch, session).astype(bool)
    else:
        passing = np.ones(ns, dtype=bool)
    if not bool(passing.any()):
        # zero passing sample rows: the sample carries no information
        # about the selection's values and the normal interval collapses
        # to [0, 0] — refusing is the only honest answer
        raise ApproximationError(
            "no sampled row satisfies the predicate — the selection is "
            "too rare to estimate from the sample; run exact"
        )
    stratum = sample["stratum"]
    N = sample["N"].astype(np.float64)
    n = sample["n"].astype(np.float64)
    if bool(np.any((n < 2) & (n < N))):
        # a partially-sampled stratum with one sample row has no
        # estimable variance (ddof=1 is undefined) — a zero-width
        # "interval" from it would be categorically false, so refuse
        # (a fully-sampled singleton stratum is exact and fine)
        raise ApproximationError(
            "a stratum has a single sampled row but more than one "
            "population row — variance is not estimable; enlarge "
            "hyperspace.index.agg.sampleRowsPerGroup or run exact"
        )
    H = len(N)
    fpc = np.clip(1.0 - n / N, 0.0, 1.0)

    # -- group factorization over the PASSING sample rows --------------------
    # One virtual group for the ungrouped shape keeps the estimator a
    # single [H, G] computation either way: y restricted to a group is
    # zero on every other row, and those zeros belong in the stratum
    # mean/variance — that is what makes the per-group interval honest.
    if group_key is None:
        G = 1
        codes = np.zeros(ns, dtype=np.int64)
        grouped_rows = passing
        key_values = None
    else:
        if group_key not in batch.column_names:
            raise ApproximationError(
                f"group key {group_key!r} is not in the index sample — "
                "only indexed columns are estimable"
            )
        kcol = batch.column(group_key)
        rep = kcol.key_rep()
        nm = kcol.null_mask
        valid = np.ones(ns, dtype=bool) if nm is None else ~nm
        # null keys form their own group, like the exact engine's
        # factorize; an out-of-range rep stands in for them
        grouped_rows = passing
        pass_valid = passing & valid
        uniq = np.unique(rep[pass_valid])
        has_null_group = bool(np.any(passing & ~valid))
        G = len(uniq) + int(has_null_group)
        codes = np.searchsorted(uniq, rep)
        codes = np.clip(codes, 0, max(len(uniq) - 1, 0))
        # rows whose rep is not actually in uniq (non-passing values)
        # only matter where grouped_rows is True, and there membership
        # is exact; null rows get the trailing group id
        if has_null_group:
            codes = np.where(valid, codes, len(uniq))
        # group key values for the output: first passing occurrence
        order = np.argsort(codes[pass_valid], kind="stable")
        first_idx = np.nonzero(pass_valid)[0][order]
        _codes_sorted = codes[pass_valid][order]
        firsts = first_idx[
            np.searchsorted(_codes_sorted, np.arange(len(uniq)))
        ]
        arrow_key = sample["table"].column(group_key)
        key_values = arrow_key.take(pa.array(firsts, type=pa.int64()))
        if has_null_group:
            key_values = pa.concat_arrays(
                [
                    key_values.combine_chunks()
                    if isinstance(key_values, pa.ChunkedArray)
                    else key_values,
                    pa.nulls(1, type=arrow_key.type),
                ]
            )

    def _estimate(y: np.ndarray):
        """[G] estimates + half-widths from the stratified estimator
        applied per group (y already zeroed outside its rows)."""
        member = grouped_rows
        idx = stratum * G + codes
        sums = np.bincount(
            idx[member], weights=y[member], minlength=H * G
        ).reshape(H, G)
        sq = np.bincount(
            idx[member], weights=(y * y)[member], minlength=H * G
        ).reshape(H, G)
        n_col = n[:, None]
        mean = sums / n_col
        with np.errstate(invalid="ignore", divide="ignore"):
            var_h = np.where(
                n_col > 1, (sq - n_col * mean * mean) / (n_col - 1), 0.0
            )
        var_h = np.maximum(var_h, 0.0)
        est = np.sum(N[:, None] * mean, axis=0)
        var = np.sum(
            N[:, None] * N[:, None] * var_h / n_col * fpc[:, None], axis=0
        )
        return est, _Z95 * np.sqrt(np.maximum(var, 0.0))

    out: Dict[str, Any] = {}
    rel_errs = []
    for spec in plan.aggs:
        if spec.func == "count":
            if spec.column is None:
                y = passing.astype(np.float64)
            else:
                col = batch.column(spec.column)
                nm = col.null_mask
                valid_c = (
                    np.ones(ns, dtype=bool) if nm is None else ~nm
                )
                y = (passing & valid_c).astype(np.float64)
        else:  # sum
            col = batch.column(spec.column)
            if col.kind != "numeric":
                raise ApproximationError(
                    f"sum() over non-numeric column {spec.column!r}"
                )
            v = col.values.astype(np.float64, copy=False)
            nm = col.null_mask
            if nm is not None:
                v = np.where(nm, 0.0, v)
            y = np.where(passing, v, 0.0)
        est, hw = _estimate(y)
        out[spec.name] = est
        out[spec.name + "_lo"] = est - hw
        out[spec.name + "_hi"] = est + hw
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.where(
                est != 0.0,
                hw / np.abs(est),
                np.where(hw == 0.0, 0.0, np.inf),
            )
        worst = float(np.max(rel)) if len(rel) else 0.0
        rel_errs.append((spec.name, worst))
        if worst > budget:
            raise ApproximationError(
                f"estimate for {spec.name!r} has relative 95%-CI "
                f"half-width {worst:.4f} > budget {budget:.4f}"
                + (
                    " in at least one group"
                    if group_key is not None
                    else ""
                )
                + " — run exact, or widen the budget / enlarge "
                "hyperspace.index.agg.sampleRowsPerGroup"
            )
    last_approx_stats = {
        "mode": "agg_approx",
        "strata": H,
        "groups": G if group_key is not None else 0,
        "sample_rows": int(ns),
        "population_rows": int(sample["N"].sum()),
        "rel_half_widths": {k: float(v) for k, v in rel_errs},
        "wall_s": time.perf_counter() - t0,
    }
    cols: Dict[str, Any] = {}
    if key_values is not None:
        cols[group_key] = key_values
    for k, v in out.items():
        cols[k] = pa.array(np.asarray(v, dtype=np.float64), type=pa.float64())
    table = pa.table(cols)
    if key_values is not None:
        table = table.sort_by([(group_key, "ascending")])
    return table
