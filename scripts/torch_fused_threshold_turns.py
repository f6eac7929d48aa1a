"""Times the queries of ``chip_smoke.py``'s phases 7-9 under the fixed
fused-route threshold and under the calibrated one, in turns on one card:
fixed, calibrated, calibrated, fixed.

    python3 scripts/torch_fused_threshold_turns.py   # about 4 min on an H100

It builds the kernels (``kernels.build_all``), removes the calibration
cache and probes afresh (``calibrate.thresholds()``), then runs phase 4
(``chip_smoke.filter_path``: lineitem and li_idx), phase 5
(``chip_smoke.join_path``: orders and o_idx) and phase 7
(``chip_smoke.range_path``, which creates li_rg_idx), so that every index
of phases 7-9 is in place. Each turn then serves phase 7's range and
cut-off filters (``range_queries``), phase 8's queries
(``aggregate_queries``) and phase 9's (``agg_plane_queries``) with the
fused pipeline on: a warm-up and 5 timed runs a query, its p50 and its
B3b, B5f, B3a and B5 launches a run. The fixed threshold is the constant
(``HS_CALIBRATE=0``, the probe's off switch); the calibrated one is the
probe's cached value. Every answer must equal the first turn's, in
order, bit for bit: the routes are equal by design. Prints the card's
name and power limit first and one JSON line at the end: the thresholds,
the probe's per-size times, and each query's p50 and launches a turn.
Writes its tables under ``build/chip_smoke/`` and removes them at the
end. Needs one CUDA device and the repository checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as CS  # noqa: E402

TURNS = ("fixed", "calibrated", "calibrated", "fixed")
RUNS = 5
KERNELS = {"b3b": "fused_select", "b5f": "fused_filter_agg", "b3a": "range_mask",
           "b5": "segment_reduce"}


def set_threshold(mode: str) -> int:
    """Point the dispatch at the constant (``fixed``) or the probe's cached
    value (``calibrated``); returns the threshold the card now uses."""
    import torch

    from hyperspace_tpu_torch import calibrate
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC

    os.environ["HS_CALIBRATE"] = "0" if mode == "fixed" else "1"
    calibrate.invalidate()
    return PC._native_fused_pipeline_min_rows(torch.device("cuda"))


def turn_queries(ctx) -> dict:
    """label -> plan: phases 7-9's queries as a user would send them."""
    from hyperspace_tpu_torch import functions as F

    items = ctx["items"]
    queries, cutoff = CS.range_queries(items)
    out = {f"7 {suffix}": items.filter(cond).select(*cols)
           for suffix, cond, cols in queries + [cutoff]}
    out.update({f"8 {label}": q for label, q in CS.aggregate_queries(F, items).items()})
    out.update({f"9 {label}": q for label, (q, _i, _s) in CS.agg_plane_queries(F, items).items()})
    return out


def run_turn(sess, queries: dict, want: dict) -> dict:
    """Each query: a warm-up, RUNS timed runs (p50 ms), its launches, and
    its answer held to ``want`` (filled on the first turn)."""
    import torch

    from hyperspace_tpu_torch import ops
    from torch_b5_cases import same_rows

    out = {}
    for label, q in queries.items():
        got = q.collect()  # warm-up
        before = ops.launch_counts()
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            got = q.collect()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        after = ops.launch_counts()
        if label not in want:
            want[label] = got
        elif not same_rows(got, want[label]):
            raise AssertionError(f"{label}: the answer differs between thresholds")
        out[label] = {"p50_ms": float(np.median(times)), "rows": got.num_rows,
                      **{k: (after[v] - before[v]) / RUNS for k, v in KERNELS.items()}}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fused_threshold_turns: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import calibrate, kernels

    card = CS.card_line()
    CS.log(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build_all()
    CS.log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.2f}s")
    if os.path.exists(calibrate.cache_file()):
        os.remove(calibrate.cache_file())
    calibrate.invalidate()
    th = calibrate.thresholds()
    if th.source != "calibrated":
        raise AssertionError(f"the probe did not run: {th}")
    CS.log(f"calibrated: {th}")
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    turns, thresholds, want = [], [], {}
    try:
        ctx = CS.filter_path(work, None)
        CS.join_path(work, ctx, CS.B4Inputs())
        CS.range_path(work, ctx, CS.B3aInputs())
        sess = ctx["session"]
        sess.enable_hyperspace()
        queries = turn_queries(ctx)
        for mode in TURNS:
            thresholds.append(set_threshold(mode))
            t0 = time.perf_counter()
            turns.append(run_turn(sess, queries, want))
            CS.log(f"turn {mode} (threshold {thresholds[-1]} rows): "
                   f"{time.perf_counter() - t0:.1f}s")
    finally:
        os.environ.pop("HS_CALIBRATE", None)
        shutil.rmtree(work, ignore_errors=True)
    if thresholds[0] == thresholds[1]:
        CS.log("the calibrated threshold equals the fixed one: the turns compare one route")
    rows = {}
    for label in turns[0]:
        by = [t[label] for t in turns]
        fixed = [b["p50_ms"] for b, m in zip(by, TURNS) if m == "fixed"]
        cal = [b["p50_ms"] for b, m in zip(by, TURNS) if m == "calibrated"]
        rows[label] = {"rows": by[0]["rows"], "fixed_p50_ms": fixed, "calibrated_p50_ms": cal,
                       "fixed_launches": {k: by[0][k] for k in KERNELS},
                       "calibrated_launches": {k: by[1][k] for k in KERNELS}}
        moved = rows[label]["fixed_launches"] != rows[label]["calibrated_launches"]
        CS.log(f"{label}: fixed {fixed[0]:.3f} / {fixed[1]:.3f} ms, calibrated {cal[0]:.3f} / "
               f"{cal[1]:.3f} ms{'; route moved: ' if moved else ''}"
               f"{rows[label]['fixed_launches'] if moved else ''}"
               f"{' -> ' + str(rows[label]['calibrated_launches']) if moved else ''}")
    CS.log(json.dumps({"card": card, "thresholds": dict(zip(TURNS, thresholds)),
                       "probe": calibrate.probe_times(), "queries": rows}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
