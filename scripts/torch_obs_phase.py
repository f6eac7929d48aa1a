"""Runs phase 19 of ``chip_smoke.py`` (SQL, tracing, the query log, an
action's root span and the profiler trace, ``obs_sql_path``) alone on the
card, for iterating on it without the phases before it.

    python3 scripts/torch_obs_phase.py   # about 3 min on an H100

It builds the kernels (``kernels.build_all``), runs phase 4
(``chip_smoke.filter_path``: the lineitem files and li_idx) and phase 5
(``chip_smoke.join_path``: the orders files and o_idx), then
``chip_smoke.obs_sql_path``, and prints its record as one JSON line.
Without phase 7's li_rg_idx, query d takes li_idx. Prints the card's
name and power limit first. Writes its tables under
``build/chip_smoke/`` and removes them at the end. Needs one CUDA device
and the repository checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_obs_phase: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import kernels

    card = CS.card_line()
    CS.log(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build_all()
    CS.log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.2f}s")
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    calls, b5_inputs = CS.KernelCalls(), CS.B5Inputs()
    try:
        ctx = CS.filter_path(work, None)
        CS.join_path(work, ctx, CS.B4Inputs())
        t0 = time.perf_counter()
        out = CS.obs_sql_path(work, ctx, calls, b5_inputs, card)
        CS.log(f"phase 19: {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    CS.log(json.dumps({"obs": out, "card": card}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
