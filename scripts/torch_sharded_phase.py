"""Runs phase 18 of ``chip_smoke.py`` (the sharded build and serve,
``sharded_path``) alone on the card, for iterating on it without the
phases before it.

    python3 scripts/torch_sharded_phase.py   # about 3 min on an H100

It builds the kernels (``kernels.build_all``), runs phase 4
(``chip_smoke.filter_path``: the lineitem files and li_idx, whose bucket
files phase 18 holds its builds to) and phase 5 (``chip_smoke.join_path``:
the orders and o_idx, the join phase 18 serves at 4 shards), then builds
phase 16's st_idx alone (``outofcore_path``'s first step: li_idx's
configuration under a budget of 2.5 source files, the files phase 18's
streamed build is held to), then ``chip_smoke.sharded_path`` and the
timings of B8a and B8b on its kept calls, and prints the records as one
JSON line. Prints the card's name and power limit first. Writes its
tables under ``build/chip_smoke/`` and removes them at the end. Needs
one CUDA device and the repository checkout.
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
        print("torch_sharded_phase: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, kernels
    from hyperspace_tpu_torch.indexes import covering_build as CB

    card = CS.card_line()
    CS.log(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build_all()
    CS.log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.2f}s")
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    calls = CS.KernelCalls()
    try:
        ctx = CS.filter_path(work, None)
        CS.join_path(work, ctx, CS.B4Inputs())
        per_file = CB.per_file_materialized_bytes(
            [os.path.join(ctx["src"], "part0.parquet")], "parquet")[0]
        ctx["oc_budget"] = int(CS.OC_BUDGET_FILES * per_file)
        oc = HyperspaceSession()
        oc.conf.set("hyperspace.system.path", os.path.join(work, "oc_indexes"))
        oc.conf.set("hyperspace.index.build.memoryBudgetBytes", ctx["oc_budget"])
        Hyperspace(oc).create_index(oc.read.parquet(ctx["src"]), CoveringIndexConfig(
            "st_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"]))
        calls.settle()
        calls.totals()  # phase 18 counts its own calls
        t0 = time.perf_counter()
        out = CS.sharded_path(work, ctx, calls, card)
        CS.log(f"phase 18: {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dev = torch.device("cuda")
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    records = [
        CS.b8_timing("b8a", out["keep"]["b8a"], flush, out["launches"]["bucket_exchange_pack"],
                     out["held"].get("b8a", 0)),
        CS.b8_timing("b8b", out["keep"]["b8b"], flush, out["launches"]["bucket_exchange_order"],
                     out["held"].get("b8b", 0)),
    ]
    out.pop("keep")
    CS.log(json.dumps({"sharded": out, "kernels": records, "card": card}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
