"""Runs phase 15 of ``chip_smoke.py`` (the lake sources, ``lake_path``)
alone on the card, for iterating on it without the phases before it.

    python3 scripts/torch_lake_phase.py   # about 2.5 min on an H100

It builds the kernels (``kernels.build_all``), generates phase 4's 8
lineitem files (``chip_smoke.gen_lineitem``, 6,001,215 rows), builds
phase 14's ``hs_idx`` over a copy of them in a card session with lineage
on (phase 15 holds ld_idx's bucket files to it byte for byte), and then
runs ``chip_smoke.lake_path`` with phase 4's filter p50 / p99 from
``PERF.md`` as the yardstick it logs beside its own. Prints the card's
name and power limit first. Writes its tables under
``build/lake_phase/`` and removes them at the end. Needs one CUDA device
and the repository checkout.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as CS  # noqa: E402

#: phase 4's filter p50 / p99 ms in R16 (PERF.md section 5)
PHASE4_P50_MS, PHASE4_P99_MS = 9.394, 50.961


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lake_phase: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, kernels

    card = CS.card_line()
    CS.log(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build_all()
    CS.log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.2f}s")
    work = os.path.join(ROOT, "build", "lake_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        src = CS.gen_lineitem(work)
        hy = os.path.join(work, "hy_lineitem")
        shutil.copytree(src, hy)
        sess = HyperspaceSession()
        sess.conf.set("hyperspace.system.path", os.path.join(work, "hy_indexes"))
        sess.conf.set("hyperspace.index.lineage.enabled", True)
        Hyperspace(sess).create_index(sess.read.parquet(hy), CoveringIndexConfig(
            "hs_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"]))
        ctx = {"src": src, "p50_ms": PHASE4_P50_MS, "p99_ms": PHASE4_P99_MS}
        out = CS.lake_path(work, ctx, CS.KernelCalls(), card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    CS.log(f"torch_lake_phase: phase 15 {out['seconds']:.1f}s, launches {out['launches']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
