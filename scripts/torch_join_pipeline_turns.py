"""Time the port's co-bucketed join serve on one GPU, route against route,
in turns: ``orders ⋈ lineitem`` at TPC-H SF1 (chip_smoke.py's tables and
indexes, 200 buckets a side), through the sequential route (the
default) and the pipelined route (``hyperspace.serve.pipeline.enabled``
true). The pipelined route's rows are held equal in order to the
sequential route's. Prints, per route, the p50 over all its turns and
the stage seconds' medians (seconds of each side's own thread, summed
over both sides, on either route), and the card line.

    python3 scripts/torch_join_pipeline_turns.py [--rounds 3]

Needs one CUDA device; writes its tables under build/join_turns/ and
removes them at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_join_pipeline_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession

    work = os.path.join(ROOT, "build", "join_turns")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        sess = HyperspaceSession()
        sess.conf.set("hyperspace.system.path", os.path.join(work, "indexes"))
        hs = Hyperspace(sess)
        items = sess.read.parquet(cs.gen_lineitem(work))
        orders = sess.read.parquet(cs.gen_orders(work))
        hs.create_index(items, CoveringIndexConfig("li_idx", ["l_orderkey"],
                                                   ["l_shipdate", "l_quantity"]))
        hs.create_index(orders, CoveringIndexConfig("o_idx", ["o_orderkey"],
                                                    ["o_custkey", "o_totalprice"]))
        sess.enable_hyperspace()

        def q():
            return orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
                "o_orderkey", "o_custkey", "l_quantity").collect()

        routes = {"sequential (the default)": False, "pipelined": True}

        def run(route):
            sess.conf.set("hyperspace.serve.pipeline.enabled", routes[route])
            t0 = time.perf_counter()
            out = q()
            return out, (time.perf_counter() - t0) * 1e3, dict(sess.join_stats)

        want, _, _ = run("sequential (the default)")  # warm-up
        times = {r: [] for r in routes}
        stages = {r: [] for r in routes}
        names = list(routes)
        for rnd in range(args.rounds):
            for route in (names if rnd % 2 == 0 else names[::-1]):
                got, ms, st = run(route)
                if not got.equals(want):
                    raise AssertionError(f"{route}: rows differ from the sequential route")
                times[route].append(ms)
                stages[route].append(st)
        print(cs.card_line(), flush=True)
        for route in names:
            stage_p50 = {k: round(float(np.median([s[k] for s in stages[route]])), 4)
                         for k in stages[route][0]}
            print(f"{route}: p50_ms {np.median(times[route]):.3f} over {args.rounds} turns "
                  f"({', '.join(f'{t:.1f}' for t in times[route])}); stage p50 s {stage_p50}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
