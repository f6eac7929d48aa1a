"""Does torch.profiler keep a kernel's device event once the process's
first trace is some time old, with and without the session's pads?

    python3 scripts/torch_profiler_probe.py [--pause 40] [--rounds 4]

Needs one CUDA device; about 90 s on an H100. It builds the kernels and
launches kernel B1 (``ops.hash.bucket_ids_kernel``, 4,096 keys) alone
under ``torch.profiler`` (CPU and CUDA activity, the device synchronised
before the profiler stops), two traces in a fresh process, then, after
``--pause`` seconds with no trace, ``--rounds`` rounds of two variants:

* ``plain``: the launch alone in the trace;
* ``session``: the launch inside ``HyperspaceSession._profiled``, the
  port's ``hyperspace.profile.traceDir`` wrapper (a pad of one-element
  kernels at each end of the trace, ``session.PROFILE_PAD``).

For each trace it prints one JSON line: whether B1's kernel event is in
it, the kernel events, the kernel launches, and the launches outside the
pads without a kernel event (``session.launches_without_kernels``); then
a summary line. With ``KINETO_LOG_LEVEL=0`` in the environment, kineto
writes each trace's ``Record counts: Out-of-range = ...`` to stderr.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pause", type=float, default=40.0)
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import HyperspaceSession, kernels
    from hyperspace_tpu_torch.ops import hash as H
    from hyperspace_tpu_torch.session import launches_without_kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels.build_all()
    out_dir = tempfile.mkdtemp(prefix="hs_profiler_probe_")
    sess = HyperspaceSession()
    reps = torch.arange(4096, dtype=torch.int64, device=sess.device).reshape(1, 4096)
    t0 = time.perf_counter()
    seq = iter(range(1 << 30))

    def launch():
        H.bucket_ids_kernel(reps, 200)
        torch.cuda.synchronize()

    def plain() -> str:
        path = os.path.join(out_dir, f"plain.{next(seq):04d}.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            launch()
        prof.export_chrome_trace(path)
        return path

    def session() -> str:
        d = os.path.join(out_dir, f"session.{next(seq):04d}")
        with sess._profiled(d):
            launch()
        (name,) = os.listdir(d)
        return os.path.join(d, name)

    summary = collections.defaultdict(collections.Counter)

    def probe(phase: str, variant: str, fn) -> None:
        import warnings

        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            path = fn()
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        ker = [e["name"] for e in events if e.get("cat") == "kernel"]
        rec = {
            "phase": phase, "variant": variant, "age_s": round(time.perf_counter() - t0, 1),
            "b1_kept": any("murmur3_bucket_kernel" in n for n in ker),
            "kernels": len(ker),
            "launches": sum(e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]
                            for e in events),
            "launches_without_kernel": launches_without_kernels(path),
            "warnings": len(seen),
        }
        print(json.dumps(rec), flush=True)
        key = f"{phase} {variant}"
        summary[key]["traces"] += 1
        summary[key]["b1_kept"] += int(rec["b1_kept"])

    try:
        for _ in range(2):
            probe("fresh", "plain", plain)
        time.sleep(args.pause)
        for _ in range(args.rounds):
            probe(f"after {args.pause:g}s", "plain", plain)
            probe(f"after {args.pause:g}s", "session", session)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"summary": summary, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
