"""Times kernels B5f and B3b of commit 2396f04 (their first design) against
the package's own on the card, in turns.

    python3 scripts/torch_b5f_turns.py --extract   # where git is: writes 2396f04's sources
    python3 scripts/torch_b5f_turns.py [--sweep]    # on the card

``--extract`` writes 2396f04's ``fused_agg.cu``, ``fused_select.cu`` and
``range_terms.cuh`` (``git show 2396f04:hyperspace_tpu_torch/csrc/<file>``)
under ``build/b5f_turns/base/``, an ignored directory beside the checkout.
Run without it, the script builds them there with nvcc beside the
package's own sources (one nvcc each, all at once; each kernel's
registers and spills printed) and times, on the inputs of
``chip_smoke.b5f_replica`` (phase 9's f1 and f2 chunk of 6,001,215 rows,
s1's batch of 345,081 rows, built on the card without the tables):

* B3b through its unchanged C interface ``hs_fused_select`` on f1's terms
  and s1's batch: each build held equal to the plain version, then timed
  cold (``chip_smoke.time_cold``: 256 MiB read before each run, median
  of 30) in turns: base, current, current, base;
* B5f on f1 and f2: the base's route (``ops/fused_agg``'s ordered route,
  which is that commit's code, on its libraries: B3b, the group pass, B5)
  against the current one (the plan's route, one pass for both), each
  held bit-equal to the plain version, timed in the same turns by the
  device time of all the kernels of one call (torch.profiler, cold) and
  by CUDA events around the whole call.

With ``--sweep`` the current one-pass route is also timed (device time,
cold) on f1 and f2 at 2,048, 4,096, 8,192 and 16,384 rows a block, in
turns. Prints the card's name and power limit and one line per input and
build. Needs one CUDA device and the repository checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

PARENT = "2396f04"
OLD_DIR = os.path.join(ROOT, "build", "b5f_turns", "base")
SOURCES = ("fused_agg.cu", "fused_select.cu", "range_terms.cuh")


def extract() -> None:
    os.makedirs(OLD_DIR, exist_ok=True)
    for name in SOURCES:
        text = subprocess.run(
            ["git", "show", f"{PARENT}:hyperspace_tpu_torch/csrc/{name}"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout
        with open(os.path.join(OLD_DIR, name), "w", encoding="utf-8") as fh:
            fh.write(text)
    print(f"wrote {', '.join(SOURCES)} of {PARENT} to {OLD_DIR}")


def build() -> dict:
    """nvcc on the base's two sources at once (the package's own build as
    well); returns {"base": {name: CDLL}, "current": {name: CDLL}}."""
    from hyperspace_tpu_torch import kernels

    for name in SOURCES:
        if not os.path.exists(os.path.join(OLD_DIR, name)):
            raise SystemExit(f"{OLD_DIR}/{name} missing: run with --extract where git is")
    out_dir = os.path.join(ROOT, "build", "b5f_turns", "libs")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in ("fused_agg", "fused_select"):
        lib = os.path.join(out_dir, f"base_{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", OLD_DIR, "-o", lib,
               os.path.join(OLD_DIR, name + ".cu")]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cur_dir = kernels.build_all()
    logs = {}
    for name, lib, proc in procs:
        logs[f"base {name}"] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the base's {name}:\n{logs[f'base {name}']}")
    for name in ("fused_agg", "fused_select"):
        with open(os.path.join(cur_dir, f"lib{name}.log")) as fh:
            logs[f"current {name}"] = fh.read()
    for build_name, text in logs.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(agg_block_pass\w{0,8}|merge_\w+|insert_\w+|finish_groups|"
                              r"group_pass|select_\w+)", m.group(1))
                entry = k.group(0) if k else m.group(1)
            elif ("registers" in line or "spill" in line) and entry:
                print(f"build {build_name}: {entry}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    return {
        "base": {n: ctypes.CDLL(os.path.join(out_dir, f"base_{n}.so"))
                for n in ("fused_agg", "fused_select")},
        "current": {n: kernels.load(n) for n in ("fused_agg", "fused_select")},
    }


def bind(libs: dict) -> None:
    """The ctypes signatures of the package's wrappers on each build's
    libraries (the base's C interfaces are the current ones' subset)."""
    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.ops import fused_agg as FA

    for build_libs in libs.values():
        for name, real in (("fused_select", F._select_lib()), ("fused_agg", FA._lib())):
            lib = build_libs[name]
            for fn in ("hs_fused_select", "hs_select_scratch_bytes", "hs_fused_group"):
                if hasattr(real, fn) and hasattr(lib, fn):
                    getattr(lib, fn).argtypes = getattr(real, fn).argtypes
                    getattr(lib, fn).restype = getattr(real, fn).restype


def use(build_libs: dict) -> None:
    """Point the package's wrappers at one build's libraries."""
    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.ops import fused_agg as FA

    F._select_lib = lambda: build_libs["fused_select"]
    FA._lib = lambda: build_libs["fused_agg"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--extract", action="store_true",
                        help=f"write {PARENT}'s sources under build/b5f_turns/base and stop")
    parser.add_argument("--sweep", action="store_true",
                        help="also time the current one-pass route at other block sizes "
                        "(ops/fused_agg.BLOCK_ROWS), in turns")
    args = parser.parse_args()
    if args.extract:
        extract()
        return 0
    import torch

    import chip_smoke as CS
    from torch_b5f_cases import _state_bits

    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.ops import fused_agg as FA

    if not torch.cuda.is_available():
        print("torch_b5f_turns: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {CS.card_line()}", flush=True)
    libs = build()
    bind(libs)
    dev = torch.device("cuda")
    inputs, calls = CS.b5f_replica(dev)
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    med = lambda t: float(np.median(t))  # noqa: E731
    order = ("base", "current", "current", "base")

    sources = {"f1": inputs["f1"][1].terms}
    sources.update({k: F.range_args(b, t, dev) for k, (t, b) in calls.items()})
    for label, rargs in sources.items():
        want = F.select_torch(rargs)
        times = {b: [] for b in libs}
        for b in order:
            use(libs[b])
            if not torch.equal(F.select_kernel(rargs), want):
                raise AssertionError(f"B3b of {b} differs from its plain version on {label}")
            times[b].append(med(CS.time_cold(CS.select_launcher(rargs), flush)))
        bound = (sum(c.numel() * 8 for c in rargs.cols) + sum(
            v.numel() for v in rargs.valids if v is not None) + 8 * want.numel()) / CS.PEAK_BYTES_PER_S * 1e3
        print(f"B3b on {label} ({rargs.n} rows, {want.numel()} passing; bound {bound:.4f} ms): "
              + "; ".join(f"{b} cold ms {times[b]} (mean {np.mean(times[b]):.4f})" for b in libs),
              flush=True)

    for label, (fplan, chunk, batch) in inputs.items():
        start = PC.AggState(fplan, dev).state  # each call folds into a new state
        cpu = PC.AggState(fplan, "cpu")
        want = _state_bits(FA.fused_filter_agg_torch(cpu.state, cpu._chunk(batch)))
        routes = {
            "base": lambda: FA._fold(start, chunk, FA.group_ids_kernel, plain=False),
            "current": lambda: FA.fused_filter_agg_kernel(start, chunk),
        }
        dev_ms = {b: [] for b in libs}
        call_ms = {b: [] for b in libs}
        for b in order:
            use(libs[b])
            got = _state_bits(routes[b]())
            if any(not torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"B5f of {b} differs from its plain version on {label}")
            dev_ms[b].append(CS.device_ms_per_call(routes[b], flush)[0])
            call_ms[b].append(med(CS.time_cold(routes[b], flush, iters=10)))
        print(f"B5f on {label} ({chunk.n} rows, {len(chunk.keys)} keys; route now "
              f"{FA.route([op for op, _c in fplan.agg_ops])}): "
              + "; ".join(f"{b} device ms {dev_ms[b]} (mean {np.mean(dev_ms[b]):.4f}), whole "
                          f"call ms {call_ms[b]} (mean {np.mean(call_ms[b]):.4f})" for b in libs),
              flush=True)
    if args.sweep:
        use(libs["current"])
        sizes = (2048, 4096, 8192, 16384)
        for label, (fplan, chunk, _batch) in inputs.items():
            start = PC.AggState(fplan, dev).state
            ms = {r: [] for r in sizes}
            for r in sizes + sizes[::-1]:
                FA.BLOCK_ROWS = r
                ms[r].append(CS.device_ms_per_call(
                    lambda: FA.fused_filter_agg_kernel(start, chunk), flush)[0])
            print(f"B5f one pass on {label} by block rows: "
                  + "; ".join(f"{r}: device ms {ms[r]}" for r in sizes), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
