"""Times versions of kernel B5 (``hyperspace_tpu_torch/csrc/segment_reduce.cu``)
against each other on the card, in turns.

    python3 scripts/torch_b5_turns.py [--sass DIR] [SRC ...]

Each SRC is a version of ``csrc/segment_reduce.cu`` with its C interface
(``hs_seg_sum_count``, ``hs_seg_minmax``, ``hs_seg_fold_sum``,
``hs_seg_scratch_bytes``). The package's own source is built too, as
"current", after the SRCs; all builds start at once, one nvcc each, and
print each kernel's registers and spills. With ``--sass DIR`` each
build's SASS (``cuobjdump -sass``) is written to ``DIR/<build>.sass``.

The inputs are phase 8's B5 calls as ``chip_smoke.b5_replica`` builds them
on the card (query d's integer SUM over 1,472,478 groups, b's float fold
over 50 groups, c's fold and MIN over one group of 6,001,215 rows) and
``chip_smoke.b5_small_group_calls`` on d's layout (MIN, MAX, the count of
valid rows). On each, every build is held bit-equal to the plain version,
then timed cold (``chip_smoke.time_cold``: 256 MiB read before each run,
median of 30, of 8 for c's fold), in turns: the builds in order, then in
reverse. Prints the card's name and power limit and one line per input
and build. Needs one CUDA device and the repository checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def build(srcs: list) -> list:
    """nvcc on every source at once; returns [(name, library)]."""
    from hyperspace_tpu_torch import kernels

    out_dir = os.path.join(ROOT, "build", "b5_turns_libs")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, src in enumerate(srcs):
        name = os.path.splitext(os.path.basename(src))[0] if i < len(srcs) - 1 else "current"
        lib = os.path.join(out_dir, f"{i}_{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-o", lib, src]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for name, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(range_pass|fixup_pass|fold_sum)\w*", m.group(1))
                entry = k.group(0) if k else m.group(1)
            elif ("registers" in line or "spill" in line) and entry:
                print(f"build {name}: {entry}: {line.split(':', 1)[-1].strip()}", flush=True)
        built.append((name, lib))
    return built


def write_sass(builds: list, out_dir: str) -> None:
    from hyperspace_tpu_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    os.makedirs(out_dir, exist_ok=True)
    for name, lib in builds:
        out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                             check=True, timeout=120).stdout
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as fh:
            fh.write(out)


@contextlib.contextmanager
def bound_to(lib):
    """Routes ``ops.aggregate``'s wrappers to the library ``lib``."""
    from hyperspace_tpu_torch.ops import aggregate as A

    saved = A._lib
    A._lib = lambda: lib
    try:
        yield
    finally:
        A._lib = saved


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sass", help="write each build's SASS into this directory")
    parser.add_argument("srcs", nargs="*", help="other versions of segment_reduce.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_b5_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from hyperspace_tpu_torch import kernels
    from hyperspace_tpu_torch.ops import aggregate as A

    print(C.card_line(), flush=True)
    builds = build(args.srcs + [os.path.join(kernels.CSRC_DIR, "segment_reduce.cu")])
    if args.sass:
        write_sass(builds, args.sass)
    libs = [(name, A.bind(ctypes.CDLL(lib))) for name, lib in builds]
    dev = torch.device("cuda")
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)  # 256 MiB
    med = lambda t: float(np.median(t))  # noqa: E731
    recorded, hosts = C.b5_replica(dev)
    d_args = recorded["d"][0][1]
    calls = [(label, op, a) for label, recs in recorded.items() for op, a in recs]
    calls += [("d", op, a) for op, a, _ in C.b5_small_group_calls(d_args, hosts[id(d_args[2])])]
    for label, op, call in calls:
        kernel = getattr(A, C.B5_KERNELS[op][0])
        for name, lib in libs:
            with bound_to(lib):
                err = C.compare_b5_call(op, call)
            if err != 0:
                raise AssertionError(f"{name}: B5 {op} on query {label}'s call differs from "
                                     f"the plain version (max_abs_err {err})")
        slow = op == "segment_sum_count" and int(call[1][-1]) > 1_000_000 \
            and call[2].dtype.is_floating_point
        times = {name: [] for name, _ in libs}
        for i in list(range(len(libs))) + list(reversed(range(len(libs)))):
            name, lib = libs[i]
            with bound_to(lib):
                times[name].append(med(C.time_cold(lambda: kernel(*call), flush,
                                                   iters=8 if slow else 30)))
        b = C.b5_bound(op, call, {"f64": float("nan"), "f32": float("nan")})
        what = op + ("" if op != "segment_minmax" else " " + call[4])
        print(f"query {label}, {what} ({b['n']} rows, {b['groups']} groups, "
              f"{str(call[2].dtype).replace('torch.', '')}): bound_ms {b['bound_ms']:.4f}; "
              f"every build bit-equal to the plain version", flush=True)
        for name, t in times.items():
            print(f"  {name}: cold ms {', '.join(f'{x:.4f}' for x in t)} (mean "
                  f"{np.mean(t):.4f}, {b['bound_ms'] / np.mean(t):.1%} of the byte bound)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
