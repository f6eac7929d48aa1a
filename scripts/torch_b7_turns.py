"""Times kernel B7's build (``hs_bloom_build``) of commit 28bd287, its first
design (every bit an atomicOr in L2), against the package's own on the
card, in turns, and two designs that lost to the package's
(``scripts/torch_b7_variants.cu``).

    python3 scripts/torch_b7_turns.py --extract   # where git is: writes 28bd287's sources
    python3 scripts/torch_b7_turns.py             # on the card

``--extract`` writes 28bd287's ``bloom_bits.cu`` and ``murmur3.cuh``
(``git show 28bd287:hyperspace_tpu_torch/csrc/<file>``) under
``build/b7_turns/base/``, an ignored directory beside the checkout. Run
without it, on the card, the script builds them and
``scripts/torch_b7_variants.cu`` with nvcc beside the package's own
sources (one nvcc each, all at once) and prints each kernel's registers,
shared memory and spills (``-Xptxas -v``) once. Then, on phase 11's
m = 5,751,040 and k = 7 (the binned route) and on m = 95,872 (block) and
2^31 - 64 (global), at a source file's 750,152 rows and at 6,001,215,
l_orderkey-like reps (``rng.integers(0, 1,500,000)``), and on source file
0's own l_orderkey reps (``chip_smoke.lineitem_columns``, duplicates
included), each build's words are held bit-equal to the plain version on
a CPU copy, then timed cold (``chip_smoke.time_cold``: 256 MiB read
before each run, median of 30) in turns: base, current, current, base;
at phase 11's m the two variants join them (base, current, dsmem,
sliced, sliced, dsmem, current, base). Each line gives the current
build's route, the bound (``chip_smoke.b7_bound``) and each build's share
of it. Prints the card's name and power limit first. Needs one CUDA
device and the repository checkout.
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

PARENT = "28bd287"
TURNS_DIR = os.path.join(ROOT, "build", "b7_turns")
OLD_DIR = os.path.join(TURNS_DIR, "base")
SOURCES = ("bloom_bits.cu", "murmur3.cuh")


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
    """nvcc on the base's source and the variants' at once (the package's
    own build as well); prints every kernel's registers, shared memory and
    spills; returns {build name: (CDLL, entry name)}."""
    from hyperspace_tpu_torch import kernels

    for name in SOURCES:
        if not os.path.exists(os.path.join(OLD_DIR, name)):
            raise SystemExit(f"{OLD_DIR}/{name} missing: run with --extract where git is")
    out_dir = os.path.join(TURNS_DIR, "libs")
    os.makedirs(out_dir, exist_ok=True)
    srcs = {"base": (os.path.join(OLD_DIR, "bloom_bits.cu"), OLD_DIR),
            "variants": (os.path.join(ROOT, "scripts", "torch_b7_variants.cu"),
                         kernels.CSRC_DIR)}
    procs = []
    for name, (src, inc) in srcs.items():
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", inc, "-o", lib, src]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cur_dir = kernels.build_all()
    logs, libs = {}, {}
    for name, lib, proc in procs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
        libs[name] = ctypes.CDLL(lib)
    with open(os.path.join(cur_dir, "libbloom_bits.log")) as fh:
        logs["current"] = fh.read()
    libs["current"] = kernels.load("bloom_bits")
    for build_name, text in logs.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(bit_indices|build|block|bin|apply|dsmem|sliced)_kernel",
                              m.group(1))
                entry = k.group(0) if k else m.group(1)
            elif entry and ("registers" in line or "spill" in line or "smem" in line):
                print(f"build {build_name}: {entry}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    six = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
           ctypes.c_void_p]
    entries = {"base": (libs["base"], "hs_bloom_build"),
               "current": (libs["current"], "hs_bloom_build"),
               "dsmem": (libs["variants"], "hs_bloom_build_dsmem"),
               "sliced": (libs["variants"], "hs_bloom_build_sliced")}
    for name, (lib, fn) in entries.items():
        if name != "current":
            getattr(lib, fn).argtypes = six
            getattr(lib, fn).restype = ctypes.c_int
    return entries


def runner(name: str, entry, reps, words, m: int, k: int, stream: int):
    """One call of a build's C entry on device reps into ``words``; the
    current one through its scratch, allocated once here as its wrapper
    would allocate it a call."""
    import torch

    from hyperspace_tpu_torch.ops import bloom as B

    lib, fn_name = entry
    fn = getattr(lib, fn_name)
    n = reps.shape[0]
    if name == "current":
        need = B.build_plan(m, n, k, 0).scratch_bytes if n else 0
        scratch = torch.empty(need, dtype=torch.uint8, device=reps.device)
        fn = B._kernel_fns()[1]

        def run():
            err = fn(reps.data_ptr(), words.data_ptr(), scratch.data_ptr(), need, n, m, k, stream)
            if err:
                raise RuntimeError(f"hs_bloom_build of {name}: CUDA error {err}")
    else:
        def run():
            err = fn(reps.data_ptr(), words.data_ptr(), n, m, k, stream)
            if err:
                raise RuntimeError(f"{fn_name} of {name}: CUDA error {err}")
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--extract", action="store_true",
                        help=f"write {PARENT}'s sources under build/b7_turns/base and stop")
    args = parser.parse_args()
    if args.extract:
        extract()
        return 0
    import torch

    import chip_smoke as CS
    import torch_b7_cases as B7C

    from hyperspace_tpu_torch.ops import bloom as B

    if not torch.cuda.is_available():
        print("torch_b7_turns: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {CS.card_line()}", flush=True)
    entries = build()
    dev = torch.device("cuda")
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    k = B7C.PHASE_K
    rng = np.random.default_rng(CS.SEED + 31)
    cases = [(f"random {n}", n, m, rng.integers(0, CS.N_ORDERS, n, dtype=np.int64))
             for n in (CS.FILE_ROWS, CS.N_ROWS) for m in (95_872, B7C.PHASE_M, B7C.WRAP_M)]
    real = CS.lineitem_columns()["l_orderkey"][: CS.N_ROWS // CS.N_FILES]
    cases.append((f"file 0's l_orderkey ({len(np.unique(real))} distinct)", len(real),
                  B7C.PHASE_M, real))
    for label, n, m, host in cases:
        reps_cpu = torch.from_numpy(np.ascontiguousarray(host))
        reps = reps_cpu.to(dev)
        if m <= B7C.PHASE_M:
            want = B.build_bloom_torch(reps_cpu, m, k).numpy().view(np.uint64)
        else:
            want = B7C.words_from_indices(B.bit_indices_torch(reps_cpu, m, k).numpy(), m)
        words = torch.empty(m // 64, dtype=torch.int64, device=dev)
        order = (["base", "current", "dsmem", "sliced", "sliced", "dsmem", "current", "base"]
                 if m == B7C.PHASE_M else ["base", "current", "current", "base"])
        times = {b: [] for b in dict.fromkeys(order)}
        for b in order:
            run = runner(b, entries[b], reps, words, m, k, stream)
            words.fill_(-1)
            run()
            if not np.array_equal(words.cpu().numpy().view(np.uint64), want):
                raise AssertionError(f"the build of {b} differs from the plain version on "
                                     f"{label}, m {m}")
            times[b].append(float(np.median(CS.time_cold(run, flush))))
        bound = CS.b7_bound(n, m, k, True)
        mean = {b: float(np.mean(t)) for b, t in times.items()}
        print(f"B7 build on {label} rows, m={m}, k={k}: current takes the {B.build_route(m)} "
              f"route; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
              + "; ".join(f"{b} cold ms {times[b]} (mean {mean[b]:.4f}, "
                          f"{bound['bound_ms'] / mean[b]:.1%} of bound)" for b in times)
              + f"; base / current {mean['base'] / mean['current']:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
