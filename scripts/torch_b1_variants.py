"""Kernel B1 against its variants on one NVIDIA GPU.

    python3 scripts/torch_b1_variants.py [--baseline-src PATH]

At 6,001,215 rows and k = 1 (TPC-H SF1 lineitem's row count, as in
chip_smoke.py), times on one card and in turns:

* ``package``: hyperspace_tpu_torch/csrc/murmur3_bucket.cu, the kernel
  the package launches;
* ``tma0``..``tma3``: scripts/torch_b1_tma.cu, a TMA bulk-copy pipeline,
  at four (rows per chunk, stages) settings;
* ``baseline``: an earlier B1 source with the seven-argument C interface
  (``--baseline-src``), if given;
* ``copy``: ``Tensor.copy_`` of 36 MB, the same 72 MB of traffic as B1
  at k = 1, as a yardstick of the rate this card reaches for such a
  stream.

Then the package kernel alone, cold, at k = 2 and 3 with n = 6,001,215
(odd: plane 1 only 8-byte aligned, read with 8-byte loads) and
n = 6,001,216 (every plane 16-byte aligned), beside each byte bound.

Each variant is timed three ways: cold with a clean L2 (256 MiB read before each
run, chip_smoke.time_cold), cold with a dirty L2 (256 MiB written before
each run, so earlier write-backs land in the timed window), and warm
(back-to-back launches, chip_smoke.time_cuda). Every variant is first
held bit-equal to the plain version. Prints the card's name and power
limit and, last, one JSON object with every median.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TMA_SRC = os.path.join(ROOT, "scripts", "torch_b1_tma.cu")
TMA_CONFIGS = {0: (2048, 4), 1: (4096, 4), 2: (1024, 8), 3: (8192, 3)}


def build_tma():
    from hyperspace_tpu_torch import kernels

    out_dir = os.path.join(ROOT, "build", "b1_variants")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libtorch_b1_tma.so")
    proc = subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, TMA_SRC],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, lib


def load_tma(proc, lib: str):
    import torch

    from hyperspace_tpu_torch.ops import hash as H

    text, _ = proc.communicate()
    cs.log(f"build: tma variant: {text.strip()}")
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the TMA variant")
    fn = ctypes.CDLL(lib).b1_tma
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grids = {}

    def variant(config: int):
        def run(reps, num_buckets: int, seed: int = 42):
            k, n = reps.shape
            if k != 1:
                raise ValueError("the TMA variant takes k = 1")
            out = torch.empty(n, dtype=torch.int32, device=reps.device)
            grid = ctypes.c_int(0)
            err = fn(reps.data_ptr(), out.data_ptr(), n, H.fastmod_m(num_buckets),
                     num_buckets, seed & 0xFFFFFFFF, config, ctypes.byref(grid),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"TMA variant {config} failed: CUDA error {err}")
            grids[config] = grid.value
            return out

        return run

    return variant, grids


def time_dirty(fn, flush, iters: int = 30) -> list:
    """chip_smoke.time_cold, but writing ``flush`` before each run."""
    import torch

    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-src", help="an earlier csrc/murmur3_bucket.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_b1_variants: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import kernels
    from hyperspace_tpu_torch.ops import hash as H

    card = cs.card_line()
    cs.log(f"card: {card}")
    tma_build = build_tma()
    base_build = cs.build_baseline(args.baseline_src) if args.baseline_src else None
    kernels.build_all()
    tma, grids = load_tma(*tma_build)
    dev = torch.device("cuda")

    n = cs.N_ROWS
    variants = {"package": H.bucket_ids_kernel}
    for config in TMA_CONFIGS:
        variants[f"tma{config}"] = tma(config)
    if base_build:
        variants["baseline"] = cs.load_baseline(*base_build)
    cases = {
        (m, 1, 0): [(200, 42), (1, 42), ((1 << 31) - 1, 7), (1 << 31, 7)]
        for m in (1, 5, 1023, 1024, 2047, 2048, 2049, 8193, 1 << 20, n)
    }
    for name, fn in variants.items():
        count, err = cs.check_b1(dev, fn, name, cases)
        cs.log(f"check: {name} bit-equal to plain over {count} cases (max_abs_err {err})")

    rng = np.random.default_rng(cs.SEED + 3)
    reps = torch.from_numpy(
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, size=(1, n),
                     dtype=np.int64)
    ).to(dev)
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    src = torch.zeros(n * 3 // 2, dtype=torch.int32, device=dev)  # 36 MB
    dst = torch.empty_like(src)
    timed = {name: (lambda f: lambda: f(reps, 200))(fn) for name, fn in variants.items()}
    timed["copy"] = lambda: dst.copy_(src)
    samples = {name: {"clean": [], "dirty": [], "warm": []} for name in timed}
    order = list(timed) + list(reversed(list(timed)))
    for _ in range(2):
        for name in order:
            fn = timed[name]
            samples[name]["clean"] += cs.time_cold(fn, flush)
            samples[name]["dirty"] += time_dirty(fn, flush)
            samples[name]["warm"].append(cs.time_cuda(fn))
    bound = cs.b1_bound(n, 1)
    result = {}
    for name, s in samples.items():
        clean = np.array(s["clean"])
        result[name] = {
            "clean_ms": float(np.median(clean)),
            "clean_q25_ms": float(np.percentile(clean, 25)),
            "clean_q75_ms": float(np.percentile(clean, 75)),
            "dirty_ms": float(np.median(s["dirty"])),
            "warm_ms": float(np.median(s["warm"])),
            "share_of_bound": bound["bound_ms"] / float(np.median(clean)),
        }
        cs.log(
            f"time: {name:9s} cold clean {result[name]['clean_ms']:.4f} ms "
            f"(q25 {result[name]['clean_q25_ms']:.4f}, q75 "
            f"{result[name]['clean_q75_ms']:.4f}; {result[name]['share_of_bound']:.1%} "
            f"of {bound['bound_ms']:.4f}), cold dirty {result[name]['dirty_ms']:.4f}, "
            f"warm {result[name]['warm_ms']:.4f}"
        )
    for config, (rows, stages) in TMA_CONFIGS.items():
        result[f"tma{config}"].update(rows=rows, stages=stages, grid=grids.get(config))

    planes = []
    for k in (2, 3):
        for m in (n, n + 1):
            reps_k = torch.from_numpy(
                rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                             size=(k, m), dtype=np.int64)
            ).to(dev)
            ms = float(np.median(cs.time_cold(lambda: H.bucket_ids_kernel(reps_k, 200),
                                              flush)))
            b = cs.b1_bound(m, k)
            planes.append({"k": k, "n": m, "aligned_planes": H.aligned_planes(reps_k),
                           "ms": ms, "bound_ms": b["bound_ms"],
                           "share_of_bound": b["bound_ms"] / ms})
            cs.log(f"time: package k={k} n={m} aligned planes "
                   f"{H.aligned_planes(reps_k):#b}: cold clean {ms:.4f} ms "
                   f"({b['bound_ms'] / ms:.1%} of {b['bound_ms']:.4f})")
    print(card, flush=True)
    print(json.dumps({"rows": n, "k": 1, "bound_ms": bound["bound_ms"],
                      "variants": result, "alignment": planes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
