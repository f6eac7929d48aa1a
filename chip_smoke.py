"""Chip smoke test of hyperspace_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-src PATH]

Drives the port's main path once at real scale and holds every kernel
against its plain PyTorch version on the card:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every CUDA kernel under hyperspace_tpu_torch/csrc with nvcc
   for sm_90a, one nvcc per source, all started together;
3. kernels:
   * murmur3 bucket ids (kernel B1) bit-equal to the plain version over
     136 cases (``b1_cases``: n from 0 to 6,001,215 with ragged tails, k
     in {1, 2, 3, 4}, odd n and views 8 bytes off a 16-byte boundary,
     num_buckets in {1, 200, 2^31 - 1, 2^31}, seeds {42, 7}); timed with
     CUDA events on a busy device at 6,001,215 rows: cold (L2 flushed
     before each run) for k = 1, 2, 3 beside each byte bound and the
     plain version, warm (back to back) for k = 1, and at a query's n = 1
     and 8 as latency. With ``--baseline-src`` an earlier B1 source is
     built too, held against the plain version and timed cold in turns
     with the current kernel (baseline, current, current, baseline);
   * the per-bucket join match (kernel B4) with pair lists equal in
     order to the plain version over ``b4_cases`` (presorted and unsorted
     segments, B in {1, 7, 200}, empty segments on either side, n or
     m = 0, INT64_MIN / INT64_MAX keys, null sentinels, many-to-many
     duplicates, one skewed 2,000 x 2,000 segment);
4. filter path: a lineitem-shaped table of 6,001,215 rows (TPC-H SF1
   lineitem's row count, l_orderkey over SF1's 1,500,000 orders), a
   covering index with the default 200 buckets, then 32 point and 4
   IN-list filters served from the index with bucket pruning, each
   checked against the unindexed plan row for row;
5. join path: an orders table in the bench.py shape (1,500,000 rows,
   8 files), its covering index on o_orderkey, then ``orders ⋈
   lineitem`` on the order key served shuffle-free from both indexes
   (phase 4's li_idx covers the lineitem columns the join uses)
   (one warm-up and 5 timed runs, each stage's seconds), its rows equal
   as a multiset to the unindexed plan's (also timed); then a two-key
   join with about 1 % null keys on 200,000 rows a side, equal to its
   unindexed plan;
6. B4 on phase 5's own inputs: the first B4 call of each of phase 5's
   four plans is recorded (``B4Inputs``) and held equal in order to the
   plain version: the indexed join (1,500,000 x 6,001,215 keys, 200
   presorted buckets), the unindexed one (one segment, both row maps),
   and the two-key join both ways (per-bucket sorts, row maps). The
   indexed and unindexed inputs are timed there cold and warm, count and
   emit passes apart, beside the bound and the plain version, with a
   batched ``torch.searchsorted`` over the indexed buckets padded to
   [B, W] (ranges only, no pairs) as a yardstick.

Kernel launch counts are set to 0 just before phases 4 and 5 and read
just after each; phase 6's launches are not counted as the main path's. Any failure raises and exits non-zero. The last two
lines of standard output are the kernels' JSON record and ``{"ok": true,
"device": ...}``. It needs one CUDA device and the repository checkout
it lives in; the tables are written under build/chip_smoke/ and removed
at the end.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 6_001_215  # TPC-H SF1 lineitem
N_ORDERS = 1_500_000  # TPC-H SF1 orders
N_FILES = 8
SEED = 7
# H100 SXM peaks (NVIDIA data sheet and Hopper white paper, 700 W part):
# HBM3 bandwidth, and 32-bit integer ALU operations (132 SMs x 64 INT32
# lanes x 1.98 GHz boost; outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def hold_device(ms: float = 10.0) -> None:
    """Enqueue about ``ms`` of device busy-wait (at up to 2 GHz), so that
    the events and launches the host enqueues next queue behind it and
    time the device, not the host's path from Python to each launch."""
    import torch

    torch.cuda._sleep(int(ms * 2e6))


def time_cuda(fn, launches: int = 30, repeats: int = 5) -> float:
    """Milliseconds per launch of ``fn``, warm: ``launches`` back-to-back
    runs between two CUDA events behind :func:`hold_device`, the median
    over ``repeats`` such runs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        hold_device()
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def time_cold(fn, flush, warmup: int = 3, iters: int = 30) -> list:
    """Milliseconds of ``iters`` CUDA-event-timed runs of ``fn``, each
    after reading all of ``flush`` (five times the 50 MB L2) outside the
    timed window: every run finds its inputs in HBM and the L2 holding
    only clean lines, so no write-back of earlier work lands in the
    timed window. The flush keeps the card busy while the host enqueues
    the run, so the events time the device."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def murmur3_ops_per_row(k: int) -> int:
    """32-bit integer operations per row of kernel B1: 6 per word mix (two
    words per key); 9 for fmix (the length xor, three shift-xor pairs, two
    multiplies); 6 for the remainder by precomputed constants (two
    32x32 -> 64-bit products at 2 each, two 32-bit products at 1)."""
    return 12 * k + 15


def b1_bound(n: int, k: int) -> dict:
    """Least time of B1 on [k, n] reps: the larger of its bytes (k int64
    reads and one int32 write per row) over HBM bandwidth and its integer
    operations over the int32 peak."""
    nbytes = (8 * k + 4) * n
    ops = n * murmur3_ops_per_row(k)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes,
        "bytes_ms": bytes_ms,
        "int32_ops": ops,
        "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def b1_cases() -> dict:
    """Correctness cases of B1: (n, k, plane-0 offset in int64s) ->
    [(num_buckets, seed), ...]. Ragged tails around the 128-row warp
    tile, an exact multiple of it, odd n with k >= 2 (every other plane
    8 bytes off a 16-byte boundary), views whose plane 0 starts 8 bytes
    off, the extreme bucket counts, and k = 4 for the generic-k path."""
    cases: dict = {}

    def add(ns, ks, offsets, nbs, seeds):
        for n, k, off, nb, seed in itertools.product(ns, ks, offsets, nbs, seeds):
            cases.setdefault((n, k, off), []).append((nb, seed))

    add((0, 1, 255, 257, N_ROWS), (1, 2, 3), (0,), (200, 1 << 31), (42, 7))
    add((2, 3, 4, 5, 127, 128, 129, 1 << 20), (1, 2, 3), (0,), (200, 1 << 31), (42,))
    add((5, 129, 1 << 20, N_ROWS), (1, 2, 3), (1,), (200,), (7,))
    add((257, N_ROWS), (1, 2, 3), (0,), (1, (1 << 31) - 1), (42,))
    add((129, N_ROWS), (4,), (0, 1), (200,), (42,))
    return cases


def device_reps(reps_np: np.ndarray, dev, offset_rows: int):
    """The [k, n] reps on the card, as a contiguous view starting
    ``offset_rows`` int64s into a fresh allocation."""
    import torch

    k, n = reps_np.shape
    buf = torch.empty(k * n + offset_rows, dtype=torch.int64, device=dev)
    reps = buf[offset_rows:].view(k, n)
    reps.copy_(torch.from_numpy(reps_np))
    if n and reps.data_ptr() % 16 != (8 * offset_rows) % 16:
        raise AssertionError("allocation not 16-byte aligned; offset case is void")
    return reps


def check_b1(dev, kernel, label: str, cases: dict) -> tuple:
    """Hold ``kernel`` bit-equal to the plain version over ``cases``;
    returns (number of cases, max_abs_err)."""
    import torch

    from hyperspace_tpu_torch.ops import hash as H

    rng = np.random.default_rng(SEED)
    i64 = np.iinfo(np.int64)
    max_err, count = 0, 0
    for (n, k, off), params in cases.items():
        reps_np = rng.integers(i64.min, i64.max, size=(k, n), dtype=np.int64,
                               endpoint=True)
        extremes = np.array([i64.min, i64.max, -1, 0], dtype=np.int64)
        reps_np[0, : min(n, 4)] = extremes[: min(n, 4)]
        reps = device_reps(reps_np, dev, off)
        for nb, seed in params:
            got = kernel(reps, nb, seed)
            torch.cuda.synchronize()
            want = H.bucket_ids_torch(reps, nb, seed)
            if got.dtype != torch.int32 or got.shape != (n,):
                raise AssertionError(f"{label}: bad output {got.dtype} {got.shape}")
            err = (got.long() - want.long()).abs().max().item() if n else 0
            max_err = max(max_err, err)
            count += 1
            if err != 0:
                raise AssertionError(
                    f"{label} differs from plain: n={n} k={k} offset={off} "
                    f"nb={nb} seed={seed}"
                )
    return count, max_err


def build_baseline(src: str):
    """Start nvcc on an earlier B1 source (the C interface without the
    remainder constant and alignment bits) beside the package build;
    returns (process, library path)."""
    from hyperspace_tpu_torch import kernels

    out_dir = os.path.join(ROOT, "build", "baseline_b1")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libbaseline_b1.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def load_baseline(proc, lib: str):
    """Wait for :func:`build_baseline`; returns a wrapper with the
    package kernel's signature (reps, num_buckets, seed) -> out."""
    import ctypes

    import torch

    log_text, _ = proc.communicate()
    log(f"build: baseline B1: {log_text.strip()}")
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the baseline B1 source")
    fn = ctypes.CDLL(lib).hs_murmur3_bucket_ids
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(reps, num_buckets: int, seed: int = 42):
        k, n = reps.shape
        out = torch.empty(n, dtype=torch.int32, device=reps.device)
        err = fn(reps.data_ptr(), out.data_ptr(), n, k, num_buckets,
                 seed & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline B1 launch failed: CUDA error {err}")
        return out

    return run


def check_kernels(dev, baseline=None) -> dict:
    import torch

    from hyperspace_tpu_torch.ops import hash as H

    count, max_err = check_b1(dev, H.bucket_ids_kernel, "B1", b1_cases())
    log(f"kernels: B1 bit-equal to plain over {count} cases (max_abs_err {max_err})")

    rng = np.random.default_rng(SEED + 2)
    i64 = np.iinfo(np.int64)
    # 256 MiB read before every cold run: five times the L2
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    cold = []
    for k in (1, 2, 3):
        reps = torch.from_numpy(
            rng.integers(i64.min, i64.max, size=(k, N_ROWS), dtype=np.int64)
        ).to(dev)
        ms = float(np.median(time_cold(lambda: H.bucket_ids_kernel(reps, 200), flush)))
        plain_ms = time_cuda(lambda: H.bucket_ids_torch(reps, 200))
        b = b1_bound(N_ROWS, k)
        cold.append({"k": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"], "share_of_bound": b["bound_ms"] / ms})
        log(
            f"kernels: B1 cold at {N_ROWS} rows, k={k}: ms {ms:.4f} bound_ms "
            f"{b['bound_ms']:.4f} ({b['bound_ms'] / ms:.1%}; bytes {b['bytes']} -> "
            f"{b['bytes_ms']:.4f} ms, int32 ops {b['int32_ops']} -> "
            f"{b['ops_ms']:.4f} ms); plain_ms {plain_ms:.4f}; library_ms n/a"
        )
        if k == 1:
            reps1 = reps
    warm_ms = time_cuda(lambda: H.bucket_ids_kernel(reps1, 200))
    log(f"kernels: B1 warm (back to back) at {N_ROWS} rows, k=1: ms {warm_ms:.4f}")

    query = {}
    for n in (1, 8):
        reps = reps1[:, :n].contiguous()
        device_ms = time_cuda(lambda: H.bucket_ids_kernel(reps, 200), launches=100)
        host = []
        for _ in range(100):
            t0 = time.perf_counter()
            H.bucket_ids_kernel(reps, 200)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        query[str(n)] = {"device_ms": device_ms, "host_ms": float(np.median(host))}
        log(f"kernels: B1 query launch n={n}: device_ms {device_ms:.4f} "
            f"host_ms (call + synchronize) {np.median(host):.4f}")

    turns = None
    if baseline is not None:
        _, err_b = check_b1(dev, baseline, "baseline B1", {(N_ROWS, 1, 0): [(200, 42)]})
        baseline_samples, turns = [], []
        for name in ("baseline", "new", "new", "baseline"):
            fn = baseline if name == "baseline" else H.bucket_ids_kernel
            t = time_cold(lambda: fn(reps1, 200), flush)
            if name == "baseline":
                baseline_samples += t
            turns.append([name, float(np.median(t))])
        log(f"kernels: B1 cold in turns at {N_ROWS} rows, k=1 (baseline bit-equal, "
            f"max_abs_err {err_b}): " + ", ".join(f"{a} {b:.4f}" for a, b in turns))
    k1 = cold[0]
    return {
        "name": "murmur3_bucket_ids",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/murmur3_bucket.cu",
        "replaces": "hyperspace_tpu/ops/hash.py:248",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "cases": count,
        "timing": "cold: 256 MiB read before each run, median of 30",
        "cold_by_k": cold,
        "warm_ms": warm_ms,
        "query": query,
        "baseline_ms": float(np.median(baseline_samples)) if turns else None,
        "turns_ms": turns,
    }


I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
N_BUCKETS = 200


def b4_cases(rng) -> list:
    """Correctness cases of B4: (label, left keys, left offsets, right
    keys, right offsets, left mode, right mode), numpy. Mode "sorted": each
    segment is ascending already (a clean index bucket); "sort": the side
    is stably sorted per segment on the card first, as the main path does
    for unsorted buckets; "as is" (left only): the keys go to B4 in their
    own order, as the unindexed join's left does."""

    def case(label, l_sizes, r_sizes, lo, hi, l_mode, r_mode):
        l_sizes = np.asarray(l_sizes, dtype=np.int64)
        r_sizes = np.asarray(r_sizes, dtype=np.int64)
        l = rng.integers(lo, hi, int(l_sizes.sum()), dtype=np.int64, endpoint=True)
        r = rng.integers(lo, hi, int(r_sizes.sum()), dtype=np.int64, endpoint=True)
        l_offs = np.concatenate([[0], np.cumsum(l_sizes)])
        r_offs = np.concatenate([[0], np.cumsum(r_sizes)])
        for keys, offs, mode in ((l, l_offs, l_mode), (r, r_offs, r_mode)):
            if mode == "sorted":
                for a, b in zip(offs[:-1], offs[1:]):
                    keys[a:b].sort()
        return [label, l, l_offs, r, r_offs, l_mode, r_mode]

    out = []
    for nb in (1, 7, N_BUCKETS):
        ls = rng.integers(0, 3000, nb)
        rs = rng.integers(0, 3000, nb)
        out.append(case(f"presorted B={nb}", ls, rs, 0, 4000, "sorted", "sorted"))
        out.append(case(f"unsorted B={nb}", ls, rs, 0, 4000, "sort", "sort"))
        out.append(case(f"left unsorted B={nb}", ls, rs, -50, 50, "sort", "sorted"))
    sizes = np.array([0, 500, 0, 700, 300, 0, 900])
    out.append(case("empty left segments", sizes, sizes[::-1] + 1, 0, 300,
                    "sorted", "sorted"))
    out.append(case("empty right segments", sizes[::-1] + 1, sizes, 0, 300,
                    "sort", "sort"))
    out.append(case("n = 0", [0, 0, 0], [5, 0, 9], 0, 5, "sorted", "sorted"))
    out.append(case("m = 0", [5, 0, 9], [0, 0, 0], 0, 5, "sorted", "sorted"))
    out.append(case("n = m = 0", [0], [0], 0, 5, "sorted", "sorted"))
    out.append(case("row order", [40_000], [50_000], 0, 20_000, "as is", "sort"))
    ext = case("INT64_MIN / INT64_MAX", [1000, 1000], [1000, 1000], I64_MIN, I64_MAX,
               "sort", "sort")
    for arr in (ext[1], ext[3]):  # the extremes as real keys on both sides
        arr[::7] = I64_MAX
        arr[3::11] = I64_MIN
        arr[5::13] = -1
    out.append(ext)
    # the executor's null sentinels: left even offsets, right odd, and a
    # real key equal to one of them
    from hyperspace_tpu_torch.execution.join_exec import _SENTINEL_BASE

    sen = case("null sentinels", [800, 800], [800, 800], -10, 10, "sort", "sort")
    sen[1][::9] = _SENTINEL_BASE - 2 * np.arange(len(sen[1][::9]))
    sen[3][::9] = _SENTINEL_BASE - 2 * np.arange(len(sen[3][::9])) - 1
    sen[3][1] = _SENTINEL_BASE  # a real right key equal to a left sentinel
    out.append(sen)
    out.append(case("many-to-many", [3000, 3000], [3000, 3000], 0, 3, "sorted", "sorted"))
    skew = case("skewed segment", [100, 2000, 100], [100, 2000, 100], 0, 1000,
                "sort", "sort")
    skew[1][100:2100] = 42
    skew[3][100:2100] = 42
    out.append(skew)
    return out


def run_b4_case(dev, l, l_offs, r, r_offs, l_mode, r_mode) -> int:
    """Hold B4 against its plain version on one case on the card; returns
    the max abs error (0, or it raises)."""
    import torch

    from hyperspace_tpu_torch.ops import join as J

    lk = torch.from_numpy(l).to(dev)
    rk = torch.from_numpy(r).to(dev)
    l_row = r_row = None
    if l_mode == "sort":
        lk, l_row = J.segment_sort(lk, l_offs)
    if r_mode == "sort":
        rk, r_row = J.segment_sort(rk, r_offs)
    return compare_b4(dev, lk, l_offs, rk, r_offs, l_row, r_row)


def compare_b4(dev, lk, l_offs, rk, r_offs, l_row=None, r_row=None) -> int:
    import torch

    from hyperspace_tpu_torch.ops import join as J

    got = J.match_pairs_kernel(lk, l_offs, rk, r_offs, l_row, r_row)
    torch.cuda.synchronize()
    want = J.match_pairs_torch(lk, l_offs, rk, r_offs, l_row, r_row)
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != torch.int64 or g.device != lk.device:
            raise AssertionError(f"B4: bad output {g.dtype} {tuple(g.shape)} "
                                 f"want {tuple(w.shape)}")
    err = max(
        (int((g - w).abs().max()) if g.numel() else 0) for g, w in zip(got, want)
    )
    if err != 0:
        raise AssertionError("B4 pairs differ from the plain version")
    return err


def b4_bound(n: int, m: int, pairs: int, segments: int, probes: int,
             maps: int = 0) -> dict:
    """Least time of B4: the larger of its bytes (each left and right key
    read once, ``maps`` row maps of the left/right length read once, the
    offsets, 16 bytes written per pair) over HBM bandwidth and its
    integer operations over the int32 peak: 6 int32 operations (64-bit
    address, compare and bound update, two each) per binary-search probe
    and 4 per pair written (two 64-bit stores' addresses)."""
    nbytes = 8 * n + 8 * m + maps + 16 * (segments + 1) + 16 * pairs
    ops = 6 * probes + 4 * pairs
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes,
        "bytes_ms": bytes_ms,
        "int32_ops": ops,
        "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def b4_probes(l_offs: np.ndarray, r_offs: np.ndarray) -> int:
    """Binary-search probes of B4's count pass on these segments: per left
    row, the segment lookup over B + 1 offsets and the lower and upper
    bound over its right segment."""
    seg = np.ceil(np.log2(max(len(l_offs) - 1, 1))).astype(np.int64)
    r_len = np.diff(r_offs)
    per_row = seg + 2 * np.ceil(np.log2(r_len + 1)).astype(np.int64)
    return int(np.sum(np.diff(l_offs) * per_row))


def check_b4_cases(dev) -> tuple:
    """B4's cases against its plain version (phase 3): (count, max abs
    error)."""
    rng = np.random.default_rng(SEED + 3)
    count, max_err = 0, 0
    for _label, l, l_offs, r, r_offs, l_mode, r_mode in b4_cases(rng):
        max_err = max(max_err, run_b4_case(dev, l, l_offs, r, r_offs, l_mode, r_mode))
        count += 1
    log(f"kernels: B4 pairs equal in order to plain over {count} cases "
        f"(max_abs_err {max_err})")
    return count, max_err


class B4Inputs:
    """Keeps the inputs of the first B4 call that the join executor makes
    under each label: the very keys, offsets and row maps that phase 5
    hands the kernel, for the comparison with the plain version and the
    timing after the phase. The wrapper calls straight through, so its
    launches count as the main path's."""

    def __init__(self):
        from hyperspace_tpu_torch.execution import join_exec

        self.calls, self.label = {}, None
        inner = join_exec.match_pairs

        def recording(*args):
            if self.label is not None:
                self.calls.setdefault(self.label, args)
            return inner(*args)

        join_exec.match_pairs = recording


def time_b4(dev, args, flush) -> dict:
    """Cold and warm times of B4 on one recorded call's inputs: count
    pass, emit pass, and the two with the scan between them, beside the
    bound; and the wrapper's whole call, its read of the total included."""
    import torch

    from hyperspace_tpu_torch.ops import join as J

    lk, l_offs, rk, r_offs, l_row, r_row = args
    l_offs, r_offs = np.asarray(l_offs, np.int64), np.asarray(r_offs, np.int64)
    stream = torch.cuda.current_stream().cuda_stream
    l_offs_t = torch.from_numpy(l_offs).to(dev)
    r_offs_t = torch.from_numpy(r_offs).to(dev)
    lo, cnt = J._count_pass(lk, l_offs_t, rk, r_offs_t, stream)
    incl = torch.cumsum(cnt, 0)
    total = int(incl[-1])
    li = torch.empty(total, dtype=torch.int64, device=dev)
    ri = torch.empty(total, dtype=torch.int64, device=dev)

    def sequence():  # count pass, scan, emit pass: B4's device work
        lo2, cnt2 = J._count_pass(lk, l_offs_t, rk, r_offs_t, stream)
        J._emit_pass(lo2, cnt2, torch.cumsum(cnt2, 0), l_row, r_row, li, ri, stream)

    med = lambda t: float(np.median(t))  # noqa: E731
    count_ms = med(time_cold(lambda: J._count_pass(lk, l_offs_t, rk, r_offs_t, stream),
                             flush))
    emit_ms = med(time_cold(
        lambda: J._emit_pass(lo, cnt, incl, l_row, r_row, li, ri, stream), flush))
    ms = med(time_cold(sequence, flush))
    call = []
    for _ in range(10):
        flush.sum()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J.match_pairs_kernel(lk, l_offs, rk, r_offs, l_row, r_row)
        torch.cuda.synchronize()
        call.append((time.perf_counter() - t0) * 1e3)
    maps = sum(8 * t.shape[0] for t in (l_row, r_row) if t is not None)
    b = b4_bound(lk.shape[0], rk.shape[0], total, len(l_offs) - 1,
                 b4_probes(l_offs, r_offs), maps)
    return {
        "n": lk.shape[0], "m": rk.shape[0], "segments": len(l_offs) - 1,
        "pairs": total, "row_maps": [l_row is not None, r_row is not None],
        "ms": ms, "count_ms": count_ms, "emit_ms": emit_ms,
        "warm_ms": time_cuda(sequence), "call_ms": med(call),
        "plain_ms": time_cuda(
            lambda: J.match_pairs_torch(lk, l_offs, rk, r_offs, l_row, r_row),
            launches=3, repeats=3),
        **b,
    }


def check_b4_main_path(dev, recorded: dict, cases: int, case_err: int) -> dict:
    """B4 on the inputs that phase 5 handed it: each recorded call held
    equal in order to the plain version, then the indexed and the
    unindexed join's shapes timed; returns B4's record for the kernels
    line."""
    import torch

    labels = ("indexed", "unindexed", "two-key indexed", "two-key unindexed")
    missing = [k for k in labels if k not in recorded]
    if missing:
        raise AssertionError(f"phase 5 made no B4 call for {missing}")
    max_err = case_err
    for label in labels:
        lk, l_offs, rk, r_offs, l_row, r_row = recorded[label]
        max_err = max(max_err, compare_b4(dev, lk, l_offs, rk, r_offs, l_row, r_row))
        log(f"kernels: B4 pairs equal in order to plain on phase 5's {label} join inputs "
            f"({lk.shape[0]} x {rk.shape[0]} keys, {len(l_offs) - 1} segments, row maps "
            f"{l_row is not None}/{r_row is not None})")
    if recorded["indexed"][4] is not None or recorded["indexed"][5] is not None:
        raise AssertionError("the indexed join did not take the presorted route")

    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)  # 256 MiB
    t = time_b4(dev, recorded["indexed"], flush)
    u = time_b4(dev, recorded["unindexed"], flush)

    # yardstick: both sides padded to [B, W] with INT64_MAX, one batched
    # torch.searchsorted per bound (the count pass's ranges, no pairs)
    lk, l_offs, rk, r_offs = recorded["indexed"][:4]

    def padded(keys, offs):
        sizes = torch.from_numpy(np.diff(offs)).to(dev)
        seg = torch.repeat_interleave(torch.arange(len(offs) - 1, device=dev), sizes)
        pos = torch.arange(keys.shape[0], device=dev) - torch.from_numpy(
            offs[:-1]).to(dev)[seg]
        out = torch.full((len(offs) - 1, int(sizes.max())), I64_MAX, dtype=torch.int64,
                         device=dev)
        out[seg, pos] = keys
        return out

    lp, rp = padded(lk, l_offs), padded(rk, r_offs)
    yard_ms = float(np.median(time_cold(
        lambda: (torch.searchsorted(rp, lp), torch.searchsorted(rp, lp, right=True)),
        flush)))
    for label, r in (("indexed", t), ("unindexed", u)):
        log(
            f"kernels: B4 cold on the {label} join's inputs, {r['n']} x {r['m']} keys, "
            f"{r['segments']} segments, row maps {r['row_maps']}, {r['pairs']} pairs: "
            f"ms {r['ms']:.4f} (count pass {r['count_ms']:.4f}, emit pass "
            f"{r['emit_ms']:.4f}) bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_ms'] / r['ms']:.1%}; bytes {r['bytes']} -> {r['bytes_ms']:.4f} "
            f"ms, int32 ops {r['int32_ops']} -> {r['ops_ms']:.4f} ms); warm ms "
            f"{r['warm_ms']:.4f}; wrapper call with its total read ms {r['call_ms']:.4f}; "
            f"plain_ms {r['plain_ms']:.4f}"
        )
    log(f"kernels: batched torch.searchsorted over the indexed join's [{len(l_offs) - 1}, "
        f"W] buckets (yardstick, ranges only) cold ms {yard_ms:.4f}; library_ms n/a")
    return {
        "name": "bucket_match_pairs",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/bucket_match.cu",
        "replaces": "hyperspace_tpu/ops/join.py:142",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "cases": cases + len(labels),
        "timing": "cold: 256 MiB read before each run, median of 30; count pass, "
                  "torch.cumsum and emit pass, on the indexed join's recorded inputs",
        "pairs": t["pairs"],
        "bytes": t["bytes"],
        "count_ms": t["count_ms"],
        "emit_ms": t["emit_ms"],
        "warm_ms": t["warm_ms"],
        "call_ms": t["call_ms"],
        "searchsorted_yardstick_ms": yard_ms,
        "unindexed": {k: u[k] for k in ("n", "m", "pairs", "ms", "count_ms", "emit_ms",
                                        "warm_ms", "call_ms", "plain_ms", "bound_ms",
                                        "bound_by", "bytes")},
    }


def gen_lineitem(out_dir: str) -> str:
    """The bench.py lineitem shape at SF1 scale, 8 Parquet files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED)
    l_orderkey = rng.integers(0, N_ORDERS, N_ROWS, dtype=np.int64)
    l_shipdate = np.datetime64("1994-01-01") + rng.integers(
        0, 2400, N_ROWS
    ).astype("timedelta64[D]")
    l_quantity = rng.integers(1, 51, N_ROWS, dtype=np.int64)
    l_extendedprice = rng.normal(30000, 8000, N_ROWS)
    order = np.argsort(l_shipdate, kind="stable")
    items = pa.table(
        {
            "l_orderkey": l_orderkey[order],
            "l_shipdate": pa.array(l_shipdate[order].astype("datetime64[D]")),
            "l_quantity": l_quantity[order],
            "l_extendedprice": l_extendedprice[order],
        }
    )
    src = os.path.join(out_dir, "lineitem")
    os.makedirs(src)
    for i in range(N_FILES):
        lo, hi = i * N_ROWS // N_FILES, (i + 1) * N_ROWS // N_FILES
        pq.write_table(items.slice(lo, hi - lo), os.path.join(src, f"part{i}.parquet"))
    return src


def filter_path(work: str, device) -> dict:
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import ops

    t0 = time.perf_counter()
    src = gen_lineitem(work)
    log(f"main path: generated {N_ROWS} rows in {N_FILES} files in "
        f"{time.perf_counter() - t0:.2f}s")

    sess = HyperspaceSession(device=device)
    sess.conf.set("hyperspace.system.path", os.path.join(work, "indexes"))
    hs = Hyperspace(sess)
    df = sess.read.parquet(src)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hs.create_index(
        df, CoveringIndexConfig("li_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"])
    )
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()["murmur3_bucket_ids"]
    entry = hs.get_index("li_idx")
    files = entry.content.files
    rows = sum(pq.ParquetFile(f).metadata.num_rows for f in files)
    log(
        f"main path: build {build_s:.3f}s, {N_ROWS / build_s:,.0f} rows/s, "
        f"{len(files)} bucket files, {rows} rows, stages "
        f"{ {k: round(v, 4) for k, v in sess.build_stats.items()} }, "
        f"B1 launches {build_launches}"
    )
    if rows != N_ROWS or len(files) != 200 or build_launches <= 0:
        raise AssertionError("build did not index every row through B1")

    rng = np.random.default_rng(SEED + 1)
    point_keys = [int(k) for k in rng.integers(0, N_ORDERS, 32)]
    in_lists = [[int(k) for k in rng.integers(0, N_ORDERS, 8)] for _ in range(4)]
    queries = [df["l_orderkey"] == k for k in point_keys] + [
        df["l_orderkey"].isin(keys) for keys in in_lists
    ]

    def plan(cond):
        return df.filter(cond).select("l_orderkey", "l_shipdate", "l_quantity")

    sess.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    sess.enable_hyperspace()
    for cond in queries:
        text = hs.explain(plan(cond))
        used = text.split("Indexes used:")[1]
        if "Name: li_idx" not in text or "li_idx" not in used:
            raise AssertionError(f"index not used for {cond!r}:\n{text}")
    plan(queries[0]).collect()  # first query pays one-time set-up
    sess.exec_stats.reset()
    served, times = [], []
    for cond in queries:
        t0 = time.perf_counter()
        served.append(plan(cond).collect())
        times.append((time.perf_counter() - t0) * 1e3)
    total_launches = ops.launch_counts()["murmur3_bucket_ids"]
    query_launches = total_launches - build_launches
    stats = sess.exec_stats.as_dict()
    p50, p99 = np.percentile(times, [50, 99])
    n_point = len(point_keys)
    log(
        f"main path: {len(queries)} index-served queries p50_ms {p50:.3f} "
        f"p99_ms {p99:.3f} (point p50_ms {np.median(times[:n_point]):.3f}, "
        f"IN-list p50_ms {np.median(times[n_point:]):.3f}); "
        f"B1 launches {query_launches}; device filter "
        f"masks {stats['device_filter_evals']}; host Unsupported masks "
        f"{stats['host_filter_evals']}; bucket-pruned scans "
        f"{stats['bucket_pruned_scans']}"
    )
    if query_launches <= 0 or stats["host_filter_evals"] != 0:
        raise AssertionError("queries did not run through B1 and the device mask")
    if stats["bucket_pruned_scans"] != len(queries):
        raise AssertionError("not every query was bucket-pruned")

    # A point filter reads one bucket, whose rows keep source order among
    # equal keys, so it must match the unindexed plan row for row. An IN
    # list spans buckets and comes out bucket by bucket, so it must match
    # as a multiset (both sides sorted by every column).
    sess.disable_hyperspace()
    base_times, n_rows = [], 0
    for i, (cond, got) in enumerate(zip(queries, served)):
        t0 = time.perf_counter()
        want = plan(cond).collect()
        base_times.append((time.perf_counter() - t0) * 1e3)
        if i >= len(point_keys):
            keys = [(c, "ascending") for c in want.column_names]
            got, want = got.sort_by(keys), want.sort_by(keys)
        if not got.equals(want):
            raise AssertionError(f"index-served rows differ for {cond!r}")
        n_rows += got.num_rows
    if n_rows == 0:
        raise AssertionError("no query matched a row")
    log(
        f"main path: all {len(queries)} queries equal the unindexed plan "
        f"({n_rows} rows); unindexed p50_ms "
        f"{np.percentile(base_times, 50):.3f}"
    )
    return {"launches": total_launches, "session": sess, "hs": hs, "items": df}


def gen_orders(out_dir: str) -> str:
    """The bench.py orders shape at SF1 scale, 8 Parquet files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED + 4)
    orders = pa.table(
        {
            "o_orderkey": np.arange(N_ORDERS, dtype=np.int64),
            "o_custkey": rng.integers(0, N_ORDERS // 10, N_ORDERS),
            "o_totalprice": rng.normal(150000, 30000, N_ORDERS),
        }
    )
    src = os.path.join(out_dir, "orders")
    os.makedirs(src)
    for i in range(N_FILES):
        lo, hi = i * N_ORDERS // N_FILES, (i + 1) * N_ORDERS // N_FILES
        pq.write_table(orders.slice(lo, hi - lo), os.path.join(src, f"part{i}.parquet"))
    return src


def gen_null_keyed(out_dir: str, name: str, cols, seed: int, n: int = 200_000) -> str:
    """Two int64 key columns (about 1 % nulls in each) and a value."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    k1, k2, v = cols
    table = pa.table(
        {
            k1: pa.array(rng.integers(0, 20_000, n), mask=rng.random(n) < 0.01),
            k2: pa.array(rng.integers(0, 5, n), mask=rng.random(n) < 0.01),
            v: rng.integers(0, 1000, n),
        }
    )
    src = os.path.join(out_dir, name)
    os.makedirs(src)
    for i in range(2):
        pq.write_table(table.slice(i * n // 2, n // 2), os.path.join(src, f"p{i}.parquet"))
    return src


def sorted_rows(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


def index_served(hs, df, names) -> None:
    text = hs.explain(df)
    with_plan = text.split("Plan without indexes:")[0]
    if with_plan.count("Hyperspace(Type: CI") != 2 or not all(
        f"Name: {n}," in with_plan for n in names
    ):
        raise AssertionError(f"join not index-served on both sides:\n{text}")


def join_path(work: str, ctx: dict, b4_inputs: B4Inputs) -> dict:
    """Phase 5: orders ⋈ lineitem served from both indexes, then a two-key
    join with null keys; launch counts read from 0 at its start. Each
    plan's first B4 inputs are kept in ``b4_inputs`` under its label."""
    from hyperspace_tpu_torch import CoveringIndexConfig
    from hyperspace_tpu_torch import ops

    sess, hs, items = ctx["session"], ctx["hs"], ctx["items"]
    src = gen_orders(work)
    ops.reset_launch_counts()
    orders = sess.read.parquet(src)
    t0 = time.perf_counter()
    hs.create_index(
        orders, CoveringIndexConfig("o_idx", ["o_orderkey"], ["o_custkey", "o_totalprice"])
    )
    log(f"join path: built o_idx over {N_ORDERS} rows in {time.perf_counter() - t0:.3f}s, "
        f"B1 launches {ops.launch_counts()['murmur3_bucket_ids']}")

    def q():
        return orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
            "o_orderkey", "o_custkey", "l_quantity")

    sess.enable_hyperspace()
    index_served(hs, q(), ("o_idx", "li_idx"))
    sess.exec_stats.reset()
    b4_before = ops.launch_counts()["bucket_match_pairs"]
    b4_inputs.label = "indexed"
    q().collect()  # warm-up
    times, stages = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        got = q().collect()
        times.append((time.perf_counter() - t0) * 1e3)
        stages.append(dict(sess.join_stats))
    b4_indexed = ops.launch_counts()["bucket_match_pairs"] - b4_before
    stats = sess.exec_stats.as_dict()
    if b4_indexed <= 0 or stats["co_bucketed_joins"] != 6 or stats["unbucketed_joins"]:
        raise AssertionError(f"indexed join did not run co-bucketed through B4: "
                             f"{stats}, B4 launches {b4_indexed}")
    if got.num_rows != N_ROWS:
        raise AssertionError(f"join gave {got.num_rows} rows, want {N_ROWS}")
    p50, p99 = np.percentile(times, [50, 99])
    stage_p50 = {k: float(np.median([st.get(k, 0.0) for st in stages])) for k in stages[0]}
    log(f"join path: orders ⋈ lineitem index-served x5: p50_ms {p50:.3f} p99_ms "
        f"{p99:.3f}, {got.num_rows} rows, stage p50 s "
        f"{ {k: round(v, 4) for k, v in stage_p50.items()} }, B4 launches {b4_indexed} "
        f"({b4_indexed // 6} per join), co-bucketed joins {stats['co_bucketed_joins']}")

    sess.disable_hyperspace()
    b4_inputs.label = "unindexed"
    base_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        want = q().collect()
        base_times.append((time.perf_counter() - t0) * 1e3)
    base_stages = dict(sess.join_stats)
    stats = sess.exec_stats.as_dict()
    if stats["unbucketed_joins"] != 2:
        raise AssertionError(f"unindexed plan did not run unbucketed: {stats}")
    if not sorted_rows(got).equals(sorted_rows(want)):
        raise AssertionError("index-served join rows differ from the unindexed plan")
    log(f"join path: rows equal to the unindexed plan as a multiset; unindexed ms "
        f"{', '.join(f'{t:.3f}' for t in base_times)}, stages s "
        f"{ {k: round(v, 4) for k, v in base_stages.items()} }")

    a_src = gen_null_keyed(work, "nk_a", ("k1", "k2", "va"), SEED + 5)
    b_src = gen_null_keyed(work, "nk_b", ("j1", "j2", "vb"), SEED + 6)
    a, b = sess.read.parquet(a_src), sess.read.parquet(b_src)
    hs.create_index(a, CoveringIndexConfig("nk_a_idx", ["k1", "k2"], ["va"]))
    hs.create_index(b, CoveringIndexConfig("nk_b_idx", ["j1", "j2"], ["vb"]))

    def q2():
        return a.join(b, on=(a["k1"] == b["j1"]) & (a["k2"] == b["j2"])).select(
            "k1", "k2", "va", "vb")

    sess.enable_hyperspace()
    index_served(hs, q2(), ("nk_a_idx", "nk_b_idx"))
    sess.exec_stats.reset()
    b4_inputs.label = "two-key indexed"
    got2 = q2().collect()
    if sess.exec_stats.co_bucketed_joins != 1:
        raise AssertionError("two-key join did not run co-bucketed")
    sess.disable_hyperspace()
    b4_inputs.label = "two-key unindexed"
    want2 = q2().collect()
    b4_inputs.label = None
    if got2.num_rows == 0 or got2.column("k1").null_count or got2.column("k2").null_count:
        raise AssertionError("two-key join gave no rows or matched a null key")
    if not sorted_rows(got2).equals(sorted_rows(want2)):
        raise AssertionError("two-key null join differs from the unindexed plan")
    launches = ops.launch_counts()
    log(f"join path: two-key join with null keys, {got2.num_rows} rows, equal to the "
        f"unindexed plan; phase launches {launches}")
    return {"launches": launches, "p50_ms": p50, "p99_ms": p99}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--baseline-src",
        help="an earlier csrc/murmur3_bucket.cu (the seven-argument C interface) "
        "to build, hold against the plain version and time in turns with the "
        "current kernel: baseline, current, current, baseline",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import kernels

    card = card_line()
    log(f"card: {card}")
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}"
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}"
    )

    t0 = time.perf_counter()
    pending = build_baseline(args.baseline_src) if args.baseline_src else None
    out_dir = kernels.build_all()
    log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.2f}s -> {out_dir}")
    for name in os.listdir(out_dir):
        if name.endswith(".log"):
            with open(os.path.join(out_dir, name)) as fh:
                log(f"build: {name}: {fh.read().strip()}")
    baseline = load_baseline(*pending) if pending else None

    dev = torch.device("cuda")
    b1 = check_kernels(dev, baseline)
    b4_cases_run, b4_case_err = check_b4_cases(dev)

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    b4_inputs = B4Inputs()
    try:
        # the default session device is cuda; the paths run it as a user would
        ctx = filter_path(work, None)
        b1["launches"] = ctx["launches"]
        b4_launches = join_path(work, ctx, b4_inputs)["launches"]["bucket_match_pairs"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    b4 = check_b4_main_path(dev, b4_inputs.calls, b4_cases_run, b4_case_err)
    b4["launches"] = b4_launches

    print(card, flush=True)
    print(json.dumps({"kernels": [b1, b4]}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
