"""Chip smoke test of hyperspace_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-src PATH]

Drives the port's main path once at real scale and holds every kernel
against its plain PyTorch version on the card:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every CUDA kernel under hyperspace_tpu_torch/csrc with nvcc
   for sm_90a;
3. kernels: murmur3 bucket ids (kernel B1) bit-equal to the plain
   version over 136 cases (``b1_cases``: n from 0 to 6,001,215 with
   ragged tails, k in {1, 2, 3, 4}, odd n and views 8 bytes off a 16-byte
   boundary, num_buckets in {1, 200, 2^31 - 1, 2^31}, seeds {42, 7});
   timed with CUDA events on a busy device at 6,001,215 rows: cold (L2
   flushed before each run) for k = 1, 2, 3 beside each byte bound and
   the plain version, warm (back to back) for k = 1, and at a query's
   n = 1 and 8 as latency.
   With ``--baseline-src`` an earlier B1 source is built too, held
   against the plain version and timed cold in turns with the current
   kernel (baseline, current, current, baseline);
4. main path: a lineitem-shaped table of 6,001,215 rows (TPC-H SF1
   lineitem's row count, l_orderkey over SF1's 1,500,000 orders), a
   covering index with the default 200 buckets, then 32 point and 4
   IN-list filters served from the index with bucket pruning, each
   checked against the unindexed plan row for row.

Any failure raises and exits non-zero. The last two lines of standard
output are the kernels' JSON record and ``{"ok": true, "device": ...}``.
It needs one CUDA device and the repository checkout it lives in; the
table is written under build/chip_smoke/ and removed at the end.
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


def main_path(work: str, device) -> dict:
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
    return {"launches": total_launches}


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
    record = check_kernels(dev, baseline)

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        # the default session device is cuda; main_path runs it as a user would
        record["launches"] = main_path(work, None)["launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
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
