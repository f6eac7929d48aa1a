"""Times kernels B8a and B8b (the bucket exchange's pack and order,
``csrc/bucket_exchange.cu``) of commit 6d68b07, their first design (hist,
a one-thread-a-digit scan over tiles, starts, rank into an int64
position a row, one scatter a column, ``torch.zeros`` outputs), against
the package's own on the card, in turns.

    python3 scripts/torch_b8_turns.py --extract   # where git is: writes 6d68b07's source
    python3 scripts/torch_b8_turns.py             # on the card

``--extract`` writes 6d68b07's ``bucket_exchange.cu`` (``git show
6d68b07:hyperspace_tpu_torch/csrc/bucket_exchange.cu``) under
``build/b8_turns/base/``, an ignored directory beside the checkout. Run
without it, on the card, the script builds it with nvcc beside the
package's own sources and prints each kernel's registers, shared memory
and spills (``-Xptxas -v``) once. The base's wrapper steps are copied
here from 6d68b07's ``ops/exchange.py`` (``base_pack``, ``base_order``:
the ``torch.zeros`` outputs, the scratch, the one read of the error
word), so the base's timed call is the one ``chip_smoke.py`` timed for
PR 20.

Inputs, built as the flat strategy builds them (``parallel/shuffle.py``:
rows padded to a power of two, then split into D = 4 shard slices, pad
rows invalid; bucket ids uniform, four 8-byte payload columns): phase
18's pack shard (shard 0 of 6,001,215 rows: 2,097,152 rows, 6 columns,
cap 1,048,576) and the order of shard 0's 4,194,304 received slots (5
columns, 201 digits); the same for one wave of phase 16's budgeted build
(two source files, 1,500,304 rows); and the order at 50,000 buckets
(B8b's two-digit route).

First, a call of each design on phase 18's pack and order under
torch.profiler, after the L2 flush: every device operation of the call
in order (kernels, fills, the read-back copy) with its median
milliseconds over 10 calls, and their sum. Then, in each shape,
each design's outputs held bit-equal to the plain version, and the call
timed cold (``chip_smoke.time_cold``: 256 MiB read before each run,
median of 30) in turns: base, current, current, base; each call with its
read of the error word, as ``chip_smoke.py`` times it, then the
launches alone (CUDA events around them, no read-back), and
``torch.sort(stable)`` of the same keys, and, as the card's practical rate
on the same bytes, a device copy (``Tensor.copy_``) that reads half the
bound's bytes and writes the other half. Prints the card's name and power
limit first. Needs one CUDA device and the repository checkout.
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

PARENT = "6d68b07"
TURNS_DIR = os.path.join(ROOT, "build", "b8_turns")
OLD_DIR = os.path.join(TURNS_DIR, "base")
SOURCE = "bucket_exchange.cu"
PAYLOADS = 4  # the 8-byte payload columns of phase 18's li_idx builds


def extract() -> None:
    os.makedirs(OLD_DIR, exist_ok=True)
    text = subprocess.run(
        ["git", "show", f"{PARENT}:hyperspace_tpu_torch/csrc/{SOURCE}"], cwd=ROOT,
        capture_output=True, text=True, check=True).stdout
    with open(os.path.join(OLD_DIR, SOURCE), "w", encoding="utf-8") as fh:
        fh.write(text)
    print(f"wrote {SOURCE} of {PARENT} to {OLD_DIR}")


def build() -> ctypes.CDLL:
    """nvcc on the base's source beside the package's own build; prints
    every kernel's registers, shared memory and spills; returns the
    base's library."""
    from hyperspace_tpu_torch import kernels

    src = os.path.join(OLD_DIR, SOURCE)
    if not os.path.exists(src):
        raise SystemExit(f"{src} missing: run with --extract where git is")
    lib = os.path.join(TURNS_DIR, "libbase.so")
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cur_dir = kernels.build_all()
    logs = {"base": proc.communicate()[0]}
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the base:\n{logs['base']}")
    with open(os.path.join(cur_dir, "libbucket_exchange.log")) as fh:
        logs["current"] = fh.read()
    for name, text in logs.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"([a-z]+_kernel|tile_hist|tile_scan|rank_move)(ILi\d)?", m.group(1))
                entry = k.group(0) if k else m.group(1)
            elif entry and ("registers" in line or "spill" in line):
                print(f"build {name}: {entry}: {line.split(':', 1)[-1].strip()}", flush=True)
    base = ctypes.CDLL(lib)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    pp, ip = ctypes.POINTER(p), ctypes.POINTER(i32)
    base.hs_exchange_tile_rows.argtypes = []
    base.hs_exchange_tile_rows.restype = i64
    base.hs_exchange_pack.argtypes = [p, p, i64, i32, i64, p, p, p, p, i32, pp, pp, ip, p]
    base.hs_exchange_pack.restype = i32
    base.hs_exchange_order.argtypes = [p, p, i64, i32, p, p, p, p, p, i32, pp, pp, ip, p]
    base.hs_exchange_order.restype = i32
    return base


# --- 6d68b07's wrapper steps (ops/exchange.py), the launch apart ---------


def _base_scratch(lib, n: int, digits: int, dev) -> dict:
    import torch

    tiles = -(-n // lib.hs_exchange_tile_rows())
    return {
        "hist": torch.empty(tiles * digits, dtype=torch.int32, device=dev),
        "totals": torch.empty(digits, dtype=torch.int64, device=dev),
        "pos": torch.empty(n, dtype=torch.int64, device=dev),
        "err": torch.zeros(1, dtype=torch.int32, device=dev),
    }


def _base_flag(err) -> None:
    if int(err.item()):
        raise ValueError(f"base: error word {int(err.item())}")


def base_pack(lib, bucket, valid, D, cap, cols, check=True):
    import torch

    from hyperspace_tpu_torch.ops import exchange as X

    n, dev = bucket.shape[0], bucket.device
    out = [torch.zeros((D, cap), dtype=c.dtype, device=dev) for c in cols]
    s = _base_scratch(lib, n, D + 1, dev)
    code = lib.hs_exchange_pack(
        bucket.data_ptr(), valid.data_ptr(), n, D, cap, s["hist"].data_ptr(),
        s["totals"].data_ptr(), s["pos"].data_ptr(), s["err"].data_ptr(),
        *X._column_args(cols, out), torch.cuda.current_stream(dev).cuda_stream)
    if code:
        raise RuntimeError(f"base pack: CUDA error {code}")
    if check:
        _base_flag(s["err"])
    return s["totals"][:D], out


def base_order(lib, bucket, valid, num_buckets, cols, check=True):
    import torch

    from hyperspace_tpu_torch.ops import exchange as X

    n, dev = bucket.shape[0], bucket.device
    out = [torch.empty_like(c) for c in cols]
    s = _base_scratch(lib, n, num_buckets + 1, dev)
    starts = torch.empty(num_buckets + 2, dtype=torch.int64, device=dev)
    code = lib.hs_exchange_order(
        bucket.data_ptr(), valid.data_ptr(), n, num_buckets, s["hist"].data_ptr(),
        s["totals"].data_ptr(), starts.data_ptr(), s["pos"].data_ptr(), s["err"].data_ptr(),
        *X._column_args(cols, out), torch.cuda.current_stream(dev).cuda_stream)
    if code:
        raise RuntimeError(f"base order: CUDA error {code}")
    if check:
        _base_flag(s["err"])
    return out, starts[num_buckets : num_buckets + 1]


# --- inputs ---------------------------------------------------------------


def flat_inputs(total_rows: int, num_buckets: int, D: int, seed: int, dev):
    """Shard 0's pack arguments and its order arguments, as the flat
    strategy makes them over ``total_rows`` rows (every shard packed with
    the package's kernel, the [D, cap] blocks exchanged by concatenation,
    ``parallel/shuffle._exchange_blocks``)."""
    import torch

    from hyperspace_tpu_torch.ops import exchange as X
    from hyperspace_tpu_torch.parallel.shuffle import pad_len

    target = pad_len(total_rows)
    target += (-target) % D
    n_local = target // D
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, num_buckets, (target,), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.arange(target, device=dev) < total_rows
    pay = [torch.randint(-(2**62), 2**62, (target,), dtype=torch.int64, device=dev,
                         generator=gen) for _ in range(PAYLOADS)]
    shards = []
    for s in range(D):
        sl = slice(s * n_local, (s + 1) * n_local)
        shards.append((ids[sl], valid[sl], [p[sl] for p in pay]))
    dest = torch.where(valid, ids.long() % D, D).view(D, n_local)
    counts = torch.stack([torch.bincount(dest[s], minlength=D + 1)[:D] for s in range(D)])
    cap = min(pad_len(max(int(counts.max()), 1)), n_local)
    packed = [X.pack_kernel(i, v, D, cap, [i, v, *p])[1] for i, v, p in shards]
    recv = [torch.cat([packed[s][c][0] for s in range(D)]) for c in range(len(packed[0]))]
    i0, v0, p0 = shards[0]
    pack_args = (i0, v0, D, cap, [i0, v0, *p0])
    order_args = (recv[0], recv[1], num_buckets, [recv[0], *recv[2:]])
    return pack_args, order_args


# --- timing ---------------------------------------------------------------


def device_split(fn, flush, iters: int = 10) -> list:
    """Every device operation of one ``fn()`` call after the L2 flush, from
    torch.profiler: [(name, median ms)] in launch order, then ("sum", the
    sum of those). The device idles between operations while the host
    launches under the profiler, so no span from first start to last end
    is kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(iters):
        flush.sum()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        runs.append([(short_name(e.name), e.time_range.start, e.time_range.end) for e in evs])
    if not runs[0]:
        return []
    out = [(name, float(np.median([r[j][2] - r[j][1] for r in runs])) / 1e3)
           for j, (name, _, _) in enumerate(runs[0])]
    out.append(("sum", sum(ms for _, ms in out)))
    return out


def short_name(name: str) -> str:
    for key in ("hist_kernel", "scan_kernel", "starts_kernel", "rank_kernel", "tile_hist",
                "tile_scan", "rank_move"):
        if key in name:
            return key
    m = re.search(r"scatter_kernel<(\w+)>", name)
    if m:
        return f"scatter<{m.group(1)}>"
    m = re.search(r"scatter_kernel<unsigned (\w+)>", name)
    if m:
        return f"scatter<{m.group(1)}>"
    if "FillFunctor" in name or "Memset" in name:
        return "fill (torch.zeros)"
    if "Memcpy DtoH" in name or "DtoH" in name:
        return "read-back"
    return name[:60]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--extract", action="store_true",
                        help=f"write {PARENT}'s source under build/b8_turns/base and stop")
    args = parser.parse_args()
    if args.extract:
        extract()
        return 0
    import torch

    import chip_smoke as CS

    from hyperspace_tpu_torch.ops import exchange as X

    if not torch.cuda.is_available():
        print("torch_b8_turns: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {CS.card_line()}", flush=True)
    base = build()
    dev = torch.device("cuda")
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    D = 4
    p18 = flat_inputs(CS.N_ROWS, 200, D, CS.SEED, dev)
    wave = flat_inputs(2 * CS.FILE_ROWS, 200, D, CS.SEED + 1, dev)
    wide = flat_inputs(CS.N_ROWS, 50_000, D, CS.SEED + 2, dev)
    calls = {
        "b8a": (lambda a, check=True: base_pack(base, *a, check=check),
                lambda a: X.pack_kernel(*a), lambda a: X.pack_launch(*a), X.pack_torch),
        "b8b": (lambda a, check=True: base_order(base, *a, check=check),
                lambda a: X.order_kernel(*a), lambda a: X.order_launch(*a), X.order_torch),
    }
    for kind, a in (("b8a", p18[0]), ("b8b", p18[1])):
        for design, fn in (("base", calls[kind][0]), ("current", calls[kind][1])):
            split = device_split(lambda: fn(a), flush)
            print(f"{kind.upper()} {design} device split at phase 18's shape, cold (torch.profiler, "
                  f"median of 10): " + "; ".join(f"{n} {ms:.4f} ms" for n, ms in split),
                  flush=True)
    shapes = (("phase 18", "b8a", p18[0]), ("phase 18", "b8b", p18[1]),
              ("sh_st wave", "b8a", wave[0]), ("sh_st wave", "b8b", wave[1]),
              ("50,000 buckets", "b8b", wide[1]))
    for label, kind, a in shapes:
        base_fn, cur_fn, launch_fn, plain = calls[kind]
        want = plain(*a)
        for design, fn in (("base", base_fn), ("current", cur_fn)):
            if not CS.b8_same(fn(a), want):
                raise AssertionError(f"{kind} {design} differs from the plain version on {label}")
        times = {"base": [], "current": []}
        for design in ("base", "current", "current", "base"):
            fn = base_fn if design == "base" else cur_fn
            times[design].append(float(np.median(CS.time_cold(lambda: fn(a), flush))))
        launches = {
            "base": float(np.median(CS.time_cold(lambda: base_fn(a, check=False), flush))),
            "current": float(np.median(CS.time_cold(lambda: launch_fn(a), flush))),
        }
        if kind == "b8a":
            keys = torch.where(a[1], a[0].to(torch.int64) % a[2], a[2])
            p = X.plan(a[0].shape[0], a[2] + 1, a[2], a[3])
        else:
            keys = torch.where(a[1], a[0], a[2])
            p = X.plan(a[0].shape[0], a[2] + 1)
        sort_ms = float(np.median(CS.time_cold(lambda: torch.sort(keys, stable=True), flush)))
        bound = CS.b8_bound(kind, a)
        src = torch.empty(bound["bytes"] // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = float(np.median(CS.time_cold(lambda: dst.copy_(src), flush)))
        del src, dst
        mean = {d: float(np.mean(t)) for d, t in times.items()}
        print(f"{kind.upper()} on {label} ({a[0].shape[0]} rows, {len(a[-1])} columns, "
              f"route {p.route}): bound {bound['bound_ms']:.4f} ms ({bound['bytes']} bytes); "
              + "; ".join(f"{d} call cold ms {times[d]} (mean {mean[d]:.4f}, "
                          f"{bound['bound_ms'] / mean[d]:.1%} of bound), launches alone "
                          f"{launches[d]:.4f}" for d in times)
              + f"; base / current {mean['base'] / mean['current']:.2f}x; torch.sort(stable) "
              f"of the keys {sort_ms:.4f} ms; a device copy of the bound's bytes {copy_ms:.4f} "
              f"ms; outputs bit-equal to the plain version",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
