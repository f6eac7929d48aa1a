"""Times versions of kernel B4 (``hyperspace_tpu_torch/csrc/bucket_match.cu``)
against each other on the card, in turns.

    python3 scripts/torch_b4_turns.py [SRC ...]

Each SRC is a version of ``csrc/bucket_match.cu`` with either C interface:
this tree's (count pass, one-block scan of its range totals, emit pass;
the source defines ``hs_bucket_match_ranges``) or the earlier two-pass one
(a count pass writing int64 ``lo`` / ``cnt`` per left row, ``torch.cumsum``
over ``cnt``, an emit pass). The package's own source is built too, as
"current", after the SRCs; all builds start at once, one nvcc each, and
print each kernel's registers and shared memory.

The inputs are ``chip_smoke.b4_timed_inputs``, built on the card: the
indexed and unindexed join's calls replicated by ``chip_smoke.b4_replica``,
the unindexed ones with the left side shuffled, and the "row order" case.
On each, every build is held equal in order to the plain version, then
timed cold (``chip_smoke.time_cold``: 256 MiB read before each run, median
of 30), the count pass alone and the whole device sequence, in turns: the
builds in order, then in reverse. Prints the card's name and power limit
and one line per input and build. Needs one CUDA device and the
repository checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(srcs: list) -> list:
    """nvcc on every source at once; returns [(name, source, library)]."""
    from hyperspace_tpu_torch import kernels

    out_dir = os.path.join(ROOT, "build", "b4_turns_libs")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, src in enumerate(srcs):
        name = os.path.splitext(os.path.basename(src))[0] if i < len(srcs) - 1 else "current"
        lib = os.path.join(out_dir, f"{i}_{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-o", lib, src]
        procs.append((name, src, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for name, src, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(count|emit|scan)_kernel(I[il]E)?", m.group(1))
                entry = k.group(0) if k else m.group(1)
            elif "registers" in line and entry:
                print(f"build {name}: {entry}: {line.split(':', 1)[1].strip()}", flush=True)
        built.append((name, src, lib))
    return built


@contextlib.contextmanager
def bound_to(fns: dict):
    """Routes ``ops.join``'s passes to the library behind ``fns``."""
    from hyperspace_tpu_torch.ops import join as J

    saved = J._kernel_fns
    J._kernel_fns = lambda: fns
    try:
        yield
    finally:
        J._kernel_fns = saved


def current_runner(lib: str, dev, args):
    """(count pass, whole sequence, its pairs) of a build with this tree's
    interface, int32 ``lo`` / ``cnt`` as the wrapper takes them."""
    import torch

    from hyperspace_tpu_torch.ops import join as J

    fns = J.bind(ctypes.CDLL(lib))
    lk, l_offs, rk, r_offs, l_row, r_row = args
    stream = torch.cuda.current_stream().cuda_stream
    lo_t = torch.from_numpy(np.asarray(l_offs, np.int64)).to(dev)
    ro_t = torch.from_numpy(np.asarray(r_offs, np.int64)).to(dev)
    dtype = J.index_dtype(rk.shape[0])
    with bound_to(fns):
        groups = J._range_groups(lk.shape[0], dtype)
        total = int(J._scan_pass(J._count_pass(
            lk, lo_t, rk, ro_t, groups, dtype, stream).range_tot, stream)[-1])
    li = torch.empty(total, dtype=torch.int64, device=dev)
    ri = torch.empty(total, dtype=torch.int64, device=dev)

    def count():
        with bound_to(fns):
            return J._count_pass(lk, lo_t, rk, ro_t, groups, dtype, stream)

    def sequence():
        c = count()
        with bound_to(fns):
            J._scan_pass(c.range_tot, stream)
            J._emit_pass(c, l_row, r_row, li, ri, stream)

    sequence()
    return count, sequence, (li, ri)


def two_pass_runner(lib: str, dev, args):
    """The same for a build with the earlier two-pass interface."""
    import torch

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    so = ctypes.CDLL(lib)
    count_fn, emit_fn = so.hs_bucket_match_count, so.hs_bucket_match_emit
    count_fn.argtypes = [p, i64, p, p, i64, p, p, p, p]
    emit_fn.argtypes = [p, p, p, i64, p, p, p, p, p]
    count_fn.restype = emit_fn.restype = ctypes.c_int
    lk, l_offs, rk, r_offs, l_row, r_row = args
    n, stream = lk.shape[0], torch.cuda.current_stream().cuda_stream
    lo_t = torch.from_numpy(np.asarray(l_offs, np.int64)).to(dev)
    ro_t = torch.from_numpy(np.asarray(r_offs, np.int64)).to(dev)
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    cnt = torch.empty(n, dtype=torch.int64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def count():
        err = count_fn(lk.data_ptr(), n, lo_t.data_ptr(), ro_t.data_ptr(),
                       lo_t.shape[0] - 1, rk.data_ptr(), lo.data_ptr(), cnt.data_ptr(),
                       stream)
        if err:
            raise RuntimeError(f"count pass: CUDA error {err}")

    count()
    total = int(torch.cumsum(cnt, 0)[-1])
    li = torch.empty(total, dtype=torch.int64, device=dev)
    ri = torch.empty(total, dtype=torch.int64, device=dev)

    def sequence():
        count()
        incl = torch.cumsum(cnt, 0)
        err = emit_fn(lo.data_ptr(), cnt.data_ptr(), incl.data_ptr(), n, ptr(l_row),
                      ptr(r_row), li.data_ptr(), ri.data_ptr(), stream)
        if err:
            raise RuntimeError(f"emit pass: CUDA error {err}")

    sequence()
    return count, sequence, (li, ri)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_b4_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from hyperspace_tpu_torch import kernels
    from hyperspace_tpu_torch.ops import join as J

    print(C.card_line(), flush=True)
    srcs = sys.argv[1:] + [os.path.join(kernels.CSRC_DIR, "bucket_match.cu")]
    builds = build(srcs)
    dev = torch.device("cuda")
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)  # 256 MiB
    med = lambda t: float(np.median(t))  # noqa: E731
    for label, args in C.b4_timed_inputs(dev, C.b4_replica(dev)).items():
        lk, l_offs, rk, r_offs, l_row, r_row = args
        want = J.match_pairs_torch(lk, l_offs, rk, r_offs, l_row, r_row)
        runs = []
        for name, src, lib in builds:
            with open(src) as fh:
                runner = (current_runner if "hs_bucket_match_ranges" in fh.read()
                          else two_pass_runner)
            count, sequence, got = runner(lib, dev, args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name}: pairs differ from the plain version "
                                     f"on the {label} inputs")
            runs.append((name, count, sequence))
        times = {name: ([], []) for name, _, _ in runs}
        for i in list(range(len(runs))) + list(reversed(range(len(runs)))):
            name, count, sequence = runs[i]
            times[name][0].append(med(C.time_cold(count, flush)))
            times[name][1].append(med(C.time_cold(sequence, flush)))
        maps = sum(8 * t.shape[0] for t in (l_row, r_row) if t is not None)
        b = C.b4_bound(lk.shape[0], rk.shape[0], want[0].shape[0], len(l_offs) - 1,
                       C.b4_probes(np.asarray(l_offs), np.asarray(r_offs)), maps)
        print(f"{label}: {lk.shape[0]} x {rk.shape[0]} keys, {len(l_offs) - 1} segments, "
              f"{want[0].shape[0]} pairs, bound_ms {b['bound_ms']:.4f}; every build "
              f"equal in order to the plain version", flush=True)
        for name, (cnt_ms, seq_ms) in times.items():
            print(f"  {name}: cold ms, whole sequence "
                  f"{', '.join(f'{t:.4f}' for t in seq_ms)} (mean {np.mean(seq_ms):.4f}, "
                  f"{b['bound_ms'] / np.mean(seq_ms):.1%} of the bound); count pass "
                  f"{', '.join(f'{t:.4f}' for t in cnt_ms)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
