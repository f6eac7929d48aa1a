"""What bounds kernel B4 (``hyperspace_tpu_torch/csrc/bucket_match.cu``) on
the card: times its count and emit passes cold on device tensors shaped
like ``chip_smoke.py``'s indexed join (``chip_smoke.b4_replica``) while
one thing changes at a time.

    python3 scripts/torch_b4_probe.py

* left side thinned to 1/1 ... 1/16 of its rows within every bucket, the
  right side whole: does a pass scale with the left rows or the right?
* the count pass launched over 1, 4, ... of its ranges, each range as
  long as in the full call: one warp's own chain against all warps at
  once (cold, and warm behind a device busy-wait);
* ``torch.Tensor.fill_`` and ``copy_`` of 96, 48 and 24 MiB: the card's
  write rate, the ceiling of the emit pass's 96 MB of pairs.

Prints one line per measurement and the card's name and power limit. It
needs one CUDA device and the repository checkout.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_b4_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from hyperspace_tpu_torch.ops import join as J

    print(C.card_line(), flush=True)
    dev = torch.device("cuda")
    lk, l_offs, rk, r_offs, _, _ = C.b4_replica(dev)["indexed"]
    l_offs = np.asarray(l_offs)
    r_offs_t = torch.from_numpy(np.asarray(r_offs)).to(dev)
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)  # 256 MiB
    stream = torch.cuda.current_stream().cuda_stream
    med = lambda t: float(np.median(t))  # noqa: E731

    def count(keys, offs, groups):
        return J._count_pass(keys, offs, rk, r_offs_t, groups, torch.int32, stream)

    for keep in (1, 2, 4, 8, 16):
        rows = np.arange(0, lk.shape[0], keep)
        keys = lk[torch.from_numpy(rows).to(dev)].contiguous()
        offs = torch.from_numpy(np.searchsorted(rows, l_offs).astype(np.int64)).to(dev)
        groups = J._range_groups(keys.shape[0], torch.int32)
        count_ms = med(C.time_cold(lambda: count(keys, offs, groups), flush))
        counts = count(keys, offs, groups)
        total = int(J._scan_pass(counts.range_tot, stream)[-1])
        li = torch.empty(total, dtype=torch.int64, device=dev)
        ri = torch.empty_like(li)
        emit_ms = med(C.time_cold(
            lambda: J._emit_pass(counts, None, None, li, ri, stream), flush))
        print(f"left rows 1/{keep}: n {keys.shape[0]}, {total} pairs, {groups} groups "
              f"a warp: count pass cold ms {count_ms:.4f}, emit pass cold ms "
              f"{emit_ms:.4f}", flush=True)

    groups = J._range_groups(lk.shape[0], torch.int32)
    full = ((lk.shape[0] + 31) // 32 + groups - 1) // groups
    for ranges in (1, 4, 16, 64, 256, 1024, full):
        n = min(ranges * groups * 32, lk.shape[0])
        keys = lk[:n].contiguous()
        offs = torch.from_numpy(np.minimum(l_offs, n).astype(np.int64)).to(dev)
        cold = med(C.time_cold(lambda: count(keys, offs, groups), flush))
        warm = C.time_cuda(lambda: count(keys, offs, groups))
        print(f"count pass over {ranges} of {full} ranges ({groups} groups each, n {n}): "
              f"cold ms {cold:.4f}, warm ms {warm:.4f}", flush=True)

    for mib in (96, 48, 24):
        x = torch.empty(mib << 17, dtype=torch.int64, device=dev)
        y = torch.empty_like(x)
        fill_ms = med(C.time_cold(lambda: x.fill_(7), flush))
        copy_ms = med(C.time_cold(lambda: y.copy_(x), flush))
        print(f"fill_ {mib} MiB: cold ms {fill_ms:.4f} ({(mib << 20) / fill_ms / 1e9:.3f} "
              f"TB/s); copy_ {mib} MiB: cold ms {copy_ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
