"""Per-bucket merge-join match for co-bucketed index scans (kernel B4).

Counterpart of ``hyperspace_tpu/ops/join.py``: the payoff of the
JoinIndexRule (reference ``covering/JoinIndexRule.scala:619-634``). Both
sides are bucketed by the join keys, so the join runs per bucket pair
with no shuffle. The reference pads every bucket to the widest, runs one
vmapped XLA program (``_bucket_join``: argsort, searchsorted ranges) and
expands the ranges into row pairs on the host (``expand_match_ranges``).
Here the buckets are ragged segments of one flat array per side, and the
whole match — ranges and pair expansion — is kernel B4
(``csrc/bucket_match.cu``), written by hand for Hopper.

* :func:`combine_reps` folds a composite key into one int64 (host numpy,
  as in the reference: O(k·n) bit arithmetic that needs uint64, which
  PyTorch on the CPU lacks).
* :func:`segment_sort` sorts each segment's keys stably on the tensor's
  device (``ops/sort.sort_permutation``), for sides whose buckets are not
  key-sorted already.
* :func:`match_pairs` is the entry point: a CPU tensor takes the plain
  version :func:`match_pairs_torch`, a CUDA tensor launches B4 (count
  pass, ``torch.cumsum`` to size the output, emit pass) and counts each
  launch in :data:`launches`. It raises on what it cannot take; there is
  no fallback.

Pair order: segment ascending, then left position, then right sorted
position — the reference's order on every one of its routes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.ops.sort import sort_permutation

#: kernel launches made by :func:`match_pairs` on CUDA tensors (count
#: and emit passes each count one; never the plain version)
launches = 0


def combine_reps(reps: np.ndarray) -> np.ndarray:
    """[k, n] int64 -> [n] int64: splitmix64 mix of the composite key
    (identity copy for k == 1, where reps are already exact). Equal keys
    give equal combined values; different keys may collide, so a caller
    with k > 1 re-verifies the key columns at the matched pairs."""
    if reps.shape[0] == 1:
        return reps[0].copy()
    with np.errstate(over="ignore"):
        h = np.zeros(reps.shape[1], dtype=np.uint64)
        m1 = np.uint64(0xBF58476D1CE4E5B9)
        m2 = np.uint64(0x94D049BB133111EB)
        gold = np.uint64(0x9E3779B97F4A7C15)
        for i in range(reps.shape[0]):
            x = h ^ (reps[i].view(np.uint64) + gold)
            x = x * m1
            x ^= x >> np.uint64(27)
            x = x * m2
            x ^= x >> np.uint64(31)
            h = x
    return h.view(np.int64)


def segment_sort(
    keys: torch.Tensor, offs: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable per-segment ascending sort of ``keys`` [n] int64, segments
    given by host offsets ``offs`` [B + 1]: returns (sorted keys, perm),
    where perm maps each sorted position to its original position.
    Within segment b it equals ``offs[b] + np.argsort(keys[offs[b]:
    offs[b + 1]], kind="stable")``: stable by key within stable by
    segment, with rows already grouped by segment."""
    offs = _host_offsets(offs, keys.shape[0], "offs")
    sizes = torch.from_numpy(np.diff(offs)).to(keys.device)
    seg = torch.repeat_interleave(
        torch.arange(len(offs) - 1, device=keys.device),
        sizes,
        output_size=keys.shape[0],
    )
    perm = sort_permutation(keys[None], seg)
    return keys[perm], perm


def _host_offsets(offs, length: int, name: str) -> np.ndarray:
    """Segment offsets as a host int64 array, checked: [B + 1] with
    B >= 1, 0 first, ``length`` last, non-decreasing."""
    if isinstance(offs, torch.Tensor):
        offs = offs.cpu().numpy()
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    if offs.ndim != 1 or len(offs) < 2:
        raise ValueError(f"{name} must be [B + 1] with B >= 1, got {offs.shape}")
    if offs[0] != 0 or offs[-1] != length or np.any(np.diff(offs) < 0):
        raise ValueError(
            f"{name} must rise from 0 to {length}, got {offs[0]}..{offs[-1]}"
        )
    return offs


def _check(l_keys, l_offs, r_sorted, r_offs, l_row, r_row):
    """Validate the inputs of :func:`match_pairs`; returns the host
    offsets of both sides."""
    for name, t in (("l_keys", l_keys), ("r_sorted", r_sorted)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(
                f"{name} must be [n] int64, got {tuple(t.shape)} {t.dtype}"
            )
    if r_sorted.device != l_keys.device:
        raise ValueError(f"r_sorted on {r_sorted.device}, l_keys on {l_keys.device}")
    for name, row, length in (
        ("l_row", l_row, l_keys.shape[0]),
        ("r_row", r_row, r_sorted.shape[0]),
    ):
        if row is None:
            continue
        if (
            not isinstance(row, torch.Tensor)
            or row.dtype != torch.int64
            or row.shape != (length,)
            or row.device != l_keys.device
        ):
            raise ValueError(f"{name} must be [{length}] int64 on {l_keys.device}")
    lo = _host_offsets(l_offs, l_keys.shape[0], "l_offs")
    ro = _host_offsets(r_offs, r_sorted.shape[0], "r_offs")
    if len(lo) != len(ro):
        raise ValueError(f"{len(lo) - 1} left segments but {len(ro) - 1} right")
    return lo, ro


def _empty_pairs(device) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros(0, dtype=torch.int64, device=device)
    return z, z.clone()


def match_pairs_torch(
    l_keys: torch.Tensor,
    l_offs,
    r_sorted: torch.Tensor,
    r_offs,
    l_row: Optional[torch.Tensor] = None,
    r_row: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B4, on the tensors' own device: per
    segment, ``torch.searchsorted`` left and right bounds of each left key
    in the segment's sorted right slice, then ``repeat_interleave`` to
    expand the ranges into (li, ri) pairs mapped through ``l_row`` /
    ``r_row`` (None = identity)."""
    lo_np, ro_np = _check(l_keys, l_offs, r_sorted, r_offs, l_row, r_row)
    dev = l_keys.device
    li_parts, ri_parts = [], []
    for b in range(len(lo_np) - 1):
        l0, l1 = int(lo_np[b]), int(lo_np[b + 1])
        r0, r1 = int(ro_np[b]), int(ro_np[b + 1])
        if l0 == l1 or r0 == r1:
            continue
        ls, rs = l_keys[l0:l1], r_sorted[r0:r1]
        lo = torch.searchsorted(rs, ls, right=False)
        cnt = torch.searchsorted(rs, ls, right=True) - lo
        total = int(cnt.sum())
        if total == 0:
            continue
        li_parts.append(
            torch.repeat_interleave(torch.arange(l0, l1, device=dev), cnt)
        )
        starts = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(total, device=dev) - torch.repeat_interleave(
            starts, cnt
        )
        ri_parts.append(torch.repeat_interleave(lo + r0, cnt) + within)
    if not li_parts:
        return _empty_pairs(dev)
    li, ri = torch.cat(li_parts), torch.cat(ri_parts)
    if l_row is not None:
        li = l_row[li]
    if r_row is not None:
        ri = r_row[ri]
    return li, ri


@functools.cache
def _kernel_fns():
    from hyperspace_tpu_torch import kernels

    lib = kernels.load("bucket_match")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    count = lib.hs_bucket_match_count
    # l_keys, n, l_offs, r_offs, num_segments, r_sorted, lo, cnt, stream
    count.argtypes = [p, i64, p, p, i64, p, p, p, p]
    count.restype = ctypes.c_int
    emit = lib.hs_bucket_match_emit
    # lo, cnt, incl, n, l_row, r_row, li, ri, stream
    emit.argtypes = [p, p, p, i64, p, p, p, p, p]
    emit.restype = ctypes.c_int
    return count, emit


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"bucket match {what} launch failed: CUDA error {err}")


def _count_pass(
    l_keys: torch.Tensor,
    l_offs: torch.Tensor,
    r_sorted: torch.Tensor,
    r_offs: torch.Tensor,
    stream: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B4's count pass on ``stream``: per left position the
    absolute lower bound ``lo`` and the match count ``cnt`` ([n] int64
    each). ``l_offs`` / ``r_offs`` are the checked offsets on the device;
    every tensor is contiguous."""
    global launches
    n = l_keys.shape[0]
    lo = torch.empty(n, dtype=torch.int64, device=l_keys.device)
    cnt = torch.empty(n, dtype=torch.int64, device=l_keys.device)
    err = _kernel_fns()[0](
        l_keys.data_ptr(), n, l_offs.data_ptr(), r_offs.data_ptr(),
        l_offs.shape[0] - 1, r_sorted.data_ptr(), lo.data_ptr(),
        cnt.data_ptr(), stream,
    )
    _raise_on(err, "count")
    if n:  # the C side launches nothing for n = 0
        launches += 1
    return lo, cnt


def _emit_pass(
    lo: torch.Tensor,
    cnt: torch.Tensor,
    incl: torch.Tensor,
    l_row: Optional[torch.Tensor],
    r_row: Optional[torch.Tensor],
    li: torch.Tensor,
    ri: torch.Tensor,
    stream: int,
) -> None:
    """Launch B4's emit pass on ``stream``: write the pairs into ``li`` /
    ``ri`` ([incl[-1]] int64) at each position's exclusive offset."""
    global launches
    n = lo.shape[0]
    err = _kernel_fns()[1](
        lo.data_ptr(), cnt.data_ptr(), incl.data_ptr(), n, _ptr(l_row),
        _ptr(r_row), li.data_ptr(), ri.data_ptr(), stream,
    )
    _raise_on(err, "emit")
    if n:
        launches += 1


def _contiguous(name: str, t: Optional[torch.Tensor]) -> None:
    if t is not None and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def match_pairs_kernel(
    l_keys: torch.Tensor,
    l_offs,
    r_sorted: torch.Tensor,
    r_offs,
    l_row: Optional[torch.Tensor] = None,
    r_row: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 on the card: count pass, inclusive ``torch.cumsum`` of the
    counts, one read of the total to allocate the pairs, emit pass. With
    n = 0 or m = 0 nothing launches."""
    lo_np, ro_np = _check(l_keys, l_offs, r_sorted, r_offs, l_row, r_row)
    dev = l_keys.device
    if dev.type != "cuda":
        raise ValueError(f"match_pairs_kernel needs CUDA tensors, got {dev}")
    for name, t in (("l_keys", l_keys), ("r_sorted", r_sorted),
                    ("l_row", l_row), ("r_row", r_row)):
        _contiguous(name, t)
    if l_keys.shape[0] == 0 or r_sorted.shape[0] == 0:
        return _empty_pairs(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        l_offs_t = torch.from_numpy(lo_np).to(dev)
        r_offs_t = torch.from_numpy(ro_np).to(dev)
        lo, cnt = _count_pass(l_keys, l_offs_t, r_sorted, r_offs_t, stream)
        incl = torch.cumsum(cnt, 0)
        total = int(incl[-1])
        li = torch.empty(total, dtype=torch.int64, device=dev)
        ri = torch.empty(total, dtype=torch.int64, device=dev)
        if total:
            _emit_pass(lo, cnt, incl, l_row, r_row, li, ri, stream)
    return li, ri


def match_pairs(
    l_keys: torch.Tensor,
    l_offs,
    r_sorted: torch.Tensor,
    r_offs,
    l_row: Optional[torch.Tensor] = None,
    r_row: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All (li, ri) pairs with ``l_keys[i] == r_sorted[j]`` inside the
    same segment, mapped through ``l_row`` / ``r_row`` (None = identity).

    ``l_keys`` [n] int64 holds the left keys in emission order, segment b
    at ``l_offs[b]:l_offs[b + 1]``; ``r_sorted`` [m] int64 holds each
    right segment ascending at ``r_offs[b]:r_offs[b + 1]``; the offsets
    are host int64 arrays of B + 1 entries. A CPU tensor takes the plain
    version, a CUDA tensor launches B4."""
    if l_keys.device.type == "cpu":
        return match_pairs_torch(l_keys, l_offs, r_sorted, r_offs, l_row, r_row)
    if l_keys.device.type == "cuda":
        return match_pairs_kernel(l_keys, l_offs, r_sorted, r_offs, l_row, r_row)
    raise ValueError(f"match_pairs: unsupported device {l_keys.device}")
