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
  pass, a scan of its per-range totals that sizes the output, emit
  pass) and counts each launch in :data:`launches`. It raises on
  what it cannot take; there is no fallback.
* :func:`match_pairs_sharded` is the reference's mesh route
  (``_sharded_join``, ``ops/join.py:174``): the segments padded with
  empty ones to a multiple of the shard count, each shard's contiguous
  block of segments matched by B4 on the shard's device (its launches
  also counted in :data:`shard_launches`), the pairs concatenated in
  segment order.

Pair order: segment ascending, then left position, then right sorted
position — the reference's order on every one of its routes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError
from hyperspace_tpu_torch.ops.sort import sort_permutation

#: kernel launches made by :func:`match_pairs` on CUDA tensors (count
#: pass, scan and emit pass each count one; never the plain version)
launches = 0
#: the part of :data:`launches` made by :func:`match_pairs_sharded`'s
#: shard calls
shard_launches = 0


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

    return bind(kernels.load("bucket_match"))


def bind(lib: ctypes.CDLL) -> dict:
    """The C functions of a library built from ``csrc/bucket_match.cu``,
    with their argument types, by name."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ranges = lib.hs_bucket_match_ranges
    # n, index_bytes, out: groups of 32 left rows per range
    ranges.argtypes = [i64, i32, ctypes.POINTER(i64)]
    ranges.restype = ctypes.c_int
    count = lib.hs_bucket_match_count
    # l_keys, n, l_offs, r_offs, num_segments, r_sorted, range_groups, lo,
    # cnt, group_first, range_tot, index_bytes, stream
    count.argtypes = [p, i64, p, p, i64, p, i64, p, p, p, p, i32, p]
    count.restype = ctypes.c_int
    scan = lib.hs_bucket_match_scan
    # v, len, stream
    scan.argtypes = [p, i64, p]
    scan.restype = ctypes.c_int
    emit = lib.hs_bucket_match_emit
    # lo, cnt, group_first, range_offs, n, range_groups, l_row, r_row, li,
    # ri, index_bytes, stream
    emit.argtypes = [p, p, p, p, i64, i64, p, p, p, p, i32, p]
    emit.restype = ctypes.c_int
    return {"ranges": ranges, "count": count, "scan": scan, "emit": emit}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"bucket match {what} launch failed: CUDA error {err}")


def index_dtype(m: int, int64_index: bool = False) -> torch.dtype:
    """The type of B4's per-left-row ``lo`` / ``cnt``: int32 while the
    right side has fewer than 2^31 rows (every ``lo`` is below ``m``,
    every ``cnt`` at most ``m``), else int64; ``int64_index`` takes the
    int64 instance at any ``m``."""
    return torch.int64 if int64_index or m >= 1 << 31 else torch.int32


def _range_groups(n: int, dtype: torch.dtype) -> int:
    """Groups of 32 left rows in each range that a warp of B4's count
    pass walks: the groups split evenly over one resident wave of that
    pass on the current device (asked of the library, which caches the
    wave per device); the emit pass finds each group's range by it."""
    out = ctypes.c_int64(0)
    err = _kernel_fns()["ranges"](n, torch.iinfo(dtype).bits // 8, ctypes.byref(out))
    _raise_on(err, "range sizing")
    return out.value


class _Counts(NamedTuple):
    """What B4's count pass leaves for the emit pass: per left position
    ``lo`` and ``cnt`` (int32 or int64), per group of 32 positions its
    first output within its range (``group_first``, int64), and
    ``range_tot`` (int64: 0, then each range's pair total; after
    :func:`_scan_pass` each range's first output, last the number of
    pairs)."""

    lo: torch.Tensor
    cnt: torch.Tensor
    group_first: torch.Tensor
    range_tot: torch.Tensor
    range_groups: int


def _count_pass(
    l_keys: torch.Tensor,
    l_offs: torch.Tensor,
    r_sorted: torch.Tensor,
    r_offs: torch.Tensor,
    range_groups: int,
    dtype: torch.dtype,
    stream: int,
) -> _Counts:
    """Launch B4's count pass on ``stream`` over ranges of
    ``range_groups`` groups of 32 left positions, ``lo`` / ``cnt`` of
    ``dtype``. ``l_offs`` / ``r_offs`` are the checked offsets on the
    device; every tensor is contiguous."""
    global launches
    n, dev = l_keys.shape[0], l_keys.device
    groups = (n + 31) // 32
    ranges = (groups + range_groups - 1) // range_groups
    counts = _Counts(
        torch.empty(n, dtype=dtype, device=dev),
        torch.empty(n, dtype=dtype, device=dev),
        torch.empty(groups, dtype=torch.int64, device=dev),
        torch.empty(ranges + 1, dtype=torch.int64, device=dev),
        range_groups,
    )
    err = _kernel_fns()["count"](
        l_keys.data_ptr(), n, l_offs.data_ptr(), r_offs.data_ptr(),
        l_offs.shape[0] - 1, r_sorted.data_ptr(), range_groups,
        counts.lo.data_ptr(), counts.cnt.data_ptr(), counts.group_first.data_ptr(),
        counts.range_tot.data_ptr(), counts.lo.element_size(), stream,
    )
    _raise_on(err, "count")
    if n:  # the C side launches nothing for n = 0
        launches += 1
    return counts


def _scan_pass(range_tot: torch.Tensor, stream: int) -> torch.Tensor:
    """Launch B4's scan on ``stream``: ``range_tot`` becomes its inclusive
    cumsum in place, each range's first output, its last entry the number
    of pairs; returns it."""
    global launches
    err = _kernel_fns()["scan"](range_tot.data_ptr(), range_tot.shape[0], stream)
    _raise_on(err, "scan")
    if range_tot.shape[0]:
        launches += 1
    return range_tot


def _emit_pass(
    counts: _Counts,
    l_row: Optional[torch.Tensor],
    r_row: Optional[torch.Tensor],
    li: torch.Tensor,
    ri: torch.Tensor,
    stream: int,
) -> None:
    """Launch B4's emit pass on ``stream``: write the pairs into ``li`` /
    ``ri`` ([counts.range_tot[-1]] int64) once :func:`_scan_pass` has
    scanned ``counts.range_tot``."""
    global launches
    n = counts.lo.shape[0]
    err = _kernel_fns()["emit"](
        counts.lo.data_ptr(), counts.cnt.data_ptr(), counts.group_first.data_ptr(),
        counts.range_tot.data_ptr(), n, counts.range_groups, _ptr(l_row), _ptr(r_row),
        li.data_ptr(), ri.data_ptr(), counts.lo.element_size(), stream,
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
    int64_index: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 on the card: count pass, scan of its totals (one per range of
    consecutive groups of 32 left rows), one read of the last to allocate
    the pairs, emit pass: three launches. ``lo`` / ``cnt`` are int32
    unless the right side has 2^31 rows or more, or ``int64_index`` asks
    for the int64 instance (:func:`index_dtype`). With n = 0 or m = 0
    nothing launches."""
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
        dtype = index_dtype(r_sorted.shape[0], int64_index)
        counts = _count_pass(
            l_keys, l_offs_t, r_sorted, r_offs_t,
            _range_groups(l_keys.shape[0], dtype), dtype, stream,
        )
        total = int(_scan_pass(counts.range_tot, stream)[-1])
        li = torch.empty(total, dtype=torch.int64, device=dev)
        ri = torch.empty(total, dtype=torch.int64, device=dev)
        if total:
            _emit_pass(counts, l_row, r_row, li, ri, stream)
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


def match_pairs_sharded(
    devices,
    l_keys: torch.Tensor,
    l_offs,
    r_sorted: torch.Tensor,
    r_offs,
    l_row: Optional[torch.Tensor] = None,
    r_row: Optional[torch.Tensor] = None,
    out_device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`match_pairs` over a shard mesh (``devices``, one a shard; a
    device may repeat): the B segments padded with empty ones to a
    multiple of D, as the reference pads its bucket dimension
    (``join_exec.py:784-800``), shard s matching segments ``[s * B' / D,
    (s + 1) * B' / D)`` on ``devices[s]``. Identity row maps become each
    slice's base offset. The pairs (on ``out_device``, default the
    keys') are :func:`match_pairs`'s, in the same order."""
    global shard_launches
    lo_np, ro_np = _check(l_keys, l_offs, r_sorted, r_offs, l_row, r_row)
    D = len(devices)
    out_device = torch.device(out_device) if out_device is not None else l_keys.device
    B = len(lo_np) - 1
    per = -(-B // D)
    lo_np = np.concatenate([lo_np, np.full(per * D - B, lo_np[-1], dtype=np.int64)])
    ro_np = np.concatenate([ro_np, np.full(per * D - B, ro_np[-1], dtype=np.int64)])
    li_parts, ri_parts = [], []
    for s in range(D):
        b0, b1 = s * per, (s + 1) * per
        l0, l1, r0, r1 = int(lo_np[b0]), int(lo_np[b1]), int(ro_np[b0]), int(ro_np[b1])
        if l0 == l1 or r0 == r1:
            continue
        dev = torch.device(devices[s])
        before = launches
        li, ri = match_pairs(
            l_keys[l0:l1].to(dev), lo_np[b0 : b1 + 1] - l0,
            r_sorted[r0:r1].to(dev), ro_np[b0 : b1 + 1] - r0,
            None if l_row is None else l_row[l0:l1].to(dev),
            None if r_row is None else r_row[r0:r1].to(dev),
        )
        shard_launches += launches - before
        li_parts.append(li.to(out_device) + (l0 if l_row is None else 0))
        ri_parts.append(ri.to(out_device) + (r0 if r_row is None else 0))
    if not li_parts:
        return _empty_pairs(out_device)
    return torch.cat(li_parts), torch.cat(ri_parts)
