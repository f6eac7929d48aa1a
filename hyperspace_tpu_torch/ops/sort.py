"""Build sort, group-by sort, z-order sort and ORDER BY — stable
permutations on the device.

Counterpart of ``hyperspace_tpu/ops/sort.py`` (``sort_permutation``,
``partitioned_sort_permutation`` with the per-bucket runs of the
pipelined build, ``lexsort_perm``, ``order_rep`` and
``ordering_permutation``). The reference sorts by
``(bucket, key_0, key_1, ...)`` with a stable lexsort over uint32 planes
in which each signed int64 key becomes ``(hi ^ signbit, lo)``; that plane
pair orders exactly as the signed int64 itself. So here each key sorts
directly as int64: stable ``torch.sort`` passes, least significant key
first, then the bucket. Stable passes compose into the stable lexsort,
so the permutation is identical to the reference's, not just another
valid order. ORDER BY sorts the same way by value-order reps: per key,
least significant first, the rep (complemented when descending), then
the NaN and null placement.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _lsd_sort(perm: torch.Tensor, planes) -> torch.Tensor:
    """Apply stable sorts by ``planes`` (least significant first) to
    ``perm``; each plane is indexed in original row order."""
    for plane in planes:
        perm = perm[torch.sort(plane[perm], stable=True).indices]
    return perm


def sort_permutation(
    key_reps: torch.Tensor, bucket: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Permutation (int64, on the input's device) sorting rows stably by
    ``(bucket, key_reps[0], key_reps[1], ...)``; ``key_reps`` is [k, n]
    int64."""
    if key_reps.dim() != 2 or key_reps.dtype != torch.int64:
        raise ValueError(
            f"key_reps must be [k, n] int64, got {tuple(key_reps.shape)} "
            f"{key_reps.dtype}"
        )
    n = key_reps.shape[1]
    perm = torch.arange(n, dtype=torch.int64, device=key_reps.device)
    planes = [key_reps[j] for j in reversed(range(key_reps.shape[0]))]
    if bucket is not None:
        planes.append(bucket)
    return _lsd_sort(perm, planes)


def lexsort_permutation(planes: torch.Tensor) -> torch.Tensor:
    """Stable lexsort of [m, n] uint32 planes (as int32 bits), plane 0
    primary -> [n] int64 permutation on the planes' device: the
    reference's ``lexsort_indices`` / ``lexsort_perm``
    (``ops/sort.py:100-151``) under the z-order build. One stable pass a
    plane, least significant first, each plane widened to int64
    zero-extended (a signed sort of the bits would put every word with its
    top bit set first)."""
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError(
            f"planes must be [m, n] int32 (uint32 bits), got {tuple(planes.shape)} "
            f"{planes.dtype}"
        )
    n = planes.shape[1]
    perm = torch.arange(n, dtype=torch.int64, device=planes.device)
    widened = [planes[j].to(torch.int64) & 0xFFFFFFFF for j in reversed(range(planes.shape[0]))]
    return _lsd_sort(perm, widened)


def partitioned_sort_permutation(
    key_reps: torch.Tensor, bucket: torch.Tensor, num_buckets: int
) -> torch.Tensor:
    """The reference's partition-first build sort: rows grouped by bucket
    (ascending), each bucket's rows stably key-sorted. Its permutation is
    defined to equal ``sort_permutation(key_reps, bucket)``, which is
    what the card computes: one pass per key, one for the bucket."""
    if bucket.shape != (key_reps.shape[1],):
        raise ValueError(
            f"bucket must be [{key_reps.shape[1]}], got {tuple(bucket.shape)}"
        )
    if bucket.numel() and not 0 <= int(bucket.min()) <= int(bucket.max()) < num_buckets:
        raise ValueError(f"bucket ids outside [0, {num_buckets})")
    return sort_permutation(key_reps, bucket)


def bucket_sort_runs(
    key_reps: torch.Tensor, bucket: torch.Tensor, num_buckets: int
):
    """The partition-first build sort handed to the host for the pipelined
    writer: ``(perm, offsets)`` as int64 numpy arrays, ``perm`` equal to
    ``partitioned_sort_permutation(key_reps, bucket, num_buckets)`` (so to
    ``sort_permutation(key_reps, bucket)``) and bucket ``b``'s rows, key
    sorted, at ``perm[offsets[b]:offsets[b+1]]`` (the offsets a bincount
    and a cumsum on the card). The reference yields the
    runs bucket by bucket from a host counting scatter and per-bucket
    lexsorts (``ops/sort.py:171``, ``:216``); the card computes the whole
    permutation in a few passes, so it comes back in one copy, through
    pinned memory from the card."""
    perm = partitioned_sort_permutation(key_reps, bucket, num_buckets)
    counts = torch.bincount(bucket.to(torch.int64), minlength=num_buckets)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    if perm.is_cuda:
        host = torch.empty(perm.shape, dtype=perm.dtype, pin_memory=True)
        host.copy_(perm)
        return host.numpy(), offsets.cpu().numpy()
    return perm.numpy(), offsets.numpy()


def shard_tail_plan(shard_offsets: np.ndarray) -> list:
    """The shards of a sharded tail that hold rows: the units that sort
    and write concurrently (reference ``ops/sort.py:288``; its per-shard
    share of host sort threads has no counterpart here, the sorts run on
    the devices)."""
    return [
        s for s in range(len(shard_offsets) - 1) if shard_offsets[s + 1] > shard_offsets[s]
    ]


def sharded_sort_permutation(
    key_reps: torch.Tensor,
    bucket: torch.Tensor,
    num_buckets: int,
    shard_offsets: np.ndarray,
    devices: Optional[Sequence] = None,
) -> torch.Tensor:
    """The sharded twin of :func:`partitioned_sort_permutation` (reference
    ``ops/sort.py:302``): each shard's post-exchange slice
    (``shard_offsets[s]:shard_offsets[s + 1]``, exactly the buckets it
    owns) sorts by (bucket, keys) on its own device (``devices[s]``,
    default the input's), concurrently with the other shards. The output
    (int64, on the input's device) is shard-major, not globally bucket
    ascending, but every bucket lives in one slice, so each bucket's rows
    come in the same order as in the global sort, the only order the
    bucketed writers see."""
    from concurrent.futures import ThreadPoolExecutor

    shards = shard_tail_plan(shard_offsets)

    def run_shard(s: int) -> torch.Tensor:
        lo, hi = int(shard_offsets[s]), int(shard_offsets[s + 1])
        dev = key_reps.device if devices is None else torch.device(devices[s])
        perm = partitioned_sort_permutation(
            key_reps[:, lo:hi].to(dev), bucket[lo:hi].to(dev), num_buckets
        )
        return perm.to(key_reps.device) + lo

    if not shards:
        return torch.zeros(0, dtype=torch.int64, device=key_reps.device)
    with ThreadPoolExecutor(max_workers=len(shards), thread_name_prefix="hs-shardsort") as pool:
        return torch.cat(list(pool.map(run_shard, shards)))


# ---------------------------------------------------------------------------
# User-facing ORDER BY (value order, not key-rep order)
# ---------------------------------------------------------------------------


def order_rep(col) -> np.ndarray:
    """int64 rep whose signed order equals the column's VALUE order.

    Unlike ``Column.key_rep`` (arbitrary-but-consistent order, hash for
    strings), this is order-preserving: ints/temporal as-is, uints via
    sign-bit xor, floats via the IEEE-754 total-order trick (NaN sorts
    after +inf, matching numpy/pyarrow), strings via per-batch dictionary
    rank. Null placement is handled by the caller (``ordering_permutation``
    adds a null plane), so nulls here get an arbitrary in-band value.
    """
    if col.kind == "string":
        order = sorted(range(len(col.dictionary)), key=col.dictionary.__getitem__)
        rank = np.empty(max(len(col.dictionary), 1), dtype=np.int64)
        for r, i in enumerate(order):
            rank[i] = r
        return rank[np.maximum(col.codes, 0)].astype(np.int64)
    v = col.values
    if v.dtype.kind == "f":
        # IEEE-754 total order as SIGNED int64: positives keep their bit
        # pattern; negatives complement the magnitude bits (sign bit stays,
        # so they remain negative and larger magnitudes sort lower).
        u = v.astype(np.float64).view(np.uint64)
        rep = np.where(
            u >> np.uint64(63) == 1,
            u ^ np.uint64(0x7FFFFFFFFFFFFFFF),
            u,
        )
        return rep.view(np.int64)
    if v.dtype.kind == "u":
        return (
            v.astype(np.uint64) ^ np.uint64(0x8000000000000000)
        ).view(np.int64)
    return v.astype(np.int64)


def ordering_permutation(
    batch, keys: Sequence[Tuple[str, bool]], device
) -> torch.Tensor:
    """Stable permutation (int64, on ``device``) ordering ``batch`` by
    ``keys`` = ((column, ascending), ...). Nulls always sort last
    (pyarrow's ``null_placement="at_end"``), and NaN always sorts after
    every other value but before nulls — in BOTH directions, like
    pyarrow's sort_by. Descending flips values only, never the null/NaN
    placement.

    The reference lexsorts uint32 planes ``[null, nan, hi, lo]`` per key,
    key 0 most significant. Here each key is one stable pass over its
    int64 rep (``~rep`` descending: the complement reverses signed order)
    and, where the key has nulls or NaNs, one pass over its placement
    ``2 * null + nan``; keys from least to most significant. A key with
    neither has a constant placement plane, which a stable sort skips."""
    n = batch.num_rows
    planes = []
    for name, asc in reversed(list(keys)):
        col = batch.column(name)
        rep = order_rep(col)
        if not asc:
            rep = ~rep  # bitwise complement reverses signed order
        planes.append(rep)
        place = np.zeros(n, dtype=np.int64)
        null = col.null_mask
        if null is not None:
            place += 2 * null
        if col.kind == "numeric" and col.values.dtype.kind == "f":
            place += np.isnan(col.values)
        if place.any():
            planes.append(place)
    dev = torch.device(device)
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    return _lsd_sort(perm, [torch.from_numpy(np.ascontiguousarray(p)).to(dev) for p in planes])
