"""Build sort — group rows by bucket, key-sorted within each bucket.

Counterpart of ``hyperspace_tpu/ops/sort.py`` (``sort_permutation`` and
``partitioned_sort_permutation``). The reference sorts by
``(bucket, key_0, key_1, ...)`` with a stable lexsort over uint32 planes
in which each signed int64 key becomes ``(hi ^ signbit, lo)``; that plane
pair orders exactly as the signed int64 itself. So here each key sorts
directly as int64: stable ``torch.sort`` passes, least significant key
first, then the bucket. Stable passes compose into the stable lexsort,
so the permutation is identical to the reference's, not just another
valid order.
"""

from __future__ import annotations

from typing import Optional

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
