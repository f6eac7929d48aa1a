"""Device ops of the index data plane, on PyTorch tensors.

Counterpart of ``hyperspace_tpu/ops``. Each op takes tensors on an
explicit device (the session's). Where the JAX package had a Pallas
kernel, the port has a kernel written by hand for Hopper plus a plain
PyTorch version of the same function beside it: a tensor on the CPU takes
the plain version, a tensor on the card launches the kernel or raises.

* :mod:`.hash` — murmur3 bucket ids (kernel B1, ``csrc/murmur3_bucket.cu``);
* :mod:`.sort` — bucket-partitioned stable key sort (torch ops);
* :mod:`.filter` — SQL three-valued predicate masks (torch ops), and the
  fused range mask of range conjunctions (kernel B3a,
  ``csrc/range_mask.cu``);
* :mod:`.join` — per-bucket merge-join match of co-bucketed sides
  (kernel B4, ``csrc/bucket_match.cu``);
* :mod:`.aggregate` — per-group sum, count, min and max over sorted
  groups (kernel B5, ``csrc/segment_reduce.cu``);
* :mod:`.filter` also holds the fused select, the passing rows' indices
  of a range conjunction (kernel B3b, ``csrc/fused_select.cu``);
* :mod:`.fused_agg` — the fused filter→aggregate over one chunk (kernel
  B5f, ``csrc/fused_agg.cu``): one pass for order-free aggregates, else
  B3b, the group pass and B5;
* :mod:`.zorder` — z-addresses: the host order encodings and word
  scaling, the bit interleave (kernel B6, ``csrc/zorder_interleave.cu``),
  and the z-order sort through :mod:`.sort`'s ``lexsort_permutation``;
* :mod:`.bloom` — Bloom filter bit indices, build and probe of the
  data-skipping index (kernel B7, ``csrc/bloom_bits.cu``);
* :mod:`.exchange` — the sharded build's bucket exchange: the pack of a
  shard's rows into ``[D, cap]`` slots (kernel B8a) and the order of a
  shard's received slots by bucket (kernel B8b), ``csrc/bucket_exchange.cu``,
  replacing ``hyperspace_tpu/parallel/shuffle.py:306``'s two argsorts:
  each a stable counting sort over 4,096-row tiles in three launches
  (tile histograms, their scan, a rank-and-move pass that stages each
  column in shared memory in digit order), bound by HBM bytes; B8b over
  more than 4,095 buckets in two such passes.
"""

from __future__ import annotations

import importlib
from typing import Dict

# Every hand-written kernel: name -> (module, wrapper that launches it,
# plain PyTorch version it is held against, CUDA source). The wrapper's
# module keeps a launch count that only kernel launches raise: the
# attribute ``launches``, or the one LAUNCH_COUNTERS names. B5's module
# has two more wrappers of the same source, each beside its plain
# version: ``segment_minmax_kernel`` / ``_torch`` and
# ``segment_count_kernel`` / ``_torch``. B5f's wrapper launches B5 too.
# B7's module has a second wrapper of its source, ``build_bloom_kernel``
# beside ``build_bloom_torch``, counted in the same ``launches`` and by
# route in ``ROUTE_COUNTERS``.
KERNEL_TWINS = {
    "murmur3_bucket_ids": (
        "hyperspace_tpu_torch.ops.hash",
        "bucket_ids_kernel",
        "bucket_ids_torch",
        "hyperspace_tpu_torch/csrc/murmur3_bucket.cu",
    ),
    "bucket_match_pairs": (
        "hyperspace_tpu_torch.ops.join",
        "match_pairs_kernel",
        "match_pairs_torch",
        "hyperspace_tpu_torch/csrc/bucket_match.cu",
    ),
    "range_mask": (
        "hyperspace_tpu_torch.ops.filter",
        "range_mask_kernel",
        "range_mask_torch",
        "hyperspace_tpu_torch/csrc/range_mask.cu",
    ),
    "segment_reduce": (
        "hyperspace_tpu_torch.ops.aggregate",
        "segment_sum_count_kernel",
        "segment_sum_count_torch",
        "hyperspace_tpu_torch/csrc/segment_reduce.cu",
    ),
    "fused_select": (
        "hyperspace_tpu_torch.ops.filter",
        "select_kernel",
        "select_torch",
        "hyperspace_tpu_torch/csrc/fused_select.cu",
    ),
    "fused_filter_agg": (
        "hyperspace_tpu_torch.ops.fused_agg",
        "fused_filter_agg_kernel",
        "fused_filter_agg_torch",
        "hyperspace_tpu_torch/csrc/fused_agg.cu",
    ),
    "zorder_interleave": (
        "hyperspace_tpu_torch.ops.zorder",
        "interleave_kernel",
        "interleave_torch",
        "hyperspace_tpu_torch/csrc/zorder_interleave.cu",
    ),
    "bloom_bits": (
        "hyperspace_tpu_torch.ops.bloom",
        "bit_indices_kernel",
        "bit_indices_torch",
        "hyperspace_tpu_torch/csrc/bloom_bits.cu",
    ),
    "bucket_exchange_pack": (
        "hyperspace_tpu_torch.ops.exchange",
        "pack_kernel",
        "pack_torch",
        "hyperspace_tpu_torch/csrc/bucket_exchange.cu",
    ),
    "bucket_exchange_order": (
        "hyperspace_tpu_torch.ops.exchange",
        "order_kernel",
        "order_torch",
        "hyperspace_tpu_torch/csrc/bucket_exchange.cu",
    ),
}

#: kernels whose module counts them under another attribute than ``launches``
LAUNCH_COUNTERS = {
    "fused_select": "select_launches",
    "bucket_exchange_pack": "pack_launches",
    "bucket_exchange_order": "order_launches",
}

#: launches by route of a kernel entry with more than one route, each also
#: counted in its kernel's own count: name -> (module, attribute)
ROUTE_COUNTERS = {
    "bloom_bits.build_block": ("hyperspace_tpu_torch.ops.bloom", "block_launches"),
    "bloom_bits.build_binned": ("hyperspace_tpu_torch.ops.bloom", "binned_launches"),
    "bloom_bits.build_global": ("hyperspace_tpu_torch.ops.bloom", "global_launches"),
    "bucket_match_pairs.shard": ("hyperspace_tpu_torch.ops.join", "shard_launches"),
}


def _counters():
    for name, (mod, _w, _p, _s) in KERNEL_TWINS.items():
        yield name, mod, LAUNCH_COUNTERS.get(name, "launches")
    for name, (mod, attr) in ROUTE_COUNTERS.items():
        yield name, mod, attr


def launch_counts() -> Dict[str, int]:
    """Kernel (and route) name -> launches since the last
    :func:`reset_launch_counts`."""
    return {name: getattr(importlib.import_module(mod), attr)
            for name, mod, attr in _counters()}


def reset_launch_counts() -> None:
    for _name, mod, attr in _counters():
        setattr(importlib.import_module(mod), attr, 0)
