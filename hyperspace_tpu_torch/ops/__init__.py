"""Device ops of the index data plane, on PyTorch tensors.

Counterpart of ``hyperspace_tpu/ops``. Each op takes tensors on an
explicit device (the session's). Where the JAX package had a Pallas
kernel, the port has a kernel written by hand for Hopper plus a plain
PyTorch version of the same function beside it: a tensor on the CPU takes
the plain version, a tensor on the card launches the kernel or raises.

* :mod:`.hash` — murmur3 bucket ids (kernel B1, ``csrc/murmur3_bucket.cu``);
* :mod:`.sort` — bucket-partitioned stable key sort (torch ops);
* :mod:`.filter` — SQL three-valued predicate masks (torch ops);
* :mod:`.join` — per-bucket merge-join match of co-bucketed sides
  (kernel B4, ``csrc/bucket_match.cu``).
"""

from __future__ import annotations

import importlib
from typing import Dict

# Every hand-written kernel: name -> (module, wrapper that launches it,
# plain PyTorch version it is held against, CUDA source). The wrapper's
# module keeps a ``launches`` count that only kernel launches raise.
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
}


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last :func:`reset_launch_counts`."""
    return {
        name: importlib.import_module(mod).launches
        for name, (mod, _w, _p, _s) in KERNEL_TWINS.items()
    }


def reset_launch_counts() -> None:
    for mod, _w, _p, _s in KERNEL_TWINS.values():
        importlib.import_module(mod).launches = 0
