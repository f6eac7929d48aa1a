"""Cases of kernel B7, the Bloom filter bit indices (``ops/bloom.py``):
shared by the CPU tests against the JAX package (``test_torch_bloom.py``),
the CUDA tests against the plain version (``test_torch_cuda.py``) and
``chip_smoke.py``'s phase 3.

A case is ``(n, m, k, fill)``: ``n`` int64 key reps hashed into k bit
indices below m. The fills:

* ``"edges"``: INT64_MIN, INT64_MAX, 0, -1, 2^32 - 1, 2^32, the int64
  bit-views of uint64 values at and above 2^63, repeated to n (so every
  case past 10 rows holds duplicates);
* ``"random"``: seeded reps over the whole int64 range;
* ``"strings"``: the reps a string column gives its values
  (``murmur3_64_bytes`` of the UTF-8 bytes), 97 distinct strings repeated.

The sizes straddle a warp (31, 33) and pass a 65,536-row boundary. m
covers one word (64), a filter of ~10,000 items at fpp 0.01 (95,872),
phase 11's l_orderkey sketch (``optimal_params(600_000, 0.01)``:
5,751,040 bits, k = 7) and ``WRAP_M``, the named case where h1 + j·h2
passes 2^32 for about half the rows while 2^32 is no multiple of m, so
only the sum wrapped at 2^32 before the remainder gives the reference's
indices. k covers 1, 7 and optimal_params' cap, 16.

``BOUNDARY_CASES`` hold the build's route edges (``ops/bloom.build_plan``)
at 65,537 random reps and k = 7, apart from ``CASES``' product so the CPU
suite's time stays flat: m at the last word one block holds (2^20 bits,
the block route), one word past it (the binned route: 17 slices of
2^16 bits, the last of 64), the last word the binned route holds
(``BINNED_MAX_BITS`` = 2^24: 256 slices) and one word past it (the
global route). At 65,537 rows the block route's case builds 17 partial
filters and the binned route's 65 tiles, more than the copies of a slice
on an H100 (264 blocks, 15 a slice of 17), so every copy takes tiles. The
slices hold 2^16 bits, a multiple of 64, so no slice edge splits a 64-bit
word's halves.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import itertools

import numpy as np

SIZES = (0, 1, 31, 33, 1000, 65_537)
PHASE_M, PHASE_K = 5_751_040, 7
WRAP_M = (1 << 31) - 64
BITS = (64, 95_872, PHASE_M, WRAP_M)
KS = (1, 7, 16)
FILLS = ("edges", "random", "strings")

CASES = list(itertools.product(SIZES, BITS, KS, FILLS))
#: the build's cases: its plain version sets a bool plane of m bytes, so
#: the wrap case (2 GiB) is held through the indices, and on the card by
#: :func:`words_from_indices`
BUILD_CASES = [c for c in CASES if c[1] != WRAP_M]
#: the route boundaries: the most bits the block and the binned routes take
BLOCK_BITS, BINNED_BITS = 1 << 20, 1 << 24
BOUNDARY_CASES = [(65_537, m, 7, "random")
                  for m in (BLOCK_BITS, BLOCK_BITS + 64, BINNED_BITS, BINNED_BITS + 64)]

EDGE_REPS = np.array(
    [
        -(1 << 63),
        (1 << 63) - 1,
        0,
        -1,
        (1 << 32) - 1,
        1 << 32,
        int(np.uint64(1 << 63).view(np.int64)),
        int(np.uint64((1 << 63) + 12345).view(np.int64)),
        int(np.uint64((1 << 64) - 2).view(np.int64)),
        7,
    ],
    dtype=np.int64,
)


def case_id(case) -> str:
    n, m, k, fill = case
    return f"n{n}-m{m}-k{k}-{fill}" + ("-wrap" if m == WRAP_M else "")


def reps_for(case, seed: int = 5) -> np.ndarray:
    """``case``'s [n] int64 key reps."""
    from hyperspace_tpu_torch.utils.hashing import murmur3_64_bytes

    n, m, k, fill = case
    if fill == "edges":
        return np.resize(EDGE_REPS, n)
    if fill == "strings":
        distinct = np.array(
            [murmur3_64_bytes(f"key-{i}".encode()) for i in range(97)], dtype=np.int64
        )
        return np.resize(distinct, n)
    rng = np.random.default_rng(seed + 7 * n + 3 * k + m % 1000)
    return rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64, endpoint=True)


def words_from_indices(idx: np.ndarray, m: int) -> np.ndarray:
    """The [m / 64] uint64 words with exactly the bits of ``idx`` set (bit
    i in word i >> 6 at bit i & 63), without a plane of m bits."""
    words = np.zeros(m // 64, dtype=np.uint64)
    flat = np.asarray(idx, dtype=np.int64).ravel()
    np.bitwise_or.at(words, flat >> 6, np.left_shift(np.uint64(1), (flat & 63).astype(np.uint64)))
    return words
