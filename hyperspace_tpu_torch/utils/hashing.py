"""Host-side hashing utilities.

Reference: ``util/HashingUtils.scala`` (md5 for plan/file fingerprints).
Bucket assignment runs on the device (:mod:`hyperspace_tpu_torch.ops.hash`).
The murmur3 functions here hash what never reaches the device raw: string
dictionary entries, hashed once per unique value (O(unique), not O(rows))
and gathered through the dictionary codes (``io/columnar.py`` key-rep
contract). They must match ``hyperspace_tpu/utils/hashing.py`` bit for
bit, since every bucket id depends on them.
"""

from __future__ import annotations

import hashlib
from typing import Any

_M32 = 0xFFFFFFFF


def md5_hex(value: Any) -> str:
    """md5 of ``str(value)`` as hex — mirrors HashingUtils.md5Hex."""
    return hashlib.md5(str(value).encode("utf-8")).hexdigest()


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def murmur3_32_bytes(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit of raw bytes (standard reference algorithm).

    The device kernel (``csrc/murmur3_bucket.cu``) applies the same
    block/mix/fmix arithmetic to int64 key reps; this host version handles
    the variable-width inputs (strings).
    """
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = seed & _M32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k1 = int.from_bytes(data[4 * i : 4 * i + 4], "little")
        k1 = (k1 * c1) & _M32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _M32
        h1 ^= k1
        h1 = _rotl32(h1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _M32
    tail = data[nblocks * 4 :]
    k1 = 0
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * c1) & _M32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _M32
        h1 ^= k1
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M32
    h1 ^= h1 >> 16
    return h1


def murmur3_64_bytes(data: bytes) -> int:
    """Stable signed 64-bit hash of bytes: two seeded murmur3-32 words.

    Used as the key rep of string values (``io/columnar.py``). Signed so it
    fits np.int64 directly.
    """
    lo = murmur3_32_bytes(data, seed=0)
    hi = murmur3_32_bytes(data, seed=0x9747B28C)
    u = (hi << 32) | lo
    return u - (1 << 64) if u >= (1 << 63) else u
