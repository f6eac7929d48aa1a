"""Bucket hashing — murmur3 bucket ids over int64 key reps (kernel B1).

Counterpart of ``hyperspace_tpu/ops/hash.py``. Bucket assignment is a pure
function of the key *values* (their int64 key reps, ``io/columnar.py``),
so the build and query-time bucket pruning agree on the layout, and an
index built by either package is served by the other.

Each int64 rep is hashed as its 8 little-endian bytes (lo uint32 word,
then hi), k key columns extend the block stream, seed 42 by default,
fmix with length 8k, then ``% num_buckets``. The result equals
``murmur3_32_bytes(b"".join(rep_i 8-byte LE)) % num_buckets``.

* :func:`bucket_ids` is the entry point: a CPU tensor takes the plain
  version, a CUDA tensor launches the hand-written kernel
  (``csrc/murmur3_bucket.cu``) and counts the launch.
* :func:`bucket_ids_torch` is the plain PyTorch version, the remainder
  of :func:`hash_words_torch`'s raw hash (which the Bloom filters of
  ``ops/bloom.py`` share). PyTorch on the CPU has no uint32 shifts, adds
  or remainders, so it computes in int64 with every value kept in
  [0, 2^32): products with the 32-bit constants go through the
  constants' 16-bit halves, so nothing overflows int64.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_C1 = 0xCC9E2D51
_C2 = 0x1B873593

#: kernel launches made by :func:`bucket_ids` (never by the plain version)
launches = 0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32,
    exact in int64: x * c_lo < 2^48 and (x * c_hi mod 2^16) << 16 < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_word(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = _mul32(k, _C1)
    k = _rotl32(k, 15)
    k = _mul32(k, _C2)
    h = _rotl32(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & _M32


def _fmix(h: torch.Tensor, length: int) -> torch.Tensor:
    h = h ^ length
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _check(key_reps: torch.Tensor, num_buckets: int) -> None:
    if not isinstance(key_reps, torch.Tensor):
        raise TypeError(f"key_reps must be a torch.Tensor, got {type(key_reps)}")
    if key_reps.dtype != torch.int64 or key_reps.dim() != 2:
        raise ValueError(
            f"key_reps must be [k, n] int64, got {tuple(key_reps.shape)} "
            f"{key_reps.dtype}"
        )
    if key_reps.shape[0] < 1:
        raise ValueError("key_reps needs at least one key column")
    if not 1 <= int(num_buckets) <= 1 << 31:
        raise ValueError(f"num_buckets must be in [1, 2^31], got {num_buckets}")


def hash_words_torch(key_reps: torch.Tensor, seed: int) -> torch.Tensor:
    """Raw murmur3-32 of [k, n] int64 key reps, each as its two words (lo,
    then hi), before any remainder: [n] int64 holding uint32 values, on
    the tensor's own device (``hash_words`` of the JAX package over the
    split words)."""
    k, n = key_reps.shape
    h = torch.full((n,), int(seed) & _M32, dtype=torch.int64, device=key_reps.device)
    for j in range(k):
        rep = key_reps[j]
        h = _mix_word(h, rep & _M32)
        h = _mix_word(h, (rep >> 32) & _M32)
    return _fmix(h, 8 * k)


def bucket_ids_torch(
    key_reps: torch.Tensor, num_buckets: int, seed: int = 42
) -> torch.Tensor:
    """Plain PyTorch version: [k, n] int64 key reps -> [n] int32 bucket
    ids, on the tensor's own device."""
    _check(key_reps, num_buckets)
    h = hash_words_torch(key_reps, seed)
    return torch.remainder(h, int(num_buckets)).to(torch.int32)


def fastmod_m(num_buckets: int) -> int:
    """The kernel's remainder constant for divisor d = ``num_buckets``:
    floor((2^64 - 1) / d) + 1 mod 2^64, so that for every 32-bit h,
    h % d == floor(((m * h) mod 2^64) * d / 2^64) (Lemire, Kaser and
    Kurz, 2019). d = 1 gives 0."""
    return ((_M64 // int(num_buckets)) + 1) & _M64


def aligned_planes(key_reps: torch.Tensor) -> int:
    """Bit j set iff plane j (j < 32) of the [k, n] int64 tensor starts on
    a 16-byte boundary, so the kernel may read it with 16-byte loads.
    Plane j starts 8jn bytes after plane 0: with odd n every other plane
    is only 8-byte aligned, and a view with a storage offset can move
    plane 0 itself."""
    k, n = key_reps.shape
    base = key_reps.data_ptr()
    return sum(1 << j for j in range(min(k, 32)) if (base + 8 * j * n) % 16 == 0)


@functools.cache
def _kernel_fn():
    from hyperspace_tpu_torch import kernels

    fn = kernels.load("murmur3_bucket").hs_murmur3_bucket_ids
    fn.argtypes = [
        ctypes.c_void_p,  # reps
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # n
        ctypes.c_int,  # k
        ctypes.c_int64,  # num_buckets
        ctypes.c_uint64,  # fastmod_m
        ctypes.c_int64,  # seed
        ctypes.c_uint32,  # aligned_planes
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(
    key_reps: torch.Tensor, out: torch.Tensor, num_buckets: int, seed: int, stream: int
) -> None:
    """Hand contiguous [k, n] reps and a fresh [n] int32 output to the C
    function on ``stream``; raise on any error code it returns (the C side
    refuses an output or a plane marked aligned that is not)."""
    global launches
    if not key_reps.is_contiguous():
        raise ValueError("key_reps must be contiguous")
    k, n = key_reps.shape
    err = _kernel_fn()(
        key_reps.data_ptr(),
        out.data_ptr(),
        n,
        k,
        int(num_buckets),
        fastmod_m(num_buckets),
        int(seed) & _M32,
        aligned_planes(key_reps),
        stream,
    )
    if err != 0:
        raise KernelLaunchError(f"murmur3 bucket kernel launch failed: CUDA error {err}")
    if n:  # the C side launches nothing for n = 0
        launches += 1


def bucket_ids_kernel(
    key_reps: torch.Tensor, num_buckets: int, seed: int = 42
) -> torch.Tensor:
    """Launch ``csrc/murmur3_bucket.cu`` on the current stream: [k, n]
    int64 contiguous CUDA key reps -> [n] int32 bucket ids."""
    _check(key_reps, num_buckets)
    if key_reps.device.type != "cuda":
        raise ValueError(f"bucket_ids_kernel needs a CUDA tensor, got {key_reps.device}")
    out = torch.empty(key_reps.shape[1], dtype=torch.int32, device=key_reps.device)
    with torch.cuda.device(key_reps.device):
        stream = torch.cuda.current_stream(key_reps.device).cuda_stream
        _launch(key_reps, out, num_buckets, seed, stream)
    return out


def bucket_ids(
    key_reps: torch.Tensor, num_buckets: int, seed: int = 42
) -> torch.Tensor:
    """[k, n] int64 key reps -> [n] int32 bucket ids on the same device:
    the plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (it raises on what it cannot take; there is no fallback)."""
    _check(key_reps, num_buckets)
    if key_reps.device.type == "cpu":
        return bucket_ids_torch(key_reps, num_buckets, seed)
    if key_reps.device.type == "cuda":
        return bucket_ids_kernel(key_reps, num_buckets, seed)
    raise ValueError(f"bucket_ids: unsupported device {key_reps.device}")
