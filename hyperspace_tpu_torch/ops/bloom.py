"""Bloom filter bit indices, build and probe (kernel B7).

Counterpart of ``hyperspace_tpu/ops/bloom.py`` (reference: the
data-skipping expressions ``BloomFilterAgg.scala`` and
``BloomFilterMightContain(Any).scala``). Both sides double-hash an int64
key rep over the murmur3 of its two words (``ops/hash.py``): bit index
j = (h1 + j·h2) mod m, h1 with seed 0x9747B28C, h2 with seed 0x85EBCA6B
OR 1, the sum wrapping at 2^32 before the remainder (the reference's
uint32 arithmetic).

* :func:`bit_indices` ([n] int64 reps -> [k, n] int32),
  :func:`build_bloom` ([n] reps -> the [m / 64] packed words of one
  filter) and :func:`might_contain` (the probe: reps against one or
  more filters) dispatch by device: a CPU tensor takes the plain
  version, a CUDA tensor launches the hand-written kernel
  (``csrc/bloom_bits.cu``: ``hs_bloom_bit_indices`` and
  ``hs_bloom_build``) and counts the launch in :data:`launches`, or
  raises. :func:`to_host` reads a kernel's output back and raises a
  fault of the kernel's run as ``KernelLaunchError``.
* :func:`bit_indices_torch` and :func:`build_bloom_torch` are the plain
  PyTorch versions: int64 tensors masked to 32 bits after every multiply
  and add, the bits set in a bool plane, then packed little-endian into
  64-bit words (bit i in word i >> 6 at bit i & 63, as
  ``np.packbits(..., bitorder="little").view(np.uint64)`` on a
  little-endian host). PyTorch has no uint64, so the words travel as
  int64 tensors holding the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError
from hyperspace_tpu_torch.ops.hash import _M32, hash_words_torch

SEED1 = 0x9747B28C
SEED2 = 0x85EBCA6B
#: the largest m the int32 indices can address
MAX_BITS = 1 << 31

#: kernel launches made by the wrappers (never by the plain versions)
launches = 0


def optimal_params(expected_items: int, fpp: float) -> Tuple[int, int]:
    """(num_bits m, num_hashes k) for a target false-positive rate."""
    expected_items = max(1, expected_items)
    m = max(64, int(-expected_items * math.log(fpp) / (math.log(2) ** 2)))
    m = ((m + 63) // 64) * 64  # word-align
    k = max(1, round(m / expected_items * math.log(2)))
    return m, min(k, 16)


def _check(reps: torch.Tensor, m: int, k: int, build: bool = False) -> None:
    if not isinstance(reps, torch.Tensor):
        raise TypeError(f"reps must be a torch.Tensor, got {type(reps)}")
    if reps.dtype != torch.int64 or reps.dim() != 1:
        raise ValueError(f"reps must be [n] int64, got {tuple(reps.shape)} {reps.dtype}")
    if not 1 <= int(m) <= MAX_BITS:
        raise ValueError(f"m must be in [1, 2^31], got {m}")
    if build and int(m) % 64:
        raise ValueError(f"a filter's m must be a multiple of 64, got {m}")
    if int(k) < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def bit_indices_torch(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Plain PyTorch version: [n] int64 reps -> [k, n] int32 bit indices,
    on the tensor's own device."""
    _check(reps, m, k)
    words = reps[None, :]
    h1 = hash_words_torch(words, SEED1)
    h2 = hash_words_torch(words, SEED2) | 1  # odd => full cycle
    j = torch.arange(int(k), dtype=torch.int64, device=reps.device)[:, None]
    wrapped = (h1[None, :] + ((j * h2[None, :]) & _M32)) & _M32
    return torch.remainder(wrapped, int(m)).to(torch.int32)


def build_bloom_torch(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Plain PyTorch version: [n] int64 reps -> the filter's [m / 64]
    packed words (int64 holding the uint64 bits)."""
    _check(reps, m, k, build=True)
    m = int(m)
    if reps.numel() == 0:
        return torch.zeros(m // 64, dtype=torch.int64, device=reps.device)
    bits = torch.zeros(m, dtype=torch.bool, device=reps.device)
    bits[bit_indices_torch(reps, m, k).reshape(-1).long()] = True
    shifts = torch.arange(64, dtype=torch.int64, device=reps.device)
    # distinct powers of two: the sum is the OR, bit 63 as int64's sign
    return (bits.view(m // 64, 64).to(torch.int64) << shifts).sum(dim=1)


@functools.cache
def _kernel_fns():
    from hyperspace_tpu_torch import kernels

    lib = kernels.load("bloom_bits")
    fns = (lib.hs_bloom_bit_indices, lib.hs_bloom_build)
    for fn in fns:
        fn.argtypes = [
            ctypes.c_void_p,  # reps
            ctypes.c_void_p,  # out (indices) / words (build)
            ctypes.c_int64,  # n
            ctypes.c_int64,  # m
            ctypes.c_int,  # k
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return fns


def _launch(entry: int, reps: torch.Tensor, out: torch.Tensor, m: int, k: int) -> None:
    """Hand contiguous CUDA reps and the output to C entry ``entry`` (0:
    indices, 1: build) on the current stream; raise on any error code it
    returns."""
    global launches
    if reps.device.type != "cuda":
        raise ValueError(f"the B7 kernel needs a CUDA tensor, got {reps.device}")
    if not reps.is_contiguous():
        raise ValueError("reps must be contiguous")
    n = reps.shape[0]
    with torch.cuda.device(reps.device):
        stream = torch.cuda.current_stream(reps.device).cuda_stream
        err = _kernel_fns()[entry](reps.data_ptr(), out.data_ptr(), n, int(m), int(k), stream)
    if err != 0:
        raise KernelLaunchError(f"Bloom bit-index kernel launch failed: CUDA error {err}")
    if n:  # the C side launches nothing for n = 0
        launches += 1


def bit_indices_kernel(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Launch ``hs_bloom_bit_indices``: [n] int64 CUDA reps -> [k, n]
    int32 bit indices."""
    _check(reps, m, k)
    out = torch.empty((int(k), reps.shape[0]), dtype=torch.int32, device=reps.device)
    _launch(0, reps, out, m, k)
    return out


def build_bloom_kernel(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Launch ``hs_bloom_build``: [n] int64 CUDA reps -> the filter's
    [m / 64] packed words (int64 holding the uint64 bits)."""
    _check(reps, m, k, build=True)
    words = torch.empty(int(m) // 64, dtype=torch.int64, device=reps.device)
    _launch(1, reps, words, m, k)
    return words


def _dispatch(name: str, reps: torch.Tensor, plain, kernel, m: int, k: int):
    if not isinstance(reps, torch.Tensor):
        raise TypeError(f"reps must be a torch.Tensor, got {type(reps)}")
    if reps.device.type == "cpu":
        return plain(reps, m, k)
    if reps.device.type == "cuda":
        return kernel(reps, m, k)
    raise ValueError(f"{name}: unsupported device {reps.device}")


def bit_indices(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """[n] int64 reps -> [k, n] int32 bit indices on the same device: the
    plain version for a CPU tensor, B7 for a CUDA tensor (it raises on
    what it cannot take; there is no fallback)."""
    return _dispatch("bit_indices", reps, bit_indices_torch, bit_indices_kernel, m, k)


def build_bloom(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """[n] int64 reps -> the [m / 64] packed words of their filter on the
    same device, as :func:`bit_indices` dispatches."""
    return _dispatch("build_bloom", reps, build_bloom_torch, build_bloom_kernel, m, k)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host. A kernel that faults while it runs reports it at
    the next synchronization, which for B7's output is this copy: torch
    raises a ``RuntimeError`` there, re-raised as
    :class:`~hyperspace_tpu_torch.kernels.KernelLaunchError`, so no caller
    can take the fault for a sketch that cannot decide."""
    if t.device.type == "cpu":
        return t
    try:
        return t.cpu()
    except RuntimeError as e:
        raise KernelLaunchError(f"Bloom bit-index kernel failed while it ran: {e}") from e


def might_contain(
    bloom_words: torch.Tensor, reps: torch.Tensor, m: int, k: int
) -> torch.Tensor:
    """[n] reps against the [..., m / 64] packed words of one or more
    filters -> bool [..., n]: every one of a rep's k bits is set. The
    indices come from :func:`bit_indices` on the reps' device; the bits
    are read where the words lie (the k·n indices, not the words, cross
    between devices)."""
    if reps.numel() == 0:
        return torch.zeros(bloom_words.shape[:-1] + (0,), dtype=torch.bool,
                           device=bloom_words.device)
    idx = bit_indices(reps, m, k)
    idx = to_host(idx) if bloom_words.device.type == "cpu" else idx.to(bloom_words.device)
    idx = idx.long()
    bits = (bloom_words[..., idx >> 6] >> (idx & 63)) & 1  # [..., k, n]
    return bits.bool().all(dim=-2)
