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
* The build takes one of three routes, chosen by m alone
  (:func:`build_plan`), the first two setting the bits in shared memory:
  ``block`` (a filter of at most :data:`BLOCK_MAX_BITS`: one block holds
  it all, one partial filter a block, ORed into the output), ``binned``
  (at most :data:`BINNED_MAX_BITS`: each tile's indices sorted by 8 KiB
  slice into scratch this module allocates, then each slice built in
  shared memory, a few copies ORed into the output) and ``global`` (a
  larger filter: global atomics). :func:`build_bloom_routes_torch` is the
  plain model of the two shared-memory routes, copy by copy. Each route
  counts its launches (:data:`block_launches`, :data:`binned_launches`,
  :data:`global_launches`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError
from hyperspace_tpu_torch.ops.hash import _M32, hash_words_torch

SEED1 = 0x9747B28C
SEED2 = 0x85EBCA6B
#: the largest m the int32 indices can address
MAX_BITS = 1 << 31

#: the build's routes, shared with ``csrc/bloom_bits.cu`` (a CPU test
#: reads them there). block: filters of at most BLOCK_MAX_BITS bits, one
#: block of BLOCK_THREADS threads for each ROWS_PER_BLOCK rows, at most
#: what the card holds at once. binned: filters of at most BINNED_MAX_BITS
#: bits, slices of 2^SLICE_SHIFT bits; tiles of TILE_ROWS rows and at most
#: CHUNK indices a row, TILE_ENTRIES 16-bit entries of scratch each, then
#: slices + 1 16-bit offsets each; BIN_THREADS threads a block. Larger
#: filters take the global route.
BLOCK_MAX_BITS = 1 << 20
BLOCK_THREADS = 512
ROWS_PER_BLOCK = 4096
BINNED_MAX_BITS = 1 << 24
SLICE_SHIFT = 16
BIN_THREADS = 512
TILE_ROWS = 2 * BIN_THREADS
CHUNK = 8
TILE_ENTRIES = TILE_ROWS * CHUNK
ROUTES = ("block", "binned", "global")

#: kernel launches made by the wrappers (never by the plain versions)
launches = 0
#: the build's calls that launched, by route (each also counted in
#: ``launches``)
block_launches = binned_launches = global_launches = 0


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


class BuildPlan(NamedTuple):
    """The build's route for one call and its launch shape."""

    route: str  #: "block", "binned" or "global"
    block_bits: int  #: bits a block holds (the filter, or a slice; 0 on the global route)
    partials: int  #: copies ORed into each output word
    scratch_bytes: int  #: device scratch the call needs (binned)


def build_route(m: int) -> str:
    """The build's route for a filter of m bits."""
    m = int(m)
    return "block" if m <= BLOCK_MAX_BITS else "binned" if m <= BINNED_MAX_BITS else "global"


def build_plan(m: int, n: int, k: int, resident: int) -> BuildPlan:
    """The build's plan for n reps into a filter of m bits, k indices a
    rep, as ``csrc/bloom_bits.cu`` computes it; ``resident`` is the
    blocks of the route's kernel the card holds at once
    (:func:`kernel_build_plan` reads it on the card). The block route
    launches one block for each ROWS_PER_BLOCK rows, at most ``resident``;
    the binned route launches ``resident`` blocks, so each slice has
    resident // slices copies (at least 1)."""
    m, n, k, resident = int(m), int(n), int(k), int(resident)
    route = build_route(m)
    if route == "global":
        return BuildPlan(route, 0, 0, 0)
    if route == "block":
        return BuildPlan(route, m, min(-(-n // ROWS_PER_BLOCK), resident), 0)
    slices = -(-m >> SLICE_SHIFT)
    tiles = -(-n // TILE_ROWS) * -(-k // CHUNK)
    scratch = tiles * TILE_ENTRIES * 2 + -(-tiles * (slices + 1) * 2 // 16) * 16
    return BuildPlan(route, 1 << SLICE_SHIFT, max(resident // slices, 1), scratch)


def build_bloom_routes_torch(reps: torch.Tensor, m: int, k: int,
                             resident: int) -> torch.Tensor:
    """Plain model of the build's shared-memory routes, copy by copy:
    [m / 64] packed words (int64 holding the uint64 bits), equal to
    :func:`build_bloom_torch`'s.

    * block: the kernel's grid-stride loop gives row r to block
      (r // BLOCK_THREADS) mod partials; each block sets its rows' bits in
      its own copy of the filter, and the copies are ORed.
    * binned: tile t holds rows [t // chunks * TILE_ROWS, + TILE_ROWS) and
      their indices j in [CHUNK * (t % chunks), + CHUNK); slice s's copy
      p < partials takes the tiles t = p mod partials and sets each entry
      (idx mod 2^SLICE_SHIFT) of the slice; the copies of each slice are
      ORed, the slices laid end to end."""
    _check(reps, m, k, build=True)
    m, k, n = int(m), int(k), reps.shape[0]
    plan = build_plan(m, n, k, resident)
    if plan.route == "global":
        raise ValueError(f"m = {m} takes the global route, which holds no copy in shared memory")
    shifts = torch.arange(64, dtype=torch.int64, device=reps.device)
    if n == 0:
        return torch.zeros(m // 64, dtype=torch.int64, device=reps.device)
    idx = bit_indices_torch(reps, m, k).long()  # [k, n]
    rows = torch.arange(n, device=reps.device)
    if plan.route == "block":
        copies = torch.zeros((plan.partials, m), dtype=torch.bool, device=reps.device)
        block = (rows // BLOCK_THREADS) % plan.partials
        copies[block.expand(k, n).reshape(-1), idx.reshape(-1)] = True
        filt = copies.any(dim=0)
    else:
        chunks = -(-k // CHUNK)
        tile = (rows // TILE_ROWS)[None, :] * chunks + (
            torch.arange(k, device=reps.device) // CHUNK)[:, None]  # [k, n]
        slices = -(-m >> SLICE_SHIFT)
        copies = torch.zeros((slices, plan.partials, 1 << SLICE_SHIFT), dtype=torch.bool,
                             device=reps.device)
        copies[(idx >> SLICE_SHIFT).reshape(-1), (tile % plan.partials).reshape(-1),
               (idx & ((1 << SLICE_SHIFT) - 1)).reshape(-1)] = True
        filt = copies.any(dim=1).reshape(-1)[:m]
    return (filt.view(m // 64, 64).to(torch.int64) << shifts).sum(dim=1)


@functools.cache
def _kernel_fns():
    from hyperspace_tpu_torch import kernels

    lib = kernels.load("bloom_bits")
    indices, build, plan = lib.hs_bloom_bit_indices, lib.hs_bloom_build, lib.hs_bloom_build_plan
    indices.argtypes = [
        ctypes.c_void_p,  # reps
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # n
        ctypes.c_int64,  # m
        ctypes.c_int,  # k
        ctypes.c_void_p,  # stream
    ]
    build.argtypes = [
        ctypes.c_void_p,  # reps
        ctypes.c_void_p,  # words
        ctypes.c_void_p,  # scratch
        ctypes.c_int64,  # scratch bytes
        ctypes.c_int64,  # n
        ctypes.c_int64,  # m
        ctypes.c_int,  # k
        ctypes.c_void_p,  # stream
    ]
    plan.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                     ctypes.POINTER(ctypes.c_int64)]
    for fn in (indices, build, plan):
        fn.restype = ctypes.c_int
    return indices, build, plan


def kernel_build_plan(n: int, m: int, k: int, device=None) -> Tuple[BuildPlan, int]:
    """The build's plan as ``hs_bloom_build`` computes it on the card
    (``device``, default the current one), and the route's blocks the
    card holds at once (0 on the global route): what a test holds
    :func:`build_plan` against."""
    out = (ctypes.c_int64 * 5)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = _kernel_fns()[2](int(n), int(m), int(k), out)
    if err != 0:
        raise KernelLaunchError(f"Bloom build plan failed: CUDA error {err}")
    route, block_words, partials, scratch, resident = list(out)
    return BuildPlan(ROUTES[route], 32 * block_words, partials, scratch), resident


def _launch(entry: int, reps: torch.Tensor, out: torch.Tensor, m: int, k: int) -> None:
    """Hand contiguous CUDA reps and the output to C entry ``entry`` (0:
    indices, 1: build, with the scratch its plan needs) on the current
    stream; raise on any error code it returns."""
    global launches, block_launches, binned_launches, global_launches
    if reps.device.type != "cuda":
        raise ValueError(f"the B7 kernel needs a CUDA tensor, got {reps.device}")
    if not reps.is_contiguous():
        raise ValueError("reps must be contiguous")
    n = reps.shape[0]
    route = build_route(m) if entry == 1 else None
    with torch.cuda.device(reps.device):
        stream = torch.cuda.current_stream(reps.device).cuda_stream
        if entry == 0:
            err = _kernel_fns()[0](reps.data_ptr(), out.data_ptr(), n, int(m), int(k), stream)
        else:
            need = build_plan(m, n, k, 0).scratch_bytes
            scratch = torch.empty(need, dtype=torch.uint8, device=reps.device)
            err = _kernel_fns()[1](reps.data_ptr(), out.data_ptr(), scratch.data_ptr(), need, n,
                                   int(m), int(k), stream)
    if err != 0:
        raise KernelLaunchError(f"Bloom bit-index kernel launch failed: CUDA error {err}")
    if n:  # the C side launches nothing for n = 0
        launches += 1
        if route == "block":
            block_launches += 1
        elif route == "binned":
            binned_launches += 1
        elif route == "global":
            global_launches += 1


def bit_indices_kernel(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Launch ``hs_bloom_bit_indices``: [n] int64 CUDA reps -> [k, n]
    int32 bit indices."""
    _check(reps, m, k)
    out = torch.empty((int(k), reps.shape[0]), dtype=torch.int32, device=reps.device)
    _launch(0, reps, out, m, k)
    return out


def build_bloom_kernel(reps: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Launch ``hs_bloom_build``: [n] int64 CUDA reps -> the filter's
    [m / 64] packed words (int64 holding the uint64 bits), by the route m
    gives (:func:`build_plan`); the binned route's scratch is allocated
    here, the kernel allocates nothing."""
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
