"""The bucket exchange of the sharded build: pack (kernel B8a) and order
(kernel B8b).

Counterpart of the body of ``hyperspace_tpu/parallel/shuffle.py::
_flat_program`` (:306-365), the flat strategy's ``shard_map``: each source
shard scatters its rows into a ``[D, cap]`` buffer a column, the buffers
cross the mesh, and each destination shard orders its ``D * cap`` received
slots by bucket with the invalid slots last. The crossing is a copy
(``parallel/shuffle.py``); the two stable sorts around it are
``csrc/bucket_exchange.cu``, written by hand for Hopper.

* :func:`pack` — B8a: ``bucket`` [n] int32 and ``valid`` [n] bool of one
  shard, D and cap; every column is scattered into a zeroed ``[D, cap]``
  buffer at ``(bucket % D, stable rank within that destination)``, the
  invalid rows dropped. Returns the count a destination and the buffers.
  A rank that reaches ``cap`` raises ``ValueError`` (the kernel sets a
  flag; the plain version checks the counts).
* :func:`order` — B8b: ``bucket`` and ``valid`` [m] of one shard's
  received slots; every column in the stable order by bucket with the
  invalid slots last. Returns the ordered columns and the count of valid
  rows (the ordered columns' first rows).

A CPU tensor takes the plain version (:func:`pack_torch`,
:func:`order_torch`: stable ``argsort``, ``bincount`` and indexing, as
``_flat_program`` does); a CUDA tensor launches the kernel, one launch
sequence a call counted once in :data:`pack_launches` /
:data:`order_launches`, or raises. Columns of 1, 2, 4 and 8 bytes go
through the kernels as raw bits, so every type (bool included) comes out
bit-equal.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError

#: launch sequences of B8a (:func:`pack_kernel`) on CUDA tensors
pack_launches = 0
#: launch sequences of B8b (:func:`order_kernel`) on CUDA tensors
order_launches = 0

_ERR_OVERFLOW, _ERR_DIGIT = 1, 2


def _check(bucket: torch.Tensor, valid: torch.Tensor, cols: Sequence[torch.Tensor]) -> int:
    if bucket.dim() != 1 or bucket.dtype != torch.int32:
        raise ValueError(f"bucket must be [n] int32, got {tuple(bucket.shape)} {bucket.dtype}")
    n = bucket.shape[0]
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be [{n}] bool, got {tuple(valid.shape)} {valid.dtype}")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: a shard takes fewer than 2^31")
    for c in [valid, *cols]:
        if c.device != bucket.device:
            raise ValueError(f"a column on {c.device}, bucket on {bucket.device}")
    for j, c in enumerate(cols):
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"column {j} must be [{n}], got {tuple(c.shape)}")
        if c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"column {j}: {c.element_size()}-byte elements")
    return n


def pack_torch(
    bucket: torch.Tensor, valid: torch.Tensor, D: int, cap: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of B8a: ``(counts [D] int64, [D, cap]
    buffers)``."""
    n = _check(bucket, valid, cols)
    dest = torch.where(valid, bucket.to(torch.int64) % D, D)
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    counts = torch.bincount(dest_s, minlength=D + 1)
    if n and int(counts[:D].max()) > cap:
        raise ValueError(f"exchange slot overflow: a destination has more than {cap} rows")
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=bucket.device) - offsets[dest_s]
    keep = dest_s < D
    slot = dest_s[keep] * cap + rank[keep]
    out = []
    for c in cols:
        buf = torch.zeros(D * cap, dtype=c.dtype, device=c.device)
        buf[slot] = c[order][keep]
        out.append(buf.view(D, cap))
    return counts[:D], out


def order_torch(
    bucket: torch.Tensor, valid: torch.Tensor, num_buckets: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of B8b: ``(ordered columns, count [1]
    int64)``."""
    _check(bucket, valid, cols)
    key = torch.where(valid, bucket, num_buckets)
    perm = torch.sort(key, stable=True).indices
    return [c[perm] for c in cols], valid.sum(dtype=torch.int64).reshape(1)


@functools.cache
def _kernel_fns():
    from hyperspace_tpu_torch import kernels

    return bind(kernels.load("bucket_exchange"))


def bind(lib: ctypes.CDLL) -> dict:
    """The C functions of a library built from ``csrc/bucket_exchange.cu``,
    with their argument types, by name."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    pp, ip = ctypes.POINTER(p), ctypes.POINTER(i32)
    tile = lib.hs_exchange_tile_rows
    tile.argtypes = []
    tile.restype = i64
    pack = lib.hs_exchange_pack
    # bucket, valid, n, D, cap, hist, totals, pos, err, ncols, srcs, dsts,
    # sizes, stream
    pack.argtypes = [p, p, i64, i32, i64, p, p, p, p, i32, pp, pp, ip, p]
    pack.restype = i32
    order = lib.hs_exchange_order
    # bucket, valid, n, num_buckets, hist, totals, starts, pos, err, ncols,
    # srcs, dsts, sizes, stream
    order.argtypes = [p, p, i64, i32, p, p, p, p, p, i32, pp, pp, ip, p]
    order.restype = i32
    return {"tile": tile, "pack": pack, "order": order}


def _column_args(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor]):
    k = len(srcs)
    return (
        k,
        (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in srcs]),
        (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in dsts]),
        (ctypes.c_int * max(k, 1))(*[c.element_size() for c in srcs]),
    )


def _cuda_inputs(bucket, valid, cols, name: str):
    if bucket.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {bucket.device}")
    for t in (bucket, valid, *cols):
        if not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous")


def _scratch(n: int, digits: int, dev) -> dict:
    tiles = -(-n // _kernel_fns()["tile"]())
    return {
        "hist": torch.empty(tiles * digits, dtype=torch.int32, device=dev),
        "totals": torch.empty(digits, dtype=torch.int64, device=dev),
        "pos": torch.empty(n, dtype=torch.int64, device=dev),
        "err": torch.zeros(1, dtype=torch.int32, device=dev),
    }


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"bucket exchange {what} launch failed: CUDA error {code}")


def _check_flag(err: torch.Tensor, what: str, cap: int = 0) -> None:
    flag = int(err.item())
    if flag & _ERR_OVERFLOW:
        raise ValueError(f"exchange slot overflow: a destination has more than {cap} rows")
    if flag & _ERR_DIGIT:
        raise ValueError(f"bucket exchange {what}: a bucket id out of range")


def pack_kernel(
    bucket: torch.Tensor, valid: torch.Tensor, D: int, cap: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """B8a on the card: hist, scan, rank and one scatter a column on the
    current stream, then one read of the error word."""
    global pack_launches
    n = _check(bucket, valid, cols)
    _cuda_inputs(bucket, valid, cols, "pack_kernel")
    if D < 1 or cap < 1:
        raise ValueError(f"pack needs D >= 1 and cap >= 1, got {D}, {cap}")
    dev = bucket.device
    out = [torch.zeros((D, cap), dtype=c.dtype, device=dev) for c in cols]
    if n == 0:
        return torch.zeros(D, dtype=torch.int64, device=dev), out
    with torch.cuda.device(dev):
        s = _scratch(n, D + 1, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _kernel_fns()["pack"](
            bucket.data_ptr(), valid.data_ptr(), n, D, cap, s["hist"].data_ptr(),
            s["totals"].data_ptr(), s["pos"].data_ptr(), s["err"].data_ptr(),
            *_column_args(cols, out), stream,
        )
        _raise_on(code, "pack")
        pack_launches += 1
        _check_flag(s["err"], "pack", cap)
    return s["totals"][:D], out


def order_kernel(
    bucket: torch.Tensor, valid: torch.Tensor, num_buckets: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """B8b on the card: hist, scan, starts, rank and one scatter a column
    on the current stream, then one read of the error word."""
    global order_launches
    n = _check(bucket, valid, cols)
    _cuda_inputs(bucket, valid, cols, "order_kernel")
    if num_buckets < 1:
        raise ValueError(f"order needs num_buckets >= 1, got {num_buckets}")
    dev = bucket.device
    out = [torch.empty_like(c) for c in cols]
    if n == 0:
        return out, torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        s = _scratch(n, num_buckets + 1, dev)
        starts = torch.empty(num_buckets + 2, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _kernel_fns()["order"](
            bucket.data_ptr(), valid.data_ptr(), n, num_buckets, s["hist"].data_ptr(),
            s["totals"].data_ptr(), starts.data_ptr(), s["pos"].data_ptr(),
            s["err"].data_ptr(), *_column_args(cols, out), stream,
        )
        _raise_on(code, "order")
        order_launches += 1
        _check_flag(s["err"], "order")
    return out, starts[num_buckets : num_buckets + 1]


def pack(
    bucket: torch.Tensor, valid: torch.Tensor, D: int, cap: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """B8a: the plain version for CPU tensors, the kernel for CUDA ones."""
    if bucket.device.type == "cpu":
        return pack_torch(bucket, valid, D, cap, cols)
    if bucket.device.type == "cuda":
        return pack_kernel(bucket, valid, D, cap, cols)
    raise ValueError(f"pack: unsupported device {bucket.device}")


def order(
    bucket: torch.Tensor, valid: torch.Tensor, num_buckets: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """B8b: the plain version for CPU tensors, the kernel for CUDA ones."""
    if bucket.device.type == "cpu":
        return order_torch(bucket, valid, num_buckets, cols)
    if bucket.device.type == "cuda":
        return order_kernel(bucket, valid, num_buckets, cols)
    raise ValueError(f"order: unsupported device {bucket.device}")
