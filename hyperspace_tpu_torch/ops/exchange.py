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
  shard, D and cap; every column is moved into a ``[D, cap]`` buffer at
  ``(bucket % D, stable rank within that destination)``, the invalid rows
  dropped and each destination's tail zero. Returns the count a
  destination and the buffers. A count past ``cap`` raises
  ``ValueError`` (the kernel sets a flag; the plain version checks the
  counts).
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

The kernels are one stable counting sort over tiles of :data:`TILE_ROWS`
rows in three launches a pass: ``tile_hist`` (a tile's count a digit,
written digit-major), ``tile_scan`` (a block a digit scans its tile
counts) and ``rank_move`` (a tile's stable ranks in shared memory, then
each column staged in digit order and stored a digit's run at a time;
B8a's blocks past the last tile zero the tails). B8b over more than
:data:`MAX_DIGITS` digits (num_buckets + 1) takes two such passes, the
key's low :data:`DIGIT_BITS` bits and then its high bits: :func:`plan`
chooses the route by the digit count alone. :func:`pack_model` and
:func:`order_model` are the plain model of those steps (CPU tests hold
them to the plain versions).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError

#: launch sequences of B8a (:func:`pack_kernel`) on CUDA tensors
pack_launches = 0
#: launch sequences of B8b (:func:`order_kernel`) on CUDA tensors
order_launches = 0

#: the kernels' shape, shared with ``csrc/bucket_exchange.cu`` (a CPU test
#: reads them there): tiles of TILE_ROWS rows, a block of THREADS threads
#: each, a warp's contiguous stretch of WARP_ROWS rows; one pass takes at
#: most MAX_DIGITS digits (its shared memory), more take two passes of
#: DIGIT_BITS bits each; a rank_move launch moves at most MAX_COLS columns.
TILE_ROWS = 4096
THREADS = 256
WARPS = THREADS // 32
WARP_ROWS = TILE_ROWS // WARPS
DIGIT_BITS = 12
MAX_DIGITS = 1 << DIGIT_BITS
MAX_COLS = 16

_ERR_OVERFLOW, _ERR_DIGIT = 1, 2


class Plan(NamedTuple):
    """A call's route and the scratch its kernel needs."""

    route: str  #: "one_digit" or "two_digit"
    tiles: int  #: blocks of tile_hist and rank_move's tiles
    passes: Tuple[Tuple[str, int], ...]  #: (mode, digits) of each pass
    hist_entries: int  #: int32 tile counts, digit-major
    totals_entries: int  #: int64 totals a digit
    zero_blocks: int  #: B8a's rank_move blocks past the last tile
    keys_entries: int  #: int32 keys the low pass moves (two_digit)


def route(digits: int) -> str:
    """The route of a sort over ``digits`` digits."""
    return "one_digit" if digits <= MAX_DIGITS else "two_digit"


def plan(n: int, digits: int, D: int = 0, cap: int = 0) -> Plan:
    """The route and scratch of a call over n rows and ``digits`` digits
    (B8a: D + 1 digits, with D and cap; B8b: num_buckets + 1), as
    ``csrc/bucket_exchange.cu`` takes them. Raises ``ValueError`` for more
    digits than two passes hold, or more shards than one."""
    n, digits = int(n), int(digits)
    tiles = -(-n // TILE_ROWS)
    if D and digits > MAX_DIGITS:
        raise ValueError(f"pack takes at most {MAX_DIGITS - 1} shards on the card, got {D}")
    if route(digits) == "one_digit":
        passes = (("pack" if D else "order", digits),)
    else:
        high = ((digits - 1) >> DIGIT_BITS) + 1
        if high > MAX_DIGITS:
            raise ValueError(f"order takes fewer than {MAX_DIGITS ** 2} buckets on the card, "
                             f"got {digits - 1}")
        passes = (("low", MAX_DIGITS), ("high", high))
    width = max(d for _, d in passes)
    return Plan(
        route=route(digits),
        tiles=tiles,
        passes=passes,
        hist_entries=tiles * width,
        totals_entries=width,
        zero_blocks=-(-int(D) * int(cap) // TILE_ROWS) if D else 0,
        keys_entries=n if len(passes) == 2 else 0,
    )


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


# ---------------------------------------------------------------------------
# The plain model of the kernel's steps
# ---------------------------------------------------------------------------


def _keys_model(mode: str, bucket: torch.Tensor, valid: Optional[torch.Tensor],
                arg: int) -> torch.Tensor:
    """``key_of``: a row's int64 key (pack: destination, D if invalid;
    order and low: bucket, num_buckets if invalid; high: the moved key).
    An id out of range raises, as the kernel's error word does."""
    b = bucket.to(torch.int64)
    if mode == "high":
        return b
    bad = valid & (b < 0) if mode == "pack" else valid & ((b < 0) | (b >= arg))
    if bool(bad.any()):
        raise ValueError(f"bucket exchange {'pack' if mode == 'pack' else 'order'}: "
                         "a bucket id out of range")
    return torch.where(valid, b % arg if mode == "pack" else b, arg)


def _digits_model(mode: str, key: torch.Tensor) -> torch.Tensor:
    if mode == "low":
        return key & (MAX_DIGITS - 1)
    if mode == "high":
        return key >> DIGIT_BITS
    return key


def _pass_model(digit: torch.Tensor, digits: int) -> dict:
    """One pass's steps over the rows' digits: ``tile_hist`` (hist
    [digits, tiles], digit-major), ``tile_scan`` (its exclusive scan over
    tiles, the totals) and ``rank_move``'s ranks: a row's stable rank
    among its digit in its warp's stretch, the scan across the tile's
    warps, the tile's run starts, the row's place in the tile (``lpos``,
    a permutation of each tile) and its rank within its digit over the
    whole input (``rank``)."""
    n = digit.numel()
    tiles = -(-n // TILE_ROWS)
    row = torch.arange(n)
    tile, warp = row // TILE_ROWS, (row % TILE_ROWS) // WARP_ROWS
    hist = torch.bincount(digit * tiles + tile, minlength=digits * tiles).view(digits, tiles)
    prefix = torch.cumsum(hist, 1) - hist
    totals = hist.sum(1)
    group = (tile * WARPS + warp) * digits + digit
    cnt = torch.bincount(group, minlength=tiles * WARPS * digits)
    first = torch.cumsum(cnt, 0) - cnt
    by_group = torch.sort(group, stable=True).indices
    in_warp = torch.empty(n, dtype=torch.int64)
    in_warp[by_group] = torch.arange(n) - first[group[by_group]]
    cnt = cnt.view(tiles, WARPS, digits)
    woff = torch.cumsum(cnt, 1) - cnt
    tcount = cnt.sum(1)
    tstart = torch.cumsum(tcount, 1) - tcount
    lpos = tstart[tile, digit] + woff[tile, warp, digit] + in_warp
    rank = prefix[digit, tile] + lpos - tstart[tile, digit]
    return {"hist": hist, "prefix": prefix, "totals": totals, "lpos": lpos, "rank": rank}


def _move_model(cols: Sequence[torch.Tensor], pos: torch.Tensor, keep: torch.Tensor,
                size: int) -> List[torch.Tensor]:
    """``move_column``: every kept row's value at its position, over a
    buffer of ``size`` slots filled with a pattern that no slot should
    keep."""
    out = []
    for c in cols:
        buf = torch.empty(size, dtype=c.dtype)
        buf.view(torch.uint8).fill_(0xA5)
        buf[pos[keep]] = c[keep]
        out.append(buf)
    return out


def pack_tail_ranges(totals: torch.Tensor, D: int, cap: int) -> List[Tuple[int, int]]:
    """The slot ranges B8a's zero blocks clear: block z covers slots
    [z * TILE_ROWS, (z + 1) * TILE_ROWS) of the flat [D * cap] buffer and
    zeroes those of each destination d at or past its count."""
    out = []
    slots = D * cap
    for z in range(-(-slots // TILE_ROWS)):
        lo, hi = z * TILE_ROWS, min((z + 1) * TILE_ROWS, slots)
        d = lo // cap
        while d < D and d * cap < hi:
            a = max(lo, d * cap + min(int(totals[d]), cap))
            b = min(hi, (d + 1) * cap)
            if a < b:
                out.append((a, b))
            d += 1
    return out


def pack_model(
    bucket: torch.Tensor, valid: torch.Tensor, D: int, cap: int,
    cols: Sequence[torch.Tensor], trace: Optional[dict] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain model of B8a's kernel, step by step (:func:`_pass_model`,
    :func:`pack_tail_ranges`); equal to :func:`pack_torch`. ``trace``, a
    dict, receives the plan, the pass's steps, the positions and the
    count of writes a slot (1 everywhere: positions and tails cover
    [D, cap] once)."""
    n = _check(bucket, valid, cols)
    p = plan(n, D + 1, D, cap)
    key = _keys_model("pack", bucket, valid, D)
    steps = _pass_model(key, D + 1)
    totals = steps["totals"]
    if bool((totals[:D] > cap).any()):
        raise ValueError(f"exchange slot overflow: a destination has more than {cap} rows")
    keep = key < D
    pos = key * cap + steps["rank"]
    out = _move_model(cols, pos, keep, D * cap)
    tails = pack_tail_ranges(totals, D, cap)
    written = torch.zeros(D * cap, dtype=torch.int64)
    written.index_add_(0, pos[keep], torch.ones(int(keep.sum()), dtype=torch.int64))
    for a, b in tails:
        written[a:b] += 1
        for buf in out:
            buf[a:b] = 0
    if trace is not None:
        trace.update(plan=p, steps=steps, positions=pos[keep], tails=tails, written=written)
    return totals[:D].clone(), [buf.view(D, cap) for buf in out]


def order_model(
    bucket: torch.Tensor, valid: torch.Tensor, num_buckets: int,
    cols: Sequence[torch.Tensor], trace: Optional[dict] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain model of B8b's kernel: one pass over num_buckets + 1 digits,
    or, past :data:`MAX_DIGITS`, the low pass (moving the columns and the
    keys) and the high pass over the moved keys; equal to
    :func:`order_torch`. ``trace`` receives the plan and each pass's
    steps."""
    n = _check(bucket, valid, cols)
    p = plan(n, num_buckets + 1)
    key = _keys_model("order", bucket, valid, num_buckets)
    count = torch.tensor([n - int((key == num_buckets).sum())], dtype=torch.int64)
    cols, passes = list(cols), []
    for mode, digits in p.passes:
        if len(p.passes) == 2 and mode == "low":
            cols = cols + [key.to(torch.int32)]
        digit = _digits_model(mode, key)
        steps = _pass_model(digit, digits)
        starts = torch.cumsum(steps["totals"], 0) - steps["totals"]
        pos = starts[digit] + steps["rank"]
        cols = _move_model(cols, pos, torch.ones(n, dtype=torch.bool), n)
        if mode == "low":
            key = _keys_model("high", cols.pop(), None, num_buckets)
        passes.append(steps)
    if trace is not None:
        trace.update(plan=p, passes=passes)
    return cols, count


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


@functools.cache
def _kernel_fns():
    from hyperspace_tpu_torch import kernels

    return bind(kernels.load("bucket_exchange"))


def bind(lib: ctypes.CDLL) -> dict:
    """The C functions of a library built from ``csrc/bucket_exchange.cu``,
    with their argument types, by name."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    pp, ip = ctypes.POINTER(p), ctypes.POINTER(i32)
    fns = {
        # bucket, valid, n, D, cap, hist, totals, err, stream
        "pack_count": (lib.hs_exchange_pack_count, [p, p, i64, i32, i64, p, p, p, p]),
        # bucket, valid, n, D, cap, hist, totals, ncols, srcs, dsts, sizes, stream
        "pack_move": (lib.hs_exchange_pack_move, [p, p, i64, i32, i64, p, p, i32, pp, pp, ip, p]),
        # bucket, valid, n, num_buckets, hist, totals, err, count, stream
        "order_count": (lib.hs_exchange_order_count, [p, p, i64, i32, p, p, p, p, p]),
        # bucket, valid, n, num_buckets, hist, totals, err, keys, tmps, ncols,
        # srcs, dsts, sizes, stream
        "order_move": (lib.hs_exchange_order_move,
                       [p, p, i64, i32, p, p, p, p, pp, i32, pp, pp, ip, p]),
    }
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = i32
    return {name: fn for name, (fn, _) in fns.items()}


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])


def _column_args(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor]):
    k = len(srcs)
    return (
        k,
        _pointers(srcs),
        _pointers(dsts),
        (ctypes.c_int * max(k, 1))(*[c.element_size() for c in srcs]),
    )


def _cuda_inputs(bucket, valid, cols, name: str):
    if bucket.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {bucket.device}")
    for t in (bucket, valid, *cols):
        if not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"bucket exchange {what} launch failed: CUDA error {code}")


class ErrorWord(NamedTuple):
    """A call's error word, copied to pinned host memory once its counts
    are done (before ``rank_move``), and the event that copy ends at."""

    host: torch.Tensor
    ready: torch.cuda.Event


def _copy_back(err: torch.Tensor) -> ErrorWord:
    host = torch.empty(err.shape, dtype=err.dtype, pin_memory=True)
    host.copy_(err, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return ErrorWord(host, ready)


def _check_flag(word: ErrorWord, what: str, cap: int = 0) -> None:
    word.ready.synchronize()
    flag = int(word.host[0])
    if flag & _ERR_OVERFLOW:
        raise ValueError(f"exchange slot overflow: a destination has more than {cap} rows")
    if flag & _ERR_DIGIT:
        raise ValueError(f"bucket exchange {what}: a bucket id out of range")


def pack_launch(
    bucket: torch.Tensor, valid: torch.Tensor, D: int, cap: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor], ErrorWord]:
    """B8a's launches on the current stream, unchecked and uncounted:
    ``(counts, buffers, error word)``; the error word is copied back
    between the counts and the moves. :func:`pack_kernel` is this, the
    check of the error word and the count."""
    n = _check(bucket, valid, cols)
    _cuda_inputs(bucket, valid, cols, "pack_kernel")
    if D < 1 or cap < 1:
        raise ValueError(f"pack needs D >= 1 and cap >= 1, got {D}, {cap}")
    p = plan(n, D + 1, D, cap)
    dev = bucket.device
    fns = _kernel_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = [torch.empty((D, cap), dtype=c.dtype, device=dev) for c in cols]
        hist = torch.empty(max(p.hist_entries, 1), dtype=torch.int32, device=dev)
        totals = torch.empty(p.totals_entries, dtype=torch.int64, device=dev)
        err = torch.zeros(2, dtype=torch.int64, device=dev)
        rows = (bucket.data_ptr(), valid.data_ptr(), n, D, cap, hist.data_ptr(),
                totals.data_ptr())
        _raise_on(fns["pack_count"](*rows, err.data_ptr(), stream), "pack")
        word = _copy_back(err)
        _raise_on(fns["pack_move"](*rows, *_column_args(cols, out), stream), "pack")
    return totals[:D], out, word


def pack_kernel(
    bucket: torch.Tensor, valid: torch.Tensor, D: int, cap: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """B8a on the card: tile_hist and tile_scan, the error word's copy,
    rank_move (the columns and the zero tails) on the current stream, and
    the word's one read while rank_move runs."""
    global pack_launches
    counts, out, word = pack_launch(bucket, valid, D, cap, cols)
    pack_launches += 1
    _check_flag(word, "pack", cap)
    return counts, out


def order_launch(
    bucket: torch.Tensor, valid: torch.Tensor, num_buckets: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[List[torch.Tensor], torch.Tensor, Optional[ErrorWord]]:
    """B8b's launches on the current stream, unchecked and uncounted:
    ``(ordered columns, count, error word)``; no launch and no error word
    for 0 rows. :func:`order_kernel` is this, the check of the error word
    and the count."""
    n = _check(bucket, valid, cols)
    _cuda_inputs(bucket, valid, cols, "order_kernel")
    if num_buckets < 1:
        raise ValueError(f"order needs num_buckets >= 1, got {num_buckets}")
    p = plan(n, num_buckets + 1)
    dev = bucket.device
    out = [torch.empty_like(c) for c in cols]
    if n == 0:
        return out, torch.zeros(1, dtype=torch.int64, device=dev), None
    fns = _kernel_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        hist = torch.empty(p.hist_entries, dtype=torch.int32, device=dev)
        totals = torch.empty(p.totals_entries, dtype=torch.int64, device=dev)
        err = torch.zeros(2, dtype=torch.int64, device=dev)
        count = torch.empty(1, dtype=torch.int64, device=dev)
        keys, tmps = None, []
        if p.keys_entries:
            keys = torch.empty(p.keys_entries, dtype=torch.int32, device=dev)
            tmps = [torch.empty_like(c) for c in cols]
        rows = (bucket.data_ptr(), valid.data_ptr(), n, num_buckets, hist.data_ptr(),
                totals.data_ptr(), err.data_ptr())
        _raise_on(fns["order_count"](*rows, count.data_ptr(), stream), "order")
        word = _copy_back(err)
        _raise_on(fns["order_move"](
            *rows, keys.data_ptr() if keys is not None else None,
            _pointers(tmps) if keys is not None else None, *_column_args(cols, out), stream,
        ), "order")
    return out, count, word


def order_kernel(
    bucket: torch.Tensor, valid: torch.Tensor, num_buckets: int,
    cols: Sequence[torch.Tensor],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """B8b on the card: tile_hist and tile_scan, the error word's copy,
    rank_move on the current stream (past MAX_DIGITS digits, the high
    pass's three launches after it), and the word's one read while the
    moves run."""
    global order_launches
    out, count, word = order_launch(bucket, valid, num_buckets, cols)
    if word is None:
        return out, count
    order_launches += 1
    _check_flag(word, "order")
    return out, count


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
