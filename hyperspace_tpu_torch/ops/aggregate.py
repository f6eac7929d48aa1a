"""Grouped reductions over sorted groups — the aggregate kernel (B5).

Counterpart of ``hyperspace_tpu/ops/aggregate.py`` (``segment_sum_count``,
``segment_minmax``, ``segment_count``), with the semantics of its host
route (``_host_sum_count``, ``_host_minmax``), which the JAX executor takes
at the sizes its tests use:

* sum and count run over valid rows; integers (bool, signed, unsigned)
  sum in 64 bits with wrap-around, floats in their own type as a left
  fold in row order from +0.0 (``np.add.at``), NaN bits included: the
  first NaN the fold meets stays (a NaN value quieted, or for
  ``inf + -inf`` the x86 default NaN);
* float MIN is NaN only when the group has no valid non-NaN value; any
  valid NaN wins MAX; ties keep the later row (-0.0 against 0.0: the
  later one's sign); a group without valid rows gives ``fill``.

Groups come as the group-sorted row permutation ``perm`` (None for the
identity) and offsets ``offs`` ([G + 1], ``offs[0] = 0``, ``offs[G] = n``,
nondecreasing), as ``execution/aggregate_exec._factorize`` produces them:
group g is rows ``perm[offs[g]:offs[g + 1]]``, in row order, because the
sort is stable. ``n`` is the number of positions: ``perm``'s length, or
the values' when ``perm`` is None. A ``perm`` may select some rows only
(the fused filter-aggregate passes the rows that pass its predicate).

The float sum takes an optional ``start`` ([G], the values' type): group
g then folds its rows onto ``start[g]`` instead of +0.0, in row order,
with the same NaN rule (a NaN start stays, quieted once the group has a
row), which is how the fused filter-aggregate carries its float sums
across chunks.

Each function takes tensors on one device. On the CPU it runs the plain
PyTorch version; on CUDA it launches ``csrc/segment_reduce.cu`` or raises.
The CUDA plain versions exist for the card's checks, except the float
fold's: ``index_add_`` on CUDA adds with atomics, in no fixed order, so
that one is checked on a CPU copy.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError

#: B5 kernel launches made by the ``*_kernel`` functions (never by the plain versions)
launches = 0

# value type codes of the C interface
_I64, _U64, _F32, _F64 = 0, 1, 2, 3


def _signed(bits: int, width: int) -> int:
    return bits - (1 << width) if bits >> (width - 1) else bits


# float bit patterns: the quiet bit; the x86 default NaN, which
# ``inf + -inf`` gives; numpy's ``np.nan``
_QUIET = {torch.float64: 1 << 51, torch.float32: 1 << 22}
_DEFAULT_NAN = {torch.float64: _signed(0xFFF8000000000000, 64),
                torch.float32: _signed(0xFFC00000, 32)}
_CANONICAL_NAN = {torch.float64: 0x7FF8000000000000, torch.float32: 0x7FC00000}
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def int_fill_bits(fill, unsigned: bool) -> int:
    """An integer MIN/MAX fill as the int64 bits the reduction carries
    (uint64 fills as their two's-complement bits)."""
    return _signed(int(fill) % (1 << 64), 64) if unsigned else int(fill)


def device_values(values: np.ndarray, device) -> Tuple[torch.Tensor, bool]:
    """A column's numpy values as the tensor B5 reduces, on ``device``,
    and whether they are unsigned 64-bit: bool and integers of up to 32
    bits widen to int64 on the device, uint64 travels as its int64 bits,
    int64 and floats stay as they are."""
    if values.dtype.kind == "f" and values.dtype.itemsize < 4:
        raise ValueError(f"B5 reduces float32 and float64 columns, not {values.dtype}")
    unsigned = values.dtype == np.uint64
    if unsigned:
        values = values.view(np.int64)
    with warnings.catch_warnings():
        # read-only Arrow buffers: nothing here writes a tensor in place
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(np.ascontiguousarray(values))
    t = t.to(torch.device(device))
    if t.dtype not in (torch.int64, torch.float32, torch.float64):
        t = t.to(torch.int64)
    return t, unsigned


def _positions(perm, vals) -> int:
    return perm.numel() if perm is not None else vals.numel()


def _positions_gid(offs: torch.Tensor, n: int) -> torch.Tensor:
    """Group id of each position of the group-sorted order."""
    lengths = offs[1:] - offs[:-1]
    g = torch.arange(lengths.numel(), dtype=torch.int64, device=offs.device)
    return torch.repeat_interleave(g, lengths, output_size=n)


def _in_order(t: Optional[torch.Tensor], perm: Optional[torch.Tensor]):
    return t if t is None or perm is None else t[perm]


def _from_bits(bits: int, dtype) -> torch.Tensor:
    return torch.tensor(bits, dtype=_BITS[dtype]).view(dtype)


# -- plain versions -------------------------------------------------------------


def segment_sum_count_torch(perm, offs, vals, valid, start=None):
    """Plain version: ``index_add_`` over the rows in group order onto
    +0.0 or ``start`` (on a 1-D CPU tensor the same left fold as
    ``np.add.at``), then the NaN bits the numpy fold keeps for each group
    whose sum is NaN."""
    n, num = _positions(perm, vals), offs.numel() - 1
    gid = _positions_gid(offs, n)
    vp, ok = _in_order(vals, perm), _in_order(valid, perm)
    v = vp if ok is None else torch.where(ok, vp, torch.zeros((), dtype=vp.dtype))
    init = (torch.zeros(num, dtype=vals.dtype, device=vals.device) if start is None
            else start.clone())
    sums = init.index_add_(0, gid, v)
    if ok is None:
        counts = offs[1:] - offs[:-1]
    else:
        counts = torch.zeros(num, dtype=torch.int64, device=vals.device).index_add_(
            0, gid, ok.to(torch.int64))
    if vals.dtype.is_floating_point:
        sums = _numpy_nan_bits(sums, gid, v, ok, start, offs)
    return sums, counts


def _numpy_nan_bits(sums, gid, v, ok, start=None, offs=None):
    """The bits ``np.add.at`` leaves in each NaN sum: the first NaN event
    of the group's fold decides. A NaN start stays, quieted when the group
    has a row. Else, if a valid NaN value comes before any ``inf + -inf``
    (the fold of the start and the rows before it is not NaN), that value
    quieted; otherwise the x86 default NaN."""
    bad = torch.isnan(sums)
    if not bool(bad.any()):
        return sums
    n, dt = v.numel(), v.dtype
    isn = torch.isnan(v) if ok is None else torch.isnan(v) & ok
    pos = torch.arange(n, dtype=torch.int64, device=v.device)
    first = torch.full_like(sums, n, dtype=torch.int64).scatter_reduce_(
        0, gid[isn], pos[isn], "amin")
    before = pos < first[gid]
    init = torch.zeros_like(sums) if start is None else start.clone()
    prefix = init.index_add_(0, gid, torch.where(before, v, torch.zeros((), dtype=dt)))
    quiet = v[first.clamp(max=max(n - 1, 0))].view(_BITS[dt]) | _QUIET[dt]
    bits = torch.where((first < n) & ~torch.isnan(prefix), quiet,
                       _from_bits(_DEFAULT_NAN[dt], dt).view(_BITS[dt]))
    if start is not None:
        has_rows = offs[1:] > offs[:-1]
        start_bits = start.view(_BITS[dt])
        kept = torch.where(has_rows, start_bits | _QUIET[dt], start_bits)
        bits = torch.where(torch.isnan(start), kept, bits)
    return torch.where(bad, bits.view(dt), sums)


def segment_minmax_torch(perm, offs, vals, valid, mode, fill=None, unsigned=False):
    """Plain version: ``scatter_reduce_`` for each group's extreme value
    over the rows that take part (valid; for MIN also not NaN), then the
    last such row holding a value equal to it, whose bits are the result
    (ties keep the later row, so -0.0 against 0.0 keeps the later sign);
    then the NaN rules, or ``fill`` where no row took part."""
    n, num = _positions(perm, vals), offs.numel() - 1
    gid = _positions_gid(offs, n)
    vp, ok = _in_order(vals, perm), _in_order(valid, perm)
    flt = vals.dtype.is_floating_point
    take = torch.ones(n, dtype=torch.bool, device=vals.device) if ok is None else ok
    if flt:
        isn = torch.isnan(vp)
        nan_seen = (take & isn).to(torch.int64)
        take = take & ~isn
        fill = float("inf") if mode == "min" else float("-inf")
    else:
        fill = int_fill_bits(fill, unsigned)
    key = vp
    if unsigned:  # uint64 bits: flip the sign bit so signed order is unsigned order
        key = vp ^ torch.tensor(-(1 << 63), dtype=torch.int64)
    red = torch.empty(num, dtype=key.dtype, device=vals.device).scatter_reduce_(
        0, gid[take], key[take], "amin" if mode == "min" else "amax", include_self=False)
    pos = torch.arange(n, dtype=torch.int64, device=vals.device)
    eq = take & (key == red[gid])
    last = torch.full((num,), -1, dtype=torch.int64, device=vals.device).scatter_reduce_(
        0, gid[eq], pos[eq], "amax")
    if n:
        out = torch.where(last >= 0, vp[last.clamp(min=0)], torch.tensor(fill, dtype=vals.dtype))
    else:
        out = torch.full((num,), fill, dtype=vals.dtype, device=vals.device)
    if flt:
        nan = _from_bits(_CANONICAL_NAN[vals.dtype], vals.dtype)
        if mode == "min":
            out = torch.where(last >= 0, out, nan)
        else:
            has_nan = torch.zeros(num, dtype=torch.int64, device=vals.device).index_add_(
                0, gid, nan_seen) > 0
            out = torch.where(has_nan, nan, out)
    return out


def segment_count_torch(perm, offs, valid):
    """Plain version: valid rows per group (the group sizes when every
    row is valid)."""
    if valid is None:
        return offs[1:] - offs[:-1]
    n = _positions(perm, valid)
    gid = _positions_gid(offs, n)
    ok = _in_order(valid, perm).to(torch.int64)
    return torch.zeros(offs.numel() - 1, dtype=torch.int64, device=valid.device).index_add_(
        0, gid, ok)


# -- the kernel -----------------------------------------------------------------


@functools.cache
def _lib():
    from hyperspace_tpu_torch import kernels

    return bind(kernels.load("segment_reduce"))


def bind(lib):
    """Declare the C interface of a library built from
    ``csrc/segment_reduce.cu`` on its ctypes functions; returns ``lib``."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.hs_seg_sum_count.argtypes = [p, p, p, p, i64, i64, p, p, p, p]
    lib.hs_seg_minmax.argtypes = [p, p, p, p, i64, i64, ctypes.c_int, ctypes.c_int,
                                  i64, p, p, p]
    lib.hs_seg_fold_sum.argtypes = [p, p, p, p, i64, ctypes.c_int, p, p, p, p]
    for fn in (lib.hs_seg_sum_count, lib.hs_seg_minmax, lib.hs_seg_fold_sum):
        fn.restype = ctypes.c_int
    lib.hs_seg_scratch_bytes.argtypes = [i64]
    lib.hs_seg_scratch_bytes.restype = i64
    return lib


def _check(perm, offs, vals, valid, dtypes) -> torch.device:
    ref = vals if vals is not None else valid
    dev = offs.device
    rows = ref.numel() if ref is not None else perm.numel()
    if offs.dtype != torch.int64 or offs.dim() != 1 or offs.numel() < 1:
        raise ValueError("offs must be a [G + 1] int64 tensor")
    if perm is not None and (perm.dim() != 1 or perm.numel() > rows):
        raise ValueError(f"perm must be a [m <= {rows}] tensor")
    for name, t, want, n in (("perm", perm, (torch.int64,), _positions(perm, ref)),
                             ("vals", vals, dtypes, rows), ("valid", valid, (torch.bool,), rows)):
        if t is None:
            continue
        if t.device != dev or t.shape != (n,) or not t.is_contiguous() or t.dtype not in want:
            raise ValueError(f"{name} must be a contiguous [{n}] tensor of {want} on {dev}")
    if not offs.is_contiguous():
        raise ValueError("offs must be contiguous")
    return dev


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{what} failed: CUDA error {err}")


def _scratch(n: int, dev) -> torch.Tensor:
    return torch.empty(int(_lib().hs_seg_scratch_bytes(n)), dtype=torch.uint8, device=dev)


def _check_start(start, vals, num: int) -> None:
    if start is None:
        return
    if not vals.dtype.is_floating_point:
        raise ValueError("a start vector is for the float fold only")
    if (start.dtype != vals.dtype or start.shape != (num,) or not start.is_contiguous()
            or start.device != vals.device):
        raise ValueError(f"start must be a contiguous [{num}] {vals.dtype} tensor on {vals.device}")


def segment_sum_count_kernel(perm, offs, vals, valid, start=None):
    """B5's sum and count on CUDA tensors: integers (int64, or uint64 as
    int64 bits) by the parallel range pass, floats by the ordered fold
    (from ``start`` when given)."""
    global launches
    dev = _check(perm, offs, vals, valid, (torch.int64, torch.float32, torch.float64))
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_count_kernel needs CUDA tensors, got {dev}")
    n, num = _positions(perm, vals), offs.numel() - 1
    _check_start(start, vals, num)
    sums = torch.empty(num, dtype=vals.dtype, device=dev)
    counts = torch.empty(num, dtype=torch.int64, device=dev)
    if num == 0:
        return sums, counts
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if vals.dtype.is_floating_point:
            err = lib.hs_seg_fold_sum(_ptr(perm), offs.data_ptr(), vals.data_ptr(),
                                      _ptr(valid), num, int(vals.dtype == torch.float64),
                                      sums.data_ptr(), counts.data_ptr(), stream, _ptr(start))
            _raise_on(err, "B5 float fold")
            launches += 1
        else:
            scratch = _scratch(n, dev)
            err = lib.hs_seg_sum_count(_ptr(perm), offs.data_ptr(), vals.data_ptr(),
                                       _ptr(valid), n, num, sums.data_ptr(),
                                       counts.data_ptr(), scratch.data_ptr(), stream)
            _raise_on(err, "B5 sum/count")
            launches += 2  # range pass, fix-up
    return sums, counts


def segment_count_kernel(perm, offs, valid):
    """B5's count of valid rows on CUDA tensors (the sum/count launch
    without values)."""
    global launches
    dev = _check(perm, offs, None, valid, ())
    if dev.type != "cuda":
        raise ValueError(f"segment_count_kernel needs CUDA tensors, got {dev}")
    n, num = _positions(perm, valid), offs.numel() - 1
    counts = torch.empty(num, dtype=torch.int64, device=dev)
    if num == 0:
        return counts
    with torch.cuda.device(dev):
        scratch = _scratch(n, dev)
        err = _lib().hs_seg_sum_count(_ptr(perm), offs.data_ptr(), None, valid.data_ptr(),
                                      n, num, None, counts.data_ptr(), scratch.data_ptr(),
                                      torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "B5 count")
    launches += 2
    return counts


def _value_code(dtype, unsigned: bool) -> int:
    if dtype == torch.float64:
        return _F64
    if dtype == torch.float32:
        return _F32
    return _U64 if unsigned else _I64


def segment_minmax_kernel(perm, offs, vals, valid, mode, fill=None, unsigned=False):
    """B5's MIN or MAX on CUDA tensors, by the parallel range pass."""
    global launches
    dev = _check(perm, offs, vals, valid, (torch.int64, torch.float32, torch.float64))
    if dev.type != "cuda":
        raise ValueError(f"segment_minmax_kernel needs CUDA tensors, got {dev}")
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    n, num = _positions(perm, vals), offs.numel() - 1
    out = torch.empty(num, dtype=vals.dtype, device=dev)
    if num == 0:
        return out
    flt = vals.dtype.is_floating_point
    fill_bits = 0 if flt else int_fill_bits(fill, unsigned)
    with torch.cuda.device(dev):
        scratch = _scratch(n, dev)
        err = _lib().hs_seg_minmax(_ptr(perm), offs.data_ptr(), vals.data_ptr(), _ptr(valid),
                                   n, num, _value_code(vals.dtype, unsigned),
                                   int(mode == "max"), fill_bits, out.data_ptr(),
                                   scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "B5 min/max")
    launches += 2
    return out


# -- dispatch by device -----------------------------------------------------------


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"B5: unsupported device {t.device}")
    return t.device.type


def segment_sum_count(perm, offs, vals, valid, start=None):
    """(per-group sum over valid rows, from ``start`` for a float sum when
    given, per-group count of valid rows): the plain version for CPU
    tensors, kernel B5 for CUDA tensors."""
    if _route(offs) == "cpu":
        _check_start(start, vals, offs.numel() - 1)
        return segment_sum_count_torch(perm, offs, vals, valid, start)
    return segment_sum_count_kernel(perm, offs, vals, valid, start)


def segment_minmax(perm, offs, vals, valid, mode, fill=None, unsigned=False):
    """Per-group MIN or MAX (``fill`` for an integer group without valid
    rows; ``unsigned`` for uint64 bits in an int64 tensor)."""
    if _route(offs) == "cpu":
        return segment_minmax_torch(perm, offs, vals, valid, mode, fill, unsigned)
    return segment_minmax_kernel(perm, offs, vals, valid, mode, fill, unsigned)


def segment_count(perm, offs, valid):
    """Per-group count of valid rows. Without a validity mask that is each
    group's size, and no reduction runs."""
    if valid is None:
        return offs[1:] - offs[:-1]
    if _route(offs) == "cpu":
        return segment_count_torch(perm, offs, valid)
    return segment_count_kernel(perm, offs, valid)
