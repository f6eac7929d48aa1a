"""Z-addresses — per-column order encodings, bit interleaving (kernel B6),
the z-order sort, and the z-space box decomposition of the serve path.

Counterpart of ``hyperspace_tpu/ops/zorder.py`` (reference:
``zordercovering/ZOrderField.scala:26-569`` and ``ZOrderUDF.scala:32-100``):

1. per column, an order-preserving uint64 encoding (sign flip for ints,
   the IEEE total-order trick for floats, dictionary ranks for strings),
   on the host in numpy;
2. min/max (or quantile) scaling onto ``bits`` bits a column, on the
   host in numpy, as the reference does it;
3. bit interleaving across columns into ``ceil(k * bits / 32)`` uint32
   planes, most significant first, on the device: :func:`interleave`
   launches kernel B6 (``csrc/zorder_interleave.cu``) for a CUDA tensor
   and takes the plain version :func:`interleave_torch` for a CPU one;
4. the stable lexsort over the planes, plane 0 primary
   (``ops/sort.lexsort_permutation``).

PyTorch has few operators for uint32, so the words and planes travel as
int32 tensors holding the uint32 bit patterns (numpy's ``view``); the
plain version and the sort widen them to int64, zero-extended.

The reference pads the rows to its shape policy's length before
interleaving and slices the padding off after; the port launches at the
exact n, so the planes of the real rows are the same.

The rest of the module is host code copied from the reference: the
scalar encoders, the outward-rounded word bounds of a query box, the box's
decomposition into z-ranges and the span readers of the zone maps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import numpy as np
import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError

#: kernel launches made by :func:`interleave` (never by the plain version)
launches = 0

_M32 = 0xFFFFFFFF


def order_u64_np(col) -> np.ndarray:
    """Order-preserving uint64 of a Column's values (host prep; nulls sort
    first)."""
    if col.kind == "string":
        order = sorted(range(len(col.dictionary)), key=lambda i: col.dictionary[i])
        rank = np.empty(max(len(col.dictionary), 1), dtype=np.uint64)
        for r, i in enumerate(order):
            rank[i] = r + 1  # 0 reserved for null
        return np.where(
            col.codes < 0, np.uint64(0), rank[np.maximum(col.codes, 0)]
        )
    v = col.values
    if v.dtype.kind == "f":
        bits = v.astype(np.float64).view(np.uint64)
        sign = bits >> np.uint64(63)
        enc = np.where(
            sign == 1, ~bits, bits | np.uint64(1) << np.uint64(63)
        )
    elif v.dtype.kind == "b":
        enc = v.astype(np.uint64) + np.uint64(1)
    elif v.dtype.kind == "u":
        enc = v.astype(np.uint64)
    else:
        enc = (v.astype(np.int64) ^ np.int64(-(2**63))).view(np.uint64)
    if col.validity is not None:
        enc = np.where(col.validity, np.maximum(enc, np.uint64(1)), np.uint64(0))
    return enc


# ---------------------------------------------------------------------------
# Kernel B6: the bit interleave
# ---------------------------------------------------------------------------


def num_planes(k: int, bits: int) -> int:
    return (k * bits + 31) // 32


def _check(words: torch.Tensor, bits: int) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"words must be a torch.Tensor, got {type(words)}")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(
            f"words must be [k, n] int32 (uint32 bits), got {tuple(words.shape)} "
            f"{words.dtype}"
        )
    if words.shape[0] < 1:
        raise ValueError("words needs at least one column")
    if not 1 <= int(bits) <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")


def interleave_torch(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain PyTorch version: [k, n] words (int32 holding uint32 bits, each
    < 2^bits) -> [ceil(k * bits / 32), n] int32 planes holding uint32 bits,
    most significant first. Z-bit t (from the most significant) is bit
    ``bits - 1 - t // k`` of column ``t % k``, stored at bit
    ``31 - t % 32`` of plane ``t // 32``; the last plane's low bits stay
    zero. Computed in int64."""
    _check(words, bits)
    k, n = words.shape
    total = k * bits
    w = words.to(torch.int64) & _M32
    planes = torch.zeros((num_planes(k, bits), n), dtype=torch.int64, device=words.device)
    for t in range(total):
        bit = (w[t % k] >> (bits - 1 - t // k)) & 1
        planes[t // 32] |= bit << (31 - t % 32)
    # uint32 bits into int32: subtract 2^32 where the top bit is set
    return torch.where(planes >= 1 << 31, planes - (1 << 32), planes).to(torch.int32)


@functools.cache
def _kernel_fn():
    from hyperspace_tpu_torch import kernels

    fn = kernels.load("zorder_interleave").hs_zorder_interleave
    fn.argtypes = [
        ctypes.c_void_p,  # words
        ctypes.c_void_p,  # planes
        ctypes.c_int64,  # n
        ctypes.c_int,  # k
        ctypes.c_int,  # bits
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def interleave_kernel(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Launch ``csrc/zorder_interleave.cu`` on the current stream: [k, n]
    int32 contiguous CUDA words -> [ceil(k * bits / 32), n] int32 planes
    (uint32 bits)."""
    global launches
    _check(words, bits)
    if words.device.type != "cuda":
        raise ValueError(f"interleave_kernel needs a CUDA tensor, got {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    k, n = words.shape
    out = torch.empty((num_planes(k, bits), n), dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = _kernel_fn()(words.data_ptr(), out.data_ptr(), n, k, int(bits), stream)
    if err != 0:
        raise KernelLaunchError(f"z-order interleave kernel launch failed: CUDA error {err}")
    if n:  # the C side launches nothing for n = 0
        launches += 1
    return out


def interleave(words: torch.Tensor, bits: int) -> torch.Tensor:
    """[k, n] words -> z-address planes on the same device: the plain
    version for a CPU tensor, kernel B6 for a CUDA tensor (it raises on
    what it cannot take; there is no fallback)."""
    _check(words, bits)
    if words.device.type == "cpu":
        return interleave_torch(words, bits)
    if words.device.type == "cuda":
        return interleave_kernel(words, bits)
    raise ValueError(f"interleave: unsupported device {words.device}")


def planes_to_numpy(planes: torch.Tensor) -> np.ndarray:
    """Device planes (int32 bits) -> host [nplanes, n] uint32."""
    return planes.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# The frozen encoder spec
# ---------------------------------------------------------------------------


class ZOrderEncoder:
    """FIXED per-column encoding spec -> z-address planes. Spec kinds per
    column:

    * ``("range", min_u64, max_u64)`` — min/max scaling of the numeric
      order encoding;
    * ``("quantile", sorted_bounds)`` — rank by binary search over
      sampled boundaries (skew-resistant);
    * ``("dict", sorted_strings)`` — global lexicographic rank for string
      columns.
    """

    def __init__(self, bits: int, specs: List):
        self.bits = bits
        self.specs = specs

    # -- construction -------------------------------------------------------
    @staticmethod
    def fit(columns: List, bits: int, quantile: bool, relative_error: float):
        """(encoder, per-column encodings) from in-memory Columns — the
        encodings are returned so the caller never encodes twice."""
        specs = []
        encs = []
        for col in columns:
            if col.kind == "string":
                spec = ("dict", sorted(set(col.dictionary)))
                specs.append(spec)
                encs.append(_dict_encode(col, spec[1]))
                continue
            e = order_u64_np(col)
            encs.append(e)
            if quantile:
                max_sample = max(int(1.0 / max(relative_error, 1e-4) ** 2), 1024)
                sample = (
                    e if len(e) <= max_sample else e[:: max(1, len(e) // max_sample)]
                )
                specs.append(("quantile", np.sort(sample)))
            else:
                specs.append(
                    (
                        "range",
                        e.min() if len(e) else np.uint64(0),
                        e.max() if len(e) else np.uint64(0),
                    )
                )
        return ZOrderEncoder(bits, specs), encs

    # -- encoding -----------------------------------------------------------
    def encode(self, col, j: int) -> np.ndarray:
        """Per-row uint64 order encoding of a Column under spec j."""
        spec = self.specs[j]
        if spec[0] == "dict":
            return _dict_encode(col, spec[1])
        return order_u64_np(col)

    def _words(self, enc: np.ndarray, spec) -> np.ndarray:
        bits = self.bits
        top = (1 << bits) - 1
        if spec[0] == "quantile":
            bounds = spec[1]
            pos = np.searchsorted(bounds, enc, side="right").astype(np.float64)
            return ((pos / max(len(bounds), 1)) * np.float64(top)).astype(np.uint32)
        if spec[0] == "dict":
            # global ranks in [0, len]: plain range scaling over the rank space
            mn, mx = np.uint64(0), np.uint64(len(spec[1]))
        else:
            _tag, mn, mx = spec
        # min/max scaling on the host, as the reference does
        off = (enc - mn).astype(np.float64)
        rng = float(int(mx) - int(mn))
        scale = ((2.0**bits) - 1) / rng if rng > 0 else 0.0
        return np.clip(off * scale, 0, top).astype(np.uint32)

    def planes_from_encodings(self, encs: List[np.ndarray], device) -> torch.Tensor:
        """[nplanes, n] planes (int32 holding uint32 bits, most significant
        first) on ``device`` from per-column encodings produced by
        :meth:`encode`: the words go to the device and B6 interleaves
        them there."""
        words = np.stack([self._words(e, s) for e, s in zip(encs, self.specs)])
        return interleave(torch.from_numpy(words.view(np.int32)).to(device), self.bits)

    def planes(self, columns: List, device) -> torch.Tensor:
        return self.planes_from_encodings(
            [self.encode(c, j) for j, c in enumerate(columns)], device
        )


def _dict_encode(col, sorted_global: List[str]) -> np.ndarray:
    """uint64 global lexicographic rank (+1; 0 = null) of a string Column's
    values under a frozen sorted dictionary."""
    local = col.dictionary
    rank_of = np.searchsorted(np.array(sorted_global, dtype=object), local)
    lut = np.asarray(rank_of, dtype=np.uint64) + np.uint64(1)
    if len(lut) == 0:
        lut = np.zeros(1, dtype=np.uint64)
    enc = lut[np.maximum(col.codes, 0)]
    return np.where(col.codes < 0, np.uint64(0), enc)


# ---------------------------------------------------------------------------
# Z-address range decomposition (serve-side pruning)
# ---------------------------------------------------------------------------
#
# A z-laid-out index file is a contiguous run of the z-sorted order, so its
# rows span a narrow interval of z-addresses even when each column's
# per-file min/max is wide. Pruning works in z-space: the query box (per
# column word intervals under the file set's frozen encoder spec)
# decomposes into a small set of z-address keep-ranges, and a file or row
# group whose captured z-span misses every range cannot hold a matching
# row.


def order_u64_scalar(value, kind: str) -> int:
    """Order-preserving uint64 of ONE engine-domain value — the scalar twin
    of :func:`order_u64_np` for encoding query-box bounds. ``kind`` is the
    numpy dtype kind of the column's storage ("f"/"b"/"u"/else int);
    ``value`` must already be in the column's storage domain."""
    if kind == "f":
        bits = int(np.float64(value).view(np.uint64))
        if bits >> 63:
            return (~bits) & 0xFFFFFFFFFFFFFFFF
        return bits | (1 << 63)
    if kind == "b":
        return int(bool(value)) + 1
    v = int(value)
    if kind == "u":
        return v & 0xFFFFFFFFFFFFFFFF
    return (v ^ -(1 << 63)) & 0xFFFFFFFFFFFFFFFF


def spec_word_bounds(spec, enc_lo: int, enc_hi: int, bits: int):
    """[word_lo, word_hi] of an encoded-value interval under one frozen
    spec — the scalar twin of :meth:`ZOrderEncoder._words`, rounded
    OUTWARD (floor the low end, ceil the high end). Only "range" and
    "dict" specs appear in captured zone-map metadata; quantile specs
    abstain (None)."""
    top = (1 << bits) - 1
    if spec[0] == "dict":
        mn, mx = 0, len(spec[1])
    elif spec[0] == "range":
        mn, mx = int(spec[1]), int(spec[2])
    else:
        return None
    rng = mx - mn
    if rng <= 0:
        return 0, top
    scale = ((2.0**bits) - 1) / float(rng)

    def word(enc, up):
        off = float(max(min(enc, mx), mn) - mn) * scale
        w = int(np.ceil(off)) if up else int(np.floor(off))
        return max(0, min(top, w))

    return word(enc_lo, False), word(enc_hi, True)


def z_box_ranges(word_lo, word_hi, bits: int, max_ranges: int = 64):
    """Decompose a per-column word box into z-address keep-ranges: a sorted
    list of inclusive ``(z_lo, z_hi)`` python-int ranges (in k*bits-bit
    z-space, MSB = column 0's top bit, the interleave's layout) whose
    union covers every z-address inside the box. A bounded prefix-tree
    walk: a cell disjoint from the box in any column is dropped, a
    contained cell emits its whole z-interval, anything else splits on the
    next z-bit; cells left when the budget runs out are emitted whole, so
    the union may over-cover but never under-covers."""
    k = len(word_lo)
    total = k * bits
    out = []
    budget = [max(4, int(max_ranges)) * 4]

    def rec(depth, zpref, col_pref):
        nfixed = [depth // k + (1 if j < depth % k else 0) for j in range(k)]
        for j in range(k):
            free = bits - nfixed[j]
            clo = col_pref[j] << free
            chi = clo + (1 << free) - 1
            if chi < word_lo[j] or clo > word_hi[j]:
                return
        inside = True
        for j in range(k):
            free = bits - nfixed[j]
            clo = col_pref[j] << free
            chi = clo + (1 << free) - 1
            if clo < word_lo[j] or chi > word_hi[j]:
                inside = False
                break
        span = total - depth
        if inside or depth == total or budget[0] <= 0:
            lo = zpref << span
            out.append((lo, lo + (1 << span) - 1))
            return
        budget[0] -= 1
        j = depth % k
        for b in (0, 1):
            child = list(col_pref)
            child[j] = (col_pref[j] << 1) | b
            rec(depth + 1, (zpref << 1) | b, child)

    rec(0, 0, [0] * k)
    out.sort()
    merged = []
    for lo, hi in out:
        if merged and lo <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def planes_z_minmax(planes: np.ndarray, start: int, end: int):
    """(z_lo, z_hi) python ints of rows [start, end) of host ``planes``
    ([nplanes, n] uint32, most significant plane first), in PACKED
    (32*nplanes-bit) z-space; None for an empty slice. One plane reduces
    to a min/max; wider addresses pay one lexsort of the slice."""
    sub = planes[:, start:end]
    n = sub.shape[1]
    if n == 0:
        return None

    def pack(col) -> int:
        z = 0
        for w in col:
            z = (z << 32) | int(w)
        return z

    if sub.shape[0] == 1:
        return int(sub[0].min()), int(sub[0].max())
    order = np.lexsort(sub[::-1])
    return pack(sub[:, order[0]]), pack(sub[:, order[-1]])


def pack_box_ranges(ranges, bits: int, k: int, nplanes: int):
    """Shift keep-ranges from k*bits-bit z-space into the PACKED
    32*nplanes-bit space :func:`planes_z_minmax` reports spans in (the
    last plane's low bits are zero padding)."""
    pad = 32 * nplanes - k * bits
    if pad <= 0:
        return list(ranges)
    return [((lo << pad), ((hi << pad) | ((1 << pad) - 1))) for lo, hi in ranges]


def z_order_permutation(
    columns: List,
    bits: int = 16,
    quantile: bool = False,
    relative_error: float = 0.01,
    device=None,
) -> torch.Tensor:
    """Sort permutation (int64, on ``device``; None is cuda) by z-address
    over the given Columns — the build's replacement for
    repartitionByRange on ``_zaddr`` (ZOrderCoveringIndex.scala:97-154).
    The planes are interleaved by B6 and lexsorted on the device."""
    from hyperspace_tpu_torch.ops.sort import lexsort_permutation
    from hyperspace_tpu_torch.session import resolve_device

    dev = resolve_device(device)
    enc, encs = ZOrderEncoder.fit(columns, bits, quantile, relative_error)
    return lexsort_permutation(enc.planes_from_encodings(encs, dev))
