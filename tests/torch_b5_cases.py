"""Cases of kernel B5, the segment reductions (``csrc/segment_reduce.cu``),
shared by ``test_torch_aggregate.py`` (plain versions against the JAX
package, on the CPU), ``test_torch_cuda.py`` and ``chip_smoke.py``
(kernel against the plain version, on the card), with the bitwise row
comparison they use. numpy, pyarrow and torch only.

Each case is (group id per row, values, validity or None, number of
groups), the JAX package's ``segment_*`` arguments; :func:`groups` turns
the group ids into the port's (perm, offs). The cases cover every value
type B5 takes, NaN, -0.0 / 0.0, +-inf and NaN payloads, nulls, integer
wrap-around, one group of 100,000 rows, 10,000 groups, and groups with no
valid row or only NaN."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import torch

NAN_PAYLOAD = np.array([0x7FF8000000000123], dtype=np.uint64).view(np.float64)[0]
NEG_NAN = np.array([0xFFF8000000000456], dtype=np.uint64).view(np.float64)[0]


def groups(gid: np.ndarray, num: int):
    """The port's (perm, offs) for reference group ids."""
    perm = np.argsort(gid, kind="stable")
    offs = np.concatenate([[0], np.cumsum(np.bincount(gid, minlength=num))])
    return torch.from_numpy(perm), torch.from_numpy(offs.astype(np.int64))


def b5_cases() -> dict:
    rng = np.random.default_rng(1)
    n, g = 5000, 37
    gid = rng.integers(0, g, n)
    flts = rng.normal(size=n)
    flts[rng.random(n) < 0.05] = np.nan
    flts[rng.random(n) < 0.05] = 0.0
    flts[rng.random(n) < 0.05] = -0.0
    flts[rng.random(n) < 0.01] = np.inf
    flts[rng.random(n) < 0.01] = -np.inf
    valid = rng.random(n) > 0.1
    big_gid = np.zeros(100_000, dtype=np.int64)
    big = rng.normal(0, 1e6, 100_000)
    many_gid = rng.integers(0, 10_000, 60_000)
    return {
        "int64": (gid, rng.integers(-(2**40), 2**40, n, dtype=np.int64), valid, g),
        "int64_wrap": (gid, rng.integers(2**61, 2**62, n, dtype=np.int64), None, g),
        "int32": (gid, rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32),
                  valid, g),
        "uint8": (gid, rng.integers(0, 256, n).astype(np.uint8), valid, g),
        "uint64": (gid, rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
                   valid, g),
        "bool": (gid, rng.random(n) < 0.5, valid, g),
        "float64": (gid, flts, valid, g),
        "float64_no_nulls": (gid, flts, None, g),
        "float32": (gid, flts.astype(np.float32), valid, g),
        "one_group_of_100000": (big_gid, big, None, 1),
        "one_group_of_100000_float32": (big_gid, big.astype(np.float32), None, 1),
        "ten_thousand_groups": (many_gid, rng.normal(size=60_000), rng.random(60_000) > 0.3,
                                10_000),
        "all_null_and_nan_only_groups": (
            np.array([0, 0, 1, 1, 2, 2, 3]),
            np.array([np.nan, np.nan, 5.0, 7.0, np.nan, 1.0, -0.0]),
            np.array([True, True, False, False, True, False, True]), 5),
        "nan_payloads_and_inf_minus_inf": (
            np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3]),
            np.array([np.inf, -np.inf, NAN_PAYLOAD, NAN_PAYLOAD, np.inf, -np.inf,
                      NEG_NAN, NAN_PAYLOAD, 1.0, -np.inf, 2.0]),
            None, 4),
    }


B5_CASES = b5_cases()

SNAN = np.array([0x7FF0000000000001], dtype=np.uint64).view(np.float64)[0]


def b5_start_cases() -> dict:
    """Cases of the float fold from a carried start: (group id per row,
    values, validity or None, number of groups, start per group). The
    reference is ``np.add.at`` onto a copy of the start."""
    rng = np.random.default_rng(5)
    n, g = 3000, 11
    gid = rng.integers(0, g - 1, n)  # the last group has no row
    vals = rng.normal(0, 1e3, n)
    valid = rng.random(n) > 0.1
    start = rng.normal(0, 1e16, g)
    return {
        "neg_zero_start_pos_zero_rows": (
            np.array([0, 0, 1, 2]), np.array([0.0, 0.0, 0.0, -0.0]),
            np.array([True, False, True, True]), 4, np.full(4, -0.0)),
        "nan_payload_start": (
            np.array([0, 0, 1, 1, 2]), np.array([1.0, NAN_PAYLOAD, 2.0, np.inf, 3.0]), None, 4,
            np.array([SNAN, NEG_NAN, -np.inf, NAN_PAYLOAD])),
        "inf_start": (
            np.array([0, 0, 1, 1, 2, 3]), np.array([1.0, -np.inf, 5.0, -7.0, np.inf, np.nan]),
            None, 4, np.array([np.inf, -np.inf, -np.inf, np.inf])),
        "empty_groups_keep_their_start": (
            np.array([1, 1]), np.array([1.0, 2.0]), None, 4,
            np.array([SNAN, 4.0, -0.0, NAN_PAYLOAD])),
        "start_decides_the_bits": (gid, vals, valid, g, start),
        "float32": (gid, vals.astype(np.float32), valid, g, start.astype(np.float32)),
        "long_groups_through_tiles": (
            np.repeat(np.arange(3), [700, 1, 2049]), rng.normal(size=2750), None, 3,
            np.array([1e17, -3.5, 2.0**60])),
    }


B5_START_CASES = b5_start_cases()


def fold_from_start_numpy(gid, vals, valid, num, start) -> np.ndarray:
    """The reference fold: ``np.add.at`` onto a copy of the start, null
    rows adding 0.0."""
    out = np.array(start, dtype=vals.dtype, copy=True)
    v = vals if valid is None else np.where(valid, vals, vals.dtype.type(0))
    with np.errstate(invalid="ignore"):
        np.add.at(out, gid, v)
    return out


# widths of csrc/segment_reduce.cu (test_torch_aggregate.py holds them to
# kRange, kShortGroup and kTile in the source)
RANGE = 2048  # positions a warp of the range pass owns
SHORT_GROUP = 32  # the longest group one lane of the range pass folds alone
FOLD_TILE = 256  # positions a tile of the float fold


def _offsets(lengths) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def _fill(rng, n: int, lo: int = 1, hi: int = 7) -> list:
    """Random group lengths in [lo, hi] that sum to n (the last one cut)."""
    out = []
    while n > 0:
        k = min(int(rng.integers(lo, hi, endpoint=True)), n)
        out.append(k)
        n -= k
    return out


def _pinned(rng, n: int, pins) -> np.ndarray:
    """Offsets of n positions holding the groups ``pins`` ([(start,
    length)], ascending, apart), the rest in groups of 1-7 rows."""
    lengths, at = [], 0
    for start, length in pins:
        lengths += _fill(rng, start - at) + [length]
        at = start + length
    return _offsets(lengths + _fill(rng, n - at))


def _q18_runs(rng, keys: int):
    """TPC-H Q18's shape: keys of 1-7 rows, stored in 8 buckets of a
    key-sorted index, so the stable group sort's permutation is made of
    runs of consecutive rows."""
    sizes = rng.integers(1, 8, keys)
    key = np.repeat(np.arange(keys), sizes)
    bucket = (key * 2654435761) % 8
    stored = key[np.lexsort((key, bucket))]  # the rows in index order
    return np.argsort(stored, kind="stable").astype(np.int64), _offsets(sizes)


def _fold_tiles() -> np.ndarray:
    """Float fold groups of 1, 255, 256, 257, 511 and 3 x 256 + 17 rows, an
    empty one, and two that reuse both tile buffers several times."""
    t = FOLD_TILE
    return _offsets([1, t - 1, t, t + 1, 2 * t - 1, 3 * t + 17, 0, 9 * t + 100, 11 * t + 3])


def _late_specials(perm, offs, vals: dict) -> dict:
    """The fold layout's values: no NaN or inf anywhere, then in group 7 a
    NaN with a payload first in tile 6, and in group 8 +inf in tile 5 and
    -inf in tile 8 (``inf + -inf`` first there); those rows valid."""
    f = vals["float64"]
    f[~np.isfinite(f)] = 1.5
    t = FOLD_TILE
    for g, at, value in ((7, 6 * t + 11, NAN_PAYLOAD), (8, 5 * t + 7, np.inf),
                         (8, 8 * t + 200, -np.inf)):
        row = perm[offs[g] + at]
        f[row] = value
        vals["valid"][row] = True
    vals["float32"] = f.astype(np.float32)
    return vals


def b5_layouts() -> dict:
    """Group layouts around the kernel's widths: name -> (perm or None for
    the identity, offs, values as :func:`layout_values` gives them). Groups
    span ranges, end on range edges, are empty at the start, inside and at
    the end, and there may be no rows at all; groups of 1-7 rows as Q18
    makes them; groups of SHORT_GROUP - 1, SHORT_GROUP and SHORT_GROUP + 1
    rows on and across range edges; a long group amid a round of short
    ones; empty groups inside rounds and on range edges; float fold groups
    around the tile width, with a NaN and an ``inf + -inf`` first met in a
    late tile."""
    rng = np.random.default_rng(9)
    n = 5 * RANGE + 37

    def shuffled(offs):
        """Rows dealt to the groups at random, in row order within each
        group (as the stable group sort gives them)."""
        offs = np.asarray(offs, np.int64)
        perm = rng.permutation(int(offs[-1])).astype(np.int64)
        gid = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
        return perm[np.lexsort((perm, gid))], offs

    r = RANGE
    edges = [0, r - 1, r, 2 * r, 2 * r + 1, 3 * r, 4 * r - 96, n]
    mid = 2 * r + r // 2 - 60
    empties = [0, 0, 0, 5, r, r, r, r + 6, mid, mid, n, n, n]
    layouts = {
        "identity_one_group": (None, np.array([0, n], np.int64)),
        "identity_range_edges": (None, np.array(edges, np.int64)),
        "shuffled_range_edges": shuffled(edges),
        "empty_groups_everywhere": shuffled(empties),
        "long_group_across_ranges": shuffled([0, 100, 5 * r - 220, n]),
        "single_rows": shuffled(np.arange(n + 1)),
        "no_rows": (np.zeros(0, np.int64), np.zeros(4, np.int64)),
    }
    s = SHORT_GROUP
    short_pins = [(r - (s - 1), s - 1), (r, s), (2 * r - (s + 1), s + 1), (2 * r, s - 1),
                  (3 * r - s, s), (3 * r, s + 1), (4 * r - 9, s - 1), (5 * r - 20, s),
                  (6 * r - 13, s + 1)]
    short_offs = _pinned(rng, 6 * r + 37, short_pins)
    # range 1 starts a round at its first position: 15 groups of 3 rows, one
    # of 200, 16 of 3; range 2 likewise with one of SHORT_GROUP + 1 and one
    # of SHORT_GROUP amid them
    mid_round = [3] * 15 + [200] + [3] * 16
    mid_lengths = (_fill(rng, r) + mid_round + _fill(rng, r - sum(mid_round))
                   + [3] * 10 + [s + 1] + [3] * 10 + [s] + [3] * 10 + _fill(rng, 50))
    empty_lengths = []
    for edge in range(r, 5 * r + 1, r):  # small groups, some empty; three empty on each edge
        empty_lengths += _fill(rng, edge - sum(empty_lengths), lo=0, hi=4) + [0, 0, 0]
    empty_lengths += _fill(rng, 37, lo=0, hi=4) + [0, 0]
    layouts.update({
        "q18_runs": _q18_runs(rng, 3 * r // 2),
        "identity_q18_sizes": (None, _offsets(_fill(rng, n))),
        "short_groups_on_range_edges": shuffled(short_offs),
        "identity_short_groups_on_range_edges": (None, short_offs),
        "long_group_amid_a_round": shuffled(_offsets(mid_lengths)),
        "empty_groups_in_rounds": shuffled(_offsets(empty_lengths)),
        "fold_tiles": shuffled(_fold_tiles()),
        "identity_fold_tiles": (None, _fold_tiles()),
    })
    out = {}
    for name, (perm, offs) in layouts.items():
        vals = layout_values(int(offs[-1]))
        if name.endswith("fold_tiles"):
            ident = np.arange(int(offs[-1])) if perm is None else perm
            vals = _late_specials(ident, offs, vals)
        out[name] = (perm, offs, vals)
    return out


def layout_gid(perm, offs) -> np.ndarray:
    """The reference's group id per row for a layout."""
    n = int(offs[-1])
    gid = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    out = np.empty(n, dtype=np.int64)
    out[np.arange(n) if perm is None else perm] = gid
    return out


def layout_values(n: int, seed: int = 4) -> dict:
    """Values for a layout's n rows, one array per B5 value type, with
    NaN, -0.0 / 0.0, +-inf, integer extremes, and a validity mask."""
    rng = np.random.default_rng(seed + n)
    f = rng.normal(0, 1e3, n)
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, NAN_PAYLOAD])
    hit = rng.random(n) < 0.05
    f[hit] = special[rng.integers(0, len(special), int(hit.sum()))]
    i = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    i[::97] = np.iinfo(np.int64).min
    i[1::89] = np.iinfo(np.int64).max
    return {
        "float64": f,
        "float32": f.astype(np.float32),
        "int64": i,
        "uint64": i.view(np.uint64),
        "valid": rng.random(n) > 0.2,
    }


def same_rows(a: pa.Table, b: pa.Table) -> bool:
    """Rows equal in order, float columns compared bit for bit: NaN equals
    NaN of the same bits and -0.0 differs from 0.0, where ``Table.equals``
    fails on any NaN (ROADMAP C.4)."""
    if a.schema != b.schema or a.num_rows != b.num_rows:
        return False
    for name in a.column_names:
        x, y = a.column(name).combine_chunks(), b.column(name).combine_chunks()
        if pa.types.is_floating(x.type):
            if not np.array_equal(np.asarray(x.is_null()), np.asarray(y.is_null())):
                return False
            width = np.int64 if x.type == pa.float64() else np.int32
            bits = [c.fill_null(0).to_numpy(zero_copy_only=False).view(width) for c in (x, y)]
            if not np.array_equal(*bits):
                return False
        elif not x.equals(y):
            return False
    return True


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu()
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """0 when the bits agree; else the largest difference among the
    elements whose bits differ, a difference that is no number or zero
    (NaN against a value, other NaN bits, -0.0 against 0.0) counting as
    inf."""
    a, b = a.cpu(), b.cpu()
    differ = _bits(a) != _bits(b)
    if not bool(differ.any()):
        return 0.0
    d = (a[differ].to(torch.float64) - b[differ].to(torch.float64)).abs()
    d[torch.isnan(d) | (d == 0)] = float("inf")
    return float(d.max())


def b5_kernel_errors(perm, offs, vals, valid, unsigned=False) -> dict:
    """Each B5 launch function on the given CUDA tensors against its plain
    version on CPU copies of the same tensors (the float fold's plain
    version needs the CPU's ordered ``index_add_``): op -> max abs error,
    0 when the outputs are equal bit for bit."""
    from hyperspace_tpu_torch.ops import aggregate as A

    cpu = [None if t is None else t.cpu() for t in (perm, offs, vals, valid)]
    out = {}
    got = A.segment_sum_count_kernel(perm, offs, vals, valid)
    want = A.segment_sum_count_torch(*cpu)
    out["sum"] = abs_err(got[0], want[0])
    out["count"] = abs_err(got[1], want[1])
    for mode in ("min", "max"):
        fill = None
        if not vals.dtype.is_floating_point:
            fill = (2**64 - 1 if mode == "min" else 0) if unsigned else (
                2**63 - 1 if mode == "min" else -(2**63))
        got = A.segment_minmax_kernel(perm, offs, vals, valid, mode, fill, unsigned)
        want = A.segment_minmax_torch(*cpu, mode, fill, unsigned)
        out[mode] = abs_err(got, want)
    if valid is not None:
        out["count_valid"] = abs_err(A.segment_count_kernel(perm, offs, valid),
                                      A.segment_count_torch(cpu[0], cpu[1], cpu[3]))
    return out
