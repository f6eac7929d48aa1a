"""Kernels B8a and B8b (the bucket exchange's pack and order) step by
step, on the CPU: the plain model of the kernel's own steps
(``ops/exchange.pack_model`` / ``order_model``: tile histograms written
digit-major, their scan over tiles, each warp's stable ranks, the scan
across a tile's warps, positions, B8a's zero tails, B8b's two-digit
route) held bit for bit to the plain versions ``pack_torch`` /
``order_torch``, which ``test_torch_exchange_strategies.py`` holds to the
JAX package's ``_flat_program``; and the route and scratch sizes
(``ops/exchange.plan``) against the constants of
``csrc/bucket_exchange.cu``. The kernel itself is held against the plain
versions on the card (``test_torch_cuda.py``, ``chip_smoke.py`` phase
18)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re

import numpy as np
import pytest
import torch

from hyperspace_tpu_torch.ops import exchange as X

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = X.TILE_ROWS
SIZES = (0, 1, T - 1, T, T + 1, 3 * T + 5)


def _source_constants() -> dict:
    with open(os.path.join(ROOT, "hyperspace_tpu_torch", "csrc", "bucket_exchange.cu")) as fh:
        src = fh.read()
    found = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    shifts = dict(re.findall(r"constexpr int (k\w+) = 1 << (k\w+);", src))
    found.update({k: 1 << found[v] for k, v in shifts.items()})
    return found


def _same(a, b) -> bool:
    """Equal bit for bit: nested lists and tuples of tensors."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def _rows(rng, n, nb, D, layout="random"):
    """bucket, valid and a column of each width for one shard's rows."""
    ids = rng.integers(0, nb, n).astype(np.int32)
    if layout == "one_dest":  # every valid row to destination 1 % D
        ids = ids - ids % D + 1 % D
        ids[ids >= nb] -= D
    valid = rng.random(n) > 0.2
    if layout == "all_invalid":
        valid[:] = False
    f = rng.normal(size=n)
    f[::7] = np.nan
    cols = [
        torch.from_numpy(rng.integers(-(2**62), 2**62, n)),
        torch.from_numpy(f),
        torch.from_numpy(rng.integers(-5, 300, n).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 2**16, n).astype(np.int16)),
        torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8)),
    ]
    bucket, valid = torch.from_numpy(ids), torch.from_numpy(valid)
    return bucket, valid, [bucket, valid, *cols]


def _cap(bucket, valid, D) -> int:
    """The flat strategy's cap: the largest destination's count, to a
    power of two."""
    dest = torch.where(valid, bucket.long() % D, D)
    most = int(torch.bincount(dest, minlength=D + 1)[:D].max()) if bucket.numel() else 0
    return 1 << max(most - 1, 0).bit_length() if most else 1


def _check_pack_and_order(bucket, valid, cols, D, nb, cap):
    trace = {}
    got = X.pack_model(bucket, valid, D, cap, cols, trace=trace)
    want = X.pack_torch(bucket, valid, D, cap, cols)
    assert _same(got, want)
    # every slot of [D, cap] written once: by a row or by a zero tail
    assert bool((trace["written"] == 1).all())
    steps, n = trace["steps"], bucket.numel()
    assert steps["hist"].shape == (D + 1, trace["plan"].tiles)
    for t in range(trace["plan"].tiles):  # a tile's places: a permutation of its rows
        lpos = steps["lpos"][t * T:(t + 1) * T]
        assert torch.equal(torch.sort(lpos).values, torch.arange(lpos.numel()))
    assert int(steps["totals"].sum()) == n
    # the order over the packed slots, as a destination shard receives them
    recv = [c.reshape(-1) for c in got[1]]
    o_trace = {}
    o_got = X.order_model(recv[0], recv[1], nb, recv, trace=o_trace)
    assert _same(o_got, X.order_torch(recv[0], recv[1], nb, recv))
    assert o_trace["plan"].route == X.route(nb + 1)
    # and over the rows as they came
    assert _same(X.order_model(bucket, valid, nb, cols), X.order_torch(bucket, valid, nb, cols))


@pytest.mark.parametrize("nb", [1, 200, 50_000])
@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_model_equals_the_plain_versions(n, D, nb):
    """Pack and order by the kernel's steps equal the plain versions at
    tile edges, every D and one- and two-digit bucket counts."""
    rng = np.random.default_rng(n * 31 + D * 7 + nb)
    bucket, valid, cols = _rows(rng, n, nb, D)
    _check_pack_and_order(bucket, valid, cols, D, nb, _cap(bucket, valid, D))


@pytest.mark.parametrize("layout", ["one_dest", "all_invalid"])
@pytest.mark.parametrize("nb", [200, 50_000])
@pytest.mark.parametrize("D", [1, 4, 8])
def test_model_on_skewed_rows(layout, nb, D):
    """Every row to one destination, or no row valid."""
    rng = np.random.default_rng(D * 3 + len(layout) + nb)
    bucket, valid, cols = _rows(rng, 3 * T + 5, nb, D, layout)
    _check_pack_and_order(bucket, valid, cols, D, nb, _cap(bucket, valid, D))


def test_model_raises_as_the_kernel_does():
    """A count past cap and a bucket id out of range raise ValueError."""
    rng = np.random.default_rng(3)
    bucket, valid, cols = _rows(rng, T + 1, 200, 4)
    cap = _cap(bucket, valid, 4)
    with pytest.raises(ValueError, match="overflow"):
        X.pack_model(bucket, valid, 4, cap // 4, cols)
    bad = bucket.clone()
    bad[np.flatnonzero(valid.numpy())[0]] = -3
    with pytest.raises(ValueError, match="out of range"):
        X.pack_model(bad, valid, 4, cap, [bad])
    bad[np.flatnonzero(valid.numpy())[0]] = 200
    with pytest.raises(ValueError, match="out of range"):
        X.order_model(bad, valid, 200, [bad])
    with pytest.raises(ValueError, match="shards"):
        X.plan(10, X.MAX_DIGITS + 1, X.MAX_DIGITS, 1)


def test_tail_ranges_cover_each_destination_past_its_count():
    """The zero blocks' ranges are exactly [count_d, cap) of each
    destination, cut at tile edges."""
    D, cap = 3, 2 * T + 7
    totals = torch.tensor([0, cap, 5, 9])
    ranges = X.pack_tail_ranges(totals, D, cap)
    zeroed = torch.zeros(D * cap, dtype=torch.int64)
    for a, b in ranges:
        assert a // T == (b - 1) // T  # inside one block's slots
        zeroed[a:b] += 1
    want = torch.zeros(D * cap, dtype=torch.int64)
    want[0:cap] = 1
    want[2 * cap + 5:3 * cap] = 1
    assert torch.equal(zeroed, want)


def test_kernel_source_shares_the_constants():
    """T, the block, the warp's stretch, the digit limit and the column
    group are one constant each in the C source and in ``ops/exchange.py``."""
    c = _source_constants()
    assert c["kTileRows"] == X.TILE_ROWS
    assert c["kThreads"] == X.THREADS
    assert c["kDigitBits"] == X.DIGIT_BITS
    assert c["kMaxDigits"] == X.MAX_DIGITS == 1 << X.DIGIT_BITS
    assert c["kMaxCols"] == X.MAX_COLS
    assert X.WARPS == X.THREADS // 32 and X.WARP_ROWS * X.WARPS == X.TILE_ROWS


#: phase 18's two shapes (chip_smoke.py: one shard of the flat build at
#: D = 4, cap 1,048,576, and a shard's received slots over 200 buckets)
#: and an order over 50,000 buckets: (n, digits, D, cap)
PLAN_CASES = [
    pytest.param(2_097_152, 5, 4, 1 << 20, id="phase18-pack"),
    pytest.param(4_194_304, 201, 0, 0, id="phase18-order"),
    pytest.param(4_194_304, 50_001, 0, 0, id="order-50000-buckets"),
]


@pytest.mark.parametrize("n, digits, D, cap", PLAN_CASES)
def test_route_and_scratch_follow_the_source_constants(n, digits, D, cap):
    """The route is chosen by the digit count alone, and the scratch the
    wrapper allocates is what the C entries take: ceil(n / kTileRows) tiles
    of hist a digit of the widest pass, its totals, B8a's zero blocks and
    the two-digit route's keys."""
    c = _source_constants()
    p = X.plan(n, digits, D, cap)
    tiles = -(-n // c["kTileRows"])
    assert p.tiles == tiles
    if digits <= c["kMaxDigits"]:
        assert p.route == "one_digit"
        assert p.passes == (("pack" if D else "order", digits),)
        width = digits
    else:
        assert p.route == "two_digit"
        high = ((digits - 1) >> c["kDigitBits"]) + 1
        assert p.passes == (("low", c["kMaxDigits"]), ("high", high))
        assert high <= c["kMaxDigits"]
        width = c["kMaxDigits"]
    assert p.hist_entries == tiles * width and p.totals_entries == width
    assert p.zero_blocks == (-(-D * cap // c["kTileRows"]) if D else 0)
    assert p.keys_entries == (n if p.route == "two_digit" else 0)
    assert X.route(digits) == p.route
