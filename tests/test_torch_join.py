"""The port's join match (kernel B4's plain version and its wrapper) and
its JoinIndexRule against the JAX package, on the CPU.

Op level: ``ops/join`` against the reference's own numpy forms of the
per-bucket match (``_match_ranges_host`` + ``expand_match_ranges``), its
unindexed ``merge_join_indices`` and its null-sentinel layout; pair lists
must be equal in order. Wrapper level: the C arguments B4's wrapper
packs, through ctypes callbacks standing in for the library. Rule level:
the cases of ``tests/test_join_rule.py`` (its Hybrid Scan case is in
``tests/test_torch_hybrid.py``) through both
packages on the same tables: the rewritten plan's text, its score, the
filter reasons and the rows, in order. All comparisons are exact."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import ctypes
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.execution import join_exec as JJ
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JConfig
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.ops import join as JO
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import ops as port_ops
from hyperspace_tpu_torch.execution import join_exec as TJ
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig as TConfig
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.ops import join as J
from torch_b4_cases import b4_edge_cases

I64 = np.iinfo(np.int64)

# --- combine_reps -------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_combine_reps_matches_reference(k, n):
    rng = np.random.default_rng(100 + k)
    reps = rng.integers(I64.min, I64.max, size=(k, n), dtype=np.int64, endpoint=True)
    reps[:, : min(n, 3)] = np.array([I64.min, I64.max, 0])[: min(n, 3)]
    got = J.combine_reps(reps)
    want = JO.combine_reps_np(reps)
    assert got.dtype == np.int64 and np.array_equal(got, want)


# --- match_pairs_torch against the reference's per-bucket match ---------------


def _ragged(rng, sizes, lo, hi):
    sizes = np.asarray(sizes, dtype=np.int64)
    keys = rng.integers(lo, hi, int(sizes.sum()), dtype=np.int64, endpoint=True)
    return keys, np.concatenate([[0], np.cumsum(sizes)])


def _reference_pairs(l, l_offs, r, r_offs):
    """The reference's device-form match: buckets padded to [B, W]
    (``join_exec._device_match``), ``_match_ranges_host`` (the numpy twin
    of ``_bucket_join``), then ``expand_match_ranges`` per bucket."""
    B = len(l_offs) - 1

    def padded(keys, offs):
        width = max(int(np.diff(offs).max()), 1)
        pad = np.full((B, width), I64.max, dtype=np.int64)
        rowmap = np.zeros((B, width), dtype=np.int64)
        for b in range(B):
            a, e = offs[b], offs[b + 1]
            pad[b, : e - a] = keys[a:e]
            rowmap[b, : e - a] = np.arange(a, e)
        return pad, rowmap, np.diff(offs)

    l_pad, l_map, l_len = padded(l, l_offs)
    r_pad, r_map, r_len = padded(r, r_offs)
    perm_l, perm_r, lo, cnt = JO._match_ranges_host(l_pad, l_len, r_pad, r_len)
    li, ri = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for b in range(B):
        a, c = JO.expand_match_ranges(
            lo[b], cnt[b], l_map=l_map[b][perm_l[b]], r_map=r_map[b][perm_r[b]]
        )
        li.append(a)
        ri.append(c)
    return np.concatenate(li), np.concatenate(ri)


def _port_pairs(l, l_offs, r, r_offs, sort_l=True, sort_r=True):
    """The port's route: unsorted sides sorted per segment first
    (``segment_sort``), then the plain B4."""
    lk, rk = torch.from_numpy(l), torch.from_numpy(r)
    l_row = r_row = None
    if sort_l:
        lk, l_row = J.segment_sort(lk, l_offs)
    if sort_r:
        rk, r_row = J.segment_sort(rk, r_offs)
    li, ri = J.match_pairs(lk, l_offs, rk, r_offs, l_row, r_row)
    return li.numpy(), ri.numpy()


RAGGED = {
    "one bucket": ([700], [900], 0, 300),
    "eight buckets": ([50, 0, 300, 7, 1, 0, 250, 90], [40, 60, 0, 9, 1, 33, 250, 0], 0, 60),
    "many-to-many": ([200, 200, 200, 200], [300, 300, 300, 300], 0, 3),
    "no match": ([100, 100], [100, 100], 0, 1 << 40),
    "extremes": ([400, 400, 400], [400, 400, 400], I64.min, I64.max),
    "all empty right": ([5, 0, 9], [0, 0, 0], 0, 5),
    "all empty left": ([0, 0, 0], [5, 0, 9], 0, 5),
}


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_unsorted_buckets_match_reference_in_order(case):
    l_sizes, r_sizes, lo, hi = RAGGED[case]
    rng = np.random.default_rng(len(case))
    l, l_offs = _ragged(rng, l_sizes, lo, hi)
    r, r_offs = _ragged(rng, r_sizes, lo, hi)
    if case == "extremes":  # the pad value and its opposite as real keys
        l[::5], r[::3] = I64.max, I64.max
        l[1::7], r[1::4] = I64.min, I64.min
    got = _port_pairs(l, l_offs, r, r_offs)
    want = _reference_pairs(l, l_offs, r, r_offs)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_presorted_buckets_take_identity_maps(case):
    """Key-sorted buckets (clean index scans) go to B4 as they are, with
    no row maps: the same pairs as the reference's sorting route."""
    l_sizes, r_sizes, lo, hi = RAGGED[case]
    rng = np.random.default_rng(7 + len(case))
    l, l_offs = _ragged(rng, l_sizes, lo, hi)
    r, r_offs = _ragged(rng, r_sizes, lo, hi)
    for keys, offs in ((l, l_offs), (r, r_offs)):
        for a, e in zip(offs[:-1], offs[1:]):
            keys[a:e].sort()
    got = _port_pairs(l, l_offs, r, r_offs, sort_l=False, sort_r=False)
    want = _reference_pairs(l, l_offs, r, r_offs)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


EDGE = b4_edge_cases()


@pytest.mark.parametrize("sort_sides", [False, True])
@pytest.mark.parametrize("case", sorted(EDGE))
def test_b4_edge_cases_match_reference_in_order(case, sort_sides):
    """The shapes that send B4's groups down each search branch (a group
    across one-row segments, windows of W and W + 1 keys, an all-equal
    segment wider than W, ragged n): the plain version's pairs equal the
    reference's, presorted with identity maps and through the sorting
    route with each side's keys shuffled within its segments."""
    l, l_offs, r, r_offs = EDGE[case]
    if sort_sides:
        rng = np.random.default_rng(5)
        l, r = l.copy(), r.copy()
        for keys, offs in ((l, l_offs), (r, r_offs)):
            for a, e in zip(offs[:-1], offs[1:]):
                keys[a:e] = rng.permutation(keys[a:e])
    got = _port_pairs(l, l_offs, r, r_offs, sort_l=sort_sides, sort_r=sort_sides)
    want = _reference_pairs(l, l_offs, r, r_offs)
    assert len(want[0]) > 0
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_edge_cases_sit_at_the_kernels_window_width():
    """The edge cases' window width is the kernel's own (``kWindow`` in
    ``csrc/bucket_match.cu``): the cases of W and W + 1 keys stay at the
    window's edge if it changes."""
    import torch_b4_cases
    from hyperspace_tpu_torch import kernels as port_kernels

    with open(os.path.join(port_kernels.CSRC_DIR, "bucket_match.cu")) as fh:
        found = re.search(r"constexpr int kWindow = (\d+);", fh.read())
    assert found and int(found.group(1)) == torch_b4_cases.WINDOW


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n, m", [(0, 5), (5, 0), (300, 500), (2000, 1500)])
def test_unindexed_match_matches_merge_join_indices(n, m, k):
    rng = np.random.default_rng(n + m + k)
    l_reps = rng.integers(0, 40, size=(k, n), dtype=np.int64)
    r_reps = rng.integers(0, 40, size=(k, m), dtype=np.int64)
    got = TJ.merge_join_indices(l_reps, r_reps, torch.device("cpu"))
    want = JJ.merge_join_indices(l_reps, r_reps)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _null_keyed_buckets(batch_cls, rng_seed, parity_name):
    rng = np.random.default_rng(rng_seed)
    out = {}
    for b in range(5):
        n = int(rng.integers(0, 120))
        out[b] = batch_cls.from_arrow(
            pa.table(
                {
                    parity_name: pa.array(
                        rng.integers(-3, 9, n), type=pa.int64(), mask=rng.random(n) < 0.2
                    ),
                    "v": pa.array(rng.integers(0, 100, n), type=pa.int64()),
                }
            )
        )
    return out


def test_null_sentinel_layout_and_match_equal_the_reference():
    """Null keys become the reference's sentinels (left even, right odd
    offsets); the sentineled per-bucket match gives the reference's pairs,
    and a real key equal to a sentinel is matched and then dropped by the
    numeric re-verification in both packages."""
    sentinel = int(JJ._SENTINEL_BASE)
    sides = {}
    for name, batch_cls, prep in (
        ("port", TBatch, TJ.prepare_join_side),
        ("jax", JBatch, JJ.prepare_join_side),
    ):
        lb = _null_keyed_buckets(batch_cls, 1, "k")
        rb = _null_keyed_buckets(batch_cls, 2, "j")
        rb[0] = batch_cls.concat(
            [rb[0], batch_cls.from_arrow(pa.table({"j": pa.array([sentinel]), "v": [1]}))]
        )
        sides[name] = (prep(lb, ["k"]), prep(rb, ["j"]))
    (tl, tr), (jl, jr) = sides["port"], sides["jax"]
    assert tl.nulls is not None and tr.nulls is not None
    for parity, (tp, jp) in enumerate(((tl, jl), (tr, jr))):
        assert np.array_equal(TJ._sentineled(tp, parity), JJ._sentineled(jp, parity))
    got = TJ._match(tl, tr, TJ._sentineled(tl, 0), TJ._sentineled(tr, 1),
                    torch.device("cpu"), None)
    want = JJ._host_match(jl, jr, JJ._sentineled(jl, 0), JJ._sentineled(jr, 1))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    out = TJ.co_bucketed_join_prepared(tl, tr, [("k", "j")], torch.device("cpu"))
    ref = JJ.co_bucketed_join_prepared(jl, jr, [("k", "j")])
    assert out.to_arrow().equals(ref.to_arrow())
    k = out.column("k")
    assert not k.null_mask.any() and sentinel not in k.values


def test_join_key_equal_to_pad_sentinel():
    """A real INT64_MAX join key is not dropped (reference
    ``test_join_rule.py:268``): the same rows, in order, in both packages."""
    MAX = (1 << 63) - 1
    tables = (
        pa.table({"k": pa.array([1, MAX, 5], type=pa.int64()), "a": [10, 20, 30]}),
        pa.table({"j": pa.array([MAX, 5, MAX], type=pa.int64()), "b": [1, 2, 3]}),
    )
    got = TJ.co_bucketed_join_prepared(
        TJ.prepare_join_side({0: TBatch.from_arrow(tables[0])}, ["k"]),
        TJ.prepare_join_side({0: TBatch.from_arrow(tables[1])}, ["j"]),
        [("k", "j")], torch.device("cpu"),
    )
    want = JJ.co_bucketed_join(
        {0: JBatch.from_arrow(tables[0])}, {0: JBatch.from_arrow(tables[1])},
        [("k", "j")], None,
    )
    assert got.to_arrow().equals(want.to_arrow())
    assert sorted(zip(got.column("k").values.tolist(), got.column("b").values.tolist())) == [
        (5, 2), (MAX, 1), (MAX, 3)
    ]


# --- wrapper host logic -----------------------------------------------------------

_COUNT_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p]
_EMIT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_SCAN_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
_RANGES_ARGS = [ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]


@pytest.fixture
def fake_b4(monkeypatch):
    """Stand ctypes callbacks in for hs_bucket_match_ranges / _count /
    _scan / _emit, so every argument goes through the C types the wrapper
    declares. The range sizing answers ``state["range_groups"]``."""
    from hyperspace_tpu_torch import kernels as port_kernels

    state = {"count": [], "emit": [], "scan": [], "ranges": [], "rc": 0,
             "range_groups": 2}

    def make(name, argtypes):
        def c_function(*args):
            if name == "ranges":
                args[2][0] = state["range_groups"]
                args = args[:2]
            state[name].append(args)
            return state["rc"]

        return ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(c_function)

    lib = type("FakeLib", (), {
        "hs_bucket_match_count": make("count", _COUNT_ARGS),
        "hs_bucket_match_emit": make("emit", _EMIT_ARGS),
        "hs_bucket_match_scan": make("scan", _SCAN_ARGS),
        "hs_bucket_match_ranges": make("ranges", _RANGES_ARGS),
    })()
    monkeypatch.setattr(port_kernels, "load", lambda name: lib)
    monkeypatch.setattr(J, "launches", 0)
    J._kernel_fns.cache_clear()
    yield state
    J._kernel_fns.cache_clear()


def test_count_pass_packs_arguments_for_the_c_function(fake_b4):
    lk = torch.arange(70, dtype=torch.int64)
    rk = torch.arange(9, dtype=torch.int64)
    lo_t = torch.tensor([0, 30, 70])
    ro_t = torch.tensor([0, 4, 9])
    c = J._count_pass(lk, lo_t, rk, ro_t, 2, torch.int32, 0xABC0)
    count = J._kernel_fns()["count"]
    assert list(count.argtypes) == _COUNT_ARGS and count.restype is ctypes.c_int
    (args,) = fake_b4["count"]
    assert args == (lk.data_ptr(), 70, lo_t.data_ptr(), ro_t.data_ptr(), 2,
                    rk.data_ptr(), 2, c.lo.data_ptr(), c.cnt.data_ptr(),
                    c.group_first.data_ptr(), c.range_tot.data_ptr(), 4, 0xABC0)
    assert c.lo.shape == c.cnt.shape == (70,) and c.lo.dtype == c.cnt.dtype == torch.int32
    # 3 groups of 32 rows in ranges of 2 groups: a leading 0, then 2 totals
    assert c.group_first.shape == (3,) and c.group_first.dtype == torch.int64
    assert c.range_tot.shape == (3,) and c.range_tot.dtype == torch.int64
    assert c.range_groups == 2 and J.launches == 1


@pytest.mark.parametrize("with_maps", [False, True])
def test_emit_pass_packs_arguments_and_null_maps(fake_b4, with_maps):
    n, total = 5, 12
    c = J._Counts(torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
                  torch.zeros(1, dtype=torch.int64), torch.tensor([0, total]), 1)
    l_row = torch.arange(n) if with_maps else None
    r_row = torch.arange(20) if with_maps else None
    li, ri = torch.empty(total, dtype=torch.int64), torch.empty(total, dtype=torch.int64)
    J._emit_pass(c, l_row, r_row, li, ri, 7)
    emit = J._kernel_fns()["emit"]
    assert list(emit.argtypes) == _EMIT_ARGS and emit.restype is ctypes.c_int
    (args,) = fake_b4["emit"]
    maps = (l_row.data_ptr(), r_row.data_ptr()) if with_maps else (None, None)
    assert args == (c.lo.data_ptr(), c.cnt.data_ptr(), c.group_first.data_ptr(),
                    c.range_tot.data_ptr(), n, 1, *maps, li.data_ptr(), ri.data_ptr(), 4, 7)
    assert J.launches == 1


def test_scan_pass_packs_arguments_for_the_c_function(fake_b4):
    range_tot = torch.tensor([0, 5, 0, 7], dtype=torch.int64)
    assert J._scan_pass(range_tot, 0xBEE) is range_tot  # in place
    scan = J._kernel_fns()["scan"]
    assert list(scan.argtypes) == _SCAN_ARGS and scan.restype is ctypes.c_int
    assert fake_b4["scan"] == [(range_tot.data_ptr(), 4, 0xBEE)]
    assert J.launches == 1


@pytest.mark.parametrize("dtype, index_bytes", [(torch.int32, 4), (torch.int64, 8)])
def test_range_sizing_asks_the_library(fake_b4, dtype, index_bytes):
    """The groups per range come from the library (one resident wave of
    the count pass), for this n and index type; sizing launches nothing."""
    fake_b4["range_groups"] = 24
    assert J._range_groups(1_500_000, dtype) == 24
    ranges = J._kernel_fns()["ranges"]
    assert list(ranges.argtypes) == _RANGES_ARGS and ranges.restype is ctypes.c_int
    assert fake_b4["ranges"] == [(1_500_000, index_bytes)] and J.launches == 0


def test_launch_raises_on_a_c_error_and_counts_no_launch(fake_b4):
    fake_b4["rc"] = 700  # cudaErrorIllegalAddress
    z = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="count launch failed: CUDA error 700"):
        J._count_pass(z, torch.tensor([0, 3]), z, torch.tensor([0, 3]), 1, torch.int32, 0)
    with pytest.raises(RuntimeError, match="emit launch failed: CUDA error 700"):
        J._emit_pass(J._Counts(z, z, z, torch.tensor([0, 0]), 1), None, None, z, z, 0)
    with pytest.raises(RuntimeError, match="scan launch failed: CUDA error 700"):
        J._scan_pass(torch.tensor([0, 0]), 0)
    with pytest.raises(RuntimeError, match="range sizing launch failed: CUDA error 700"):
        J._range_groups(3, torch.int32)
    assert J.launches == 0


def test_launch_counts_nothing_for_no_rows(fake_b4):
    z = torch.zeros(0, dtype=torch.int64)
    c = J._count_pass(z, torch.tensor([0, 0]), z, torch.tensor([0, 0]), 1, torch.int32, 0)
    J._emit_pass(c, None, None, z, z, 0)
    assert len(fake_b4["count"]) == len(fake_b4["emit"]) == 1 and J.launches == 0


@pytest.mark.parametrize(
    "m, int64_index, want",
    [
        (0, False, torch.int32),
        (6_001_215, False, torch.int32),
        ((1 << 31) - 1, False, torch.int32),
        (1 << 31, False, torch.int64),
        (1 << 40, False, torch.int64),
        (9, True, torch.int64),
    ],
)
def test_index_type_is_int32_below_2_pow_31_right_rows(m, int64_index, want):
    assert J.index_dtype(m, int64_index) == want


@pytest.mark.parametrize("dtype, index_bytes", [(torch.int32, 4), (torch.int64, 8)])
def test_both_index_types_reach_the_c_functions(fake_b4, dtype, index_bytes):
    """lo / cnt of either type go out with their element size, and the
    emit pass takes the type of the count pass's outputs."""
    k = torch.arange(40, dtype=torch.int64)
    offs = torch.tensor([0, 40])
    c = J._count_pass(k, offs, k, offs, 1, dtype, 0)
    assert c.lo.dtype == c.cnt.dtype == dtype
    J._scan_pass(c.range_tot, 0)
    J._emit_pass(c, None, None, k, k, 0)
    assert fake_b4["count"][0][11] == fake_b4["emit"][0][10] == index_bytes
    assert J.launches == 3


def test_kernel_wrapper_refuses_cpu_tensors(fake_b4):
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        J.match_pairs_kernel(k, [0, 4], k, [0, 4])
    assert fake_b4["count"] == [] and J.launches == 0


@pytest.mark.parametrize(
    "l_offs, r_offs, match",
    [
        ([0, 5], [0, 4], "l_offs must rise from 0 to 4"),
        ([1, 4], [0, 4], "l_offs must rise"),
        ([0, 3, 2, 4], [0, 1, 2, 4], "l_offs must rise"),
        ([0, 4], [0, 2, 4], "1 left segments but 2 right"),
        ([4], [4], r"\[B \+ 1\]"),
    ],
)
def test_bad_offsets_are_refused(l_offs, r_offs, match):
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        J.match_pairs(k, l_offs, k, r_offs)


def test_bad_keys_and_maps_are_refused():
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="l_keys must be"):
        J.match_pairs(k.int(), [0, 4], k, [0, 4])
    with pytest.raises(ValueError, match="r_row must be"):
        J.match_pairs(k, [0, 4], k, [0, 4], None, torch.zeros(3, dtype=torch.int64))


def test_zero_size_sides_give_empty_pairs_on_the_cpu():
    z, k = torch.zeros(0, dtype=torch.int64), torch.arange(4)
    for args in ((z, [0, 0], k, [0, 4]), (k, [0, 4], z, [0, 0])):
        li, ri = J.match_pairs(*args)
        assert li.shape == ri.shape == (0,) and li.dtype == torch.int64


def test_b4_is_registered_with_its_plain_version():
    assert port_ops.KERNEL_TWINS["bucket_match_pairs"] == (
        "hyperspace_tpu_torch.ops.join",
        "match_pairs_kernel",
        "match_pairs_torch",
        "hyperspace_tpu_torch/csrc/bucket_match.cu",
    )


# --- JoinIndexRule decisions against the JAX rule -------------------------------


@pytest.fixture
def join_tables(tmp_path):
    """The tables of ``tests/test_join_rule.py``."""
    rng = np.random.default_rng(11)
    n1, n2 = 400, 600
    orders = pa.table(
        {
            "o_key": pa.array(rng.integers(0, 80, n1), type=pa.int64()),
            "o_amount": pa.array(rng.normal(100, 20, n1)),
            "o_tag": pa.array([f"t{int(x) % 4}" for x in rng.integers(0, 99, n1)]),
        }
    )
    items = pa.table(
        {
            "l_key": pa.array(rng.integers(0, 80, n2), type=pa.int64()),
            "l_qty": pa.array(rng.integers(1, 9, n2), type=pa.int64()),
        }
    )
    d1, d2 = tmp_path / "orders", tmp_path / "items"
    d1.mkdir(), d2.mkdir()
    for i in range(2):
        pq.write_table(orders.slice(i * 200, 200), d1 / f"p{i}.parquet")
    for i in range(3):
        pq.write_table(items.slice(i * 200, 200), d2 / f"p{i}.parquet")
    return str(d1), str(d2)


def _null_tables(tmp_path):
    rng = np.random.default_rng(23)
    n1, n2 = 300, 500
    a = pa.table(
        {
            "k1": pa.array([None if i % 17 == 0 else int(x) for i, x in
                            enumerate(rng.integers(0, 12, n1))], type=pa.int64()),
            "k2": pa.array(rng.integers(0, 5, n1), type=pa.int64()),
            "va": pa.array(rng.normal(size=n1)),
        }
    )
    b = pa.table(
        {
            "j1": pa.array([None if i % 13 == 0 else int(x) for i, x in
                            enumerate(rng.integers(0, 12, n2))], type=pa.int64()),
            "j2": pa.array(rng.integers(0, 5, n2), type=pa.int64()),
            "vb": pa.array(rng.integers(0, 100, n2), type=pa.int64()),
        }
    )
    return _write_pair(tmp_path, a, b)


def _string_tables(tmp_path):
    a = pa.table({"tag_a": ["x", "y", "z", "x", "w"], "va": [1, 2, 3, 4, 5]})
    b = pa.table({"tag_b": ["x", "x", "q", "z"], "vb": [10, 20, 30, 40]})
    return _write_pair(tmp_path, a, b)


def _write_pair(tmp_path, a, b):
    (tmp_path / "a").mkdir(), (tmp_path / "b").mkdir()
    pq.write_table(a, tmp_path / "a" / "p.parquet")
    pq.write_table(b, tmp_path / "b" / "p.parquet")
    return str(tmp_path / "a"), str(tmp_path / "b")


def _q_both(o, i):
    return o.join(i, on=o["o_key"] == i["l_key"]).select("o_key", "o_amount", "l_qty")


def _q_filter_sides(o, i):
    return o.filter(o["o_key"] > 10).join(i, on=o["o_key"] == i["l_key"]).select(
        "o_key", "l_qty")


def _q_uncovered(o, i):
    return o.join(i, on=o["o_key"] == i["l_key"]).select("o_key", "o_tag", "l_qty")


def _q_beats_filter(o, i):
    return o.filter(o["o_key"] > 0).join(i, on=o["o_key"] == i["l_key"]).select(
        "o_key", "l_qty")


def _q_bare(o, i):
    return o.join(i, on=o["o_key"] == i["l_key"])


def _q_string(a, b):
    return a.join(b, on=a["tag_a"] == b["tag_b"]).select("va", "vb")


def _q_nulls(a, b):
    return a.join(b, on=(a["k1"] == b["j1"]) & (a["k2"] == b["j2"])).select(
        "k1", "k2", "va", "vb")


_O_IDX = ("o_idx", ["o_key"], ["o_amount"])
_L_IDX = ("l_idx", ["l_key"], ["l_qty"])
# case -> (tables, index configs per side, query, lineage, want index scans)
RULE_CASES = {
    "both_sides_rewritten": ("join", [_O_IDX], [_L_IDX], _q_both, False, 2),  # :63
    "filter_sides": ("join", [_O_IDX], [_L_IDX], _q_filter_sides, False, 2),  # :82
    "uncovered_columns": ("join", [_O_IDX], [_L_IDX], _q_uncovered, False, 0),  # :98
    "index_on_wrong_column": (  # :111
        "join", [("o_bad", ["o_amount"], ["o_key"])], [_L_IDX], _q_both, False, 0),
    "join_beats_filter_rule": ("join", [_O_IDX], [_L_IDX], _q_beats_filter, False, 2),  # :127
    "string_key": (  # :167
        "string", [("a_idx", ["tag_a"], ["va"])], [("b_idx", ["tag_b"], ["vb"])],
        _q_string, False, 2),
    "lineage_column_not_leaked": (  # :188
        "join", [("o_idx", ["o_key"], ["o_amount", "o_tag"])], [_L_IDX], _q_bare, True, 2),
    "multi_key_with_nulls": (  # :217
        "nulls", [("ab_idx", ["k1", "k2"], ["va"])], [("bb_idx", ["j1", "j2"], ["vb"])],
        _q_nulls, False, 2),
}


def _rule_run(pkg, root, src, case):
    """Build the case's indexes with ``pkg`` and report what its rule
    decided: plan text, score, filter reasons per (leaf, index), rows."""
    tables, l_cfgs, r_cfgs, query, lineage, _ = RULE_CASES[case]
    if pkg == "port":
        from hyperspace_tpu_torch.constants import States
        from hyperspace_tpu_torch.rules import tags
        from hyperspace_tpu_torch.rules.candidate import collect_candidates
        from hyperspace_tpu_torch.rules.score import ScoreBasedIndexPlanOptimizer
        from hyperspace_tpu_torch.plan.nodes import prune_join_columns

        s = T.HyperspaceSession(device="cpu")
        s.conf.set("hyperspace.system.path", root)
        s.conf.set("hyperspace.index.num_buckets", 8)
        s.conf.set("hyperspace.index.lineage.enabled", lineage)
        hs, cfg = T.Hyperspace(s), TConfig
    else:
        from hyperspace_tpu.constants import States
        from hyperspace_tpu.rules import tags
        from hyperspace_tpu.rules.candidate import collect_candidates
        from hyperspace_tpu.rules.score import ScoreBasedIndexPlanOptimizer
        from hyperspace_tpu.plan.nodes import prune_join_columns

        s = JSession()
        s.conf.set(JC.INDEX_SYSTEM_PATH, root)
        s.conf.set(JC.INDEX_NUM_BUCKETS, 8)
        s.conf.set(JC.BUILD_NUM_SHARDS, 1)
        s.conf.set(JC.INDEX_LINEAGE_ENABLED, lineage)
        hs, cfg = JHyperspace(s), JConfig
    left, right = s.read.parquet(src[0]), s.read.parquet(src[1])
    for df, cfgs in ((left, l_cfgs), (right, r_cfgs)):
        for c in cfgs:
            hs.create_index(df, cfg(*c))
    q = query(left, right)
    entries = sorted(s.index_manager.get_indexes([States.ACTIVE]), key=lambda e: e.name)
    for e in entries:
        e.set_tag(None, tags.INDEX_PLAN_ANALYSIS_ENABLED, True)
    plan = prune_join_columns(q.logical_plan)
    cands = collect_candidates(s, plan, entries)
    best, score = ScoreBasedIndexPlanOptimizer(s).apply_with_score(plan, cands)
    reasons = [
        [(e.name, [(r.code, r.args) for r in e.get_tag(leaf, tags.FILTER_REASONS) or []])
         for e in entries]
        for leaf in plan.collect_leaves()
    ]
    s.enable_hyperspace()
    text = hs.explain(q).replace(root, "<sys>")
    rows = q.collect()
    s.disable_hyperspace()
    return {"plan": best.pretty().replace(root, "<sys>"), "score": score,
            "reasons": reasons, "rows": rows, "unindexed": q.collect(), "explain": text}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_join_rule_decides_as_the_reference(case, tmp_path, join_tables):
    kind = RULE_CASES[case][0]
    src = {"join": join_tables, "string": None, "nulls": None}[kind]
    if kind == "string":
        src = _string_tables(tmp_path)
    elif kind == "nulls":
        src = _null_tables(tmp_path)
    got = _rule_run("port", str(tmp_path / "port"), src, case)
    want = _rule_run("jax", str(tmp_path / "jax"), src, case)
    assert got["plan"].replace("/port/", "/<pkg>/") == want["plan"].replace("/jax/", "/<pkg>/")
    assert got["score"] == want["score"] == 70 * RULE_CASES[case][5]
    assert got["reasons"] == want["reasons"]
    assert got["rows"].equals(want["rows"])
    assert got["unindexed"].equals(want["unindexed"])
    n_scans = RULE_CASES[case][5]
    for out in (got, want):
        plan_part = out["explain"].split("Plan without indexes:")[0]
        assert plan_part.count("Hyperspace(Type: CI") == n_scans
    if case == "lineage_column_not_leaked":
        assert "_data_file_id" not in got["rows"].column_names
