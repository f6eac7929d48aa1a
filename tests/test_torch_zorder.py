"""The port's z-address ops against the JAX package on the CPU, bit for
bit: the order encodings (``order_u64_np``) over every column type, the
encoder's planes under range, dict and quantile specs, the plain
interleave against the reference's ``_interleave`` over
``tests/torch_b6_cases.py``'s small cases, the z-order permutation, the
box decomposition (``spec_word_bounds``, ``z_box_ranges``,
``pack_box_ranges``) and the span reader ``planes_z_minmax``; plus the
reference's own cases of ``tests/test_zorder.py::TestZAddress`` and
``tests/test_range_prune.py::TestZBoxRanges`` run on the port, and the
wrappers' device rule."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
from hyperspace_tpu.io.columnar import Column as JColumn
from hyperspace_tpu.ops import zorder as JZ
from hyperspace_tpu_torch import ops as port_ops
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import Column as TColumn
from hyperspace_tpu_torch.ops import zorder as TZ
from hyperspace_tpu_torch.ops.sort import lexsort_permutation
import torch_b6_cases as B6

I64 = np.iinfo(np.int64)


def _arrays():
    """name -> arrow array: every column type the encoder takes, with
    nulls, NaN, +-0.0, +-inf and the integer extremes."""
    rng = np.random.default_rng(5)
    f = rng.normal(0, 1e3, 200)
    f[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324, -5e-324, np.nan]
    mask = rng.random(200) < 0.1
    base = np.datetime64("2019-01-01")
    out = {
        "int64": pa.array(np.r_[[I64.min, I64.max, -1, 0], rng.integers(-1e9, 1e9, 196)]),
        "int64_nulls": pa.array(rng.integers(-50, 50, 200), mask=mask),
        "int32": pa.array(rng.integers(-1000, 1000, 200).astype(np.int32)),
        "int16": pa.array(rng.integers(-300, 300, 200).astype(np.int16)),
        "int8": pa.array(rng.integers(-128, 127, 200).astype(np.int8)),
        "uint64": pa.array(np.concatenate([np.array([0, 2**64 - 1, 2**63], dtype=np.uint64),
                                           rng.integers(0, 2**40, 197).astype(np.uint64)])),
        "uint32": pa.array(rng.integers(0, 2**32 - 1, 200, dtype=np.uint64).astype(np.uint32)),
        "uint8": pa.array(rng.integers(0, 255, 200).astype(np.uint8)),
        "float64": pa.array(f),
        "float64_nulls": pa.array(f, mask=mask),
        "float32": pa.array(f.astype(np.float32)),
        "bool": pa.array(rng.random(200) < 0.5),
        "bool_nulls": pa.array(rng.random(200) < 0.5, mask=mask),
        "string": pa.array([f"s{int(x):04d}" for x in rng.integers(0, 60, 200)]),
        "string_nulls": pa.array(
            [None if m else f"s{int(x)}" for m, x in zip(mask, rng.integers(0, 60, 200))]
        ),
        "date32": pa.array((base + rng.integers(0, 900, 200)).astype("datetime64[D]")),
        "timestamp": pa.array(
            (base + rng.integers(0, 900, 200)).astype("datetime64[us]"),
            type=pa.timestamp("us", tz="UTC"),
        ),
        "empty": pa.array([], type=pa.int64()),
    }
    return out


ARRAYS = _arrays()


def _cols(arr):
    return TColumn.from_arrow(arr), JColumn.from_arrow(arr)


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_order_encoding_equals_the_reference(name):
    t, j = _cols(ARRAYS[name])
    got, want = TZ.order_u64_np(t), JZ.order_u64_np(j)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)


def test_date_values_take_the_integer_branch():
    t, j = _cols(ARRAYS["date32"])
    assert t.values.dtype == j.values.dtype and t.values.dtype.kind == "i"


ENCODER_SETS = {
    "k1": ["int64"],
    "k2": ["date32", "int64_nulls"],
    "k3": ["float64_nulls", "string", "uint64"],
    "k4": ["int32", "string_nulls", "bool", "timestamp"],
}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("quantile", [False, True])
@pytest.mark.parametrize("cols", sorted(ENCODER_SETS))
def test_encoder_planes_equal_the_reference(cols, quantile, bits):
    """Range or quantile specs for the numeric columns, dict specs for the
    strings: the same specs and bit-equal planes."""
    pairs = [_cols(ARRAYS[c]) for c in ENCODER_SETS[cols]]
    tenc, tencs = TZ.ZOrderEncoder.fit([p[0] for p in pairs], bits, quantile, 0.05)
    jenc, jencs = JZ.ZOrderEncoder.fit([p[1] for p in pairs], bits, quantile, 0.05)
    for a, b in zip(tenc.specs, jenc.specs):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    for a, b in zip(tencs, jencs):
        assert np.array_equal(a, b)
    got = TZ.planes_to_numpy(tenc.planes([p[0] for p in pairs], "cpu"))
    want = jenc.planes([p[1] for p in pairs])
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert got.shape == (TZ.num_planes(len(pairs), bits), 200)


@pytest.mark.parametrize("case", B6.SMALL_CASES, ids=B6.case_id)
def test_plain_interleave_equals_the_reference(case):
    n, k, bits, _fill, _offset = case
    words = B6.words_tensor(case, "cpu")
    got = TZ.planes_to_numpy(TZ.interleave_torch(words, bits))
    assert got.shape == (TZ.num_planes(k, bits), n)
    if n:
        want = np.asarray(JZ._interleave(jnp.asarray(B6.case_words(case)), bits))
        assert np.array_equal(got, want)


def test_cases_cover_the_kernels_paths():
    """Every specialised (k, bits) route of ``csrc/zorder_interleave.cu``
    and its generic one, at k * bits of 32, 33, 48 and 128, views 4 bytes
    off a 16-byte boundary, and SF1's row count."""
    prods = {k * bits for _n, k, bits, _f, _o in B6.CASES}
    assert {32, 33, 48, 128} <= prods
    assert any(k > 1 and bits > 16 for _n, k, bits, _f, _o in B6.CASES)
    assert any(o for *_r, o in B6.CASES) and B6.N_FULL in {c[0] for c in B6.CASES}
    assert {"zero", "top", "random"} == {c[3] for c in B6.CASES}


def test_interleave_keeps_the_last_planes_padding_zero():
    words = torch.full((3, 5), 2**11 - 1, dtype=torch.int32)
    planes = TZ.planes_to_numpy(TZ.interleave(words, 11))
    assert planes.shape == (2, 5)
    assert (planes[0] == 0xFFFFFFFF).all() and (planes[1] == 0x80000000).all()


def test_interleave_rules():
    with pytest.raises(ValueError):
        TZ.interleave(torch.zeros((2, 3), dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        TZ.interleave(torch.zeros((2, 3), dtype=torch.int32), 33)
    with pytest.raises(ValueError):
        TZ.interleave(torch.zeros((0, 3), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        TZ.interleave(torch.zeros((2, 3), dtype=torch.int32, device="meta"), 16)
    with pytest.raises(ValueError, match="CUDA"):
        TZ.interleave_kernel(torch.zeros((2, 3), dtype=torch.int32), 16)
    before = TZ.launches
    TZ.interleave(torch.zeros((2, 3), dtype=torch.int32), 16)
    assert TZ.launches == before  # the plain version launches nothing


def test_b6_is_registered_with_its_twin():
    assert port_ops.KERNEL_TWINS["zorder_interleave"] == (
        "hyperspace_tpu_torch.ops.zorder", "interleave_kernel", "interleave_torch",
        "hyperspace_tpu_torch/csrc/zorder_interleave.cu")
    port_ops.reset_launch_counts()
    assert port_ops.launch_counts()["zorder_interleave"] == 0


def test_lexsort_sorts_the_top_bit_last_and_stays_stable():
    rng = np.random.default_rng(2)
    planes = rng.integers(0, 2**32, size=(2, 3000), dtype=np.uint64).astype(np.uint32)
    planes[0, ::3] = 0x80000000  # ties in the primary plane, top bit set
    planes[1, ::6] = 7
    got = lexsort_permutation(torch.from_numpy(planes.view(np.int32))).numpy()
    assert np.array_equal(got, np.lexsort(planes[::-1]))


PERM_SETS = {
    "ints": ["int64"],
    "ties": ["uint8", "bool"],
    "mixed": ["date32", "string", "float64"],
    "nulls": ["int64_nulls", "string_nulls", "float64_nulls", "bool_nulls"],
}


@pytest.mark.parametrize("quantile", [False, True])
@pytest.mark.parametrize("cols", sorted(PERM_SETS))
def test_z_order_permutation_equals_the_reference(cols, quantile):
    pairs = [_cols(ARRAYS[c]) for c in PERM_SETS[cols]]
    got = TZ.z_order_permutation([p[0] for p in pairs], quantile=quantile, device="cpu")
    want = JZ.z_order_permutation([p[1] for p in pairs], quantile=quantile)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_z_order_permutation_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HyperspaceException, match="device='cpu'"):
        TZ.z_order_permutation([TColumn.from_arrow(ARRAYS["int64"])])


SPECS = [
    ("range", 0, 1000),
    ("range", 2**63 - 5, 2**63 + 10**6),
    ("range", 7, 7),
    ("dict", ["a", "b", "c", "d"]),
    ("quantile", [1, 2, 3]),
]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_spec_word_bounds_equal_the_reference(spec, bits):
    rng = np.random.default_rng(spec)
    sp = SPECS[spec]
    for _ in range(200):
        lo = int(rng.integers(0, 2**62)) if rng.random() < 0.3 else int(rng.integers(0, 1200))
        hi = lo + int(rng.integers(0, 900))
        if sp[0] == "range" and sp[1] > 2**62:
            lo, hi = lo + 2**63 - 10, hi + 2**63 - 10
        assert TZ.spec_word_bounds(sp, lo, hi, bits) == JZ.spec_word_bounds(sp, lo, hi, bits)


@pytest.mark.parametrize("k, bits", [(1, 16), (2, 4), (2, 16), (3, 8), (4, 16)])
def test_z_box_ranges_equal_the_reference(k, bits):
    rng = np.random.default_rng(k * 100 + bits)
    for max_ranges in (4, 64):
        for _ in range(20):
            lo = [int(x) for x in rng.integers(0, 1 << bits, k)]
            hi = [int(rng.integers(a, 1 << bits)) for a in lo]
            got = TZ.z_box_ranges(lo, hi, bits, max_ranges)
            assert got == JZ.z_box_ranges(lo, hi, bits, max_ranges)
            nplanes = TZ.num_planes(k, bits)
            assert TZ.pack_box_ranges(got, bits, k, nplanes) == JZ.pack_box_ranges(
                got, bits, k, nplanes)


def test_scalar_encoding_equals_the_reference():
    for kind, values in (("i", [I64.min, -1, 0, 5, I64.max]), ("u", [0, 2**64 - 1]),
                         ("f", [-np.inf, -0.0, 0.0, 1.5, np.inf]), ("b", [False, True])):
        for v in values:
            assert TZ.order_u64_scalar(v, kind) == JZ.order_u64_scalar(v, kind)


@pytest.mark.parametrize("nplanes", [1, 2])
def test_planes_z_minmax_equals_the_reference(nplanes):
    rng = np.random.default_rng(nplanes)
    planes = rng.integers(0, 2**32, size=(nplanes, 500), dtype=np.uint64).astype(np.uint32)
    planes[0, 100:200] = 3  # ties in plane 0: the span turns on plane 1
    for start, end in ((0, 500), (100, 200), (7, 8), (40, 40), (0, 64)):
        got = TZ.planes_z_minmax(planes, start, end)
        assert got == JZ.planes_z_minmax(planes, start, end)


# -- the reference's own cases (tests/test_zorder.py::TestZAddress) ---------


def test_order_encoding_preserves_order():
    e = TZ.order_u64_np(TColumn.from_arrow(pa.array([-5, -1, 0, 3, 2**40], type=pa.int64())))
    assert (e[:-1] < e[1:]).all()
    e = TZ.order_u64_np(TColumn.from_arrow(pa.array([-1e9, -1.5, -0.0, 0.25, 3e7])))
    assert (e[:-1] < e[1:]).all()
    e = TZ.order_u64_np(TColumn.from_arrow(pa.array(["b", "a", "c"])))
    assert e[1] < e[0] < e[2]


def test_null_sorts_first():
    e = TZ.order_u64_np(TColumn.from_arrow(pa.array([5, None, -3], type=pa.int64())))
    assert e[1] == 0 and e[1] < e[2] < e[0]


def test_z_permutation_locality():
    """Each contiguous quarter of the z-order of a 32 x 32 grid stays within
    about half the range in both dimensions."""
    n = 32
    xs, ys = np.meshgrid(np.arange(n), np.arange(n))
    xs, ys = xs.ravel(), ys.ravel()
    cx = TColumn.from_arrow(pa.array(xs, type=pa.int64()))
    cy = TColumn.from_arrow(pa.array(ys, type=pa.int64()))
    perm = TZ.z_order_permutation([cx, cy], bits=8, device="cpu").numpy()
    quarter = len(perm) // 4
    for q in range(4):
        idx = perm[q * quarter:(q + 1) * quarter]
        assert xs[idx].max() - xs[idx].min() <= n // 2 + 1
        assert ys[idx].max() - ys[idx].min() <= n // 2 + 1


# -- the reference's own cases (tests/test_range_prune.py::TestZBoxRanges) --


def _z(x, y, bits):
    z = 0
    for t in range(2 * bits):
        z = (z << 1) | (((x, y)[t % 2] >> (bits - 1 - t // 2)) & 1)
    return z


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_z_box_ranges_cover_the_box(seed):
    bits = 4
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << bits, 2)
    hi = [int(rng.integers(a, 1 << bits)) for a in lo]
    ranges = TZ.z_box_ranges(list(map(int, lo)), hi, bits, max_ranges=8)
    for x in range(int(lo[0]), hi[0] + 1):
        for y in range(int(lo[1]), hi[1] + 1):
            z = _z(x, y, bits)
            assert any(a <= z <= b for a, b in ranges), (x, y, z)


def test_full_box_is_one_range():
    assert TZ.z_box_ranges([0, 0], [15, 15], 4) == [(0, 255)]


def test_budget_caps_range_count():
    assert len(TZ.z_box_ranges([1, 3], [14, 11], 8, max_ranges=4)) <= 4 * 4 + 1
