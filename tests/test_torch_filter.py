"""The port's device predicate mask against the JAX package's device
mask (ops/filter.device_filter_mask) and host evaluator
(plan/expressions.filter_mask), on the same Arrow table: SQL
three-valued logic, nulls, NaN, IN lists with and without NULL, string
compares and date/timestamp literals. Masks are booleans: exact
equality."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import datetime

import numpy as np
import pyarrow as pa
import pytest

from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.ops.filter import device_filter_mask as jax_device_mask
from hyperspace_tpu.plan import expressions as JE
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.ops import filter as TF
from hyperspace_tpu_torch.plan import expressions as TE

N = 500


def _table() -> pa.Table:
    rng = np.random.default_rng(11)

    def nulls(p=0.1):
        return rng.random(N) < p

    i64 = rng.integers(-50, 50, N)
    f64 = rng.normal(0, 10, N).round(1)
    f64[rng.random(N) < 0.05] = np.nan
    f64[:3] = [0.0, -0.0, np.nan]
    words = np.array(["apple", "banana", "cherry", "date", "elder", "fig"])
    days = rng.integers(18000, 18100, N).astype(np.int32)
    ts = rng.integers(1_600_000_000_000_000, 1_600_100_000_000_000, N)
    return pa.table(
        {
            "i64": pa.array(i64, mask=nulls()),
            "i32": pa.array(rng.integers(-5, 5, N).astype(np.int32)),
            "f64": pa.array(f64, mask=nulls(0.05)),
            "f32": pa.array(rng.normal(0, 1, N).astype(np.float32)),
            "s": pa.array(words[rng.integers(0, 6, N)], mask=nulls()),
            "d": pa.array(days, mask=nulls()).cast(pa.date32()),
            "ts": pa.array(ts, type=pa.timestamp("us")),
            "b": pa.array(rng.random(N) < 0.5, mask=nulls(0.05)),
            "u8": pa.array(rng.integers(0, 255, N).astype(np.uint8)),
        }
    )


def _col(E, name):
    return E.Col(name)


# each predicate is built per package from its own expression module
PREDICATES = {
    "eq_int": lambda E: E.Col("i64") == 7,
    "ne_int_nulls": lambda E: E.Col("i64") != 7,
    "lt_lit_left": lambda E: E.Lt(E.Lit(3), E.Col("i64")),
    "le_float_lit_on_int": lambda E: E.Col("i64") <= 2.5,
    "ge_int32_vs_int64_lit": lambda E: E.Col("i32") >= np.int64(1),
    "gt_nan_col": lambda E: E.Col("f64") > 0.0,
    "eq_nan_lit": lambda E: E.Col("f64") == float("nan"),
    "eq_neg_zero": lambda E: E.Col("f64") == -0.0,
    "col_col": lambda E: E.Col("i64") < E.Col("f64"),
    "and_nulls": lambda E: (E.Col("i64") > 0) & (E.Col("f64") < 5.0),
    "or_nulls": lambda E: (E.Col("i64") > 10) | (E.Col("s") == "fig"),
    "not_and": lambda E: ~((E.Col("i64") > 0) & E.Col("f64").is_null()),
    "not_or": lambda E: ~((E.Col("i64") < 0) | (E.Col("b") == True)),  # noqa: E712
    "isnull": lambda E: E.Col("s").is_null(),
    "is_not_null": lambda E: E.Col("d").is_not_null(),
    "in_ints": lambda E: E.Col("i64").isin(3, -7, 11, 48),
    "in_with_null": lambda E: E.Col("i64").isin(3, None, -7),
    "not_in_with_null": lambda E: ~E.Col("i64").isin(3, None, -7),
    "in_only_null": lambda E: E.Col("i64").isin(None),
    "in_floats_nan": lambda E: E.Col("f64").isin(float("nan"), 1.5, -0.0),
    "in_mixed_types": lambda E: E.Col("i32").isin(1, "a", 2.0),
    "str_eq": lambda E: E.Col("s") == "cherry",
    "str_ne": lambda E: E.Col("s") != "cherry",
    "str_lt": lambda E: E.Col("s") < "c",
    "str_ge_absent": lambda E: E.Col("s") >= "coconut",
    "str_in_null": lambda E: E.Col("s").isin("apple", "kiwi", None),
    "not_str_in": lambda E: ~E.Col("s").isin("apple", "date"),
    "date_lit": lambda E: E.Col("d") >= datetime.date(2019, 4, 1),
    "date_iso_eq": lambda E: E.Col("d") == "2019-04-05",
    "date_between_ticks": lambda E: E.Col("d") < np.datetime64("2019-04-05T12:00"),
    "date_unrep": lambda E: E.Col("d") != "not a date",
    "ts_lit": lambda E: E.Col("ts") < datetime.datetime(2020, 9, 14, 12, 0),
    "ts_in": lambda E: E.Col("ts").isin(np.datetime64("2020-09-13T12:26:40")),
    "bool_eq": lambda E: E.Col("b") == True,  # noqa: E712
    "uint8_vs_negative": lambda E: E.Col("u8") > -1,
    "const_true_and_null_lit": lambda E: E.Lit(True) & (E.Col("i64") == None),  # noqa: E711
}


@pytest.fixture(scope="module")
def batches():
    t = _table()
    return TBatch.from_arrow(t), JBatch.from_arrow(t)


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_mask_matches_reference(name, batches):
    tb, jb = batches
    build = PREDICATES[name]
    got = TF.device_filter_mask(build(TE), tb, "cpu")
    host = JE.filter_mask(build(JE), jb)
    assert got.dtype == np.bool_ and got.shape == (N,)
    assert np.array_equal(got, host)
    assert np.array_equal(got, jax_device_mask(build(JE), jb))


@pytest.mark.parametrize("lit", [0.1, 0.3, -1.7, 2])
def test_float32_column_compares_like_the_host_path(lit, batches):
    """A Python float literal on a float32 column compares in float32, as
    the host path (numpy) does, and as the JAX executor does below its
    device-filter row threshold."""
    tb, jb = batches
    for op in ("__eq__", "__lt__", "__ge__"):
        got = TF.device_filter_mask(getattr(TE.Col("f32"), op)(lit), tb, "cpu")
        want = JE.filter_mask(getattr(JE.Col("f32"), op)(lit), jb)
        assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "build",
    [
        lambda E: E.Col("s") == E.Col("s"),  # string col-col
        lambda E: E.Col("s") < E.Col("i64"),  # mixed
        lambda E: E.Lit(5),  # bare non-bool literal
    ],
)
def test_unsupported_predicates_raise(build, batches):
    tb, _jb = batches
    with pytest.raises(TF.Unsupported):
        TF.device_filter_mask(build(TE), tb, "cpu")


def test_wide_unsigned_column_is_unsupported():
    """Wide unsigned columns used to be refused here (and masked on the
    host); they now lower: uint64 compares with its sign bit flipped, so
    values at and above 2^63 keep their order."""
    u = np.array([0, 3, 4, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64)
    t = pa.table({"u": pa.array(u)})
    for lit in (np.uint64(3), 2**63, 2**63 - 1):
        got = TF.device_filter_mask(TE.Col("u") > lit, TBatch.from_arrow(t), "cpu")
        assert np.array_equal(got, u > lit)


def test_empty_batch():
    t = _table().slice(0, 0)
    got = TF.device_filter_mask(TE.Col("i64") == 1, TBatch.from_arrow(t), "cpu")
    assert got.shape == (0,) and got.dtype == np.bool_


def _unsigned_table() -> pa.Table:
    rng = np.random.default_rng(17)
    u64 = rng.integers(0, 2**64 - 1, N, dtype=np.uint64, endpoint=True)
    u64[:6] = [0, 1, 2**63 - 1, 2**63, 2**64 - 1, 2**53 + 1]
    u32 = rng.integers(0, 2**32 - 1, N, dtype=np.uint32, endpoint=True)
    u32[:4] = [0, 2**31, 2**32 - 1, 2**31 - 1]
    u16 = rng.integers(0, 2**16 - 1, N, dtype=np.uint16, endpoint=True)
    u16[:3] = [0, 2**15, 2**16 - 1]
    return pa.table(
        {
            "u64": pa.array(u64, mask=rng.random(N) < 0.1),
            "u32": pa.array(u32),
            "u16": pa.array(u16, mask=rng.random(N) < 0.1),
            "i64": pa.array(rng.integers(-(2**62), 2**62, N)),
            "f64": pa.array(rng.normal(0, 1e19, N)),
        }
    )


UNSIGNED_PREDICATES = {
    "u32_eq_2_31": lambda E: E.Col("u32") == 2**31,
    "u32_gt_negative": lambda E: E.Col("u32") > -1,
    "u32_le_float": lambda E: E.Col("u32") <= 2.5e9,
    "u32_lt_np_uint64": lambda E: E.Col("u32") < np.uint64(2**31),
    "u16_ge": lambda E: E.Col("u16") >= 2**15,
    "u16_ne_bool": lambda E: E.Col("u16") != True,  # noqa: E712
    "u16_in": lambda E: E.Col("u16").isin(0, 2**15, 70_000, -3),
    "u64_ge_2_63": lambda E: E.Col("u64") >= 2**63,
    "u64_eq_max": lambda E: E.Col("u64") == 2**64 - 1,
    "u64_lt_np_uint64": lambda E: E.Col("u64") < np.uint64(2**63 + 5),
    "u64_gt_negative": lambda E: E.Col("u64") > -1,
    "u64_gt_np_int64": lambda E: E.Col("u64") > np.int64(-1),
    "u64_le_float": lambda E: E.Col("u64") <= 9.3e18,
    "u64_in": lambda E: E.Col("u64").isin(1, 2**63, 2**64 - 1),
    "u64_col_i64": lambda E: E.Col("u64") < E.Col("i64"),
    "u64_col_f64": lambda E: E.Col("u64") >= E.Col("f64"),
    "u16_col_u32": lambda E: E.Col("u16") > E.Col("u32"),
    "u32_col_i64": lambda E: E.Col("u32") != E.Col("i64"),
    "u64_and_or": lambda E: ((E.Col("u64") > 2**62) & (E.Col("u32") < 2**31))
    | E.Col("u16").is_null(),
    # the JAX device mask compares uint64 with an int64 literal in float64
    # (2^63 - 1 rounds to 2^63); the port compares exactly, as the host
    # evaluator does (ROADMAP C.3)
    "u64_ne_2_63_minus_1": lambda E: E.Col("u64") != 2**63 - 1,
}
JAX_DEVICE_DIFFERS = {"u64_ne_2_63_minus_1"}


@pytest.mark.parametrize("name", sorted(UNSIGNED_PREDICATES))
def test_unsigned_columns_mask_on_the_device(name):
    """uint16, uint32 and uint64 columns lower to the device mask and give
    the host evaluator's mask, and the JAX device mask's wherever that one
    agrees with the host."""
    t = _unsigned_table()
    tb, jb = TBatch.from_arrow(t), JBatch.from_arrow(t)
    build = UNSIGNED_PREDICATES[name]
    got = TF.device_filter_mask(build(TE), tb, "cpu")
    host = JE.filter_mask(build(JE), jb)
    assert np.array_equal(got, host)
    assert np.array_equal(got, TE.filter_mask(build(TE), tb))
    jax = jax_device_mask(build(JE), jb)
    assert np.array_equal(got, jax) == (name not in JAX_DEVICE_DIFFERS)
