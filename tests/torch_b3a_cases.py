"""Cases of kernel B3a, the fused range mask (``csrc/range_mask.cu``),
shared by ``test_torch_range_mask.py`` (plain version against the JAX
package, on the CPU), ``test_torch_cuda.py`` and ``chip_smoke.py``
(kernel against the plain version, on the card). numpy and pyarrow only.

Each table has the same columns at another row count: ``i`` (int64 with
INT64_MIN and INT64_MAX and nulls), ``j`` (int64 without nulls), ``f``
(float64 with NaN, -0.0, 0.0, +-inf and nulls), ``d`` (date32, read by
B3a as its int64 view). The row counts straddle the kernel's pairs of
rows and its ``kUnroll`` pairs a thread: 1, 31, 33, a ragged tail past
one block's 2,048 rows, and an odd count of several blocks. Each
predicate is built from the expression module passed in (either
package's), so one case runs through both."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import datetime

import numpy as np
import pyarrow as pa

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
ROWS = (1, 31, 33, 2 * 2048 + 5, 100_003)


def b3a_table(n: int, seed: int = 7) -> pa.Table:
    rng = np.random.default_rng(seed + n)
    i = rng.integers(-200, 200, n, dtype=np.int64)
    i[::17] = I64_MIN
    i[5::19] = I64_MAX
    f = rng.normal(0, 3, n).round(1)
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 2.5, -1.5])
    f[: min(n, len(special))] = special[: min(n, len(special))]
    f[11::13] = np.nan
    days = rng.integers(18000, 18400, n).astype(np.int32)
    return pa.table(
        {
            "i": pa.array(i, mask=rng.random(n) < 0.1),
            "j": pa.array(rng.integers(0, 10, n, dtype=np.int64)),
            "f": pa.array(f, mask=rng.random(n) < 0.05),
            "d": pa.array(days).cast(pa.date32()),
        }
    )


def _sixteen(E):
    c = E.Col
    out = (c("i") > -150) & (c("i") < 150)
    for k in range(3):
        out = out & (c("j") >= k) & (c("j") <= 9 - k)
    out = out & (c("f") > -4.5) & (c("f") <= 4.5) & (c("f") < 5.0)
    out = out & (c("d") >= datetime.date(2019, 4, 1)) & (c("d") < datetime.date(2020, 1, 1))
    out = out & (c("i") >= -149) & (c("i") <= 149) & (c("j") < 10)
    return out


# label -> (build(E) -> predicate, route): "fused" lowers to B3a terms;
# "never" lowers to NEVER_MATCH (all-False, no launch); "general" is
# refused by the exact bounds and takes the general device mask
B3A_PREDICATES = {
    "int range": (lambda E: (E.Col("i") >= -5) & (E.Col("i") < 100), "fused"),
    "int strict": (lambda E: (E.Col("i") > -5) & (E.Col("i") <= 100), "fused"),
    "int eq": (lambda E: E.Col("i") == 7, "fused"),
    "int64 min/max bounds": (
        lambda E: (E.Col("i") >= I64_MIN) & (E.Col("i") <= I64_MAX), "fused"),
    "int64 min/max strict": (
        lambda E: (E.Col("i") > I64_MIN) & (E.Col("i") < I64_MAX), "fused"),
    "float bounds on int": (
        lambda E: (E.Col("i") > 2.5) & (E.Col("i") <= 99.5) & (E.Col("j") >= 0.5), "fused"),
    "inf bounds on int": (
        lambda E: (E.Col("i") < float("inf")) & (E.Col("j") > float("-inf")), "fused"),
    "lit on the left": (lambda E: E.Lt(E.Lit(3), E.Col("j")), "fused"),
    "float range": (lambda E: (E.Col("f") > -1.5) & (E.Col("f") <= 2.5), "fused"),
    "float eq zero": (lambda E: E.Col("f") == 0.0, "fused"),
    "float eq negative zero": (lambda E: E.Col("f") == -0.0, "fused"),
    "float zero both ends": (lambda E: (E.Col("f") >= -0.0) & (E.Col("f") <= 0.0), "fused"),
    "float nan literal": (lambda E: E.Col("f") < float("nan"), "fused"),
    "float inf literal": (lambda E: E.Col("f") <= float("inf"), "fused"),
    "int literal on float": (lambda E: (E.Col("f") >= -2) & (E.Col("f") < 3), "fused"),
    "date range": (
        lambda E: (E.Col("d") >= datetime.date(2019, 6, 1))
        & (E.Col("d") < np.datetime64("2019-09-01T12:00")), "fused"),
    "three columns": (
        lambda E: (E.Col("i") >= 0) & (E.Col("f") < 0.5) & (E.Col("j") > 3), "fused"),
    "sixteen terms": (_sixteen, "fused"),
    "inf lower bound on int": (lambda E: E.Col("i") > float("inf"), "never"),
    "nan bound on int": (lambda E: E.Col("i") >= float("nan"), "never"),
    "unrepresentable date": (lambda E: E.Col("d") == "not a date", "never"),
    "2^53 float bound on int": (lambda E: E.Col("i") < 2.0**53 + 2, "general"),
    "-2^53 float bound on int": (lambda E: E.Col("j") >= -(2.0**53), "general"),
}
