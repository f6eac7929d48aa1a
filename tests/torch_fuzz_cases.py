"""The seeded predicate fuzz corpus of ``tests/test_fuzz_differential.py``,
shared by ``test_torch_fuzz_differential.py`` (the port's masks against the
JAX package's and pyarrow's, on the CPU), ``test_torch_cuda.py`` and
``chip_smoke.py`` phase 22 (the same masks on the card). numpy and pyarrow
only.

:func:`random_table` and :func:`random_spec` draw from the generator in the
reference test's order, so a seed gives the same table and predicate
there and here. A predicate is drawn as a spec, a tree of tuples, and
built by :func:`build` with either package's expression module or by
:func:`build_pyarrow` as the pyarrow compute expression of the same
semantics (SQL three-valued IN as an OR-chain of equalities)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

#: the reference test's seeds are range(30); the twin runs these
SEEDS = range(400)


def random_table(rng, n: int = 500) -> pa.Table:
    ints = rng.integers(-50, 50, n)
    int_nulls = rng.random(n) < 0.1
    flts = np.round(rng.normal(0, 10, n), 2)
    flts[rng.random(n) < 0.05] = np.nan
    strs = rng.choice(["aa", "bb", "cc", "dd", None], n, p=[0.3, 0.3, 0.2, 0.1, 0.1])
    durs = rng.integers(-5000, 5000, n)  # milliseconds
    dur_nulls = rng.random(n) < 0.1
    return pa.table({
        "i": pa.array(np.where(int_nulls, 0, ints), type=pa.int64(), mask=int_nulls),
        "f": pa.array(flts),
        "s": pa.array(strs.tolist(), type=pa.string()),
        "d": pa.array(np.where(dur_nulls, 0, durs), type=pa.duration("ms"), mask=dur_nulls),
    })


def random_spec(rng, depth: int = 0):
    """A predicate spec, drawn as the reference's ``_random_pred`` draws."""
    kind = rng.choice(
        ["cmp_i", "cmp_f", "eq_s", "in_i", "isnull", "cmp_d", "and", "or", "not"]
        if depth < 3 else ["cmp_i", "cmp_f", "eq_s", "in_i", "isnull", "cmp_d"]
    )
    if kind == "cmp_i":
        lit = int(rng.integers(-60, 60))
        return ("cmp", "i", str(rng.choice(["==", "!=", "<", "<=", ">", ">="])), lit)
    if kind == "cmp_f":
        lit = float(np.round(rng.normal(0, 10), 2))
        return ("cmp", "f", str(rng.choice(["<", ">="])), lit)
    if kind == "eq_s":
        return ("cmp", "s", "==", str(rng.choice(["aa", "bb", "zz"])))
    if kind == "cmp_d":
        unit = str(rng.choice(["s", "ms", "us"]))
        scale = {"s": 5, "ms": 5000, "us": 5_000_500}[unit]
        lit = np.timedelta64(int(rng.integers(-scale, scale)), unit)
        return ("cmp", "d", str(rng.choice(["==", "<", ">="])), lit)
    if kind == "in_i":
        return ("in", "i", [int(v) for v in rng.integers(-60, 60, 3)])
    if kind == "isnull":
        return ("isnull", str(rng.choice(["i", "s"])))
    a = random_spec(rng, depth + 1)
    b = random_spec(rng, depth + 1)
    if kind == "and":
        return ("and", a, b)
    if kind == "or":
        return ("or", a, b)
    return ("not", a)


def random_case(seed: int, n: int = 500):
    """(table, spec) of one seed, drawn in the reference test's order."""
    rng = np.random.default_rng(seed)
    table = random_table(rng, n)
    return table, random_spec(rng)


def _cmp(a, op, b):
    return {"==": lambda: a == b, "!=": lambda: a != b, "<": lambda: a < b,
            "<=": lambda: a <= b, ">": lambda: a > b, ">=": lambda: a >= b}[op]()


def build(spec, E):
    """The spec as an expression of ``E`` (either package's
    ``plan.expressions``)."""
    tag = spec[0]
    if tag == "cmp":
        return _cmp(E.Col(spec[1]), spec[2], spec[3])
    if tag == "in":
        return E.Col(spec[1]).isin(*spec[2])
    if tag == "isnull":
        return E.IsNull(E.Col(spec[1]))
    if tag == "and":
        return E.And(build(spec[1], E), build(spec[2], E))
    if tag == "or":
        return E.Or(build(spec[1], E), build(spec[2], E))
    return E.Not(build(spec[1], E))


def build_pyarrow(spec):
    """The spec as a pyarrow compute expression of the same semantics."""
    f = pc.field
    tag = spec[0]
    if tag == "cmp":
        lit = spec[3]
        if isinstance(lit, np.timedelta64):
            lit = pa.scalar(lit)
        return _cmp(f(spec[1]), spec[2], lit)
    if tag == "in":
        vals = spec[2]
        out = f(spec[1]) == vals[0]
        for v in vals[1:]:
            out = out | (f(spec[1]) == v)
        return out
    if tag == "isnull":
        return f(spec[1]).is_null()
    if tag == "and":
        return build_pyarrow(spec[1]) & build_pyarrow(spec[2])
    if tag == "or":
        return build_pyarrow(spec[1]) | build_pyarrow(spec[2])
    return ~build_pyarrow(spec[1])


def pyarrow_rows(table: pa.Table, spec) -> np.ndarray:
    """The row indices pyarrow keeps (by index: NaN-proof)."""
    indexed = table.append_column("_row", pa.array(np.arange(table.num_rows), type=pa.int64()))
    return indexed.filter(build_pyarrow(spec)).column("_row").to_numpy()
