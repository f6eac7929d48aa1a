"""The port's fused range mask (kernel B3a's lowering and plain version)
against the JAX package: ``lower_range_terms`` and
``native_range_bounds`` give the reference's terms and bounds over a
seeded predicate matrix (including its ``None`` and ``NEVER_MATCH``
outcomes), and ``range_mask_torch`` on the CPU equals the reference's
``range_mask_numpy`` (and its native ``range_mask_u8`` where that loads)
bit for bit. The kernel itself runs in ``test_torch_cuda.py``; here a
ctypes stand-in for its C function checks how the wrapper packs the
arguments. The executor's dispatch between the fused route, the general
device mask and the host is checked through ``session.exec_stats``."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import ctypes
import datetime

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.ops import filter as JF
from hyperspace_tpu.plan import expressions as JE
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.ops import filter as TF
from hyperspace_tpu_torch.plan import expressions as TE
from torch_b3a_cases import B3A_PREDICATES, ROWS, b3a_table


@pytest.fixture(scope="module")
def tables():
    out = {}
    for n in ROWS:
        t = b3a_table(n)
        out[n] = (TBatch.from_arrow(t), JBatch.from_arrow(t))
    return out


def _mixed_table(n=300):
    """b3a_table's columns plus the ones the fused route refuses: uint32,
    int32, float32, bool and string."""
    rng = np.random.default_rng(41)
    t = b3a_table(n)
    for name, arr in (
        ("u", pa.array(rng.integers(0, 2**32, n, dtype=np.uint32))),
        ("i32", pa.array(rng.integers(-50, 50, n).astype(np.int32))),
        ("f32", pa.array(rng.normal(0, 1, n).astype(np.float32))),
        ("b", pa.array(rng.random(n) < 0.5)),
        ("s", pa.array(np.array(["a", "b", "c"])[rng.integers(0, 3, n)])),
    ):
        t = t.append_column(name, arr)
    return t


_LITERALS = [
    0, 7, -5, 2.5, -0.0, 99.5, float("inf"), float("-inf"), float("nan"), True,
    2**53, 2**53 + 1, 2.0**53, -(2.0**53), 2**63 - 1, -(2**63), 2**63, 2**64,
    np.int64(3), np.float32(1.5), np.uint64(4), "x", datetime.date(2019, 6, 1),
    np.datetime64("2019-09-01T12:00"), "2019-07-04",
]
_COLUMNS = ["i", "j", "f", "d", "u", "i32", "f32", "b", "s"]
_OPS = ["=", "<", "<=", ">", ">=", "!="]


def _random_predicates(count=300, seed=5):
    """Seeded conjunctions of 1 to 18 col-op-literal terms over every
    column kind, with literals of every kind (and an occasional IN or
    OR, which never lower)."""
    rng = np.random.default_rng(seed)
    preds = []
    for _ in range(count):
        k = int(rng.integers(1, 19)) if rng.random() < 0.2 else int(rng.integers(1, 5))
        terms = []
        for _t in range(k):
            col = _COLUMNS[int(rng.integers(0, len(_COLUMNS)))]
            if rng.random() < 0.7:
                col = _COLUMNS[int(rng.integers(0, 4))]  # mostly fused-able columns
            op = _OPS[int(rng.integers(0, len(_OPS)))] if rng.random() < 0.1 else _OPS[
                int(rng.integers(0, 5))]
            lit = _LITERALS[int(rng.integers(0, len(_LITERALS)))]
            flip = bool(rng.random() < 0.2)
            terms.append((col, op, lit, flip))
        extra = rng.random()
        preds.append((terms, "in" if extra < 0.03 else ("or" if extra < 0.06 else None)))
    return preds


def _build(E, spec):
    terms, extra = spec
    cls = {"=": E.Eq, "<": E.Lt, "<=": E.Le, ">": E.Gt, ">=": E.Ge, "!=": E.Ne}
    out = None
    for col, op, lit, flip in terms:
        t = cls[op](E.Lit(lit), E.Col(col)) if flip else cls[op](E.Col(col), E.Lit(lit))
        out = t if out is None else out & t
    if extra == "in":
        out = out & E.Col("i").isin(1, 2)
    elif extra == "or":
        out = out & ((E.Col("i") > 1) | (E.Col("j") < 3))
    return out


RANDOM = _random_predicates()


def _f64_flags(batch, terms):
    return [batch.columns[name].values.dtype.kind == "f" for name, *_ in terms]


def _lowering(T_or_J, batch, expr):
    F = TF if T_or_J == "t" else JF
    terms = F.lower_range_terms(expr, batch)
    if terms is None:
        return None, None
    return terms, F.native_range_bounds(terms, _f64_flags(batch, terms))


@pytest.mark.parametrize("seed_chunk", range(6))
def test_lowering_matches_reference_over_a_seeded_matrix(seed_chunk):
    t = _mixed_table()
    tb, jb = TBatch.from_arrow(t), JBatch.from_arrow(t)
    for spec in RANDOM[seed_chunk * 50:(seed_chunk + 1) * 50]:
        got = _lowering("t", tb, _build(TE, spec))
        want = _lowering("j", jb, _build(JE, spec))
        assert repr(got) == repr(want), spec


def test_seeded_matrix_reaches_every_outcome():
    t = _mixed_table()
    tb = TBatch.from_arrow(t)
    seen = set()
    for spec in RANDOM:
        terms, bounds = _lowering("t", tb, _build(TE, spec))
        seen.add("none" if terms is None else "bounds none" if bounds is None else
                 "never" if bounds == TF.NEVER_MATCH else "bounds")
    assert seen == {"none", "bounds none", "never", "bounds"}


@pytest.mark.parametrize("case", sorted(B3A_PREDICATES))
def test_case_lowering_and_route_match_reference(case, tables):
    build, route = B3A_PREDICATES[case]
    tb, jb = tables[ROWS[-1]]
    got = _lowering("t", tb, build(TE))
    assert repr(got) == repr(_lowering("j", jb, build(JE)))
    args = TF.range_args(tb, got[0], "cpu")
    assert {"fused": TF.RangeArgs, "never": str, "general": type(None)}[route] is type(args)
    # the reference's native dispatch refuses the same conjunctions
    prep = JF.native_terms_for_batch(jb, got[0])
    assert (prep is None) == (route == "general")


@pytest.mark.parametrize("n", ROWS)
def test_plain_version_equals_the_reference_bit_for_bit(n, tables):
    tb, jb = tables[n]
    native_checked = 0
    for case, (build, route) in B3A_PREDICATES.items():
        terms = TF.lower_range_terms(build(TE), tb)
        jterms = JF.lower_range_terms(build(JE), jb)
        host = JE.filter_mask(build(JE), jb)
        fused = TF.fused_range_mask(build(TE), tb, "cpu")
        if route == "general":
            assert fused is None
            continue
        assert np.array_equal(fused, host), case
        if route == "never":
            assert not fused.any()
            continue
        got = TF.range_mask_torch(TF.range_args(tb, terms, "cpu"))
        assert got.dtype == torch.bool and got.shape == (n,)
        assert np.array_equal(got.numpy(), JF.range_mask_numpy(jb, jterms)), case
        native = JF._native_range_mask(jb, jterms)
        if native is not None:
            assert np.array_equal(got.numpy(), native), case
            native_checked += 1
    assert native_checked == 0 or native_checked == sum(
        r == "fused" for _b, r in B3A_PREDICATES.values())


def test_plain_version_over_the_seeded_matrix(tables):
    t = _mixed_table()
    tb, jb = TBatch.from_arrow(t), JBatch.from_arrow(t)
    fused = 0
    for spec in RANDOM:
        got = TF.fused_range_mask(_build(TE, spec), tb, "cpu")
        if got is None:
            continue
        fused += 1
        assert np.array_equal(got, JE.filter_mask(_build(JE, spec), jb)), spec
        terms = JF.lower_range_terms(_build(JE, spec), jb)
        assert np.array_equal(got, JF.range_mask_numpy(jb, terms)), spec
    assert fused >= 50


def test_each_distinct_column_moves_once(tables):
    tb, _ = tables[ROWS[-1]]
    expr = (TE.Col("i") >= 0) & (TE.Col("j") < 5) & (TE.Col("i") < 90) & (TE.Col("f") > 0.5)
    args = TF.range_args(tb, TF.lower_range_terms(expr, tb), "cpu")
    assert len(args.cols) == 3 and args.term_col == [0, 1, 0, 2]
    assert args.cols[2].dtype == torch.float64 and args.cols[0].dtype == torch.int64
    assert [m is None for m in args.valids] == [False, True, False]
    assert [TF.term_flags(args, t) for t in range(4)] == [0b00001, 0b01010, 0b01010, 0b10101]


def test_empty_batch_takes_no_fused_route():
    t = b3a_table(5).slice(0, 0)
    assert TF.fused_range_mask(TE.Col("i") > 1, TBatch.from_arrow(t), "cpu") is None


# -- the wrapper's host side, against a stand-in for the C function ----------------

_C_ARGTYPES = [
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
]


@pytest.fixture
def fake_c_function(monkeypatch):
    """Stand a ctypes callback in for hs_range_mask, so every argument goes
    through the C types the wrapper declares; records what it received
    (arrays read out while they live) and lets a test set the error
    code."""
    from hyperspace_tpu_torch import kernels as port_kernels

    state = {"calls": [], "rc": 0}

    def c_function(cols, valids, ncols, term_col, lo_i, hi_i, lo_f, hi_f, flags, nterms,
                   out, n, stream):
        state["calls"].append({
            "cols": [cols[c] for c in range(ncols)],
            "valids": [valids[c] for c in range(ncols)],
            "term_col": [term_col[t] for t in range(nterms)],
            "lo_i": [lo_i[t] for t in range(nterms)],
            "hi_i": [hi_i[t] for t in range(nterms)],
            "lo_f": [lo_f[t] for t in range(nterms)],
            "hi_f": [hi_f[t] for t in range(nterms)],
            "flags": [flags[t] for t in range(nterms)],
            "out": out, "n": n, "stream": stream,
        })
        return state["rc"]

    proto = ctypes.CFUNCTYPE(ctypes.c_int, *_C_ARGTYPES)
    lib = type("FakeLib", (), {"hs_range_mask": proto(c_function)})()
    monkeypatch.setattr(port_kernels, "load", lambda name: lib)
    monkeypatch.setattr(TF, "launches", 0)
    TF._kernel_fn.cache_clear()
    yield state
    TF._kernel_fn.cache_clear()


def test_launch_packs_terms_grouped_by_column(fake_c_function, tables):
    tb, _ = tables[ROWS[-1]]
    expr = (TE.Col("f") <= 2.5) & (TE.Col("i") > -7) & (TE.Col("f") > -1.0) & (
        TE.Col("i") <= 2**62)
    args = TF.range_args(tb, TF.lower_range_terms(expr, tb), "cpu")
    out = torch.empty(args.n, dtype=torch.bool)
    TF._launch(args, out, 0xABC0)
    lib_fn = TF._kernel_fn()
    assert list(lib_fn.argtypes) == _C_ARGTYPES and lib_fn.restype is ctypes.c_int
    (call,) = fake_c_function["calls"]
    assert call["cols"] == [args.cols[0].data_ptr(), args.cols[1].data_ptr()]
    assert call["valids"] == [args.valids[0].data_ptr(), args.valids[1].data_ptr()]
    assert call["term_col"] == [0, 0, 1, 1]  # f's two terms, then i's
    assert call["lo_f"] == [0.0, -1.0, 0.0, 0.0] and call["hi_f"] == [2.5, 0.0, 0.0, 0.0]
    assert call["lo_i"] == [0, 0, -7, 0] and call["hi_i"] == [0, 0, 0, 2**62]
    assert call["flags"] == [0b10010, 0b10101, 0b00101, 0b00010]
    assert (call["out"], call["n"], call["stream"]) == (out.data_ptr(), args.n, 0xABC0)
    assert TF.launches == 1


def test_launch_passes_null_for_columns_without_nulls(fake_c_function, tables):
    tb, _ = tables[ROWS[-1]]
    args = TF.range_args(tb, TF.lower_range_terms(TE.Col("j") >= 3, tb), "cpu")
    TF._launch(args, torch.empty(args.n, dtype=torch.bool), 0)
    assert fake_c_function["calls"][0]["valids"] == [None]


def test_launch_raises_on_a_c_error_and_counts_no_launch(fake_c_function, tables):
    tb, _ = tables[ROWS[-1]]
    args = TF.range_args(tb, TF.lower_range_terms(TE.Col("j") >= 3, tb), "cpu")
    fake_c_function["rc"] = 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        TF._launch(args, torch.empty(args.n, dtype=torch.bool), 0)
    assert TF.launches == 0


def test_launch_counts_nothing_for_no_rows(fake_c_function):
    args = TF.RangeArgs([torch.zeros(0, dtype=torch.int64)], [None], [0], [1], [0],
                        [0.0], [0.0], [(True, False, False, False)])
    TF._launch(args, torch.empty(0, dtype=torch.bool), 0)
    assert len(fake_c_function["calls"]) == 1 and TF.launches == 0


def test_what_the_kernel_cannot_take_is_refused(fake_c_function):
    col = torch.zeros(8, dtype=torch.int64)
    term = ([0], [0], [0.0], [0.0], [(True, False, False, False)])
    for args, match in (
        (TF.RangeArgs([col[::2]], [None], [0], *term), "contiguous"),
        (TF.RangeArgs([col.int()], [None], [0], *term), "int64 or float64"),
        (TF.RangeArgs([col], [torch.ones(8, dtype=torch.uint8)], [0], *term), "bool"),
        (TF.RangeArgs([col, col], [None, None], [0], *term), "every column needs a term"),
        (TF.RangeArgs([col], [None], [0] * 17, *(x * 17 for x in term)), "1 to 16"),
    ):
        with pytest.raises(ValueError, match=match):
            TF._launch(args, torch.empty(8, dtype=torch.bool), 0)
    with pytest.raises(ValueError, match="CUDA"):
        TF.range_mask_kernel(TF.RangeArgs([col], [None], [0], *term))
    assert fake_c_function["calls"] == [] and TF.launches == 0


# -- the executor's routes ------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_range_mask")
    rng = np.random.default_rng(3)
    n = 4000
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 1000, n)),
        "f": rng.normal(0, 1, n),
        "u": pa.array(rng.integers(2**31 - 5, 2**31 + 5, n, dtype=np.uint32)),
    }), str(root / "t.parquet"))
    return str(root / "t.parquet")


ROUTES = {
    "range conjunction": (lambda df: (df["k"] >= 10) & (df["k"] < 300) & (df["f"] < 0.5),
                          "fused_range_masks"),
    "in list": (lambda df: df["k"].isin(1, 2, 3), "device_filter_evals"),
    "uint32 == 2**31": (lambda df: df["u"] == 2**31, "device_filter_evals"),
    "uint32 range": (lambda df: (df["u"] > 2**31 - 2) & (df["u"] <= 2**31 + 1),
                     "device_filter_evals"),
}


@pytest.mark.parametrize("prune", [True, False], ids=["rangeprune", "no_rangeprune"])
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_executor_counts_each_route_apart(case, prune, served):
    """The fused route is taken exactly when range pruning is on and the
    whole predicate lowers; unsigned columns are masked on the device
    (``uint32 == 2**31`` used to take the host evaluator); the rows are
    the host evaluator's either way."""
    s = T.HyperspaceSession(device="cpu")
    s.conf.set("hyperspace.serve.rangeprune.enabled", prune)
    df = s.read.parquet(served)
    cond_fn, counter = ROUTES[case]
    got = df.filter(cond_fn(df)).collect()
    stats = s.exec_stats.as_dict()
    if not prune:
        counter = "device_filter_evals"
    assert stats[counter] == 1 and stats["host_filter_evals"] == 0
    assert stats["fused_range_masks"] + stats["device_filter_evals"] == 1
    table = pq.read_table(served)
    jb = JBatch.from_arrow(table)
    jdf_cond = cond_fn({c: JE.Col(c) for c in table.column_names})
    want = table.filter(pa.array(JE.filter_mask(jdf_cond, jb)))
    assert got.equals(want)
    if case.startswith("uint32 =="):
        assert got.num_rows > 0


def test_unsigned_gap_and_its_repair(served, monkeypatch):
    """``uint32 == 2**31``: with the unsigned mapping taken out (as before
    it existed) the device lowering refuses uint32 and the host evaluator
    masks it (host_filter_evals 1); with it, the device mask does, with
    the same rows."""
    s = T.HyperspaceSession(device="cpu")
    df = s.read.parquet(served)
    with monkeypatch.context() as m:
        m.setattr(TF, "_device_array", lambda a: a)
        before = df.filter(df["u"] == 2**31).collect()
        assert s.exec_stats.host_filter_evals == 1
        assert s.exec_stats.device_filter_evals == 0
    s.exec_stats.reset()
    after = df.filter(df["u"] == 2**31).collect()
    assert s.exec_stats.host_filter_evals == 0 and s.exec_stats.device_filter_evals == 1
    assert after.num_rows > 0 and after.equals(before)
