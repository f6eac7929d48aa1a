"""Cases of kernels B3b, the fused select (``csrc/fused_select.cu``), and
B5f, the fused filter→aggregate (``csrc/fused_agg.cu`` with B5), shared by
``test_torch_fused_pipeline.py`` (the port's plain route against the JAX
package, on the CPU), ``test_torch_cuda.py`` and ``chip_smoke.py`` (each
kernel against its plain version, on the card). numpy, pyarrow, torch
and the port only.

A B5f case is a dict: ``chunks`` (pa.Tables fed in order, the state
carried across them), ``group_by``, ``aggs`` ((func, column, alias) as
``AggSpec`` takes them) and ``terms`` (``lower_range_terms`` tuples,
``()`` when every row passes). The cases cover an empty chunk, every row
failing, one group and no groups, 1,025 groups (past the reference's
1,024-slot first table) and 100,000 groups in one chunk, NaN, -0.0 and
null keys, int64 wrap, groups of only NaN or only nulls, -0.0/0.0 ties
across two chunks, and three chunks whose float sum's bits depend on the
carried start. The ``int_`` cases take only aggregates that are exact in
any order of combination (COUNT, int SUM, int and date MIN/MAX), so B5f
folds them by its one-pass route on the card (the others, with a float
aggregate, by the ordered route): the same shapes, plus int nulls,
int64 extremes and wrap-around, and groups first met in later chunks. A
B3b case is (table, terms), NEVER_MATCH included."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import torch

SNAN = np.array([0x7FF0000000000001], dtype=np.uint64).view(np.float64)[0]
NAN_PAYLOAD = np.array([0x7FF8000000000123], dtype=np.uint64).view(np.float64)[0]
NEG_NAN = np.array([0xFFF8000000000456], dtype=np.uint64).view(np.float64)[0]

ALL_AGGS = (
    ("count", None, "n"),
    ("count", "v", "nv"),
    ("count", "s", "ns"),
    ("sum", "v", "sv"),
    ("avg", "v", "av"),
    ("min", "v", "mnv"),
    ("max", "v", "mxv"),
    ("sum", "i", "si"),
    ("min", "i", "mni"),
    ("max", "i", "mxi"),
)


def window(lo, hi):
    """``lower_range_terms`` of ``k >= lo AND k < hi``."""
    return (("k", lo, False, None, False, False), ("k", None, False, hi, True, False))


def _table(rng, n, g=None, f=None, k=None, v=None, i=None, v_valid=None, g_valid=None,
           f_valid=None):
    g = rng.integers(0, 20, n) if g is None else g
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64) if k is None else k, type=pa.int64()),
        "g": pa.array(np.asarray(g, dtype=np.int64), mask=None if g_valid is None else ~g_valid),
        "f": pa.array(rng.normal(size=n) if f is None else f,
                      mask=None if f_valid is None else ~f_valid),
        "v": pa.array(rng.normal(0, 10, n) if v is None else v,
                      mask=None if v_valid is None else ~v_valid),
        "i": pa.array(rng.integers(-(2**40), 2**40, n) if i is None else i, type=pa.int64()),
        "s": pa.array([None if x % 7 == 0 else f"s{x % 5}" for x in range(n)], type=pa.string()),
    })


def b5f_cases() -> dict:
    rng = np.random.default_rng(7)
    base = _table(rng, 3000, v_valid=rng.random(3000) > 0.1)
    fkeys = rng.normal(size=4000).round(0)
    fkeys[rng.random(4000) < 0.1] = np.nan
    fkeys[::13] = NAN_PAYLOAD
    fkeys[::17] = -0.0
    fkeys[::19] = 0.0
    fvalid = rng.random(4000) > 0.1
    many = rng.permutation(np.repeat(np.arange(100_000), 2))[:150_000]
    nan_v = np.where(np.arange(40) % 4 == 0, np.nan, 1.5)
    nan_v[8:16] = np.nan  # groups 2 and 3: only NaN
    null_v = np.arange(40) % 10 != 3  # group 3 (rows 12..15) has one null
    null_v[16:24] = False  # groups 4 and 5: only nulls

    def zeros(order):
        return _table(rng, 4, g=np.array([0, 0, 1, 1]), v=np.array(order * 2), i=np.zeros(4, np.int64))

    def carry(n, start, nan_row=None):
        v = np.full(n, 1.0)
        v[0] = start
        if nan_row is not None:
            v[nan_row] = NAN_PAYLOAD
        return _table(rng, n, g=np.arange(n) % 3, v=v)

    return {
        "empty_chunk": dict(chunks=[base.slice(0, 0), base, base.slice(0, 0)],
                            group_by=["g"], aggs=ALL_AGGS, terms=window(100, 2500)),
        "all_rows_failing": dict(chunks=[base], group_by=["g"], aggs=ALL_AGGS,
                                 terms=window(5000, 6000)),
        "all_rows_failing_ungrouped": dict(chunks=[base], group_by=[], aggs=ALL_AGGS,
                                           terms=window(5000, 6000)),
        "one_group": dict(chunks=[_table(rng, 2000, g=np.full(2000, 7))], group_by=["g"],
                          aggs=ALL_AGGS, terms=window(10, 1990)),
        "no_groups": dict(chunks=[base, base.slice(1000, 1500)], group_by=[], aggs=ALL_AGGS,
                          terms=window(100, 2900)),
        "no_terms_grouped": dict(chunks=[base], group_by=["g"], aggs=ALL_AGGS, terms=()),
        "groups_1025": dict(chunks=[_table(rng, 5125, g=np.arange(5125) % 1025)],
                            group_by=["g"], aggs=ALL_AGGS, terms=window(3, 5120)),
        "groups_100000": dict(chunks=[_table(rng, 150_000, g=many)], group_by=["g"],
                              aggs=(("count", None, "n"), ("sum", "v", "sv"),
                                    ("max", "i", "mxi")), terms=window(0, 149_000)),
        "nan_negzero_null_float_keys": dict(
            chunks=[_table(rng, 4000, f=fkeys, f_valid=fvalid)], group_by=["f"],
            aggs=ALL_AGGS, terms=window(0, 3900)),
        "two_keys_with_null_int_key": dict(
            chunks=[_table(rng, 4000, f=fkeys, f_valid=fvalid, g=rng.integers(0, 3, 4000),
                           g_valid=rng.random(4000) > 0.2)],
            group_by=["f", "g"], aggs=ALL_AGGS, terms=window(50, 3950)),
        "float_term_with_nan_rows": dict(
            chunks=[_table(rng, 3000, v=np.where(np.arange(3000) % 9 == 0, np.nan,
                                                 rng.normal(0, 10, 3000)))],
            group_by=["g"], aggs=ALL_AGGS,
            terms=(("v", -5.0, False, None, False, False), ("v", None, False, 12.5, True, False))),
        "int64_wrap": dict(chunks=[_table(rng, 3000, i=rng.integers(2**61, 2**62, 3000))] * 2,
                           group_by=["g"], aggs=ALL_AGGS, terms=window(0, 3000)),
        "all_nan_and_all_null_groups": dict(
            chunks=[_table(rng, 40, g=np.arange(40) // 4, v=nan_v, v_valid=null_v)],
            group_by=["g"], aggs=ALL_AGGS, terms=()),
        "signed_zero_ties_across_two_chunks": dict(
            chunks=[zeros([0.0, -0.0]), zeros([-0.0, 0.0])], group_by=["g"],
            aggs=ALL_AGGS, terms=()),
        "three_chunks_carried_float_sum": dict(
            chunks=[carry(3000, 1e16), carry(3000, 1.0, nan_row=1), carry(3000, 1.0)],
            group_by=["g"], aggs=ALL_AGGS, terms=window(0, 2990)),
        "three_chunks_carried_ungrouped": dict(
            chunks=[carry(3000, 1e16), carry(3000, 3.0), carry(3000, -1e16)],
            group_by=[], aggs=ALL_AGGS, terms=window(1, 3000)),
    }


INT_AGGS = (
    ("count", None, "n"),
    ("count", "j", "nj"),
    ("count", "s", "ns"),
    ("sum", "j", "sj"),
    ("avg", "j", "aj"),
    ("min", "j", "mnj"),
    ("max", "j", "mxj"),
    ("sum", "i", "si"),
    ("min", "d", "mnd"),
    ("max", "d", "mxd"),
)


def _int_table(rng, n, g=None, f=None, f_valid=None, g_valid=None, i=None, j=None,
               j_valid=None):
    """A chunk for the ``int_`` cases: ``_table``'s columns plus an int64
    ``j`` with nulls and a date32 ``d``."""
    t = _table(rng, n, g=g, f=f, f_valid=f_valid, g_valid=g_valid, i=i)
    j = rng.integers(-(2**40), 2**40, n) if j is None else j
    j_valid = rng.random(n) > 0.1 if j_valid is None else j_valid
    d = rng.integers(8000, 11000, n).astype(np.int32)
    t = t.append_column("j", pa.array(np.asarray(j, dtype=np.int64), mask=~j_valid))
    return t.append_column("d", pa.array(d, type=pa.date32()))


def b5f_int_cases() -> dict:
    rng = np.random.default_rng(11)
    base = _int_table(rng, 3000)
    fkeys = rng.normal(size=4000).round(0)
    fkeys[rng.random(4000) < 0.1] = np.nan
    fkeys[::13] = NAN_PAYLOAD
    fkeys[::17] = -0.0
    fkeys[::19] = 0.0
    fvalid = rng.random(4000) > 0.1
    many = rng.permutation(np.repeat(np.arange(100_000), 2))[:150_000]
    ext = rng.choice(np.array([-(2**63), 2**63 - 1, -1, 0, 1], dtype=np.int64), 3000)

    def later(lo, hi, n=2000):  # groups lo..hi-1, each first met in this chunk's later rows
        return _int_table(rng, n, g=np.sort(rng.integers(lo, hi, n))[::-1].copy())

    return {
        "int_empty_chunk": dict(chunks=[base.slice(0, 0), base, base.slice(0, 0)],
                                group_by=["g"], aggs=INT_AGGS, terms=window(100, 2500)),
        "int_all_rows_failing": dict(chunks=[base], group_by=["g"], aggs=INT_AGGS,
                                     terms=window(5000, 6000)),
        "int_no_groups": dict(chunks=[base, base.slice(1000, 1500)], group_by=[],
                              aggs=INT_AGGS, terms=window(100, 2900)),
        "int_no_terms_grouped": dict(chunks=[base], group_by=["g"], aggs=INT_AGGS, terms=()),
        "int_one_group": dict(chunks=[_int_table(rng, 2000, g=np.full(2000, 7))],
                              group_by=["g"], aggs=INT_AGGS, terms=window(10, 1990)),
        "int_groups_1025": dict(chunks=[_int_table(rng, 5125, g=np.arange(5125) % 1025)],
                                group_by=["g"], aggs=INT_AGGS, terms=window(3, 5120)),
        "int_groups_100000": dict(chunks=[_int_table(rng, 150_000, g=many)], group_by=["g"],
                                  aggs=(("count", None, "n"), ("sum", "i", "si"),
                                        ("max", "j", "mxj")), terms=window(0, 149_000)),
        "int_nan_negzero_null_float_keys": dict(
            chunks=[_int_table(rng, 4000, f=fkeys, f_valid=fvalid)], group_by=["f"],
            aggs=INT_AGGS, terms=window(0, 3900)),
        "int_two_keys_with_null_int_key": dict(
            chunks=[_int_table(rng, 4000, f=fkeys, f_valid=fvalid, g=rng.integers(0, 3, 4000),
                               g_valid=rng.random(4000) > 0.2)],
            group_by=["f", "g"], aggs=INT_AGGS, terms=window(50, 3950)),
        "int_wrap": dict(chunks=[_int_table(rng, 3000, i=rng.integers(2**61, 2**62, 3000),
                                            j=rng.integers(2**61, 2**62, 3000))] * 2,
                         group_by=["g"], aggs=INT_AGGS, terms=window(0, 3000)),
        "int_extremes": dict(chunks=[_int_table(rng, 3000, i=ext, j=ext[::-1].copy())],
                             group_by=["g"], aggs=INT_AGGS, terms=()),
        "int_three_chunks_new_groups_later": dict(
            chunks=[later(0, 10), later(5, 20), later(15, 30)], group_by=["g"],
            aggs=INT_AGGS, terms=window(100, 1900)),
    }


def b3b_cases() -> dict:
    rng = np.random.default_rng(8)
    t = _table(rng, 100_003, v=np.where(np.arange(100_003) % 11 == 0, np.nan,
                                        rng.normal(0, 10, 100_003)),
               v_valid=rng.random(100_003) > 0.05)
    return {
        "window": (t, window(1_000, 90_000)),
        "window_and_float": (t, window(5, 100_000) + (("v", None, False, 3.0, True, False),)),
        "all_rows_failing": (t, window(200_000, 300_000)),
        "all_rows_passing": (t, window(0, 100_003)),
        "odd_tail": (t.slice(0, 2049), window(0, 2047)),
        "one_row": (t.slice(7, 1), window(0, 10)),
        "never_match": (t, (("k", None, False, None, False, True),)),
        "empty": (t.slice(0, 0), window(0, 10)),
    }


B5F_CASES = {**b5f_cases(), **b5f_int_cases()}
B3B_CASES = b3b_cases()


def port_aggs(case):
    from hyperspace_tpu_torch.plan.nodes import AggSpec

    return [AggSpec(func, col, name) for func, col, name in case["aggs"]]


def port_plan(case):
    """The case's FusedAggPlan in the port (None where it declines)."""
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC

    schema = dict(zip(case["chunks"][0].schema.names, case["chunks"][0].schema.types))
    return PC._lower_from_terms(case["terms"], case["group_by"], port_aggs(case), schema)


def _state_bits(st) -> dict:
    out = {"n_groups": torch.tensor(st.n_groups), "rows_passed": torch.tensor(st.rows_passed)}
    for name in ("g_reps", "g_nulls", "g_kvals", "g_kvalid", "acc_i", "acc_cnt", "acc_aux"):
        out[name] = getattr(st, name).cpu()
    out["acc_f"] = st.acc_f.cpu().view(torch.int64)
    return out


def fused_kernel_errors(case, device) -> dict:
    """B5f on ``device`` (CUDA) against its plain version on the CPU, over
    the case's chunks with the state carried: per state array, the count
    of elements whose bits differ (0 everywhere when equal)."""
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops import fused_agg as FA

    plan = port_plan(case)
    kern, plain = PC.AggState(plan, device), PC.AggState(plan, "cpu")
    for table in case["chunks"]:
        batch = ColumnarBatch.from_arrow(table)
        if batch.num_rows == 0:
            continue
        ck, cp = kern._chunk(batch), plain._chunk(batch)
        kern.state = FA.fused_filter_agg_kernel(kern.state, ck)
        plain.state = FA.fused_filter_agg_torch(plain.state, cp)
    a, b = _state_bits(kern.state), _state_bits(plain.state)
    return {k: int((a[k] != b[k]).sum()) if a[k].shape == b[k].shape else -1 for k in a}


def b5f_launches(case) -> int:
    """B5f's launches over the case's chunks on the card, by the plan's
    route (``ops/fused_agg.route``). One pass, for each chunk with rows:
    the block pass, the merge table's fill and the merge, the carried
    groups' insert when there are some, and the next state's write when a
    row passed; a chunk whose block tables overflow (found by the plain
    model, ``fused_filter_agg_blocked_torch``, with the card's block rows
    and slots) adds the ordered route's.
    Ordered, for each chunk with group keys and a passing row: the group
    pass, and the carried insert once an earlier chunk had a group."""
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops import fused_agg as FA

    plan = port_plan(case)
    one_pass = FA.route([op for op, _c in plan.agg_ops]) == "one_pass"
    st = PC.AggState(plan, "cpu")
    launches = 0
    for table in case["chunks"]:
        batch = ColumnarBatch.from_arrow(table)
        if batch.num_rows == 0:
            continue
        before = st.state
        chunk = st._chunk(batch)
        st.state = FA.fused_filter_agg_blocked_torch(before, chunk, FA.BLOCK_ROWS,
                                                     FA.chunk_slots(chunk))
        passed = st.state.rows_passed > before.rows_passed
        ordered = not one_pass or st.state.overflowed > before.overflowed
        if one_pass:
            launches += 3 + int(before.n_groups > 0) + int(passed and not ordered)
        if ordered and case["group_by"] and passed:
            launches += 1 + int(before.n_groups > 0)
    return launches


def select_kernel_errors(table, terms, device) -> int:
    """B3b on ``device`` against its plain version over the same device
    columns: -1 when the counts differ, else the number of indices that
    differ."""
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops import filter as F

    batch = ColumnarBatch.from_arrow(table)
    args = F.range_args(batch, list(terms), device)
    if args is None or args == F.NEVER_MATCH or batch.num_rows == 0:
        return 0
    got = F.select_kernel(args).cpu()
    want = F.select_torch(args).cpu()
    if got.shape != want.shape:
        return -1
    return int((got != want).sum())
