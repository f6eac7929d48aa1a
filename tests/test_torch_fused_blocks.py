"""The one-pass route of kernel B5f, decomposed on the CPU.

``ops/fused_agg.fused_filter_agg_blocked_torch`` is the plain model of
what the card does on that route: the chunk cut into blocks of R rows,
each block's groups in a table of S slots that overflows past 3/4 of
them (the chunk then takes the ordered route), the blocks' groups merged
in any order, new groups numbered by their least first row. Over the
cases of ``torch_b5f_cases`` (carried across their chunks) and R in {1,
7, 64, 8192}, S in {2, 16, 1024}, its state equals bit for bit the plain
version's (``fused_filter_agg_torch``) and its partials the JAX package's
(``_AggState`` over its native ``hs_fused_filter_agg``, as
``test_torch_fused_pipeline.py`` drives it). Plans with a float
aggregate take the ordered route."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re

import numpy as np
import pytest
import torch

from hyperspace_tpu import native as jnative
from hyperspace_tpu.execution import pipeline_compiler as JPC
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.plan.nodes import AggSpec as JAggSpec
from hyperspace_tpu_torch.execution import pipeline_compiler as TPC
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.ops import fused_agg as FA
from torch_b5f_cases import B5F_CASES, _state_bits, port_aggs

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "hyperspace_tpu_torch", "csrc", "fused_agg.cu")
_JAX_PARTIALS = {}


def _schema(case):
    t = case["chunks"][0]
    return dict(zip(t.schema.names, t.schema.types))


def _plan(case):
    return TPC._lower_from_terms(list(case["terms"]), case["group_by"], port_aggs(case),
                                 _schema(case))


def _fold(case, fold):
    """An AggState over the case's chunks, each chunk folded by ``fold``."""
    st = TPC.AggState(_plan(case), "cpu")
    for t in case["chunks"]:
        b = TBatch.from_arrow(t)
        st.rows_scanned += b.num_rows
        st.chunks += 1
        if b.num_rows == 0:
            continue
        for j, name in enumerate(st.plan.group_by):
            if b.column(name).validity is not None:
                st.key_has_validity[j] = True
        st.state = fold(st.state, st._chunk(b))
    return st


def _jax_partials(name):
    """The JAX package's ``_AggState`` partials over the case's chunks
    (its native kernel), once per case; None when the native library does
    not load."""
    if name not in _JAX_PARTIALS:
        part = None
        if jnative.load(wait=True) is not None:
            c = B5F_CASES[name]
            jaggs = [JAggSpec(f, col, alias) for f, col, alias in c["aggs"]]
            js = JPC._AggState(JPC._lower_from_terms(list(c["terms"]), c["group_by"], jaggs,
                                                     _schema(c)))
            for t in c["chunks"]:
                assert js.accumulate(JBatch.from_arrow(t))
            part = js.partials()
        _JAX_PARTIALS[name] = part
    return _JAX_PARTIALS[name]


def _partials_arrays(p):
    return {k: getattr(p, k) for k in (
        "g_reps", "g_nulls", "g_kvals", "g_kvalid", "acc_i", "acc_cnt", "acc_aux")} | {
        "acc_f": p.acc_f.view(np.int64)}


def _equal_states(a, b):
    x, y = _state_bits(a), _state_bits(b)
    for k in y:
        assert x[k].shape == y[k].shape and torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("slots", [2, 16, 1024])
@pytest.mark.parametrize("block_rows", [1, 7, 64, 8192])
@pytest.mark.parametrize("case", sorted(B5F_CASES))
def test_blocked_model_equals_the_plain_version_and_the_reference(case, block_rows, slots):
    """The blocked model's state after every chunk of the case equals the
    plain version's bit for bit, and its partials the JAX package's, in
    first-occurrence order."""
    c = B5F_CASES[case]
    got = _fold(c, lambda st, ch: FA.fused_filter_agg_blocked_torch(
        st, ch, block_rows, slots, seed=block_rows * 31 + slots))
    want = _fold(c, FA.fused_filter_agg_torch)
    _equal_states(got.state, want.state)
    jp = _jax_partials(case)
    if jp is not None:
        tp = got.partials()
        assert (tp.n_groups, tp.rows_scanned, tp.rows_passed, tp.key_has_validity) == (
            jp.n_groups, jp.rows_scanned, jp.rows_passed, jp.key_has_validity)
        g, w = _partials_arrays(tp), _partials_arrays(jp)
        for k in w:
            assert np.array_equal(g[k], w[k]), k
    ops = [op for op, _c in got.plan.agg_ops]
    if FA.route(ops) == "ordered":
        assert got.state.overflowed == 0
    elif block_rows == 1:  # one row a block: one group a block, never an overflow
        assert got.state.overflowed == 0


@pytest.mark.parametrize("case", ["int_groups_1025", "int_three_chunks_new_groups_later",
                                  "int_wrap"])
def test_overflowing_blocks_route_the_chunk_to_the_ordered_route(case):
    """Blocks of 8,192 rows with more than the 2 groups 2 slots hold overflow:
    every chunk with rows goes to the ordered route and the state still
    equals the plain version's; 1,024 slots hold them."""
    c = B5F_CASES[case]
    want = _fold(c, FA.fused_filter_agg_torch)
    small = _fold(c, lambda st, ch: FA.fused_filter_agg_blocked_torch(st, ch, 8192, 2))
    _equal_states(small.state, want.state)
    assert small.state.overflowed == sum(t.num_rows > 0 for t in c["chunks"])
    if case != "int_groups_1025":
        roomy = _fold(c, lambda st, ch: FA.fused_filter_agg_blocked_torch(st, ch, 8192, 1024))
        assert roomy.state.overflowed == 0
        _equal_states(roomy.state, want.state)


def test_a_block_overflows_only_past_three_quarters_of_its_slots():
    """The overflow rule at its edge: 12 groups in one block fill 3/4 of
    16 slots and stay; 13 overflow."""
    import pyarrow as pa

    for groups, overflowed in ((12, 0), (13, 1)):
        g = np.arange(64) % groups
        t = pa.table({"k": pa.array(np.arange(64), type=pa.int64()),
                      "g": pa.array(g, type=pa.int64()),
                      "i": pa.array(np.arange(64) * 3, type=pa.int64())})
        case = dict(chunks=[t], group_by=["g"], terms=(),
                    aggs=(("count", None, "n"), ("sum", "i", "s"), ("min", "i", "m")))
        got = _fold(case, lambda st, ch: FA.fused_filter_agg_blocked_torch(st, ch, 64, 16))
        assert got.state.overflowed == overflowed
        _equal_states(got.state, _fold(case, FA.fused_filter_agg_torch).state)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_merge_takes_the_blocks_in_any_order(seed):
    """The blocks' groups merged in four drawn orders give the same bits
    (int sums wrap, MIN/MAX of equal ints are equal bits)."""
    c = B5F_CASES["int_wrap"]
    got = _fold(c, lambda st, ch: FA.fused_filter_agg_blocked_torch(st, ch, 64, 1024, seed=seed))
    _equal_states(got.state, _fold(c, FA.fused_filter_agg_torch).state)


def test_plans_with_a_float_aggregate_take_the_ordered_route():
    """The route comes from the plan: any float SUM, MIN or MAX (or more
    aggregates than the kernel's planes) is ordered; the int ones are one
    pass."""
    assert FA.route([FA.OP_COUNT_STAR, FA.OP_COUNT_COL, FA.OP_SUM_I64, FA.OP_MIN_I64,
                     FA.OP_MAX_I64]) == "one_pass"
    for op in (FA.OP_SUM_F64, FA.OP_MIN_F64, FA.OP_MAX_F64):
        assert FA.route([FA.OP_COUNT_STAR, op]) == "ordered"
    assert FA.route([FA.OP_COUNT_STAR] * FA.MAX_PLANES) == "ordered"
    for name, c in B5F_CASES.items():
        ops = [op for op, _c in _plan(c).agg_ops]
        assert FA.route(ops) == ("one_pass" if name.startswith("int_") else "ordered"), name


def test_block_constants_match_the_kernel():
    """BLOCK_ROWS, MAX_KEYS, MAX_PLANES and RANK_MAX, the limits the
    wrapper shares with fused_agg.cu, against its kMaxBlockRows,
    kMaxKeys, kMaxPlanes and kRankMax (the block tables are sized in the
    kernel alone)."""
    with open(CSRC, encoding="utf-8") as fh:
        src = fh.read()

    def const(name):  # an int constant whose value is digits
        return int(re.search(rf"constexpr int {name} = ([0-9]+);", src).group(1))

    assert FA.BLOCK_ROWS % 64 == 0 and 64 <= FA.BLOCK_ROWS <= const("kMaxBlockRows")
    assert FA.MAX_KEYS == const("kMaxKeys") and FA.MAX_PLANES == const("kMaxPlanes")
    assert FA.RANK_MAX == const("kRankMax")
