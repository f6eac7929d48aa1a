"""The port's twin of ``tests/test_fuzz_differential.py``: seeded random
predicates over seeded random tables (``torch_fuzz_cases``, drawn in the
reference test's order), at 400 seeds where the reference runs 30.

For every seed the row indices each filter path keeps are equal:

* pyarrow's compute kernels (the reference test's oracle);
* the JAX package's host evaluator (``plan/expressions.filter_mask``) and
  its device mask (``ops/filter.device_filter_mask``), as its own test runs
  them on the CPU;
* the port's host evaluator and its device mask on the CPU (``device=
  "cpu"``), where the mask lowers the predicate (else both packages
  refuse it alike with ``Unsupported``);
* where ``lower_range_terms`` accepts the predicate, the port's
  ``fused_range_mask`` (B3a's plain version on the CPU).

The case also holds the corpus to the reference's generator: the same
table, and the same predicate as ``_random_pred`` draws.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pytest
from test_fuzz_differential import _random_pred, _random_table
from torch_b5_cases import same_rows
from torch_corpus_twin import JAX, PORT
from torch_fuzz_cases import SEEDS, build, pyarrow_rows, random_spec, random_table


def _masks(P, table, spec):
    """{path: kept row indices} of one package."""
    batch = P.ColumnarBatch.from_arrow(table)
    cond = build(spec, P.E)
    out = {"host": np.nonzero(np.asarray(P.E.filter_mask(cond, batch)))[0]}
    try:
        out["device"] = np.nonzero(P.device_mask(cond, batch))[0]
    except P.filter_ops.Unsupported:
        out["device"] = None
    if P.is_port and P.filter_ops.lower_range_terms(cond, batch) is not None:
        fused = P.filter_ops.fused_range_mask(cond, batch, "cpu")
        out["fused"] = None if fused is None else np.nonzero(fused)[0]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_masks_equal_the_reference_and_pyarrow(seed):
    rng = np.random.default_rng(seed)
    table, spec = random_table(rng), random_spec(rng)
    ref_rng = np.random.default_rng(seed)
    ref_table = _random_table(ref_rng)
    assert same_rows(table, ref_table)
    assert repr(build(spec, JAX.E)) == repr(_random_pred(ref_rng)[0])
    want = pyarrow_rows(table, spec)
    mine, ref = _masks(PORT, table, spec), _masks(JAX, table, spec)
    assert ref["host"].tolist() == want.tolist(), spec
    assert mine["host"].tolist() == want.tolist(), spec
    assert (mine["device"] is None) == (ref["device"] is None), spec
    if ref["device"] is not None:
        assert ref["device"].tolist() == mine["device"].tolist() == want.tolist(), spec
    if mine.get("fused") is not None:
        assert mine["fused"].tolist() == want.tolist(), spec


def test_the_corpus_reaches_every_route():
    """Over the seeds the device mask lowers every predicate and the fused
    range route takes 136 of them: each path is held on the corpus."""
    routes = {"device": 0, "refused": 0, "fused": 0}
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        table, spec = random_table(rng), random_spec(rng)
        m = _masks(PORT, table, spec)
        routes["device" if m["device"] is not None else "refused"] += 1
        routes["fused"] += m.get("fused") is not None
    assert routes == {"device": len(SEEDS), "refused": 0, "fused": 136}, routes
