"""The port's chaos harness (``hyperspace_tpu_torch/testing/chaos.py``)
against the JAX package's (``tests/test_chaos.py``): the same seeded
schedule, a clean run, and three crash cells. Each run holds the recovery
contract (a stable tip after recovery, zero orphans after GC, serves equal
to the source's rows), and the port's serve results and counters equal the
JAX harness's, step for step.

Both harnesses build with their default route, the pipelined
partition-first writer, as the crash differentials do
(``tests/torch_crash_twin.py``).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import pytest

from hyperspace_tpu.testing import chaos as jchaos
from hyperspace_tpu.testing import faults as jfaults
from hyperspace_tpu_torch.testing import chaos as tchaos
from hyperspace_tpu_torch.testing import faults as tfaults


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (tfaults, jfaults):
        f.reset()
    yield
    for f in (tfaults, jfaults):
        f.reset()


@pytest.mark.parametrize(("seed", "n_steps"), [(7, 14), (2, 10), (5, 12), (1, 10)])
def test_schedule_equals_reference_and_is_legal(seed, n_steps):
    a = tchaos.build_schedule(seed, n_steps)
    assert a == tchaos.build_schedule(seed, n_steps)
    assert a == jchaos.build_schedule(seed, n_steps)
    assert a[0] == ("create",)
    for i, step in enumerate(a):
        if step[0].startswith("refresh"):
            assert a[i - 1][0] == "append"


def _harnesses(tmp_path, seed):
    return (
        tchaos.ChaosHarness(str(tmp_path / "port"), seed=seed, n_steps=10, device="cpu"),
        jchaos.ChaosHarness(str(tmp_path / "jax"), seed=seed, n_steps=10),
    )


def _same_report(got, want):
    assert len(got.serve_results) == len(want.serve_results)
    for a, b in zip(got.serve_results, want.serve_results):
        assert a.equals(b)
    for key in ("crashes_fired", "crashes_skipped", "recoveries", "rolled_back",
                "healed_pointers", "stranded_after", "orphans_after_gc",
                "gc_quarantined", "final_state"):
        assert getattr(got, key) == getattr(want, key), key


def test_clean_run_matches_reference(tmp_path):
    port, ref = _harnesses(tmp_path, seed=1)
    rep = port.run(run_name="clean")
    assert rep.serve_results, "schedule produced no serves"
    assert rep.stranded_after == 0 and rep.orphans_after_gc == 0
    assert rep.crashes_fired == 0
    _same_report(rep, ref.run(run_name="clean"))


@pytest.mark.parametrize(
    ("cell", "point"),
    [
        (0, "after_begin_log"),  # crash the create
        (1, "mid_data_write"),  # crash a data-writing lifecycle op
        (1, "after_end_log"),  # committed but unpublished
    ],
)
def test_crash_cells_recover_and_match_replica_and_reference(tmp_path, cell, point):
    port, ref = _harnesses(tmp_path, seed=2)
    clean = port.run(run_name="clean")
    rep = port.run(crash_step=cell, crash_point=point)
    assert rep.crashes_fired + rep.crashes_skipped == 1
    assert rep.stranded_after == 0 and rep.orphans_after_gc == 0
    assert len(rep.serve_results) == len(clean.serve_results)
    for got, want in zip(rep.serve_results, clean.serve_results):
        assert got.equals(want)
    _same_report(rep, ref.run(crash_step=cell, crash_point=point))
