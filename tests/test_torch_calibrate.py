"""The port's calibration probe (``hyperspace_tpu_torch/calibrate.py``), on
the CPU.

Twins of ``tests/test_native.py::TestCalibration`` mapped to the two fields
the port measures: the cache (with the probe's times) written and read
back without a re-probe, a machine-key mismatch and a corrupt or partial
file re-probing, ``HS_CALIBRATE=0``, the explicit module override, the
exchange strategy at and above a stubbed threshold, no probe on the CPU,
and a kernel's fault in the probe propagating where any other failure
costs only the defaults; the fused probe's threshold rule with stubbed
times, and its two routes equal to the JAX package's interpreted chain.
The probe itself times the card and runs in
``tests/test_torch_cuda.py``; here it is stubbed, and the card is
pretended where a case needs one.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os

import pytest
import torch

from hyperspace_tpu_torch import calibrate, kernels
from hyperspace_tpu_torch.execution import pipeline_compiler as PC
from hyperspace_tpu_torch.parallel import shuffle
from hyperspace_tpu_torch.parallel.mesh import Mesh

MACHINE = {"version": calibrate._PROBE_VERSION, "cpus": 8, "device": "card", "capability": "9.0",
           "cuda": "12.8", "torch": "2.x"}


def _probe_of(fused=0, compact=0, calls=None):
    def probe():
        if calls is not None:
            calls.append(1)
        return (
            calibrate.Thresholds(native_fused_pipeline_min_rows=fused,
                                 exchange_compact_min_rows=compact, source="calibrated"),
            {"fused": [{"rows": fused}], "exchange": []},
        )

    return probe


def _no_probe():
    raise AssertionError("probed")


@pytest.fixture(autouse=True)
def fresh(tmp_path, monkeypatch):
    """A build dir of the test's own, a pretended card and machine key,
    and the in-process memo dropped before and after."""
    monkeypatch.setattr(kernels, "build_dir", lambda: str(tmp_path / "build"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(calibrate, "_machine_key", lambda: dict(MACHINE))
    monkeypatch.delenv("HS_CALIBRATE", raising=False)
    calibrate.invalidate()
    yield
    calibrate.invalidate()


def test_probe_result_is_cached_under_the_build_dir(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=4096, compact=1 << 20, calls=calls))
    got = calibrate.thresholds()
    assert got == calibrate.Thresholds(4096, 1 << 20, "calibrated")
    path = tmp_path / "build" / "_hs_calibration.json"
    assert calibrate.cache_file() == str(path)
    with open(path) as f:
        data = json.load(f)
    assert data == {"machine": MACHINE, "thresholds": {
        "native_fused_pipeline_min_rows": 4096, "exchange_compact_min_rows": 1 << 20},
        "probe": {"fused": [{"rows": 4096}], "exchange": []}}
    assert calibrate.probe_times() == {"fused": [{"rows": 4096}], "exchange": []}
    assert not [n for n in os.listdir(path.parent) if ".tmp." in n]
    # a later process (a fresh memo) reads the file and never re-probes
    calibrate.invalidate()
    monkeypatch.setattr(calibrate, "_probe", _no_probe)
    assert calibrate.thresholds() == got
    assert calls == [1]


def test_memo_answers_without_the_file(monkeypatch):
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=2048))
    first = calibrate.thresholds()
    os.remove(calibrate.cache_file())
    monkeypatch.setattr(calibrate, "_probe", _no_probe)
    assert calibrate.thresholds() is first


def test_machine_key_mismatch_reprobes(monkeypatch):
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=1024))
    calibrate.thresholds()
    calibrate.invalidate()
    monkeypatch.setattr(calibrate, "_machine_key", lambda: {**MACHINE, "device": "another card"})
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=2048))
    assert calibrate.thresholds().native_fused_pipeline_min_rows == 2048


@pytest.mark.parametrize("content", [
    "{not json",
    '{"machine": null}',
    json.dumps({"machine": MACHINE}),
    json.dumps({"machine": MACHINE, "thresholds": {"native_fused_pipeline_min_rows": 8}}),
    json.dumps({"machine": MACHINE, "thresholds": {"native_fused_pipeline_min_rows": "x",
                                                   "exchange_compact_min_rows": 0}}),
    "",
], ids=["torn", "null-machine", "no-thresholds", "partial", "bad-value", "empty"])
def test_corrupt_or_partial_cache_reprobes(monkeypatch, content):
    path = calibrate.cache_file()
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        f.write(content)
    calls = []
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=8192, calls=calls))
    assert calibrate.thresholds().native_fused_pipeline_min_rows == 8192
    assert calls == [1]
    with open(path) as f:
        assert json.load(f)["thresholds"]["native_fused_pipeline_min_rows"] == 8192


def test_disabled_returns_defaults(monkeypatch):
    monkeypatch.setenv("HS_CALIBRATE", "0")
    monkeypatch.setattr(calibrate, "_probe", _no_probe)
    got = calibrate.thresholds()
    assert got.source == "defaults"
    assert got.native_fused_pipeline_min_rows == 0  # 0 = the caller's constant
    assert got.exchange_compact_min_rows == 0
    assert not os.path.exists(calibrate.cache_file())


def test_defaults_match_the_reference(monkeypatch):
    """The two fields keep the reference's names, and its uncalibrated
    values: 0 in both packages."""
    from hyperspace_tpu.native import calibrate as jcal

    monkeypatch.setenv("HS_CALIBRATE", "0")
    jcal.invalidate()
    ref = jcal.thresholds()
    mine = calibrate.thresholds()
    for f in calibrate._FIELDS:
        assert getattr(mine, f) == getattr(ref, f) == 0
    assert mine.source == ref.source == "defaults"
    ref_fields = {f.name for f in __import__("dataclasses").fields(jcal.Thresholds)}
    assert set(calibrate._FIELDS) <= ref_fields
    assert calibrate.Thresholds().source == jcal.Thresholds().source


def test_no_probe_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(calibrate, "_probe", _no_probe)
    assert calibrate.thresholds() == calibrate.Thresholds()
    assert not os.path.exists(calibrate.cache_file())
    # and a CPU session's dispatch never asks
    monkeypatch.setattr(calibrate, "thresholds", _no_probe)
    assert PC._native_fused_pipeline_min_rows("cpu") == PC._NATIVE_FUSED_PIPELINE_MIN_ROWS


def test_fused_threshold_is_calibrated_on_the_card(monkeypatch):
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=1 << 12))
    assert PC._native_fused_pipeline_min_rows("cuda") == 1 << 12
    assert PC._native_fused_pipeline_min_rows(torch.device("cuda", 0)) == 1 << 12
    # the CPU keeps the constant
    assert PC._native_fused_pipeline_min_rows("cpu") == PC._NATIVE_FUSED_PIPELINE_MIN_ROWS_DEFAULT


def test_zero_is_no_measurement(monkeypatch):
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=0))
    assert PC._native_fused_pipeline_min_rows("cuda") == PC._NATIVE_FUSED_PIPELINE_MIN_ROWS_DEFAULT


def test_module_attribute_override_beats_calibration(monkeypatch):
    monkeypatch.setattr(calibrate, "_probe", _probe_of(fused=1 << 12))
    monkeypatch.setattr(PC, "_NATIVE_FUSED_PIPELINE_MIN_ROWS", 7)
    assert PC._native_fused_pipeline_min_rows("cuda") == 7
    assert PC._native_fused_pipeline_min_rows("cpu") == 7


@pytest.mark.parametrize("threshold, rows, want", [
    (1000, 999, shuffle.STRATEGY_FLAT),
    (1000, 1000, shuffle.STRATEGY_COMPACT),
    (1000, 5000, shuffle.STRATEGY_COMPACT),
    (0, 1 << 30, shuffle.STRATEGY_FLAT),
])
def test_resolve_strategy_takes_compact_at_and_above_the_threshold(monkeypatch, threshold, rows,
                                                                    want):
    monkeypatch.setattr(calibrate, "_probe", _probe_of(compact=threshold))
    cuda_mesh = Mesh(["cuda", "cuda"])
    assert shuffle.resolve_strategy("auto", cuda_mesh, rows) == want
    # an explicit strategy and a CPU mesh never consult it
    assert shuffle.resolve_strategy("flat", cuda_mesh, rows) == shuffle.STRATEGY_FLAT
    assert shuffle.resolve_strategy("auto", Mesh(["cpu", "cpu"]), rows) == shuffle.STRATEGY_HOST


def test_a_kernel_fault_in_the_probe_propagates(monkeypatch):
    def probe():
        raise kernels.KernelLaunchError("injected B5f launch error")

    monkeypatch.setattr(calibrate, "_probe", probe)
    with pytest.raises(kernels.KernelLaunchError):
        calibrate.thresholds()
    assert calibrate._cached is None and not calibrate._probing
    monkeypatch.setattr(calibrate, "_probe", lambda: (_ for _ in ()).throw(
        kernels.KernelBuildError("nvcc refused a source")))
    with pytest.raises(kernels.KernelBuildError):
        calibrate.thresholds()


def test_any_other_probe_failure_costs_only_the_defaults(monkeypatch, caplog):
    def probe():
        raise RuntimeError("probe broke")

    monkeypatch.setattr(calibrate, "_probe", probe)
    with caplog.at_level("WARNING", logger="hyperspace_tpu_torch.calibrate"):
        got = calibrate.thresholds()
    assert got == calibrate.Thresholds()
    assert "probe broke" in caplog.text
    assert not os.path.exists(calibrate.cache_file())  # a failure is never cached on disk
    assert not calibrate._probing


def test_exchange_probe_needs_two_cards_and_one_process(monkeypatch):
    """No measurement (0, nothing timed) with fewer than 2 CUDA devices,
    on a CPU mesh, or in a job of several processes."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(shuffle, "bucket_shuffle", _no_probe)
    assert calibrate.probe_exchange_compact_min() == (0, [])
    assert calibrate.probe_exchange_compact_min(mesh=Mesh(["cpu"] * 4)) == (0, [])
    assert calibrate.probe_exchange_compact_min(mesh=Mesh(["cuda"] * 2, processes=2)) == (0, [])
    from hyperspace_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "process_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert calibrate.probe_exchange_compact_min() == (0, [])


def test_exchange_probe_times_both_strategies(monkeypatch):
    """The probe's control flow with the strategies and their timing
    stubbed: compact slower at the first size, faster at the second."""
    seen = []
    cost = {(1 << 18, "compact"): 0.02, (1 << 18, "flat"): 0.01,
            (1 << 20, "compact"): 0.01, (1 << 20, "flat"): 0.02}

    def fake_shuffle(mesh, reps, payloads, nb, strategy):
        seen.append((reps.shape[1], strategy))

    def timed(fn, reps=3):
        fn()
        return cost[seen[-1]]

    monkeypatch.setattr(shuffle, "bucket_shuffle", fake_shuffle)
    monkeypatch.setattr(calibrate, "_time_best", timed)
    rows, times = calibrate.probe_exchange_compact_min(mesh=Mesh(["cuda"] * 4))
    assert rows == 1 << 20
    assert times == [{"rows": 1 << 18, "compact_s": 0.02, "flat_s": 0.01},
                     {"rows": 1 << 20, "compact_s": 0.01, "flat_s": 0.02}]
    assert {s for _n, s in seen} == {"flat", "compact"}


def test_fused_probe_on_the_cpu_device_runs_both_routes(monkeypatch):
    """The fused probe's workload runs through both routes of each plan
    shape on the CPU's plain versions (the card is pretended only for
    ``thresholds``): it times each size's routes and returns a size or
    twice the largest."""
    calls = []
    real = calibrate._fused_routes

    def routes(*a):
        fused, declined = real(*a)
        return (lambda: calls.append("fused") or fused(),
                lambda: calls.append("declined") or declined())

    monkeypatch.setattr(calibrate, "_fused_routes", routes)
    monkeypatch.setattr(calibrate, "_FUSED_PROBE_SIZES", [1 << 10, 1 << 11])
    monkeypatch.setattr(calibrate, "_sync", lambda: None)
    rows, times = calibrate.probe_fused_pipeline_min(device="cpu")
    assert rows in (1 << 10, 1 << 11, 1 << 12)
    assert "fused" in calls and "declined" in calls
    assert {t["shape"] for t in times if t["rows"] == 1 << 10} == set(calibrate._FUSED_SHAPES)
    assert all(t["fused_s"] > 0 and t["declined_s"] > 0 for t in times)


class _Route:
    """A stubbed route: its (route, shape, rows) key names its cost."""

    def __init__(self, key):
        self.key = key

    def __call__(self):
        return None


@pytest.mark.parametrize("ordered_cost, want", [
    ({1 << 10: 0.95, 1 << 11: 0.91, 1 << 12: 0.8}, 1 << 12),
    ({1 << 10: 0.5}, 1 << 11),
    ({1 << 10: 0.99, 1 << 11: 0.95, 1 << 12: 0.95}, 1 << 13),
], ids=["ordered-wins-later", "both-win-early", "ordered-never-wins"])
def test_fused_probe_needs_every_shape_to_win_by_the_margin(monkeypatch, ordered_cost, want):
    """The threshold is the size from which the fused pass wins on both
    shapes; a size counts only where it takes at most ``_WIN_MARGIN`` of
    the declined route's time; a shape stops being timed at its first win;
    a shape that never wins gives twice the largest size."""
    one_pass_cost = {1 << 10: 0.95, 1 << 11: 0.5}
    timed = []

    def routes(batch, terms, group_by, aggs, schema, dev):
        shape = "ordered" if any(a.column == "b" for a in aggs) else "one_pass"
        n = batch.num_rows
        return _Route(("fused", shape, n)), _Route(("declined", shape, n))

    def best(fn, reps=3):
        route, shape, n = fn.key
        timed.append(fn.key)
        if route == "declined":
            return 1.0
        return (ordered_cost if shape == "ordered" else one_pass_cost)[n]

    monkeypatch.setattr(calibrate, "_fused_routes", routes)
    monkeypatch.setattr(calibrate, "_time_best", best)
    monkeypatch.setattr(calibrate, "_FUSED_PROBE_SIZES", [1 << 10, 1 << 11, 1 << 12])
    rows, times = calibrate.probe_fused_pipeline_min(device="cpu")
    assert rows == want
    # one_pass wins at 2^11 and is never timed after it
    assert [t["rows"] for t in times if t["shape"] == "one_pass"] == [1 << 10, 1 << 11]
    assert [t["rows"] for t in times if t["shape"] == "ordered"] == sorted(ordered_cost)[
        : len([t for t in times if t["shape"] == "ordered"])]
    assert all(t["declined_s"] == 1.0 for t in times)
    assert ("fused", "one_pass", 1 << 12) not in timed


@pytest.mark.parametrize("shape", sorted(calibrate._FUSED_SHAPES))
def test_fused_probe_routes_give_equal_rows(shape):
    """The probe's two routes compute the same aggregate as the JAX
    package's interpreted chain (the fused and declined routes are
    bit-equal by design)."""
    import numpy as np
    import pyarrow as pa
    from torch_b5_cases import same_rows

    from hyperspace_tpu.execution import pipeline_compiler as jpc
    from hyperspace_tpu.io.columnar import Column as JColumn
    from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
    from hyperspace_tpu.plan.nodes import AggSpec as JAggSpec
    from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
    from hyperspace_tpu_torch.plan.nodes import AggSpec

    rng = np.random.default_rng(49)
    n = 1 << 12
    values = {"k": rng.integers(0, 200, n, dtype=np.int64),
              "a": rng.integers(0, 1 << 18, n, dtype=np.int64),
              "b": rng.normal(0.0, 1.0, n)}
    schema = {"k": pa.int64(), "a": pa.int64(), "b": pa.float64()}
    batch = ColumnarBatch({c: Column("numeric", schema[c], values=v) for c, v in values.items()})
    terms = (("a", 1000, False, 110000, True, False), ("b", -1.0, True, None, False, False))
    specs = calibrate._FUSED_SHAPES[shape]
    fused, declined = calibrate._fused_routes(batch, terms, ["k"], [AggSpec(*a) for a in specs],
                                              schema, torch.device("cpu"))
    f, d = fused().to_arrow(), declined().to_arrow()
    ref = jpc.interpreted_filter_aggregate(
        JBatch({c: JColumn("numeric", schema[c], values=v) for c, v in values.items()}),
        terms, ["k"], [JAggSpec(*a) for a in specs], schema).to_arrow()
    assert f.num_rows > 100 and same_rows(f, d) and same_rows(f, ref)
