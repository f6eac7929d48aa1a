"""The port's telemetry events against the JAX package's, on the CPU.

Both packages run one lifecycle in lockstep (``torch_lifecycle_twin.Twin``:
create, a no-op refresh, an incremental refresh after an append, optimize,
delete, restore, delete, vacuum, a refused cancel and an index-served
query), each with its ``JsonlEventLogger`` selected through
``hyperspace.eventLoggerClass``. The two event logs are equal line for
line, apart from ``timestamp_ms`` (and the system path inside a usage
event's plan text). Each event class's JSON line is equal too, and every
event is counted in ``hs_events_total`` and stamped at emit time.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import dataclasses
import json
import os

import pytest
from torch_lifecycle_twin import Twin, append_file

from hyperspace_tpu import telemetry as JT
from hyperspace_tpu.obs import metrics as jmetrics
from hyperspace_tpu_torch import telemetry as TT
from hyperspace_tpu_torch.obs import metrics as tmetrics

LOGGER = {"port": "hyperspace_tpu_torch.telemetry.JsonlEventLogger",
          "jax": "hyperspace_tpu.telemetry.JsonlEventLogger"}


def _events(path, sys_path):
    out = []
    for rec in tmetrics.read_jsonl(path):
        assert rec.pop("timestamp_ms") > 0
        if "plan" in rec:
            rec["plan"] = rec["plan"].replace(sys_path, "<sys>")
        out.append(rec)
    return out


@pytest.fixture
def twin(tmp_path, sample_parquet):
    tw = Twin(tmp_path / "sys", sample_parquet)
    for pkg, s, _hs in tw.sides():
        s.conf.set("hyperspace.eventLoggerClass", LOGGER[pkg])
        s.conf.set("hyperspace.obs.eventlog.path", str(tmp_path / f"events.{pkg}.jsonl"))
    return tw


def test_lifecycle_event_lines_equal_the_reference(twin, tmp_path, sample_parquet):
    before = tmetrics.events_total.snapshot()
    twin.create("covering", "idx", ["clicks"], ["query"])
    twin.run("refresh_index", "idx", "full")  # nothing changed: a no-op event
    append_file(sample_parquet)
    twin.run("refresh_index", "idx", "incremental")
    twin.run("optimize_index", "idx", "quick")
    twin.run("delete_index", "idx")
    twin.run("restore_index", "idx")
    twin.run("delete_index", "idx")
    twin.run("vacuum_index", "idx")
    twin.run_raises("transient states|not found|Cancel", "cancel", "idx")
    twin.create("covering", "idx2", ["clicks"], ["imprs"])
    twin.query(lambda df: df.filter(df["clicks"] == 5).select("clicks", "imprs"))
    port = _events(str(tmp_path / "events.port.jsonl"), twin.tsys)
    ref = _events(str(tmp_path / "events.jax.jsonl"), twin.jsys)
    assert port == ref
    kinds = [r["event"] for r in port]
    for want in ("CreateActionEvent", "RefreshActionEvent", "RefreshIncrementalActionEvent",
                 "OptimizeActionEvent", "DeleteActionEvent", "RestoreActionEvent",
                 "VacuumActionEvent", "HyperspaceIndexUsageEvent"):
        assert want in kinds, (want, kinds)
    assert any(r["message"] == "No-op action" for r in port)
    after = tmetrics.events_total.snapshot()
    assert sum(after.values()) - sum(before.values()) == len(port)


EVENTS = [n for n in dir(JT) if n.endswith("Event") and n != "HyperspaceEvent"]


@pytest.mark.parametrize("name", sorted(EVENTS))
def test_each_event_class_line_equals_the_reference(tmp_path, name):
    kwargs = {"message": "m"}
    fields = {f.name for f in dataclasses.fields(getattr(JT, name))}
    if "index_name" in fields:
        kwargs["index_name"] = "idx"
    if "index_names" in fields:
        kwargs.update(index_names=["a", "b"], plan="Project [k]")
    lines = {}
    for pkg, T_, M in (("port", TT, tmetrics), ("jax", JT, jmetrics)):
        path = str(tmp_path / f"{pkg}.jsonl")
        ev = getattr(T_, name)(**kwargs)
        assert ev.timestamp_ms == 0
        logger = T_.JsonlEventLogger()
        logger._sink = M.JsonlSink(path)
        logger.log_event(ev)
        logger.close()
        (rec,) = M.read_jsonl(path)
        lines[pkg] = json.dumps(rec, sort_keys=True)
    assert lines["port"] == lines["jax"]


def test_default_logger_is_a_no_op_and_counts(tmp_path):
    from hyperspace_tpu_torch.config import Config

    logging = TT.EventLogging(Config())
    before = tmetrics.events_total.snapshot().get("DeleteActionEvent", 0)
    ev = TT.DeleteActionEvent(index_name="x")
    logging.log_event(ev)
    assert ev.timestamp_ms > 0
    assert tmetrics.events_total.snapshot()["DeleteActionEvent"] == before + 1
    assert type(logging._resolve()) is TT.EventLogger
    assert not os.listdir(tmp_path)
