"""The port's query log and plan specs against the JAX package's, on the CPU.

* Twins of ``tests/test_querylog_reader.py`` (torn tails, a crashed
  writer's unsealed file, unknown ``schema_v``) and of
  ``tests/test_crash_recovery.py::TestQuerylogRotateCrash``, each run
  through both packages.
* The on-disk format is shared: each package reads the other's
  segments, sealed and active, record for record.
* ``obs/planspec``: for the same plan the two packages' specs are
  JSON-equal, each package rebuilds the other's spec into the same plan,
  and a spec recorded by one replays in the other
  (``testing/replay.replay_records``) with the original query's rows.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_b5_cases import same_rows

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu.obs import metrics as jmetrics
from hyperspace_tpu.obs import planspec as jplanspec
from hyperspace_tpu.obs import querylog as jquerylog
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu.testing import faults as jfaults
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.obs import metrics as tmetrics
from hyperspace_tpu_torch.obs import planspec as tplanspec
from hyperspace_tpu_torch.obs import querylog as tquerylog
from hyperspace_tpu_torch.obs import trace as ttrace
from hyperspace_tpu_torch.testing import faults as tfaults
from hyperspace_tpu_torch.testing import replay as treplay

QL = {"port": tquerylog, "jax": jquerylog}
METRICS = {"port": tmetrics, "jax": jmetrics}
FAULTS = {"port": tfaults, "jax": jfaults}
PKGS = ["port", "jax"]


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    for f in FAULTS.values():
        f.reset()
    ttrace.set_enabled(False)
    ttrace.reset()


def _rec(ql, i, **over):
    rec = {
        "schema_v": ql.SCHEMA_V,
        "ts_ms": 1000 + i,
        "fingerprint": f"fp{i}",
        "duration_s": 0.01,
        "status": "ok",
        "stages": {"scan": 0.001},
        "rows_returned": i,
    }
    rec.update(over)
    return rec


def _write_segment(path, records, tail=""):
    with open(path, "w", encoding="utf-8") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
        fh.write(tail)


# ---------------------------------------------------------------------------
# Reader hardening (tests/test_querylog_reader.py), both packages
# ---------------------------------------------------------------------------


class TestTornTail:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_torn_tail_skipped_rest_reads(self, tmp_path, pkg):
        ql = QL[pkg]
        d = str(tmp_path)
        _write_segment(
            os.path.join(d, "querylog.1.aaaa.jsonl"),
            [_rec(ql, 0), _rec(ql, 1)],
            tail='{"schema_v": 1, "fingerprint": "torn", "dur',
        )
        got = ql.read_records(d)
        assert [r["fingerprint"] for r in got] == ["fp0", "fp1"]

    @pytest.mark.parametrize("pkg", PKGS)
    def test_torn_line_mid_union_does_not_hide_other_files(self, tmp_path, pkg):
        ql = QL[pkg]
        d = str(tmp_path)
        _write_segment(os.path.join(d, "querylog.1.aaaa.jsonl"), [_rec(ql, 0)], tail="{garbage")
        _write_segment(os.path.join(d, "querylog.2.bbbb.jsonl"), [_rec(ql, 1), _rec(ql, 2)])
        fps = {r["fingerprint"] for r in ql.read_records(d)}
        assert fps == {"fp0", "fp1", "fp2"}

    @pytest.mark.parametrize("pkg", PKGS)
    def test_empty_and_missing_directory(self, tmp_path, pkg):
        ql = QL[pkg]
        assert ql.read_records(str(tmp_path / "nope")) == []
        assert ql.read_valid_records(str(tmp_path / "nope")) == []


class TestCrashedWriterPickup:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_unsealed_active_file_reads_after_mid_rotate_crash(self, tmp_path, pkg):
        ql, faults = QL[pkg], FAULTS[pkg]
        d = str(tmp_path / "obslog")
        faults.set_crash("mid_querylog_rotate", "raise")
        log = ql.QueryLog(d, max_bytes=256, max_files=8)
        written = 0
        with pytest.raises(faults.SimulatedCrash):
            for i in range(64):
                assert log.append(_rec(ql, i, fingerprint=f"dead{i}"))
                written += 1
        written += 1  # the rotating append was durable pre-crash
        log2 = ql.QueryLog(d, max_bytes=1 << 20, max_files=8)
        for i in range(3):
            assert log2.append(_rec(ql, i, fingerprint=f"live{i}"))
        log2.close()
        got = ql.read_valid_records(d)
        fps = [r["fingerprint"] for r in got]
        assert sum(1 for f in fps if f.startswith("dead")) == written
        assert sum(1 for f in fps if f.startswith("live")) == 3
        for r in got:
            assert ql.validate_record(r) is None, r


class TestSchemaVersionSkip:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_unknown_schema_v_skipped_with_counter(self, tmp_path, pkg):
        ql, metrics = QL[pkg], METRICS[pkg]
        d = str(tmp_path)
        _write_segment(
            os.path.join(d, "querylog.1.aaaa.jsonl"),
            [
                _rec(ql, 0),
                _rec(ql, 1, schema_v=ql.SCHEMA_V + 7),
                _rec(ql, 2, schema_v="one"),
                _rec(ql, 3, schema_v=True),
                _rec(ql, 4),
            ],
        )
        before = metrics.querylog_skipped_total.value
        got = ql.read_valid_records(d)
        assert [r["fingerprint"] for r in got] == ["fp0", "fp4"]
        assert metrics.querylog_skipped_total.value - before == 3

    @pytest.mark.parametrize("pkg", PKGS)
    def test_read_records_keeps_what_valid_reader_drops(self, tmp_path, pkg):
        ql = QL[pkg]
        d = str(tmp_path)
        _write_segment(os.path.join(d, "querylog.1.aaaa.jsonl"), [_rec(ql, 0), _rec(ql, 1, schema_v=99)])
        assert len(ql.read_records(d)) == 2
        assert len(ql.read_valid_records(d)) == 1


# ---------------------------------------------------------------------------
# The rotation crash (tests/test_crash_recovery.py::TestQuerylogRotateCrash)
# ---------------------------------------------------------------------------


def _plain(tag, i):
    return {"fingerprint": f"{tag}{i}", "duration_s": 0.01, "status": "ok",
            "stages": {"scan": 0.001}, "rows_returned": i}


class TestQuerylogRotateCrash:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_crash_mid_rotate_loses_nothing(self, tmp_path, pkg):
        ql, faults = QL[pkg], FAULTS[pkg]
        d = str(tmp_path / "obslog")
        faults.set_crash("mid_querylog_rotate", "raise")
        log = ql.QueryLog(d, max_bytes=256, max_files=64)
        written = 0
        crashed = False
        try:
            for i in range(64):
                assert log.append(_plain("a", i))
                written += 1
        except faults.SimulatedCrash:
            crashed = True
            written += 1
        assert crashed, "rotation never crossed the crash seam"
        assert faults.stats().get("crash.mid_querylog_rotate", 0) == 1
        log2 = ql.QueryLog(d, max_bytes=1 << 20, max_files=64)
        for i in range(5):
            assert log2.append(_plain("b", i))
        log2.close()
        records = ql.read_records(d)
        fps = [r["fingerprint"] for r in records]
        assert len([f for f in fps if f.startswith("a")]) == written
        assert len([f for f in fps if f.startswith("b")]) == 5
        assert len(set(fps)) == len(fps), "duplicate records after crash"
        for r in records:
            assert ql.validate_record(r) is None, r

    @pytest.mark.parametrize("pkg", PKGS)
    def test_rotation_bounds_hold_without_crash(self, tmp_path, pkg):
        ql = QL[pkg]
        d = str(tmp_path / "obslog")
        log = ql.QueryLog(d, max_bytes=256, max_files=2)
        for i in range(200):
            assert log.append({"fingerprint": f"f{i}", "duration_s": 0.01, "status": "ok",
                               "stages": {}, "rows_returned": i})
        log.close()
        assert log.rotations > 2
        sealed = [n for n in os.listdir(d) if n.endswith(".sealed.jsonl")]
        assert len(sealed) <= 2
        for r in ql.read_records(d):
            assert ql.validate_record(r) is None, r

    def test_crash_by_config_and_exit_code(self, tmp_path):
        """The port's point arms from the session conf like every other."""
        from hyperspace_tpu_torch.config import Config

        conf = Config()
        conf.set(T.constants.CRASH_KEY_PREFIX + "mid_querylog_rotate", "raise")
        assert tfaults.configure(conf) == 1
        log = tquerylog.QueryLog(str(tmp_path / "q"), max_bytes=1)
        with pytest.raises(tfaults.SimulatedCrash):
            log.append(_plain("x", 0))


# ---------------------------------------------------------------------------
# One format: each package reads the other's segments
# ---------------------------------------------------------------------------


class TestSharedFormat:
    @pytest.mark.parametrize("writer", PKGS)
    def test_each_reads_the_others_segments(self, tmp_path, writer):
        d = str(tmp_path / "obslog")
        log = QL[writer].QueryLog(d, max_bytes=512, max_files=64)
        for i in range(40):
            assert log.append(_plain(writer, i))
        log.close()
        assert log.rotations >= 2
        names = sorted(os.listdir(d))
        assert any(n.endswith(".sealed.jsonl") for n in names)
        for reader in PKGS:
            got = QL[reader].read_valid_records(d)
            assert [r["fingerprint"] for r in got] == [f"{writer}{i}" for i in range(40)]
            assert all(r["schema_v"] == 1 for r in got)
        assert tquerylog.read_records(d) == jquerylog.read_records(d)

    def test_both_writers_in_one_directory(self, tmp_path):
        d = str(tmp_path / "obslog")
        logs = [QL[p].QueryLog(d, max_bytes=300) for p in PKGS]
        for i in range(20):
            for p, log in zip(PKGS, logs):
                log.append(_plain(p, i))
        for log in logs:
            log.close()
        for reader in PKGS:
            fps = sorted(r["fingerprint"] for r in QL[reader].read_valid_records(d))
            assert fps == sorted(f"{p}{i}" for p in PKGS for i in range(20))

    def test_summaries_agree(self, tmp_path):
        """predicate_shape, indexes_in_plan and rule_flavor of the same
        plan are equal in both packages."""
        src = _source(tmp_path)
        t, j = T.HyperspaceSession(device="cpu"), JSession()
        for build in _PLANS.values():
            tp, jp = build(t, src, TF).logical_plan, build(j, src, JF).logical_plan
            assert tquerylog.predicate_shape(tp) == jquerylog.predicate_shape(jp)
            assert tquerylog.rule_flavor(tp) == jquerylog.rule_flavor(jp)
            assert tquerylog.indexes_in_plan(tp) == jquerylog.indexes_in_plan(jp) == []

    def test_record_from_root_is_the_reference_schema(self, tmp_path):
        ttrace.set_enabled(True)
        root = ttrace.root("serve.query", slo_class="gold")
        with ttrace.activate(root):
            ttrace.stage("scan", seconds=0.5)
            ttrace.accumulate("rows_pruned", 4)
            ttrace.event("retry", attempt=1)
        root.set("fingerprint", "abc").set("status", "ok").set("rows_returned", 3)
        root.set("replay", {"op": "scan", "fmt": "parquet", "paths": ["/x"], "spec_v": 1})
        root.finish()
        rec = tquerylog.record_from_root(root)
        assert tquerylog.validate_record({**rec, "schema_v": 1}) is None
        assert rec["stages"] == {"scan": 0.5} and rec["rows_pruned"] == 4
        assert rec["slo_class"] == "gold" and rec["events"][0]["name"] == "retry"
        assert rec["duration_s"] == root.duration_s and rec["trace_id"] == root.trace_id
        log = tquerylog.QueryLog(str(tmp_path / "q"))
        log.append(rec)
        log.close()
        (back,) = jquerylog.read_valid_records(str(tmp_path / "q"))
        assert jquerylog.validate_record(back) is None and back["replay"] == rec["replay"]

    def test_open_log_reads_the_querylog_keys(self, tmp_path):
        """``open_log`` opens what the reference frontend opens: nothing
        with obs or the query log off, else a log sized by
        ``maxBytes`` / ``maxFiles`` under the system path's obs dir."""
        s = T.HyperspaceSession(device="cpu")
        s.conf.set(JC.INDEX_SYSTEM_PATH, str(tmp_path / "sys"))
        assert tquerylog.open_log(s.conf) is None  # obs off by default
        s.conf.set(JC.OBS_ENABLED, True)
        s.conf.set(JC.OBS_QUERYLOG_ENABLED, False)
        assert tquerylog.open_log(s.conf) is None
        s.conf.set(JC.OBS_QUERYLOG_ENABLED, True)
        s.conf.set(JC.OBS_QUERYLOG_MAX_BYTES, 300)
        s.conf.set(JC.OBS_QUERYLOG_MAX_FILES, 3)
        log = tquerylog.open_log(s.conf)
        assert log.directory == tquerylog.obs_root(s.conf) == jquerylog.obs_root(s.conf)
        assert (log.max_bytes, log.max_files) == (300, 3)
        other = tquerylog.open_log(s.conf, str(tmp_path / "elsewhere"))
        assert other.directory == str(tmp_path / "elsewhere")
        for i in range(40):
            log.append(_rec(tquerylog, i))
        log.close()
        other.close()
        assert log.rotations > 3
        sealed = [n for n in os.listdir(log.directory) if n.endswith(".sealed.jsonl")]
        assert len(sealed) <= 3

    @pytest.mark.parametrize("name", ["point", "join"])
    def test_plan_attrs_carry_the_spec_only_with_record_plans(self, tmp_path, name):
        """The root's plan attributes: the reference's predicate shape
        always, the reference's spec only under ``recordPlans``."""
        src = _source(tmp_path)
        t, j = T.HyperspaceSession(device="cpu"), JSession()
        tp = _PLANS[name](t, src, TF).logical_plan
        jp = _PLANS[name](j, src, JF).logical_plan
        assert tquerylog.plan_attrs(t.conf, tp) == {"predicate": jquerylog.predicate_shape(jp)}
        t.conf.set(JC.OBS_QUERYLOG_RECORD_PLANS, True)
        attrs = tquerylog.plan_attrs(t.conf, tp)
        assert attrs["predicate"] == jquerylog.predicate_shape(jp)
        assert json.dumps(attrs["replay"], sort_keys=True) == json.dumps(
            jplanspec.to_spec(jp), sort_keys=True)


# ---------------------------------------------------------------------------
# Plan specs: JSON-equal, rebuilt alike, replayed across packages
# ---------------------------------------------------------------------------


def _source(tmp_path):
    d = tmp_path / "src"
    if not d.exists():
        d.mkdir()
        rng = np.random.default_rng(9)
        n = 3000
        for i in range(3):
            pq.write_table(
                pa.table({
                    "k": pa.array(rng.integers(0, 200, n), type=pa.int64()),
                    "v": pa.array(rng.normal(size=n)),
                    "tag": pa.array(rng.choice(["a", "b", "c"], n)),
                    "flag": pa.array(rng.integers(0, 2, n).astype(bool)),
                }),
                str(d / f"p{i}.parquet"),
            )
        o = tmp_path / "dim"
        o.mkdir()
        pq.write_table(
            pa.table({"dk": np.arange(200, dtype=np.int64), "w": rng.integers(0, 9, 200)}),
            str(o / "d.parquet"),
        )
    return str(d)


def _dim(src):
    return os.path.join(os.path.dirname(src), "dim")


_PLANS = {
    "point": lambda s, src, F: s.read.parquet(src).filter(s.read.parquet(src)["k"] == 7).select("k", "v"),
    "range_or": lambda s, src, F: (lambda df: df.filter(
        ((df["k"] >= 10) & (df["k"] < 20)) | (df["tag"] == "c")).select("k", "tag"))(s.read.parquet(src)),
    "in_not_null": lambda s, src, F: (lambda df: df.filter(
        df["k"].isin(1, 2, 3) & ~df["v"].is_null() & (df["flag"] == True)  # noqa: E712
    ).select("k", "v", "flag"))(s.read.parquet(src)),
    "float_ne": lambda s, src, F: (lambda df: df.filter(df["v"] != 0.5).select("v"))(s.read.parquet(src)),
    "join": lambda s, src, F: (lambda a, b: a.join(b, on=a["k"] == b["dk"]).select("k", "w"))(
        s.read.parquet(src), s.read.parquet(_dim(src))),
    "agg_sort_limit": lambda s, src, F: s.read.parquet(src).group_by("tag").agg(
        F.sum("k").alias("sk"), F.count().alias("n"), F.max("v").alias("mv")).sort(("tag", False)).limit(2),
}


class TestPlanSpec:
    @pytest.mark.parametrize("name", sorted(_PLANS))
    def test_specs_json_equal_and_rebuilt_alike(self, tmp_path, name):
        src = _source(tmp_path)
        t, j = T.HyperspaceSession(device="cpu"), JSession()
        tp = _PLANS[name](t, src, TF).logical_plan
        jp = _PLANS[name](j, src, JF).logical_plan
        tspec, jspec = tplanspec.to_spec(tp), jplanspec.to_spec(jp)
        assert tspec is not None
        assert json.dumps(tspec, sort_keys=True) == json.dumps(jspec, sort_keys=True)
        # each package rebuilds the other's spec into its own plan
        assert tplanspec.from_spec(t, jspec).pretty() == tp.pretty()
        assert jplanspec.from_spec(j, tspec).pretty() == jp.pretty()
        assert tplanspec.spec_scan_paths(tspec) == jplanspec.spec_scan_paths(jspec)
        got = t.execute(tplanspec.from_spec(t, jspec))
        assert same_rows(got, t.execute(tp))

    def test_outside_the_subset_is_none_and_unknown_raises(self, tmp_path):
        src = _source(tmp_path)
        t = T.HyperspaceSession(device="cpu")
        df = t.read.parquet(src)
        assert tplanspec.to_spec(df.filter(df["k"] == np.int64(3)).logical_plan) is None
        with pytest.raises(T.HyperspaceException):
            tplanspec.from_spec(t, {"op": "window", "spec_v": 1})
        with pytest.raises(T.HyperspaceException):
            tplanspec.from_spec(t, {"op": "scan", "paths": [src], "spec_v": 99})

    def test_a_jax_recorded_log_replays_on_the_port(self, tmp_path):
        """Records written by the JAX package's QueryLog with its specs
        replay through the port's replay harness with the original rows."""
        src = _source(tmp_path)
        t, j = T.HyperspaceSession(device="cpu"), JSession()
        d = str(tmp_path / "obs")
        log = jquerylog.QueryLog(d)
        want = []
        for i, name in enumerate(sorted(_PLANS)):
            jdf = _PLANS[name](j, src, JF)
            rec = _plain("q", i)
            rec.update(ts_ms=1000 + i, replay=jplanspec.to_spec(jdf.logical_plan))
            log.append(rec)
            want.append(_PLANS[name](t, src, TF).collect())
        log.append(_plain("nospec", 0))
        log.close()
        recs = tquerylog.read_valid_records(d)
        res = treplay.replay_records(t, recs, keep_results=True, max_inflight=2)
        assert res.completed == len(_PLANS) and res.skipped == 1 and res.failed == 0
        for got, exp in zip(res.tables, want):
            assert same_rows(got, exp)
        assert treplay.last_replay_stats["completed"] == len(_PLANS)

    def test_port_generated_workload_round_trips(self, tmp_path):
        src = _source(tmp_path)
        t = T.HyperspaceSession(device="cpu")
        recs = treplay.skewed_keys([src], "k", list(range(20)), n=12, project=["k", "v"])
        from hyperspace_tpu.testing import replay as jreplay

        jrecs = jreplay.skewed_keys([src], "k", list(range(20)), n=12, project=["k", "v"])
        assert recs == jrecs
        d = str(tmp_path / "gen")
        assert treplay.record_workload(recs, d, max_bytes=2048) == 12
        back = jquerylog.read_valid_records(d)
        assert [r["fingerprint"] for r in back] == [r["fingerprint"] for r in recs]
        res = treplay.replay_records(t, back, keep_results=True)
        assert res.completed == 12
        df = t.read.parquet(src)
        for rec, got in zip(back, res.tables):
            k = rec["replay"]["child"]["cond"]["right"]["value"]
            assert same_rows(got, df.filter(df["k"] == k).select("k", "v").collect())
        for gen in ("hot_key_storm", "rolling_appends", "tenant_mix"):
            assert callable(getattr(treplay, gen))
        assert treplay.tenant_mix([src], "k", [1, 2], {"a": 2, "b": 3}) == jreplay.tenant_mix(
            [src], "k", [1, 2], {"a": 2, "b": 3})
