"""The port's workload advisor against the JAX package's, on the CPU.

Twins of ``tests/test_advisor.py``, case for case (plan specs, the
profile, what-if scoring, the budgeted apply, replay, the closed loop and
the CLI), each run on the port. Each class also holds the state the two
packages share:

* given a query log that one package recorded (a workload made from one
  numpy seed), the port's ``advise`` and the JAX package's give the same
  ``AdvisorReport.to_dict()``, in both directions. ``advise`` measures
  nothing itself: every second in a report comes from the log, every byte
  from the lake and the indexes, every score from the rule chain, so
  ``MEASURED_FIELDS`` is empty and the reports are compared whole;
* an index that one package's ``apply`` builds is served by the other with
  equal rows, in both directions.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_b5_cases import same_rows

import hyperspace_tpu_torch as T
from hyperspace_tpu import advisor as jadvisor
from hyperspace_tpu import constants as JC
from hyperspace_tpu.advisor import cli as jcli
from hyperspace_tpu.advisor import recommend as jrec
from hyperspace_tpu.dataframe import DataFrame as JDataFrame
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.obs import planspec as jplanspec
from hyperspace_tpu.obs import trace as jtrace
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu.testing import replay as jreplay
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.advisor import (
    advise,
    apply_recommendations,
    build_profile,
    hypothetical_entry,
    profile_directory,
    score_workload,
)
from hyperspace_tpu_torch.advisor import cli as tcli
from hyperspace_tpu_torch.advisor import recommend as rec_mod
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.dataframe import DataFrame
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.hyperspace import Hyperspace
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig
from hyperspace_tpu_torch.kernels import KernelLaunchError
from hyperspace_tpu_torch.obs import planspec, trace
from hyperspace_tpu_torch.testing import replay

#: fields of AdvisorReport.to_dict() that advise() measures while it runs:
#: none (the profile's seconds are the log's, the byte estimates the lake's
#: and the indexes', the gains the rule chain's)
MEASURED_FIELDS = ()

REPLAY = {"port": replay, "jax": jreplay}


@pytest.fixture(autouse=True)
def _obs_isolation():
    for t in (trace, jtrace):
        t.reset()
    yield
    for t in (trace, jtrace):
        t.set_enabled(False)
        t.reset()


def _lake(tmp_path, rows=40_000, files=4, name="lake"):
    d = tmp_path / name
    d.mkdir()
    rng = np.random.default_rng(5)
    per = rows // files
    for i in range(files):
        pq.write_table(
            pa.table(
                {
                    "key": rng.integers(0, 1000, per),
                    "ts": np.arange(i * per, (i + 1) * per, dtype=np.int64),
                    "payload": rng.integers(0, 1 << 30, per),
                }
            ),
            str(d / f"part-{i:03d}.parquet"),
        )
    return str(d)


def _port(root) -> T.HyperspaceSession:
    s = T.HyperspaceSession(device="cpu")
    s.conf.set(TC.INDEX_SYSTEM_PATH, str(root))
    s.conf.set(TC.INDEX_NUM_BUCKETS, 8)
    return s


def _jax(root) -> JSession:
    s = JSession()
    s.conf.set(JC.INDEX_SYSTEM_PATH, str(root))
    s.conf.set(JC.INDEX_NUM_BUCKETS, 8)
    return s


def _pair(tmp_path):
    """A port session and a JAX session over one system path."""
    root = tmp_path / "indexes"
    return _port(root), _jax(root)


def _seed_keys(seed: int, n: int = 6) -> list:
    """The workload's lookup keys, drawn from one numpy seed."""
    rng = np.random.default_rng(seed)
    return sorted({int(k) for k in rng.integers(0, 1000, n)})


def _record(recorder: str, data: str, obs_dir: str, seed: int = 11, n: int = 12) -> list:
    """A skewed point-lookup workload over ``data`` recorded into
    ``obs_dir`` by the ``recorder`` package's querylog writer."""
    rp = REPLAY[recorder]
    recs = rp.skewed_keys([data], "key", _seed_keys(seed), n, project=["key", "payload"])
    assert rp.record_workload(recs, obs_dir) == len(recs)
    return recs


def _strip(report: dict) -> dict:
    for f in MEASURED_FIELDS:
        report.pop(f, None)
    return report


def _same_reports(t, j, obs_dir) -> dict:
    tr = _strip(advise(t, directory=obs_dir).to_dict())
    jr = _strip(jadvisor.advise(j, directory=obs_dir).to_dict())
    assert tr == jr
    return tr


def _index_served(session, plan) -> bool:
    return any(leaf.relation.index_info for leaf in session.optimize(plan).collect_leaves())


def _answers(t, j, recs):
    """Each record's plan run by both packages (Hyperspace on in both):
    (port tables, JAX tables), each rebuilt from the record's spec."""
    tt = [DataFrame(t, planspec.from_spec(t, r["replay"])).to_arrow() for r in recs]
    jj = [JDataFrame(j, jplanspec.from_spec(j, r["replay"])).to_arrow() for r in recs]
    return tt, jj


class TestPlanSpec:
    def test_round_trip_serves_same_answer(self, tmp_path):
        s = _port(tmp_path / "idx")
        data = _lake(tmp_path)
        df = s.read.parquet(data)
        q = df.filter(df["key"] == 7).select("key", "payload")
        spec = planspec.to_spec(q.logical_plan)
        assert spec is not None and spec["spec_v"] == planspec.SPEC_V
        rebuilt = planspec.from_spec(s, spec)
        a = DataFrame(s, q.logical_plan).to_arrow()
        b = DataFrame(s, rebuilt).to_arrow()
        assert a.num_rows == b.num_rows
        assert a.column("payload").to_pylist() == b.column("payload").to_pylist()

    def test_unsupported_plan_records_no_spec(self, tmp_path):
        s = _port(tmp_path / "idx")
        data = _lake(tmp_path)
        df = s.read.parquet(data)
        other = s.read.parquet(data)
        union = df.union(other) if hasattr(df, "union") else None
        if union is not None:
            assert planspec.to_spec(union.logical_plan) is None

    def test_unknown_spec_version_raises(self, tmp_path):
        s = _port(tmp_path / "idx")
        with pytest.raises(HyperspaceException):
            planspec.from_spec(s, {"op": "scan", "fmt": "parquet", "paths": ["/x"], "spec_v": 99})

    @pytest.mark.parametrize("recorder", ["jax", "port"])
    def test_reports_equal_on_a_recorded_log(self, tmp_path, recorder):
        t, j = _pair(tmp_path)
        data = _lake(tmp_path)
        obs_dir = str(tmp_path / "obs")
        _record(recorder, data, obs_dir)
        report = _same_reports(t, j, obs_dir)
        assert report["shapes_with_plans"] == 1
        assert [r["kind"] for r in report["recommendations"]] == ["create"]


class TestProfile:
    def test_shape_cap_folds_into_overflow(self):
        recs = [
            {"predicate": f"shape{i}", "duration_s": 0.01, "status": "ok", "ts_ms": i}
            for i in range(10)
        ]
        prof = build_profile(recs, max_shapes=4)
        assert len(prof.shapes) == 4
        assert prof.overflow_records == 6
        assert prof.records == 10
        assert prof.to_dict() == jadvisor.build_profile(recs, max_shapes=4).to_dict()

    def test_hot_shapes_rank_by_cost_then_count(self):
        recs = (
            [{"predicate": "cheap", "duration_s": 0.001, "status": "ok"}] * 5
            + [{"predicate": "hot", "duration_s": 1.0, "status": "ok"}] * 2
        )
        prof = build_profile(recs)
        assert prof.hot_shapes(1)[0].shape == "hot"
        assert prof.to_dict() == jadvisor.build_profile(recs).to_dict()

    def test_degrade_retry_and_stage_aggregation(self):
        rec = {
            "predicate": "p", "duration_s": 0.5, "status": "failed",
            "stages": {"scan": 0.1, "prune": 0.02},
            "events": [{"name": "degrade"}, {"name": "retry"}],
            "indexes": ["idx1"], "slo_class": "batch", "rows_pruned": 7,
        }
        prof = build_profile([rec, dict(rec)])
        s = prof.shapes["p"]
        assert s.degrades == 2 and s.retries == 2 and s.failed == 2
        assert s.stages["scan"] == pytest.approx(0.2)
        assert s.indexes == {"idx1": 2}
        assert s.rows_pruned == 14
        assert prof.to_dict() == jadvisor.build_profile([rec, dict(rec)]).to_dict()

    def test_accumulate_is_root_scoped(self):
        """rows_pruned attributes to the executing query's root, so two
        queries pruning different amounts never blur."""
        trace.set_enabled(True)
        r1 = trace.root("serve.query")
        with trace.activate(r1):
            trace.accumulate("rows_pruned", 5)
            trace.accumulate("rows_pruned", 2)
        r1.finish()
        r2 = trace.root("serve.query")
        with trace.activate(r2):
            trace.accumulate("rows_pruned", 3)
        r2.finish()
        assert r1.attrs["rows_pruned"] == 7
        assert r2.attrs["rows_pruned"] == 3

    @pytest.mark.parametrize("recorder", ["jax", "port"])
    def test_profile_directory_equal_across_packages(self, tmp_path, recorder):
        data = _lake(tmp_path, rows=4_000, files=2)
        obs_dir = str(tmp_path / "obs")
        _record(recorder, data, obs_dir, seed=3, n=20)
        mine = profile_directory(obs_dir)
        assert mine.records == 20
        assert mine.to_dict() == jadvisor.profile_directory(obs_dir).to_dict()

    def test_served_log_profiles_equal(self, tmp_path):
        """A log the JAX package's serve frontend recorded (real seconds,
        stages and indexes) profiles and advises the same in both."""
        t, j = _pair(tmp_path)
        data = _lake(tmp_path, rows=8_000, files=2)
        j.conf.set(JC.OBS_ENABLED, True)
        j.conf.set(JC.OBS_QUERYLOG_ENABLED, True)
        j.conf.set(JC.OBS_QUERYLOG_RECORD_PLANS, True)
        jtrace.configure(j.conf)
        recs = jreplay.skewed_keys([data], "key", _seed_keys(17), 8, project=["key", "payload"])
        assert jreplay.replay_records(j, recs).completed == 8
        j.serve_frontend.close()
        obs_dir = jadvisor.recommend.obs_querylog.obs_root(j.conf)
        prof = profile_directory(obs_dir)
        assert prof.records == 8 and prof.total_s > 0
        assert prof.to_dict() == jadvisor.profile_directory(obs_dir).to_dict()
        _same_reports(t, j, obs_dir)


class TestWhatIf:
    def test_candidate_gain_positive_then_zero_once_real(self, tmp_path):
        s = _port(tmp_path / "idx")
        data = _lake(tmp_path)
        df = s.read.parquet(data)
        plan = df.filter(df["key"] == 3).select("key", "payload").logical_plan
        cands = rec_mod.enumerate_candidates(plan)
        assert [c.config.indexed_columns for c in cands] == [["key"]]
        hypo = hypothetical_entry(s, df, cands[0].config)
        out = score_workload(s, [(plan, 1.0)], [], hypo)
        assert out["gain"] > 0 and out["plans_improved"] == 1
        Hyperspace(s).create_index(
            df,
            CoveringIndexConfig(
                cands[0].config.index_name,
                list(cands[0].config.indexed_columns),
                list(cands[0].config.included_columns),
            ),
        )
        active = s.index_manager.get_indexes([States.ACTIVE])
        out2 = score_workload(s, [(plan, 1.0)], active, hypo)
        assert out2["gain"] == 0

    def test_join_and_agg_candidates(self, tmp_path):
        s = _port(tmp_path / "idx")
        j = _jax(tmp_path / "idx")
        data = _lake(tmp_path)
        other = tmp_path / "orders"
        other.mkdir()
        rng = np.random.default_rng(9)
        pq.write_table(
            pa.table({"okey": rng.integers(0, 1000, 4_000), "cost": rng.integers(0, 100, 4_000)}),
            str(other / "part-000.parquet"),
        )

        def join_plan(sess):
            left = sess.read.parquet(data).select("key", "payload")
            right = sess.read.parquet(str(other))
            return left.join(right, left["key"] == right["okey"]).logical_plan

        cands = rec_mod.enumerate_candidates(join_plan(s))
        assert {tuple(c.config.indexed_columns) for c in cands} == {("key",), ("okey",)}
        jcands = jrec.enumerate_candidates(join_plan(j))
        assert [(c.config.index_name, c.config.indexed_columns, c.config.included_columns)
                for c in cands] == [
            (c.config.index_name, c.config.indexed_columns, c.config.included_columns)
            for c in jcands
        ]
        from hyperspace_tpu.plan.nodes import AggSpec as JAggSpec
        from hyperspace_tpu_torch.plan.nodes import AggSpec

        ap = s.read.parquet(data).group_by("key").agg(AggSpec("sum", "payload", "total"))
        acands = rec_mod.enumerate_candidates(ap.logical_plan)
        assert [c.config.indexed_columns for c in acands] == [["key"]]
        jap = j.read.parquet(data).group_by("key").agg(JAggSpec("sum", "payload", "total"))
        assert [c.config.index_name for c in acands] == [
            c.config.index_name for c in jrec.enumerate_candidates(jap.logical_plan)
        ]

    @pytest.mark.parametrize("creator", ["jax", "port"])
    def test_real_twin_from_either_package_zeroes_the_gain(self, tmp_path, creator):
        """An index the other package built is ACTIVE in this one's lake:
        the hypothetical twin adds nothing in either package."""
        t, j = _pair(tmp_path)
        data = _lake(tmp_path, rows=8_000, files=2)
        df = t.read.parquet(data)
        plan = df.filter(df["key"] == 3).select("key", "payload").logical_plan
        cand = rec_mod.enumerate_candidates(plan)[0]
        cfg = (cand.config.index_name, list(cand.config.indexed_columns),
               list(cand.config.included_columns))
        if creator == "port":
            Hyperspace(t).create_index(df, CoveringIndexConfig(*cfg))
        else:
            from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JCfg

            JHyperspace(j).create_index(j.read.parquet(data), JCfg(*cfg))
        hypo = hypothetical_entry(t, df, cand.config)
        active = t.index_manager.get_indexes([States.ACTIVE])
        assert [e.name for e in active] == [cfg[0]]
        assert score_workload(t, [(plan, 1.0)], active, hypo)["gain"] == 0
        jdf = j.read.parquet(data)
        jplan = jdf.filter(jdf["key"] == 3).select("key", "payload").logical_plan
        jcand = jrec.enumerate_candidates(jplan)[0]
        jhypo = jadvisor.hypothetical_entry(j, jdf, jcand.config)
        jactive = j.index_manager.get_indexes([States.ACTIVE])
        assert jadvisor.score_workload(j, [(jplan, 1.0)], jactive, jhypo)["gain"] == 0


def _rec_for(cand, name, est):
    return rec_mod.Recommendation(
        kind="create", index_name=name, index_kind="CoveringIndex",
        indexed_columns=list(cand.config.indexed_columns),
        included_columns=list(cand.config.included_columns),
        source_paths=list(cand.source_paths),
        estimated_benefit_s=1.0, estimated_build_bytes=est,
        score_gain=1.0, shapes=[], reason="test",
    )


class TestApply:
    def test_apply_requires_opt_in(self, tmp_path):
        s = _port(tmp_path / "idx")
        with pytest.raises(HyperspaceException):
            apply_recommendations(s, [])
        s.conf.set(TC.ADVISOR_APPLY_ENABLED, True)
        assert apply_recommendations(s, [])["applied"] == 0

    def test_byte_budget_skips_but_later_cheaper_fit(self, tmp_path):
        s = _port(tmp_path / "idx")
        data = _lake(tmp_path, rows=4_000, files=2)
        df = s.read.parquet(data)
        plan = df.filter(df["key"] == 1).select("key", "payload").logical_plan
        cand = rec_mod.enumerate_candidates(plan)[0]
        out = apply_recommendations(
            s, [_rec_for(cand, "adv_big", 10_000), _rec_for(cand, "adv_small", 10)],
            max_bytes=100, force=True,
        )
        by = {o["index"]: o["outcome"] for o in out["outcomes"]}
        assert by == {"adv_big": "skipped", "adv_small": "applied"}
        names = {e.name for e in s.index_manager.get_indexes([States.ACTIVE])}
        assert "adv_small" in names and "adv_big" not in names

    def test_failures_do_not_abort_the_pass(self, tmp_path):
        s = _port(tmp_path / "idx")
        bad = rec_mod.Recommendation(
            kind="refresh", index_name="nope", index_kind="CoveringIndex",
            indexed_columns=["key"], included_columns=[], source_paths=[],
            estimated_benefit_s=1.0, estimated_build_bytes=0,
            score_gain=0.0, shapes=[], reason="test",
        )
        out = apply_recommendations(s, [bad, bad], force=True)
        assert out["failed"] == 2 and out["applied"] == 0

    def test_a_kernel_fault_fails_the_pass(self, tmp_path, monkeypatch):
        """C.7: a kernel's fault during a create is never recorded as one
        failed recommendation among others."""
        s = _port(tmp_path / "idx")
        data = _lake(tmp_path, rows=4_000, files=2)
        df = s.read.parquet(data)
        cand = rec_mod.enumerate_candidates(
            df.filter(df["key"] == 1).select("key", "payload").logical_plan)[0]

        def fault(self, *a, **k):
            raise KernelLaunchError("injected B1 launch error")

        monkeypatch.setattr(Hyperspace, "create_index", fault)
        with pytest.raises(KernelLaunchError):
            apply_recommendations(s, [_rec_for(cand, "adv_a", 10), _rec_for(cand, "adv_b", 10)],
                                  force=True)

    @pytest.mark.parametrize("applier", ["jax", "port"])
    def test_applied_index_is_served_by_the_other_package(self, tmp_path, applier):
        t, j = _pair(tmp_path)
        data = _lake(tmp_path, rows=8_000, files=2)
        obs_dir = str(tmp_path / "obs")
        recs = _record("port", data, obs_dir, seed=23, n=10)
        report = _same_reports(t, j, obs_dir)
        assert report["recommendations"]
        if applier == "port":
            summary = apply_recommendations(t, advise(t, directory=obs_dir).recommendations,
                                            force=True)
        else:
            summary = jadvisor.apply_recommendations(
                j, jadvisor.advise(j, directory=obs_dir).recommendations, force=True)
        assert summary["applied"] == 1 and summary["failed"] == 0
        # fresh sessions of both packages over the system path (a session
        # caches its index list)
        t, j = _pair(tmp_path)
        plain, _ = _answers(t, j, recs)
        t.enable_hyperspace()
        j.enable_hyperspace()
        tt, jj = _answers(t, j, recs)
        for r, p, a, b in zip(recs, plain, tt, jj):
            assert same_rows(a, p) and same_rows(b, p)
            assert _index_served(t, planspec.from_spec(t, r["replay"]))
            assert any(leaf.relation.index_info for leaf in
                       j.optimize(jplanspec.from_spec(j, r["replay"])).collect_leaves())
        # both packages see the applied index: neither recommends it again
        report2 = _same_reports(t, j, obs_dir)
        assert [r for r in report2["recommendations"] if r["kind"] == "create"] == []


class TestReplay:
    def test_records_without_spec_are_counted_skipped(self, tmp_path):
        s = _port(tmp_path / "idx")
        s.enable_hyperspace()
        data = _lake(tmp_path, rows=4_000, files=2)
        recs = replay.skewed_keys([data], "key", [1, 2, 3], 4)
        bare = {k: v for k, v in recs[0].items() if k != "replay"}
        result = replay.replay_records(s, recs + [bare])
        assert result.submitted == 4
        assert result.completed == 4
        assert result.skipped == 1
        assert replay.last_replay_stats["completed"] == 4

    def test_slo_classes_flow_to_admission(self, tmp_path):
        s = _port(tmp_path / "idx")
        s.enable_hyperspace()
        data = _lake(tmp_path, rows=4_000, files=2)
        recs = replay.tenant_mix([data], "key", [1, 2], {"interactive": 3, "batch": 2})
        result = replay.replay_records(s, recs)
        assert result.completed == 5
        classes = s.serve_frontend.stats().get("classes") or {}
        if classes:
            assert set(classes) >= {"interactive", "batch"}

    def test_preserve_timing_respects_gaps(self, tmp_path):
        import time as _time

        s = _port(tmp_path / "idx")
        s.enable_hyperspace()
        data = _lake(tmp_path, rows=4_000, files=2)
        recs = replay.skewed_keys([data], "key", [1], 3, start_ts_ms=0, interarrival_ms=120)
        t0 = _time.perf_counter()
        replay.replay_records(s, recs, preserve_timing=True)
        assert _time.perf_counter() - t0 >= 0.24  # two recorded gaps

    def test_record_workload_round_trips_reader(self, tmp_path):
        from hyperspace_tpu.obs import querylog as jquerylog
        from hyperspace_tpu_torch.obs import querylog

        recs = replay.rolling_appends(["/x"], "ts", [1, 2], 2)
        d = str(tmp_path / "obs")
        assert replay.record_workload(recs, d) == len(recs)
        got = querylog.read_valid_records(d)
        assert len(got) == len(recs)
        for r in got:
            assert querylog.validate_record(r) is None
        assert jquerylog.read_valid_records(d) == got

    @pytest.mark.parametrize("recorder", ["jax", "port"])
    def test_replayed_answers_equal_across_packages(self, tmp_path, recorder):
        t, j = _pair(tmp_path)
        data = _lake(tmp_path, rows=4_000, files=2)
        recs = _record(recorder, data, str(tmp_path / "obs"), seed=29, n=8)
        t.enable_hyperspace()
        res = replay.replay_records(t, recs, keep_results=True)
        assert res.completed == len(recs)
        _, jj = _answers(t, j, recs)
        assert all(same_rows(a, b) for a, b in zip(res.tables, jj))
        _same_reports(t, j, str(tmp_path / "obs"))


class TestConvergence:
    def test_closed_loop_improves_p50_then_recommends_nothing(self, tmp_path):
        t, j = _pair(tmp_path)
        data = _lake(tmp_path, rows=2_000_000, files=8)
        keys = list(range(0, 1000, 37))
        records = replay.skewed_keys([data], "key", keys, 16, project=["key", "payload"])
        obs_dir = str(tmp_path / "obs")
        replay.record_workload(records, obs_dir)
        t.enable_hyperspace()

        baseline = replay.replay_records(t, records, keep_results=True)
        assert baseline.completed == len(records)

        report = _same_reports(t, j, obs_dir)
        creates = [r for r in advise(t, directory=obs_dir).recommendations if r.kind == "create"]
        assert creates, "the skewed workload must motivate an index"
        top = creates[0]
        assert top.indexed_columns[0] == "key"
        assert top.index_kind == "CoveringIndex"
        assert top.estimated_benefit_s > 0
        assert report["recommendations"][0]["index_name"] == top.index_name

        summary = apply_recommendations(t, creates, force=True)
        assert summary["applied"] >= 1

        after = replay.replay_records(t, records, keep_results=True)
        assert after.completed == len(records)
        assert all(same_rows(a, b) for a, b in zip(after.tables, baseline.tables))
        for r in records:
            assert _index_served(t, planspec.from_spec(t, r["replay"]))
        assert after.p50_s < baseline.p50_s, (baseline.to_dict(), after.to_dict())

        # a fresh JAX session (a session caches its index list) sees the
        # port's index and converges too
        report2 = _same_reports(t, _jax(tmp_path / "indexes"), obs_dir)
        assert [r for r in report2["recommendations"] if r["kind"] == "create"] == [], (
            "second pass must converge to zero create recommendations")


class TestCli:
    def test_report_and_recommend(self, tmp_path, capsys):
        data = _lake(tmp_path, rows=4_000, files=2)
        recs = replay.skewed_keys([data], "key", [1, 2, 3], 6, project=["key", "payload"])
        obs_dir = str(tmp_path / "obs")
        replay.record_workload(recs, obs_dir)
        assert tcli.main(["report", "--log-dir", obs_dir]) == 0
        out = capsys.readouterr().out
        assert "records=6" in out and "replay=y" in out
        assert jcli.main(["report", "--log-dir", obs_dir]) == 0
        assert capsys.readouterr().out == out
        assert tcli.main(["recommend", "--log-dir", obs_dir, "--device", "cpu",
                          "--system-path", str(tmp_path / "idx")]) == 0
        out = capsys.readouterr().out
        assert "recommendations" in out
        assert jcli.main(["recommend", "--log-dir", obs_dir,
                          "--system-path", str(tmp_path / "jidx")]) == 0
        assert capsys.readouterr().out == out

    def test_session_commands_default_to_the_card(self, tmp_path, monkeypatch):
        """Without --device the session runs on CUDA, and raises where
        there is none."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(HyperspaceException, match="CUDA"):
            tcli.main(["recommend", "--log-dir", str(tmp_path),
                       "--system-path", str(tmp_path / "idx")])

    def test_recommend_apply_builds_what_the_jax_package_serves(self, tmp_path, capsys):
        data = _lake(tmp_path, rows=4_000, files=2)
        obs_dir = str(tmp_path / "obs")
        recs = _record("jax", data, obs_dir, seed=31, n=6)
        root = tmp_path / "indexes"
        assert tcli.main(["recommend", "--log-dir", obs_dir, "--device", "cpu",
                          "--system-path", str(root), "--apply"]) == 0
        assert "applied=1" in capsys.readouterr().out
        t, j = _port(root), _jax(root)
        t.enable_hyperspace()
        j.enable_hyperspace()
        tt, jj = _answers(t, j, recs)
        assert all(same_rows(a, b) for a, b in zip(tt, jj))
        assert all(_index_served(t, planspec.from_spec(t, r["replay"])) for r in recs)

    def test_replay_subcommand(self, tmp_path, capsys):
        import json

        data = _lake(tmp_path, rows=4_000, files=2)
        obs_dir = str(tmp_path / "obs")
        _record("port", data, obs_dir, seed=37, n=5)
        assert tcli.main(["replay", "--log-dir", obs_dir, "--device", "cpu",
                          "--system-path", str(tmp_path / "idx")]) == 0
        assert json.loads(capsys.readouterr().out)["completed"] == 5


def test_the_advisor_imports_no_jax():
    import ast

    import hyperspace_tpu_torch.advisor as pkg

    d = os.path.dirname(pkg.__file__)
    for name in os.listdir(d):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(d, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "hyperspace_tpu"), (name, m)
