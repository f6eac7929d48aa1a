"""The port's concurrent serve frontend against the JAX package's, on the
CPU: the cases of ``tests/test_serve_frontend.py``.

One lake, built by the JAX package, served by both packages' frontends.
Under the same gated schedule (single-flight, distinct plans, shedding) the
two frontends return equal rows in order and equal counters (``admitted``,
``completed``, ``deduped``, ``shed``, ``retries``, ``degraded``,
``failed``). ``plan_fingerprint``'s plan text is equal across the packages
for the filter serve's plans. The contended and the lifecycle storms
(refresh, optimize, vacuum while serving) run in the port: every answer
equals the JAX session's answer to the same query, over the source snapshot
that query saw in the lifecycle storms.
"""

from torch_frontend_twin import (  # noqa: I001  (caps torch's threads first)
    PKG,
    PKGS,
    atomic_append,
    counters,
    lake,
    session,
)

import os
import threading
import unittest.mock as mock

import pytest
from torch_b5_cases import same_rows


@pytest.fixture(autouse=True)
def _clean_faults():
    for p in PKGS:
        PKG[p].faults.reset()
    yield
    for p in PKGS:
        PKG[p].faults.reset()


@pytest.fixture
def indexed(tmp_path):
    """(src, system path, {pkg: session}): both sessions over one lake."""
    src, sp = lake(tmp_path)
    sessions = {
        p: session(p, sp, **{PKG[p].C.INDEX_FILTER_RULE_USE_BUCKET_SPEC: True}) for p in PKGS
    }
    return src, sp, sessions


def _agg(pkg, df):
    F = PKG[pkg].F
    return df.filter((df["k"] >= 50) & (df["k"] < 250)).agg(
        F.count().alias("n"), F.sum("q").alias("sq")
    )


def _gated_execute(pkg, calls, gate, started=None):
    real = PKG[pkg].execution.execute

    def slow_execute(plan, session=None):
        calls.append(plan)
        if started is not None:
            started.set()
        gate.wait(10)
        return real(plan, session)

    return slow_execute


class TestAdmission:
    def test_single_flight_dedup(self, indexed):
        _src, _sp, ss = indexed
        rows, stats = {}, {}
        for p in PKGS:
            s = ss[p]
            calls, gate = [], threading.Event()
            fe = PKG[p].frontend.ServeFrontend(s)
            try:
                with mock.patch.object(PKG[p].execution, "execute", _gated_execute(p, calls, gate)):
                    df = s.read.parquet(_src)
                    q = df.filter(df["k"] == 3).select("q")
                    futs = [fe.submit(q) for _ in range(16)]
                    assert len({id(f) for f in futs}) == 1  # one shared future
                    gate.set()
                    results = [f.result(30) for f in futs]
                assert len(calls) == 1  # one execution for 16 submits
                assert all(r.equals(results[0]) for r in results)
                assert fe.stats()["deduped"] == 15
                assert fe.stats()["admitted"] == 1
                rows[p], stats[p] = results[0], counters(fe)
            finally:
                gate.set()
                fe.close()
        assert same_rows(rows["port"], rows["jax"])
        assert stats["port"] == stats["jax"], stats

    def test_distinct_plans_not_deduped(self, indexed):
        src, _sp, ss = indexed
        rows, stats = {}, {}
        for p in PKGS:
            s = ss[p]
            fe = PKG[p].frontend.ServeFrontend(s)
            try:
                df = s.read.parquet(src)
                a = fe.submit(df.filter(df["k"] == 3).select("q"))
                b = fe.submit(df.filter(df["k"] == 4).select("q"))
                assert a is not b
                rows[p] = (a.result(30), b.result(30))
                stats[p] = counters(fe)
            finally:
                fe.close()
        assert all(same_rows(x, y) for x, y in zip(rows["port"], rows["jax"]))
        assert stats["port"] == stats["jax"] == {
            "admitted": 2, "completed": 2, "deduped": 0, "shed": 0, "retries": 0,
            "degraded": 0, "failed": 0}

    def test_shedding_past_queue_depth(self, indexed):
        src, _sp, ss = indexed
        rows, stats = {}, {}
        for p in PKGS:
            s, P = ss[p], PKG[p]
            s.conf.set(P.C.SERVE_MAX_CONCURRENCY, 1)
            s.conf.set(P.C.SERVE_MAX_QUEUE_DEPTH, 1)
            gate, started, calls = threading.Event(), threading.Event(), []
            fe = P.frontend.ServeFrontend(s)
            try:
                with mock.patch.object(P.execution, "execute",
                                       _gated_execute(p, calls, gate, started)):
                    df = s.read.parquet(src)
                    qs = [df.filter(df["k"] == i).select("q") for i in range(4)]
                    f0 = fe.submit(qs[0])
                    assert started.wait(10)  # worker busy; queue empty
                    f1 = fe.submit(qs[1])  # queued (depth 1 = full)
                    with pytest.raises(P.E.ServeOverloadedError):
                        fe.submit(qs[2])
                    assert fe.stats()["shed"] == 1
                    gate.set()
                    rows[p] = (f0.result(30), f1.result(30))
                stats[p] = counters(fe)
            finally:
                gate.set()
                fe.close()
        assert all(same_rows(x, y) for x, y in zip(rows["port"], rows["jax"]))
        assert stats["port"] == stats["jax"], stats
        assert stats["port"]["shed"] == 1 and stats["port"]["completed"] == 2

    def test_closed_frontend_rejects(self, indexed):
        src, _sp, ss = indexed
        P, s = PKG["port"], ss["port"]
        fe = P.frontend.ServeFrontend(s)
        fe.close()
        df = s.read.parquet(src)
        with pytest.raises(P.E.HyperspaceException):
            fe.submit(df.filter(df["k"] == 1).select("q"))

    def test_plan_fingerprint_sees_file_snapshots(self, indexed, tmp_path):
        src, _sp, ss = indexed
        fps = {}
        scratch = str(tmp_path / "scratch")
        os.makedirs(scratch)
        for p in PKGS:
            fp = PKG[p].frontend.plan_fingerprint
            df = ss[p].read.parquet(src)
            q1 = df.filter(df["k"] == 3).select("q")
            fps[p] = fp(q1.logical_plan)
            assert fps[p] == fp(q1.logical_plan)
        # the same plan and snapshot: the same identity in both packages
        assert fps["port"] == fps["jax"]
        atomic_append(src, scratch, "p2.parquet", 100, 7)
        for p in PKGS:
            fp = PKG[p].frontend.plan_fingerprint
            df2 = ss[p].read.parquet(src)
            assert fps[p] != fp(df2.filter(df2["k"] == 3).select("q").logical_plan)

    def test_fingerprint_plan_text_of_the_filter_serve_plans(self, indexed):
        # the filter serve's point and IN-list plans with a projection: the
        # plan text in plan_fingerprint is the same string in both packages
        src, _sp, ss = indexed
        texts = {}
        for p in PKGS:
            fp = PKG[p].frontend.plan_fingerprint
            df = ss[p].read.parquet(src)
            texts[p] = [
                fp(df.filter(df["k"] == k).select("k", "q").logical_plan)[0] for k in (0, 7, 399)
            ] + [fp(df.filter(df["k"].isin([1, 5, 9])).select("k", "q").logical_plan)[0]]
        assert texts["port"] == texts["jax"]


class TestConcurrentServes:
    def test_contended_serves_bit_identical(self, indexed):
        """8 client threads, mixed point and aggregate queries, serve cache
        on: every result of the port's frontend equals the JAX session's
        serial answer to the same query."""
        src, sp, ss = indexed
        P, s, ref = PKG["port"], ss["port"], ss["jax"]
        s.conf.set(P.C.SERVE_CACHE_ENABLED, True)
        fe = P.frontend.ServeFrontend(s)
        try:
            df = s.read.parquet(src)
            rdf = ref.read.parquet(src)
            keys = list(range(0, 64, 7))
            point = {k: ref.execute(rdf.filter(rdf["k"] == k).select("q").logical_plan)
                     for k in keys}
            agg_base = ref.execute(_agg("jax", rdf).logical_plan)
            errors = []

            def client(i):
                try:
                    for j in range(6):
                        k = keys[(i + j) % len(keys)]
                        out = fe.serve(df.filter(df["k"] == k).select("q"))
                        assert same_rows(out, point[k])
                        out = fe.serve(_agg("port", df))
                        assert same_rows(out, agg_base)
                except Exception as exc:  # propagate to the main thread
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not errors, errors
            st = fe.stats()
            assert st["failed"] == 0
            assert st["completed"] >= 1
        finally:
            fe.close()
            s.conf.set(P.C.SERVE_CACHE_ENABLED, False)
            s.clear_serve_cache()


class TestLifecycleWhileServing:
    """Refresh and optimize racing continuous serves of the port's
    frontend: every result matches the JAX session's serial unindexed
    result over the source snapshot that query saw (one pinned index
    version, never a mix), and the index ends ACTIVE."""

    def _storm(self, s, ref, hs, src_dir, actions, readers=3, iters=6):
        P = PKG["port"]
        s.conf.set(P.C.INDEX_HYBRID_SCAN_ENABLED, True)
        fe = P.frontend.ServeFrontend(s)
        results, errors = [], []

        def reader(i):
            try:
                for _j in range(iters):
                    df = s.read.parquet(src_dir)
                    files = tuple(df.logical_plan.relation.files)
                    results.append((files, fe.serve(_agg("port", df))))
            except Exception as exc:
                errors.append(exc)

        def writer():
            try:
                for step, action in enumerate(actions):
                    action(step)
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=reader, args=(i,)) for i in range(readers)]
        threads.append(threading.Thread(target=writer))
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(180)
            assert not errors, errors
            st = fe.stats()
            assert st["failed"] == 0
            ref.disable_hyperspace()
            try:
                expected = {}
                for files, out in results:
                    if files not in expected:
                        expected[files] = ref.execute(
                            _agg("jax", ref.read.parquet(*files)).logical_plan)
                    assert same_rows(out, expected[files]), (out.to_pydict(),
                                                             expected[files].to_pydict())
            finally:
                ref.enable_hyperspace()
            entry = s.index_manager.get_index_log_entry("i1")
            assert entry is not None and entry.state == P.C.States.ACTIVE
            return st
        finally:
            fe.close()
            s.conf.set(P.C.INDEX_HYBRID_SCAN_ENABLED, False)

    def _env(self, indexed, tmp_path):
        src, _sp, ss = indexed
        scratch = str(tmp_path / "scratch")
        os.makedirs(scratch, exist_ok=True)
        return src, scratch, ss["port"], ss["jax"], PKG["port"].Hyperspace(ss["port"])

    def test_refresh_while_serving(self, indexed, tmp_path):
        src, scratch, s, ref, hs = self._env(indexed, tmp_path)

        def step(i):
            atomic_append(src, scratch, f"a{i}.parquet", 400, 100 + i)
            s.index_manager.clear_cache()
            hs.refresh_index("i1", "incremental")

        self._storm(s, ref, hs, src, [step, step])

    def test_optimize_while_serving(self, indexed, tmp_path):
        src, scratch, s, ref, hs = self._env(indexed, tmp_path)

        def append_refresh(i):
            atomic_append(src, scratch, f"b{i}.parquet", 400, 200 + i)
            s.index_manager.clear_cache()
            hs.refresh_index("i1", "incremental")

        self._storm(s, ref, hs, src, [append_refresh, lambda _i: hs.optimize_index("i1", "quick")])

    def test_vacuum_while_serving_heals_by_repin(self, indexed, tmp_path):
        """vacuum(ACTIVE) deletes superseded version dirs while pinned
        queries may still hold them; the transient-I/O retry re-pins onto
        the surviving version."""
        src, scratch, s, ref, hs = self._env(indexed, tmp_path)

        def refresh_then_vacuum(i):
            atomic_append(src, scratch, f"c{i}.parquet", 400, 300 + i)
            s.index_manager.clear_cache()
            hs.refresh_index("i1", "incremental")
            hs.vacuum_index("i1")

        self._storm(s, ref, hs, src, [refresh_then_vacuum])

