"""The serve fault matrix of the port's frontend against the JAX package's,
on the CPU: the serve cases of ``tests/test_faults.py``.

For each injection point (parquet read, log read, cache insert, fastbus
send) x {transient, persistent}, a serve through the port's frontend
retries to the JAX package's rows, degrades to a path with those rows, or
fails typed. ``fastbus_send`` is driven through ``serve.router`` and a
routed request between two fleet frontends.

The reference's ``kernel_dispatch`` point degrades a kernel to its numpy
twin. The port has no such point (ROADMAP C.11), and its rule is the
opposite (C.7, C.21): a ``KernelLaunchError`` raised inside a serve fails
the query with ``failed`` +1, is not retried and is not degraded, through a
``ServeFrontend`` and through a ``FleetFrontend`` alike, and a fleet
follower re-raises its leader's fault instead of rerunning the query.
"""

from torch_frontend_twin import PKG, PKGS, sorted_table  # noqa: I001  (caps threads first)

import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_b5_cases import same_rows

import torch_frontend_twin as twin
from hyperspace_tpu_torch.kernels import KernelLaunchError


@pytest.fixture(autouse=True)
def _clean_faults():
    for p in PKGS:
        PKG[p].faults.reset()
    yield
    for p in PKGS:
        PKG[p].faults.reset()


@pytest.fixture(scope="module")
def lake_dir(tmp_path_factory):
    """One small table (3 files) and index i1 on k with v and q, built by
    the JAX package."""
    root = tmp_path_factory.mktemp("faults_lake")
    d = root / "events"
    d.mkdir()
    rng = np.random.default_rng(3)
    n = 24_000
    t = pa.table({
        "k": pa.array(rng.integers(0, 600, n), pa.int64()),
        "v": pa.array(rng.normal(0.0, 1.0, n)),
        "q": pa.array(rng.integers(1, 50, n), pa.int64()),
    })
    for i in range(3):
        pq.write_table(t.slice(i * n // 3, n // 3), str(d / f"p{i}.parquet"))
    sp = str(root / "indexes")
    b = twin.session("jax", sp)
    b.conf.set(PKG["jax"].C.INDEX_FILTER_RULE_USE_BUCKET_SPEC, True)
    PKG["jax"].Hyperspace(b).create_index(b.read.parquet(str(d)),
                                          PKG["jax"].Covering("i1", ["k"], ["v", "q"]))
    return str(d), sp


def _served(pkg, lake_dir):
    src, sp = lake_dir
    P = PKG[pkg]
    s = twin.session(pkg, sp, **{P.C.INDEX_FILTER_RULE_USE_BUCKET_SPEC: True})
    df = s.read.parquet(src)

    def q_point(key=7):
        return df.filter(df["k"] == key).select("v", "q")

    def q_agg():
        return df.filter((df["k"] >= 100) & (df["k"] < 300)).agg(
            P.F.count().alias("n"), P.F.sum("q").alias("sq"))

    base = {"point": s.execute(q_point().logical_plan), "agg": s.execute(q_agg().logical_plan)}
    return s, q_point, q_agg, base


@pytest.fixture
def served(lake_dir):
    """The port's session and frontend over the lake, its queries, and the
    JAX package's answers to them (the baselines)."""
    s, q_point, q_agg, _own = _served("port", lake_dir)
    base = _served("jax", lake_dir)[3]
    fe = s.serve_frontend
    yield "port", s, fe, q_point, q_agg, base
    fe.close()


def _same(got, want):
    assert got.schema.equals(want.schema)
    assert same_rows(got, want), (got.to_pydict(), want.to_pydict())


def test_baselines_equal_across_packages(lake_dir):
    bases = {p: _served(p, lake_dir)[3] for p in PKGS}
    for k in ("point", "agg"):
        _same(bases["port"][k], bases["jax"][k])


class TestFaultMatrix:
    @pytest.mark.parametrize("spec", ["transient:1", "transient:3"])
    def test_parquet_read_transient_retries(self, served, spec):
        pkg, s, fe, q_point, _q_agg, base = served
        PKG[pkg].faults.set_fault("parquet_read", spec)
        _same(fe.serve(q_point()), base["point"])
        assert PKG[pkg].faults.stats()["parquet_read"] >= 1
        assert fe.stats()["retries"] >= 1 and fe.stats()["failed"] == 0

    def test_parquet_read_persistent_degrades_to_source(self, served):
        pkg, s, fe, q_point, _q_agg, base = served
        # only index data reads fail (version dirs are v__=N); the degrade
        # path, the unrewritten plan over the source files, works
        PKG[pkg].faults.set_fault("parquet_read", "persistent;match=v__=")
        _same(fe.serve(q_point()), base["point"])
        assert PKG[pkg].faults.stats()["parquet_read"] >= 1
        assert fe.stats()["degraded"] >= 1

    def test_parquet_read_persistent_everywhere_fails_typed(self, served):
        pkg, s, fe, q_point, _q_agg, _base = served
        PKG[pkg].faults.set_fault("parquet_read", "persistent")
        with pytest.raises(PKG[pkg].faults.InjectedFault):
            fe.serve(q_point())
        assert fe.stats()["failed"] >= 1

    def test_log_read_transient_retries_pin(self, served):
        pkg, s, fe, q_point, _q_agg, base = served
        s.index_manager.clear_cache()  # a real log read at pin time
        PKG[pkg].faults.set_fault("log_read", "transient:1")
        _same(fe.serve(q_point()), base["point"])
        assert PKG[pkg].faults.stats()["log_read"] >= 1
        assert fe.stats()["failed"] == 0

    def test_log_read_persistent_serves_without_indexes(self, served):
        pkg, s, fe, q_point, _q_agg, base = served
        s.index_manager.clear_cache()
        PKG[pkg].faults.set_fault("log_read", "persistent")
        _same(fe.serve(q_point()), base["point"])
        assert PKG[pkg].faults.stats()["log_read"] >= 1
        assert fe.stats()["degraded_pins"] >= 1 and fe.stats()["failed"] == 0

    @pytest.mark.parametrize("spec", ["transient:1", "persistent"])
    def test_cache_insert_drops_never_fails(self, served, spec):
        pkg, s, fe, q_point, _q_agg, base = served
        P = PKG[pkg]
        s.conf.set(P.C.SERVE_CACHE_ENABLED, True)
        try:
            P.faults.set_fault("cache_insert", spec)
            _same(fe.serve(q_point()), base["point"])
            _same(fe.serve(q_point(key=11)), s.execute(q_point(key=11).logical_plan))
            cache = s.serve_cache
            assert cache.insert_failures >= 1
            assert P.faults.stats()["cache_insert"] >= 1
            assert fe.stats()["failed"] == 0
            if spec == "transient:1":
                fe.serve(q_point(key=13))  # recovered: later inserts land
                assert len(cache) >= 1
        finally:
            s.conf.set(P.C.SERVE_CACHE_ENABLED, False)
            s.clear_serve_cache()

    def test_every_point_fired_in_this_module(self, served):
        # arm every point of the package transiently, run one query a shape
        # and one fast-plane push, and require every point to have fired
        pkg, s, fe, q_point, q_agg, base = served
        P = PKG[pkg]
        s.conf.set(P.C.SERVE_CACHE_ENABLED, True)
        try:
            s.index_manager.clear_cache()
            s.clear_serve_cache()
            for point in P.faults.POINTS:
                P.faults.set_fault(point, "transient:1")
            _same(fe.serve(q_agg()), base["agg"])
            _same(fe.serve(q_point()), base["point"])
            with pytest.raises(P.faults.InjectedFault):
                P.fastbus.push("/nonexistent.sock", {"type": "event"})
            fired = P.faults.stats()
            for point in P.faults.POINTS:
                assert fired.get(point, 0) >= 1, (point, fired)
        finally:
            s.conf.set(P.C.SERVE_CACHE_ENABLED, False)
            s.clear_serve_cache()

    def test_points_are_the_references_less_kernel_dispatch(self):
        assert set(PKG["jax"].faults.POINTS) - set(PKG["port"].faults.POINTS) == {
            "kernel_dispatch"}
        with pytest.raises(PKG["port"].E.HyperspaceException):
            PKG["port"].faults.set_fault("kernel_dispatch", "transient:2")


# ---------------------------------------------------------------------------
# Kernel faults: the port's rule (ROADMAP C.7, C.11, C.21)
# ---------------------------------------------------------------------------


def _arm_b1_fault(monkeypatch):
    """A KernelLaunchError out of B1 where the bucket-pruned filter calls it
    (on a CUDA tensor the wrapper raises this from the kernel's error code;
    ``tests/test_torch_cuda.py`` injects it there)."""
    from hyperspace_tpu_torch.execution import executor

    calls = []

    def faulty(*args, **kwargs):
        calls.append(1)
        raise KernelLaunchError("murmur3 bucket kernel launch failed: CUDA error 700")

    monkeypatch.setattr(executor, "bucket_ids", faulty)
    return calls


@pytest.mark.parametrize("fleet", [False, True], ids=["frontend", "fleet"])
def test_kernel_fault_fails_the_serve_unretried_undegraded(lake_dir, monkeypatch, fleet):
    P = PKG["port"]
    s, q_point, _q_agg, base = _served("port", lake_dir)
    s.conf.set(P.C.FLEET_ENABLED, fleet)
    fe = s.serve_frontend
    assert isinstance(fe, P.fleet.FleetFrontend) == fleet
    try:
        _same(fe.serve(q_point()), base["point"])
        before = fe.stats()
        calls = _arm_b1_fault(monkeypatch)
        with pytest.raises(KernelLaunchError):
            fe.serve(q_point(key=19))
        after = fe.stats()
        assert len(calls) == 1  # launched once: no retry, no rerun
        assert after["failed"] == before["failed"] + 1
        assert (after["retries"], after["degraded"]) == (before["retries"], before["degraded"])
        if fleet:
            assert after["fleet"]["singleflight_local"] == before["fleet"]["singleflight_local"]
        monkeypatch.undo()
        _same(fe.serve(q_point(key=19)), s.execute(q_point(key=19).logical_plan))
    finally:
        fe.close()
        s.conf.set(P.C.FLEET_ENABLED, False)


def test_fleet_follower_reraises_the_leaders_kernel_fault(lake_dir, monkeypatch):
    """Two callers of one digest on the owner: the follower joins the
    leader's Future and gets its KernelLaunchError, with no local rerun."""
    P = PKG["port"]
    s, q_point, _q_agg, _base = _served("port", lake_dir)
    s.conf.set(P.C.FLEET_ENABLED, True)
    fe = s.serve_frontend
    try:
        plan = q_point(key=23).logical_plan
        pin = fe._pin()
        digest = fe._plan_digest(plan, pin)
        gate, entered, calls = threading.Event(), threading.Event(), []

        def gated(plan_, session=None):
            calls.append(1)
            entered.set()
            gate.wait(10)
            raise KernelLaunchError("murmur3 bucket kernel launch failed: CUDA error 700")

        monkeypatch.setattr(P.execution, "execute", gated)
        errors = []

        def call():
            try:
                fe._serve_digest(digest, plan, pin)
            except BaseException as exc:  # collected for the assertions
                errors.append(exc)

        leader = threading.Thread(target=call)
        leader.start()
        assert entered.wait(10)
        follower = threading.Thread(target=call)
        follower.start()
        time.sleep(0.2)  # the follower is parked on the leader's Future
        gate.set()
        leader.join(10)
        follower.join(10)
        assert len(errors) == 2 and all(isinstance(e, KernelLaunchError) for e in errors)
        assert len(calls) == 1
        assert fe.stats()["fleet"]["singleflight_local"] == 0
    finally:
        fe.close()
        s.conf.set(P.C.FLEET_ENABLED, False)


# ---------------------------------------------------------------------------
# The fleet fast plane's send seam (serve/fastbus.py)
# ---------------------------------------------------------------------------


class TestFastbusSend:
    def test_fault_raises_typed_oserror_at_the_seam(self, tmp_path):
        P = PKG["port"]
        P.faults.set_fault("fastbus_send", "transient:1")
        with pytest.raises(P.faults.InjectedFault):
            P.fastbus.push("/nonexistent.sock", {"type": "event"})
        assert P.faults.stats()["fastbus_send"] == 1
        # recovered: the next failed send is a plain dead-socket False
        assert not P.fastbus.push(str(tmp_path / "no.sock"), {"type": "e"})

    def test_push_fanout_degrades_without_raising(self, tmp_path):
        # through serve.router: an armed send fault never escapes
        # push_event_to_members (the durable poll is the retransmit)
        P = PKG["port"]
        sp = str(tmp_path / "sys")
        s = twin.session("port", sp)
        mdir = P.router.members_dir(s.conf)
        os.makedirs(mdir)
        got = []
        srv = P.fastbus.FastBusServer(lambda h, b: got.append(h))
        try:
            with open(os.path.join(mdir, "aa.json"), "w") as f:
                json.dump({"owner": "aa", "pid": os.getpid(), "sock": srv.path,
                           "expiresAtMs": int(time.time() * 1000) + 60_000}, f)
            assert set(P.router.read_members(mdir)) == {"aa"}
            P.faults.set_fault("fastbus_send", "persistent")
            assert P.router.push_event_to_members(s.conf, {"type": "index_changed"}) == 0
            assert P.faults.stats()["fastbus_send"] >= 1
            P.faults.set_fault("fastbus_send", "off")
            assert P.router.push_event_to_members(s.conf, {"type": "index_changed"}) == 1
            assert _wait(lambda: got)
            assert got[0]["event"] == {"type": "index_changed"}
        finally:
            srv.stop()

    @pytest.mark.parametrize("spec", ["transient:1", "persistent"])
    def test_routed_request_falls_back_bit_identical(self, spec, tmp_path):
        # two FleetFrontends over one lake: a query owned by the peer hits
        # the armed send seam, falls back to the durable claim/spool plane
        # and answers with the JAX package's rows over the source
        P = PKG["port"]
        d = tmp_path / "flk"
        d.mkdir()
        rng = np.random.default_rng(9)
        pq.write_table(pa.table({"k": pa.array(rng.integers(0, 50, 3000), pa.int64()),
                                 "v": pa.array(rng.integers(-99, 99, 3000), pa.int64())}),
                       str(d / "p0.parquet"))
        idx = str(tmp_path / "flk_idx")
        conf = {P.C.FLEET_ENABLED: True, P.C.FLEET_FAST_GOSSIP_MS: 60_000}
        s1 = twin.session("port", idx, num_buckets=2, **conf)
        P.Hyperspace(s1).create_index(s1.read.parquet(str(d)), P.Covering("flkidx", ["k"], ["v"]))
        s2 = twin.session("port", idx, num_buckets=2, **conf)
        fe1, fe2 = s1.serve_frontend, s2.serve_frontend
        try:
            members = fe1._router.members(refresh=True)
            pin = fe1._pin()
            probe = None
            for kk in range(200):
                q = s1.read.parquet(str(d))
                q = q.filter((q["k"] == kk % 50) & (q["v"] > -1000 - kk))
                dig = fe1._plan_digest(q.logical_plan, pin)
                if P.router.rendezvous_owner(members.keys(), dig) == fe2._router.owner:
                    probe = q
                    break
            assert probe is not None
            P.faults.set_fault("fastbus_send", spec)
            got = fe1.serve(probe)
            P.faults.set_fault("fastbus_send", "off")
            want = twin.reference_answer(idx, probe.logical_plan)
            assert sorted_table(got).equals(sorted_table(want))
            assert fe1.stats()["fleet"]["fast_fallbacks"] >= 1
            assert P.faults.stats()["fastbus_send"] >= 1
            assert fe1.stats()["failed"] == 0
        finally:
            P.faults.set_fault("fastbus_send", "off")
            fe1.close()
            fe2.close()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.01)
    return pred()
