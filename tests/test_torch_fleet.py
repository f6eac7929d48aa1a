"""The port's replicated serve fleet against the JAX package's, on the CPU:
the cases of ``tests/test_fleet.py`` (the bus, eviction, aggregate-state
push, the claim/spool single-flight, the fast path, SLO classes, the
session's frontend type; the two-process harness marked ``slow`` as in the
reference), run in the port over one lake the JAX package built. Every
answer the port's fleet serves is held to the JAX package's unindexed
answer to the same plan (``torch_frontend_twin.reference_answer``), and the
fleet harness's worker to the reference harness's digests.

Interop, across the packages on one lake:

* an event published by one package's ``FleetBus`` (a refresh's fanout) is
  installed by the other package's ``FleetFrontend``;
* a durable pin file written by one package is honoured by the other's
  ``gc_orphans``;
* ``rendezvous_owner`` picks the same owner for the same members and
  digests, ``table_to_bytes`` frames are byte-equal, and the fleet's
  ``_plan_digest`` is equal for the same plan and pin.
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

import torch_frontend_twin as twin

P = PKG["port"]


def _rows(rng, n):
    return pa.table({
        "k": pa.array(rng.integers(0, 60, n), pa.int64()),
        "v": pa.array(rng.integers(-500, 500, n), pa.int64()),
    })


@pytest.fixture
def fleet_env(tmp_path):
    """One lake (index ``fidx`` built by the JAX package) and a factory of
    fleet sessions of either package over it: the in-process stand-in for
    frontend processes (separate sessions, separate caches, coordination
    only through the lake's files)."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(7)
    pq.write_table(_rows(rng, 4000), str(src / "part-0.parquet"))
    index_root = str(tmp_path / "indexes")
    made = []

    def make_session(pkg, **conf):
        C = P.C
        base = {C.FLEET_ENABLED: True, C.SERVE_CACHE_ENABLED: True, C.FLEET_BUS_POLL_MS: 20}
        base.update(conf)
        s = twin.session(pkg, index_root, num_buckets=4, **base)
        made.append(s)
        return s

    builder = twin.session("jax", index_root, num_buckets=4)
    PKG["jax"].Hyperspace(builder).create_index(
        builder.read.parquet(str(src)), PKG["jax"].Covering("fidx", ["k"], ["v"]))
    yield {"src": str(src), "index_root": index_root, "make_session": make_session,
           "rng": rng, "tmp": tmp_path}
    for s in made:
        fe = s._serve_frontend
        if fe is not None and not fe.closed:
            fe.close()


def _truth(s, q):
    """The JAX package's unindexed answer to the port's query ``q`` over the
    lake of the port's session ``s``."""
    return twin.reference_answer(s.conf.get(P.C.INDEX_SYSTEM_PATH), q.logical_plan)


def _wait(pred, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


# ---------------------------------------------------------------------------
# The fanout bus
# ---------------------------------------------------------------------------


class TestFleetBus:
    def test_publish_poll_roundtrip(self, tmp_path):
        FleetBus = P.bus.FleetBus
        d = str(tmp_path / "bus")
        a, b = FleetBus(d, retain_ms=60_000), FleetBus(d, retain_ms=60_000)
        b.prime()
        a.publish({"type": "index_changed", "root": "/x"})
        a.publish({"type": "index_changed", "root": "/y"})
        assert [e["root"] for e in b.poll_once()] == ["/x", "/y"]
        assert b.poll_once() == []  # seen once
        assert b.received == 2

    def test_own_events_skipped(self, tmp_path):
        a = P.bus.FleetBus(str(tmp_path / "bus"))
        a.prime()
        a.publish({"type": "index_changed", "root": "/x"})
        assert a.poll_once() == []

    def test_prime_skips_history(self, tmp_path):
        FleetBus = P.bus.FleetBus
        d = str(tmp_path / "bus")
        a = FleetBus(d)
        a.publish({"type": "index_changed", "root": "/old"})
        b = FleetBus(d)
        b.prime()
        assert b.poll_once() == []
        a.publish({"type": "index_changed", "root": "/new"})
        assert [e["root"] for e in b.poll_once()] == ["/new"]

    def test_retention_prune(self, tmp_path):
        d = str(tmp_path / "bus")
        a = P.bus.FleetBus(d, retain_ms=80)
        a.publish({"type": "index_changed", "root": "/x"})
        time.sleep(0.15)
        a.publish({"type": "index_changed", "root": "/y"})
        assert a.pruned >= 1
        assert len([f for f in os.listdir(d) if f.endswith(".json")]) == 1

    def test_torn_event_skipped(self, tmp_path):
        d = str(tmp_path / "bus")
        os.makedirs(d)
        b = P.bus.FleetBus(d)
        b.prime()
        with open(os.path.join(d, "9999999999999.dead.000001.json"), "w") as f:
            f.write('{"type": "ind')
        assert b.poll_once() == []

    def test_subscriber_thread_delivers(self, tmp_path):
        FleetBus = P.bus.FleetBus
        d = str(tmp_path / "bus")
        got, done = [], threading.Event()
        b = FleetBus(d, poll_ms=10)
        b.start(lambda e: (got.append(e), done.set()))
        try:
            FleetBus(d).publish({"type": "index_changed", "root": "/z"})
            assert done.wait(5.0)
            assert got[0]["root"] == "/z"
        finally:
            b.stop()


def test_bus_events_cross_packages(tmp_path):
    # the file format is shared: each package's subscriber reads the other's
    d = str(tmp_path / "bus")
    for pub, sub in (("port", "jax"), ("jax", "port")):
        b = PKG[sub].bus.FleetBus(d)
        b.prime()
        PKG[pub].bus.FleetBus(d).publish({"type": "index_changed", "root": f"/{pub}"})
        assert [e["root"] for e in b.poll_once()] == [f"/{pub}"]


# ---------------------------------------------------------------------------
# Scoped invalidation
# ---------------------------------------------------------------------------


class TestEvictPathsUnder:
    def test_evicts_only_matching_index(self):
        from hyperspace_tpu_torch.execution.serve_cache import ServeCache

        c = ServeCache(1 << 20)
        fp_a = (("/lake/idxA/v__=1/part-0.parquet", 10, 1),)
        fp_b = (("/lake/idxB/v__=1/part-0.parquet", 10, 1),)
        c.put(("scan", fp_a), "a", 10)
        c.put(("zonemap", fp_a), "za", 10)
        c.put(("joinside", (fp_a, fp_b), ("k",), ("k",)), "j", 10)
        c.put(("scan", fp_b), "b", 10)
        assert c.evict_paths_under("/lake/idxA") == 3
        assert c.get(("scan", fp_b)) == "b"
        assert c.get(("scan", fp_a)) is None
        assert c.resident_bytes == 10

    def test_zonemaps_invalidate_paths_under_as_the_reference(self, tmp_path):
        from hyperspace_tpu.indexes import zonemaps as jz
        from hyperspace_tpu_torch.indexes import zonemaps as tz

        for zm in (tz, jz):
            zm.invalidate_local_cache()
            with zm._local_lock:
                zm._local_cache[(("/lake/idxA/v__=1/p.parquet", 1, 1),)] = ("a", 5)
                zm._local_cache[(("/lake/idxB/v__=1/p.parquet", 1, 1),)] = ("b", 7)
                zm._local_bytes = 12
        assert tz.invalidate_paths_under("/lake/idxA") == jz.invalidate_paths_under("/lake/idxA") == 1
        assert tz._local_bytes == jz._local_bytes == 7
        assert list(tz._local_cache) == list(jz._local_cache)
        for zm in (tz, jz):
            zm.invalidate_local_cache()


# ---------------------------------------------------------------------------
# Aggregate-state push payloads
# ---------------------------------------------------------------------------


class TestAggstatePush:
    def test_payload_roundtrip(self, fleet_env):
        from hyperspace_tpu.indexes import aggindex as jaggindex
        from hyperspace_tpu_torch.execution.serve_cache import ServeCache
        from hyperspace_tpu_torch.indexes import aggindex

        s = fleet_env["make_session"]("port")
        js = fleet_env["make_session"]("jax")
        files = s.index_manager.get_indexes([P.C.States.ACTIVE])[0].content.files
        jfiles = js.index_manager.get_indexes([PKG["jax"].C.States.ACTIVE])[0].content.files
        payload = aggindex.fanout_payload(files)
        assert payload is not None
        payload = json.loads(json.dumps(payload))  # as the bus carries it
        # the same payload as the reference's for the same index files
        assert payload == json.loads(json.dumps(jaggindex.fanout_payload(jfiles)))
        cache = ServeCache(1 << 24)
        aggindex.invalidate_local_cache()
        assert aggindex.install_fanout_payload(payload, cache)
        assert cache.bytes_by_kind().get("aggstate", 0) > 0

    def test_stale_payload_dropped(self, fleet_env):
        from hyperspace_tpu_torch.indexes import aggindex

        s = fleet_env["make_session"]("port")
        files = s.index_manager.get_indexes([P.C.States.ACTIVE])[0].content.files
        payload = aggindex.fanout_payload(files)
        payload["fp"][0][1] += 1  # stats moved on: a stale push
        assert not aggindex.install_fanout_payload(payload, None)

    def test_refresh_fans_out_to_peer(self, fleet_env):
        # the refresher is a fleet session of the port; a port peer installs
        # its pushed state and serves the new snapshot
        s1 = fleet_env["make_session"]("port")
        s2 = fleet_env["make_session"]("port")
        fe2 = s2.serve_frontend
        assert isinstance(fe2, P.fleet.FleetFrontend)
        pq.write_table(_rows(fleet_env["rng"], 500), os.path.join(fleet_env["src"], "part-1.parquet"))
        P.Hyperspace(s1).refresh_index("fidx", "incremental")
        # wait on bus_installed: the callback counts the event before it
        # installs the payload
        assert _wait(lambda: fe2.stats()["fleet"]["bus_installed"] >= 1)
        st = fe2.stats()["fleet"]
        assert st["bus_events"] >= 1 and st["bus_installed"] >= 1, st
        df = s2.read.parquet(fleet_env["src"])
        q = df.filter(df["k"] >= 10).agg(P.F.count().alias("n"))
        assert fe2.serve(q).equals(_truth(s2, q))


@pytest.mark.parametrize("publisher,subscriber", [("jax", "port"), ("port", "jax")])
def test_refresh_event_installed_by_the_other_package(fleet_env, publisher, subscriber):
    s_pub = fleet_env["make_session"](publisher)
    s_sub = fleet_env["make_session"](subscriber)
    fe = s_sub.serve_frontend
    assert isinstance(fe, PKG[subscriber].fleet.FleetFrontend)
    pq.write_table(_rows(fleet_env["rng"], 400),
                   os.path.join(fleet_env["src"], f"part-{publisher}.parquet"))
    PKG[publisher].Hyperspace(s_pub).refresh_index("fidx", "incremental")
    assert _wait(lambda: fe.stats()["fleet"]["bus_installed"] >= 1), fe.stats()["fleet"]
    df = s_sub.read.parquet(fleet_env["src"])
    q = df.filter(df["k"] >= 10).agg(PKG[subscriber].F.count().alias("n"))
    # held to the other package's unindexed answer
    port = s_sub if subscriber == "port" else s_pub
    pdf = port.read.parquet(fleet_env["src"])
    pq_ = pdf.filter(pdf["k"] >= 10).agg(P.F.count().alias("n"))
    if subscriber == "port":
        want = _truth(port, pq_)
    else:
        port.disable_hyperspace()
        want = pq_.collect()
        port.enable_hyperspace()
    assert fe.serve(q).equals(want)


# ---------------------------------------------------------------------------
# Cross-process single-flight (claim + spool)
# ---------------------------------------------------------------------------


class TestSingleFlight:
    """The durable claim/spool plane on its own: fast routing off, so every
    dedup goes through the claim election."""

    def test_two_frontends_one_execution(self, fleet_env):
        C = P.C
        s1 = fleet_env["make_session"]("port", **{C.FLEET_FAST_ENABLED: False})
        s2 = fleet_env["make_session"]("port", **{C.FLEET_FAST_ENABLED: False})
        fe1, fe2 = s1.serve_frontend, s2.serve_frontend
        src = fleet_env["src"]
        q1 = s1.read.parquet(src)
        q1 = q1.filter(q1["k"] == 11)
        q2 = s2.read.parquet(src)
        q2 = q2.filter(q2["k"] == 11)
        t1, t2 = fe1.serve(q1), fe2.serve(q2)
        assert sorted_table(t1).equals(sorted_table(t2))
        st1, st2 = fe1.stats()["fleet"], fe2.stats()["fleet"]
        assert st1["claims_won"] + st2["claims_won"] == 1
        assert st1["spool_hits"] + st2["spool_hits"] == 1
        assert st1["election_wins"] + st2["election_wins"] == 1
        assert st1["election_attempts"] + st2["election_attempts"] >= 1
        assert sorted_table(t1).equals(sorted_table(_truth(s1, q1)))

    def test_expired_claim_taken_over(self, fleet_env):
        C = P.C
        s2 = fleet_env["make_session"]("port", **{C.FLEET_SINGLEFLIGHT_CLAIM_MS: 30})
        fe2 = s2.serve_frontend
        sd = P.fleet.spool_dir(s2.conf)
        claim = os.path.join(sd, "deadbeef.claim")
        os.makedirs(sd, exist_ok=True)
        with open(claim, "w") as f:
            json.dump({"owner": "dead", "expiresAtMs": 1}, f)
        assert fe2._try_claim(claim) == "won"
        claim2 = os.path.join(sd, "cafebabe.claim")
        with open(claim2, "w") as f:
            json.dump({"owner": "live", "expiresAtMs": int(time.time() * 1000) + 600_000}, f)
        assert fe2._try_claim(claim2) == "held"

    def test_wait_timeout_executes_locally(self, fleet_env):
        C = P.C
        s2 = fleet_env["make_session"]("port", **{C.FLEET_FAST_ENABLED: False,
                                                C.FLEET_SINGLEFLIGHT_WAIT_MS: 50,
                                                C.FLEET_SINGLEFLIGHT_CLAIM_MS: 600_000})
        fe2 = s2.serve_frontend
        q = s2.read.parquet(fleet_env["src"])
        q = q.filter(q["k"] == 31)
        digest = fe2._plan_digest(q.logical_plan, fe2._pin())
        sd = P.fleet.spool_dir(s2.conf)
        os.makedirs(sd, exist_ok=True)
        with open(os.path.join(sd, digest + ".claim"), "w") as f:
            json.dump({"owner": "live-elsewhere",
                       "expiresAtMs": int(time.time() * 1000) + 600_000}, f)
        t = fe2.serve(q)  # waits 50 ms, then serves locally
        assert sorted_table(t).equals(sorted_table(_truth(s2, q)))
        st = fe2.stats()["fleet"]
        assert st["singleflight_local"] >= 1 and st["claim_waits"] >= 1, st
        assert st["election_losses"] >= 1 and st["election_wins"] == 0, st

    def test_spool_prune_respects_budget(self, fleet_env):
        C = P.C
        s2 = fleet_env["make_session"]("port", **{C.FLEET_FAST_ENABLED: False,
                                                C.FLEET_SPOOL_MAX_BYTES: 1})
        fe2 = s2.serve_frontend
        q = s2.read.parquet(fleet_env["src"])
        fe2.serve(q.filter(q["k"] == 42))
        sd = P.fleet.spool_dir(s2.conf)
        assert [f for f in os.listdir(sd) if f.endswith(".arrow")] == []


def test_single_flight_across_packages(fleet_env):
    # a port frontend and a JAX-package frontend elect one executor: the
    # second serves the first's spooled result
    sessions = [fleet_env["make_session"](p, **{PKG[p].C.FLEET_FAST_ENABLED: False})
                for p in ("jax", "port")]
    out, stats = [], []
    for s in sessions:
        q = s.read.parquet(fleet_env["src"])
        q = q.filter(q["k"] == 17)
        out.append(s.serve_frontend.serve(q))
        stats.append(s.serve_frontend.stats()["fleet"])
    assert sorted_table(out[0]).equals(sorted_table(out[1]))
    assert stats[0]["claims_won"] == 1 and stats[1]["spool_hits"] == 1, stats


# ---------------------------------------------------------------------------
# The fast data plane: push bus + owner routing
# ---------------------------------------------------------------------------


def _query_owned_by(fe, session, src, target_owner):
    """A probe DataFrame whose (plan, snapshot) digest rendezvous-routes to
    ``target_owner``."""
    members = fe._router.members(refresh=True)
    pin = fe._pin()
    for kk in range(300):
        df = session.read.parquet(src)
        df = df.filter((df["k"] == kk % 60) & (df["v"] > -(10**6) - kk))
        digest = fe._plan_digest(df.logical_plan, pin)
        if P.router.rendezvous_owner(members.keys(), digest) == target_owner:
            return df, digest
    raise AssertionError(f"no probe routed to {target_owner}")


class TestFastPath:
    def test_owner_local_serve_skips_claim_election(self, fleet_env):
        s = fleet_env["make_session"]("port")
        fe = s.serve_frontend
        assert fe._router is not None  # the fast plane came up
        src = fleet_env["src"]
        q = s.read.parquet(src)
        t1 = fe.serve(q.filter(q["k"] == 13))
        st = fe.stats()["fleet"]
        assert st["election_attempts"] == 0 and st["claims_won"] == 0, st
        sd = P.fleet.spool_dir(s.conf)
        if os.path.isdir(sd):
            assert [f for f in os.listdir(sd) if f.endswith(".claim")] == []
        q2 = s.read.parquet(src)
        t2 = fe.serve(q2.filter(q2["k"] == 13))
        assert sorted_table(t1).equals(sorted_table(t2))
        assert fe.stats()["fleet"]["fast_result_hits"] >= 1
        assert _wait(lambda: fe.stats()["fleet"]["spool_publishes"] >= 1)

    def test_remote_handoff_skips_spool(self, fleet_env):
        s1, s2 = fleet_env["make_session"]("port"), fleet_env["make_session"]("port")
        fe1, fe2 = s1.serve_frontend, s2.serve_frontend
        q, _d = _query_owned_by(fe1, s1, fleet_env["src"], fe2._router.owner)
        t = fe1.serve(q)
        st1, st2 = fe1.stats()["fleet"], fe2.stats()["fleet"]
        assert st1["fast_handoffs"] == 1, st1
        assert st2["fast_requests_served"] == 1, st2
        assert st1["claims_won"] + st2["claims_won"] == 0
        assert st1["spool_hits"] + st2["spool_hits"] == 0
        assert sorted_table(t).equals(sorted_table(_truth(s1, q)))

    def test_refresh_push_beats_poll(self, fleet_env):
        C = P.C
        s1 = fleet_env["make_session"]("port")
        s2 = fleet_env["make_session"]("port", **{C.FLEET_BUS_POLL_MS: 60_000})
        fe2 = s2.serve_frontend
        pq.write_table(_rows(fleet_env["rng"], 300),
                       os.path.join(fleet_env["src"], "part-push.parquet"))
        P.Hyperspace(s1).refresh_index("fidx", "incremental")
        # the poll plane is parked for 60 s: only the push delivers this fast
        assert _wait(lambda: fe2.stats()["fleet"]["fast_push_received"] >= 1, 5.0, 0.01)
        assert fe2.stats()["fleet"]["bus_events"] >= 1

    def test_dead_owner_falls_back_bit_identical(self, fleet_env):
        s1, s2 = fleet_env["make_session"]("port"), fleet_env["make_session"]("port")
        fe1, fe2 = s1.serve_frontend, s2.serve_frontend
        q, _d = _query_owned_by(fe1, s1, fleet_env["src"], fe2._router.owner)
        fe2._router._server.stop()  # kill the socket, keep the lease
        t = fe1.serve(q)
        st1 = fe1.stats()["fleet"]
        assert st1["fast_fallbacks"] == 1 and st1["claims_won"] == 1, st1
        assert sorted_table(t).equals(sorted_table(_truth(s1, q)))

    def test_owner_verifies_digest_before_answering(self, fleet_env):
        s1 = fleet_env["make_session"]("port")
        fe1 = s1.serve_frontend
        from hyperspace_tpu_torch.obs import planspec

        df = s1.read.parquet(fleet_env["src"])
        spec = planspec.to_spec(df.filter(df["k"] == 7).logical_plan)
        reply, body = P.fastbus.request(
            fe1._router._server.path, {"type": "exec", "digest": "f" * 40, "spec": spec})
        assert reply == {"status": "miss", "reason": "snapshot"} and body == b""

    def test_member_files_reaped(self, tmp_path):
        router = P.router
        d = str(tmp_path / "members")
        os.makedirs(d)
        now = int(time.time() * 1000)
        sock = str(tmp_path / "dead.sock")
        open(sock, "w").close()
        docs = {
            "aa": {"owner": "aa", "pid": 1, "sock": sock, "expiresAtMs": 1},
            "bb": {"owner": "bb", "pid": os.getpid(), "sock": "/tmp/x.sock",
                   "expiresAtMs": now + 600_000},
            "cc": {"owner": "cc", "pid": 2**22 + 12345, "sock": "/tmp/y.sock",
                   "expiresAtMs": now + 600_000},
        }
        for name, doc in docs.items():
            with open(os.path.join(d, f"{name}.json"), "w") as f:
                json.dump(doc, f)
        reaped, leftovers = router.reap_members(d)
        assert reaped == 1 and leftovers == [] and not os.path.exists(sock)
        assert set(router.read_members(d)) == {"bb", "cc"}
        reaped, leftovers = router.reap_members(d, force_dead=True)
        assert reaped == 1 and leftovers == []
        assert set(router.read_members(d)) == {"bb"}

    def test_rendezvous_is_stable_and_balanced(self):
        rendezvous_owner = P.router.rendezvous_owner
        owners = ["m1", "m2", "m3"]
        digests = [f"{i:040x}" for i in range(600)]
        first = [rendezvous_owner(owners, d) for d in digests]
        assert first == [rendezvous_owner(owners, d) for d in digests]
        assert all(first.count(o) > 100 for o in owners)
        moved = sum(1 for d, was in zip(digests, first)
                    if was != "m3" and rendezvous_owner(["m1", "m2"], d) != was)
        assert moved == 0

    def test_spool_sweep_reaps_orphans_and_counts(self, fleet_env):
        C = P.C
        s = fleet_env["make_session"]("port", **{C.FLEET_FAST_ENABLED: False,
                                               C.FLEET_SINGLEFLIGHT_CLAIM_MS: 100})
        fe = s.serve_frontend
        sd = P.fleet.spool_dir(s.conf)
        os.makedirs(sd, exist_ok=True)
        old = time.time() - 60.0
        for name in ("deadbeef.arrow.trace", "deadbeef.claim", ".tmp_spool_zz"):
            p = os.path.join(sd, name)
            with open(p, "w") as f:
                f.write("x")
            os.utime(p, (old, old))
        q = s.read.parquet(fleet_env["src"])
        fe.serve(q.filter(q["k"] == 21))  # the winner's publish runs the sweep
        names = os.listdir(sd)
        assert not {"deadbeef.arrow.trace", "deadbeef.claim", ".tmp_spool_zz"} & set(names)
        st = fe.stats()["fleet"]
        assert (st["spool_reaped_traces"], st["spool_reaped_claims"],
                st["spool_reaped_tmp"]) == (1, 1, 1), st

    def test_fleet_wide_slo_sheds_on_gossiped_depth(self, fleet_env):
        C = P.C
        conf = {C.FLEET_CLASS_KEY_PREFIX + "batch.maxConcurrency": 1,
                C.FLEET_CLASS_KEY_PREFIX + "batch.maxQueueDepth": 2,
                C.SERVE_MAX_CONCURRENCY: 8}
        s1, s2 = fleet_env["make_session"]("port", **conf), fleet_env["make_session"]("port", **conf)
        fe1, fe2 = s1.serve_frontend, s2.serve_frontend
        gate = threading.Event()
        try:
            fe2._execute_pinned = lambda plan, pin: (gate.wait(10.0),
                                                     pa.table({"x": pa.array([1])}))[1]
            src = fleet_env["src"]

            def q(sess, i):
                df = sess.read.parquet(src)
                return df.filter(df["k"] == i)

            futs = [fe2.submit(q(s2, i), slo_class="batch") for i in (0, 1)]
            depth = 0
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                fe2._router.push_gossip_now()
                with fe1._lock:
                    depth = sum(c.get("batch", 0) for _ts, c in fe1._peer_slo.values())
                if depth >= 2:
                    break
                time.sleep(0.01)
            assert depth >= 2
            with pytest.raises(P.E.ServeOverloadedError, match="fleet"):
                fe1.submit(q(s1, 50), slo_class="batch")
            assert fe1.serve(q(s1, 51), slo_class="interactive").num_rows >= 0
            gate.set()
            for f in futs:
                f.result(timeout=10)
        finally:
            gate.set()


def test_fast_handoff_of_a_kernel_fault_is_named(fleet_env, monkeypatch):
    """An owner whose execution raises replies ``miss``: in the port a
    kernel fault is named (``reason: kernel``) and counted in
    ``kernel_faults`` (ROADMAP C.21), where the reference calls every
    failure ``exec``."""
    from hyperspace_tpu_torch.kernels import KernelLaunchError

    s1 = fleet_env["make_session"]("port")
    fe1 = s1.serve_frontend
    from hyperspace_tpu_torch.obs import planspec

    df = s1.read.parquet(fleet_env["src"])
    q = df.filter(df["k"] == 9)
    digest = fe1._plan_digest(q.logical_plan, fe1._pin())

    def boom(plan, session=None):
        raise KernelLaunchError("murmur3_bucket_ids: injected launch failure")

    monkeypatch.setattr(P.execution, "execute", boom)
    reply, body = P.fastbus.request(
        fe1._router._server.path,
        {"type": "exec", "digest": digest, "spec": planspec.to_spec(q.logical_plan)})
    assert reply == {"status": "miss", "reason": "kernel"} and body == b""
    assert fe1.stats()["fleet"]["kernel_faults"] == 1


# ---------------------------------------------------------------------------
# Per-tenant SLO classes
# ---------------------------------------------------------------------------


class TestSloClasses:
    def _frontend(self, fleet_env, **conf):
        s = fleet_env["make_session"]("port", **{P.C.FLEET_ENABLED: False, **conf})
        fe = P.frontend.ServeFrontend(s)
        return s, fe

    def test_class_max_concurrency_gates_running(self, fleet_env):
        C = P.C
        s, fe = self._frontend(fleet_env, **{
            C.FLEET_CLASS_KEY_PREFIX + "batch.maxConcurrency": 1, C.SERVE_MAX_CONCURRENCY: 8})
        try:
            gate, running = threading.Event(), []

            def slow_exec(plan, pin):
                running.append(1)
                assert gate.wait(10.0)
                return pa.table({"x": pa.array([len(running)])})

            fe._execute_pinned = slow_exec
            futs = []
            for i in range(4):
                q = s.read.parquet(fleet_env["src"])
                futs.append(fe.submit(q.filter(q["k"] == i), slo_class="batch"))
            time.sleep(0.2)
            st = fe.stats()["slo_classes"]["batch"]
            assert (st["running"], st["pending"], len(running)) == (1, 3, 1), st
            gate.set()
            for f in futs:
                f.result(timeout=10)
            st = fe.stats()["slo_classes"]["batch"]
            assert (st["running"], st["pending"], st["admitted"]) == (0, 0, 4)
        finally:
            fe.close()

    def test_batch_sheds_before_interactive(self, fleet_env):
        C = P.C
        s, fe = self._frontend(fleet_env, **{
            C.FLEET_CLASS_KEY_PREFIX + "batch.maxConcurrency": 1,
            C.FLEET_CLASS_KEY_PREFIX + "batch.maxQueueDepth": 2,
            C.SERVE_MAX_CONCURRENCY: 8, C.SERVE_MAX_QUEUE_DEPTH: 64})
        gate = threading.Event()
        try:
            fe._execute_pinned = lambda plan, pin: (gate.wait(10.0),
                                                    pa.table({"x": pa.array([1])}))[1]

            def q(i):
                df = s.read.parquet(fleet_env["src"])
                return df.filter(df["k"] == i)

            futs = [fe.submit(q(i), slo_class="batch") for i in range(2)]
            with pytest.raises(P.E.ServeOverloadedError, match="batch"):
                fe.submit(q(99), slo_class="batch")
            f_int = fe.submit(q(7), slo_class="interactive")
            f_un = fe.submit(q(8))
            gate.set()
            for f in futs + [f_int, f_un]:
                f.result(timeout=10)
            st = fe.stats()
            assert st["slo_classes"]["batch"]["shed"] == 1 and st["shed"] == 1
        finally:
            gate.set()
            fe.close()

    def test_unconfigured_class_unlimited(self, fleet_env):
        s, fe = self._frontend(fleet_env)
        try:
            q = s.read.parquet(fleet_env["src"])
            assert fe.serve(q.filter(q["k"] == 3), slo_class="nosuch").num_rows >= 0
            assert "slo_classes" not in fe.stats()
        finally:
            fe.close()

    def test_close_fails_parked_admissions(self, fleet_env):
        C = P.C
        s, fe = self._frontend(fleet_env, **{C.FLEET_CLASS_KEY_PREFIX + "batch.maxConcurrency": 1})
        gate = threading.Event()
        fe._execute_pinned = lambda plan, pin: (gate.wait(10.0), pa.table({"x": pa.array([1])}))[1]

        def q(i):
            df = s.read.parquet(fleet_env["src"])
            return df.filter(df["k"] == i)

        f0 = fe.submit(q(0), slo_class="batch")
        f1 = fe.submit(q(1), slo_class="batch")  # parked
        gate.set()
        f0.result(timeout=10)
        fe.close(wait=False)
        # the parked admission ran before close, or failed with a typed
        # error; never silently dropped
        try:
            f1.result(timeout=10)
        except Exception as exc:
            assert "closed" in str(exc).lower()


# ---------------------------------------------------------------------------
# Session integration
# ---------------------------------------------------------------------------


def test_frontend_type_follows_fleet_flag(fleet_env):
    s = fleet_env["make_session"]("port")
    fe = s.serve_frontend
    assert isinstance(fe, P.fleet.FleetFrontend)
    s.conf.set(P.C.FLEET_ENABLED, False)
    fe2 = s.serve_frontend
    assert type(fe2) is P.frontend.ServeFrontend
    assert fe.closed  # the mode-mismatched frontend was retired
    s.conf.set(P.C.FLEET_ENABLED, True)
    fe3 = s.serve_frontend
    assert isinstance(fe3, P.fleet.FleetFrontend)
    assert s.device.type == "cpu"
    fe3.close()
    assert s.serve_frontend is not fe3 and not s.serve_frontend.closed


# ---------------------------------------------------------------------------
# Interop of the wire formats and identities
# ---------------------------------------------------------------------------


class TestInterop:
    def test_rendezvous_owner_agrees(self):
        owners = [f"{i:012x}" for i in (7, 99, 12345, 2**40)]
        digests = [f"{i * 7919:040x}" for i in range(300)]
        assert [PKG["port"].router.rendezvous_owner(owners, d) for d in digests] == [
            PKG["jax"].router.rendezvous_owner(owners, d) for d in digests]

    def test_table_frames_are_byte_equal(self):
        rng = np.random.default_rng(3)
        t = pa.table({"k": pa.array(rng.integers(0, 9, 50), pa.int64()),
                      "v": pa.array(rng.normal(size=50)),
                      "s": pa.array([f"r{i}" for i in range(50)])})
        tb, jb = PKG["port"].fastbus.table_to_bytes(t), PKG["jax"].fastbus.table_to_bytes(t)
        assert tb == jb
        assert PKG["port"].fastbus.table_from_bytes(jb).equals(t)
        assert PKG["jax"].fastbus.table_from_bytes(tb).equals(t)

    def test_fastbus_request_across_packages(self):
        # a port requester and a JAX-package server, and the reverse
        for server_pkg, client_pkg in (("jax", "port"), ("port", "jax")):
            srv = PKG[server_pkg].fastbus.FastBusServer(
                lambda h, b: ({"echo": h["n"]}, b[::-1]))
            try:
                reply, body = PKG[client_pkg].fastbus.request(srv.path, {"n": 5}, b"abc")
                assert reply == {"echo": 5} and body == b"cba"
                assert len(srv.path.encode()) < 108
            finally:
                srv.stop()
            assert not os.path.exists(srv.path)

    def test_plan_digest_is_equal(self, fleet_env):
        C = {p: PKG[p].C for p in PKGS}
        ss = {p: fleet_env["make_session"](p, **{C[p].FLEET_FAST_ENABLED: False}) for p in PKGS}
        digests = {}
        for p, s in ss.items():
            fe = s.serve_frontend
            pin = fe._pin()
            df = s.read.parquet(fleet_env["src"])
            digests[p] = [fe._plan_digest(q.logical_plan, pin) for q in (
                df.filter(df["k"] == 3), df.filter((df["k"] >= 5) & (df["k"] < 9)).select("v"),
                df.filter(df["k"].isin([1, 2])).agg(PKG[p].F.count().alias("n")))]
        assert digests["port"] == digests["jax"]
        assert all(d is not None for d in digests["port"])

    @pytest.mark.parametrize("writer,collector", [("port", "jax"), ("jax", "port")])
    def test_durable_pin_honoured_by_the_other_gc(self, fleet_env, writer, collector):
        from hyperspace_tpu.metadata import recovery as jrec
        from hyperspace_tpu.metadata.entry import Content as JContent
        from hyperspace_tpu_torch.metadata import recovery as trec
        from hyperspace_tpu_torch.metadata.entry import Content as TContent

        rec = {"port": trec, "jax": jrec}
        content = {"port": TContent, "jax": JContent}
        s = fleet_env["make_session"](writer)
        log_mgr, _ = s.index_manager._managers("fidx")
        index_path = log_mgr.index_path
        orphan_dir = os.path.join(index_path, "v__=9")
        os.makedirs(orphan_dir)
        orphan = os.path.join(orphan_dir, "part-orphan.parquet")
        with open(orphan, "w") as f:
            f.write("x")
        entry = log_mgr.get_latest_stable_log().copy()
        entry.content = content[writer].from_leaf_files([(orphan, 1, 1)])
        token = rec[writer].register_pins([entry], durable=True, lease_ms=60_000, heartbeat=False)
        try:
            assert rec[collector].durable_pinned_files(index_path) == {orphan.replace("\\", "/")}
            rep = rec[collector].gc_orphans(index_path, grace_ms=0)
            assert rep["kept_pinned"] == 1 and os.path.isfile(orphan), rep
            # the writer's lease expires: the collector reaps the pin file
            # and the orphan on the next pass
            rep = rec[collector].gc_orphans(index_path, grace_ms=0,
                                            now=rec[collector].now_ms() + 120_000)
            assert rep["reaped_pins"] == 1 and rep["quarantined_dirs"] == 1, rep
            assert not os.path.exists(orphan)
        finally:
            rec[writer].release_pins(token)


def test_worker_asked_for_cuda_without_a_card_raises(fleet_env):
    """A worker's spec carries its device; asked for ``cuda`` on a machine
    without a card, the worker raises before it serves (it never falls back
    to the CPU)."""
    import torch

    from hyperspace_tpu_torch.testing import fleet_harness

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the worker would open its session there")
    spec = {"worker_id": 0, "src": fleet_env["src"], "index_root": fleet_env["index_root"],
            "iters": 1, "n_queries": 1, "device": "cuda", "conf": {},
            "ready": str(fleet_env["tmp"] / "ready"), "go": str(fleet_env["tmp"] / "go"),
            "out": str(fleet_env["tmp"] / "out.json")}
    path = str(fleet_env["tmp"] / "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    with pytest.raises(PKG["port"].E.HyperspaceException, match="CUDA"):
        fleet_harness.worker_main(path)
    assert not os.path.exists(spec["ready"])


def test_worker_spec_without_a_device_is_refused(fleet_env):
    from hyperspace_tpu_torch.testing import fleet_harness

    spec = {"worker_id": 0, "src": fleet_env["src"], "index_root": fleet_env["index_root"],
            "iters": 1, "n_queries": 1, "conf": {}, "ready": str(fleet_env["tmp"] / "ready"),
            "go": str(fleet_env["tmp"] / "go"), "out": str(fleet_env["tmp"] / "out.json")}
    path = str(fleet_env["tmp"] / "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    with pytest.raises(ValueError, match="names no device"):
        fleet_harness.worker_main(path)
    assert not os.path.exists(spec["ready"])


def test_run_fleet_takes_the_card_by_default(tmp_path):
    """``run_fleet`` without a device runs on the card: without one it
    raises before it writes a lake or spawns a worker."""
    import torch

    from hyperspace_tpu_torch.testing import fleet_harness

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would spawn workers there")
    with pytest.raises(PKG["port"].E.HyperspaceException, match="CUDA"):
        fleet_harness.run_fleet(str(tmp_path / "fleet"), n_procs=2)
    assert not os.path.exists(tmp_path / "fleet")


def test_worker_digests_equal_the_reference_harness(tmp_path):
    """One port worker, run in this process on the CPU over a lake the
    reference harness built, serves the shared schedule to the reference
    harness's digests, and reports its measured window's launches (none on
    the CPU)."""
    from hyperspace_tpu.testing import fleet_harness as jharness
    from hyperspace_tpu_torch.testing import fleet_harness

    root = str(tmp_path / "fleet")
    src, index_root = jharness.build_lake(root, rows=2000)
    want = jharness.expected_digests(root, src, index_root, 6)
    spec = {"worker_id": 0, "src": src, "index_root": index_root, "iters": 1,
            "n_queries": 6, "conf": {}, "device": "cpu", "warmup": False,
            "ready": os.path.join(root, "ready.0"), "go": os.path.join(root, "go"),
            "out": os.path.join(root, "out.0.json")}
    open(spec["go"], "w").close()
    path = os.path.join(root, "spec.0.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    assert fleet_harness.worker_main(path) == 0
    with open(spec["out"]) as f:
        out = json.load(f)
    assert out["digests"] == want
    assert out["served"] == 6 and out["stats"]["failed"] == 0
    assert set(out["launches"]) >= {"murmur3_bucket_ids", "range_mask"}
    assert not any(out["launches"].values())


# ---------------------------------------------------------------------------
# N OS processes over one lake (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestFleetProcesses:
    def test_two_processes_single_flight_and_convergence(self, tmp_path):
        from hyperspace_tpu_torch.testing import fleet_harness

        rep = fleet_harness.run_fleet(str(tmp_path / "fleet"), n_procs=2, iters=3, rows=8000,
                                      fastpath_phase=True, device="cpu")
        assert rep["wrong_answers"] == 0
        dedup = rep["cross_process_dedup"] + rep["fast_handoffs"] + rep["fast_result_hits"]
        assert dedup > 0, rep
        assert rep["fast_frontends"] == 2 and rep["fast_push_received"] >= 1, rep
        assert rep["fast_handoffs"] >= 1 and rep["probe_mismatches"] == 0, rep
        assert rep["leaked_pin_files"] == 0 and rep["leaked_fast_members"] == 0

    def test_two_processes_durable_claims(self, tmp_path):
        # owner routing off: the cross-process dedup rides the claim/spool
        # plane, as phase 20 of chip_smoke.py runs it on the card
        from hyperspace_tpu_torch import constants as C
        from hyperspace_tpu_torch.testing import fleet_harness

        rep = fleet_harness.run_fleet(str(tmp_path / "fleet"), n_procs=2, iters=3, rows=8000,
                                      conf={C.FLEET_FAST_ROUTING_ENABLED: False}, device="cpu")
        assert rep["wrong_answers"] == 0 and rep["cross_process_dedup"] > 0, rep
        assert rep["leaked_pin_files"] == 0

    def test_kill_nine_mid_serve(self, tmp_path):
        from hyperspace_tpu_torch.testing import fleet_harness

        rep = fleet_harness.run_fleet(str(tmp_path / "chaos"), n_procs=3, iters=3, rows=8000,
                                      kill_one=True, fastpath_phase=True, device="cpu")
        assert rep["killed"] and rep["workers_reporting"] == 2
        assert rep["wrong_answers"] == 0
        assert rep["fast_fallbacks"] >= 1 and rep["probe_mismatches"] == 0, rep
        assert rep["leaked_pin_files"] == 0 and rep["leaked_fast_members"] == 0
