"""The port's crash recovery against the JAX package, apart from the crash
matrix (``tests/test_torch_crash_matrix.py``).

The reference's cases (``tests/test_crash_recovery.py``: crash registry,
leases and heartbeat, rollback, healing, GC, the sidecar publish seam,
cancel, the base-id resnapshot, durable pins, the spill write's crash
seam ``TestSpillWriteCrash``) run as scenarios over either
package (``tests/torch_crash_twin.py``: :class:`Pkg`, :func:`both`), each
asserting the reference's own checks, and their observations are held
equal across the packages. Port-only cases: a kernel's fault (never
retried, rolled back by the next action after its lease), the refused
``kernel_dispatch`` point, and a real process death (``os._exit`` in a
child interpreter).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from torch_crash_twin import (
    LEASE_MS,
    both,
    data_files,
    mk_index,
    pkg,
    quarantine,
    reset_faults,
    sample_source,
    serve_matches_source,
    wait_lease,
)
from torch_lifecycle_twin import append_file

import hyperspace_tpu_torch as T
from hyperspace_tpu.testing import faults as jfaults
from hyperspace_tpu_torch.testing import faults as tfaults


@pytest.fixture(autouse=True)
def _clean_faults():
    reset_faults()
    yield
    reset_faults()


# ---------------------------------------------------------------------------
# Crash registry
# ---------------------------------------------------------------------------


class TestCrashRegistry:
    def test_spec_parsing_equals_reference(self):
        specs = ["off", "", "raise", "exit", "raise;at=3", "exit;match=v__=2"]
        for spec in specs:
            assert tfaults.parse_crash_spec(spec) == jfaults.parse_crash_spec(spec)
        for bad in ("boom", "raise;at=0", "raise;x=1"):
            for f in (tfaults, jfaults):
                with pytest.raises(ValueError):
                    f.parse_crash_spec(bad)
        for spec in ["transient", "transient:3", "persistent", "persistent;match=v__=", "off"]:
            assert tfaults.parse_spec(spec) == jfaults.parse_spec(spec)
        with pytest.raises(ValueError):
            tfaults.set_crash("not_a_point", "raise")
        assert tfaults.CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE == 86
        assert set(tfaults.CRASH_POINTS) == set(jfaults.CRASH_POINTS)
        assert set(tfaults.POINTS) < set(jfaults.POINTS)

    @pytest.mark.parametrize("name", ["port", "jax"])
    def test_raise_is_one_shot(self, name):
        f = pkg(name).faults
        f.set_crash("after_begin_log", "raise")
        with pytest.raises(f.SimulatedCrash) as ei:
            f.crash("after_begin_log", "CreateAction")
        assert ei.value.point == "after_begin_log"
        f.crash("after_begin_log", "CreateAction")
        assert f.stats() == {"crash.after_begin_log": 1}

    @pytest.mark.parametrize("name", ["port", "jax"])
    def test_at_and_match(self, name):
        f = pkg(name).faults
        f.set_crash("mid_data_write", "raise;at=2;match=special")
        f.crash("mid_data_write", "/other/f1")
        f.crash("mid_data_write", "/special/f1")
        with pytest.raises(f.SimulatedCrash):
            f.crash("mid_data_write", "/special/f2")

    def test_simulated_crash_is_not_exception(self):
        assert issubclass(tfaults.SimulatedCrash, BaseException)
        assert not issubclass(tfaults.SimulatedCrash, Exception)
        assert issubclass(tfaults.InjectedFault, OSError)

    @pytest.mark.parametrize("name", ["port", "jax"])
    def test_configure_routes_crash_keys(self, name):
        P = pkg(name)
        conf = P.Config()
        conf.set(P.C.CRASH_KEY_PREFIX + "after_end_log", "raise")
        conf.set(P.C.FAULTS_KEY_PREFIX + "log_read", "transient")
        assert P.faults.configure(conf) == 2
        with pytest.raises(P.faults.SimulatedCrash):
            P.faults.crash("after_end_log")
        with pytest.raises(P.faults.InjectedFault):
            P.faults.check("log_read", "p")

    def test_arming_kernel_dispatch_raises(self):
        from hyperspace_tpu_torch.config import Config

        with pytest.raises(T.HyperspaceException, match="C.7"):
            tfaults.set_fault("kernel_dispatch", "persistent")
        conf = Config()
        conf.set("hyperspace.faults.kernel_dispatch", "transient")
        with pytest.raises(T.HyperspaceException, match="kernel_dispatch"):
            tfaults.configure(conf)
        assert tfaults.stats() == {}

    def test_points_of_later_modules_are_refused(self):
        # a point no ported module carries is refused, as in the reference
        for f in (tfaults, jfaults):
            with pytest.raises(ValueError):
                f.set_fault("not_a_point", "transient")
        # the fleet's send seam came with serve/fastbus.py (A.10b) and the
        # query log's point with obs/querylog.py (A.10a): both arm
        assert tfaults.set_fault("fastbus_send", "transient") is True
        assert tfaults.set_crash("mid_querylog_rotate", "raise") is True
        tfaults.reset()

    def test_serve_cache_points_arm(self):
        """The serve cache's points arm in the port as in the reference,
        by call and by config."""
        for f in (tfaults, jfaults):
            assert f.set_fault("cache_insert", "transient:2") is True
            assert f.set_crash("mid_spill_write", "raise;at=2") is True
            f.reset()
        from hyperspace_tpu_torch.config import Config

        conf = Config()
        conf.set("hyperspace.faults.cache_insert", "persistent")
        conf.set("hyperspace.faults.crash.mid_spill_write", "raise")
        assert tfaults.configure(conf) == 2
        assert tfaults.degraded("cache_insert", ("scan",)) is True
        with pytest.raises(tfaults.SimulatedCrash):
            tfaults.crash("mid_spill_write", "p")
        assert tfaults.stats() == {"cache_insert": 1, "crash.mid_spill_write": 1}

    @pytest.mark.parametrize("point", ["parquet_read", "log_read"])
    def test_fault_points_fire_at_their_sites_in_both_packages(self, tmp_path, point):
        def scenario(P, root):
            s, hs, src, log_mgr = mk_index(P, root)
            P.faults.set_fault(point, "transient:1")
            with pytest.raises(P.faults.InjectedFault):
                if point == "log_read":
                    log_mgr.get_latest_stable_log()
                else:
                    s.read.parquet(src).select("clicks").collect()
            # transient: the next call reads
            got = (log_mgr.get_latest_stable_log().state if point == "log_read"
                   else s.read.parquet(src).select("clicks").collect().num_rows)
            fired = P.faults.stats()
            P.faults.reset()
            return got, fired

        both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# Recovery unit behavior, as scenarios over either package
# ---------------------------------------------------------------------------


def _strand(P, log_mgr, state, owner, lease_ms):
    stable = log_mgr.get_latest_stable_log()
    stranded = stable.with_state(state)
    P.recovery.stamp_lease(stranded, owner, lease_ms)
    tip = log_mgr.get_latest_id() + 1
    assert log_mgr.write_log(tip, stranded)
    return tip


class TestRecoveryUnit:
    def test_lease_stamped_and_heartbeat_renews(self, tmp_path, monkeypatch):
        def scenario(P, root):
            s, hs, src, log_mgr = mk_index(P, root)
            append_file(src)
            cls = P.actions["refresh"].RefreshAction
            seen = {}
            orig_op = cls.op

            def slow_op(self):
                first = log_mgr.get_log(self.base_id + 1)
                time.sleep(LEASE_MS * 2.0 / 1000.0)
                seen["first"] = P.recovery.lease_expires_at(first, 0)
                seen["later"] = P.recovery.lease_expires_at(log_mgr.get_log(self.base_id + 1), 0)
                seen["owner"] = first.properties.get(P.recovery.LEASE_OWNER_PROP)
                return orig_op(self)

            monkeypatch.setattr(cls, "op", slow_op)
            hs.refresh_index("idx", "full")
            monkeypatch.undo()
            assert len(seen["owner"]) == 32
            assert seen["later"] > seen["first"]
            latest = log_mgr.get_latest_log()
            return P.recovery.LEASE_OWNER_PROP in latest.properties, latest.state

        assert both(scenario, tmp_path) == (False, "ACTIVE")

    def test_live_lease_blocks_auto_recovery(self, tmp_path):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            _strand(P, log_mgr, P.States.REFRESHING, "w1", 60_000)
            live = P.recovery.ensure_recovered(log_mgr, lease_ms=60_000)
            assert live["live_writer"] and not live["rolled_back"]
            later = P.recovery.ensure_recovered(
                log_mgr, lease_ms=60_000, now=P.recovery.now_ms() + 120_000
            )
            assert later["rolled_back"]
            return live, later, log_mgr.get_latest_log().state

        both(scenario, tmp_path)

    def test_rollback_occ_two_recoverers_single_roll(self, tmp_path):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            stable = log_mgr.get_latest_stable_log()
            tip = _strand(P, log_mgr, P.States.OPTIMIZING, "dead", 1)
            wait_lease()
            assert log_mgr.write_log(tip + 1, stable.copy())
            rolled, we_wrote = P.recovery.rollback(log_mgr, tip)
            assert not we_wrote
            return rolled.state, we_wrote, log_mgr.get_latest_id() - tip

        assert both(scenario, tmp_path) == ("ACTIVE", False, 1)

    def test_stale_pointer_healed(self, tmp_path):
        def scenario(P, root):
            _s, hs, src, log_mgr = mk_index(P, root)
            append_file(src)
            hs.refresh_index("idx", "full")
            latest = log_mgr.get_latest_id()
            log_mgr.create_latest_stable_log(latest - 2)
            assert log_mgr.get_latest_stable_pointer_id() == latest - 2
            rep = P.recovery.ensure_recovered(log_mgr, LEASE_MS)
            assert log_mgr.get_latest_stable_pointer_id() == latest
            return rep

        assert both(scenario, tmp_path)["healed_pointer"]

    def test_gc_skips_live_writer_version_dir(self, tmp_path):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            index_path = log_mgr.index_path
            _strand(P, log_mgr, P.States.REFRESHING, "live", 60_000)
            wip_dir = os.path.join(index_path, "v__=2")
            os.makedirs(wip_dir)
            wip = os.path.join(wip_dir, "part-wip.parquet")
            with open(wip, "w") as f:
                f.write("x")
            live = P.recovery.gc_orphans(index_path, grace_ms=0, lease_ms=60_000)
            assert os.path.isfile(wip)
            dead = P.recovery.gc_orphans(
                index_path, grace_ms=0, lease_ms=60_000, now=P.recovery.now_ms() + 120_000
            )
            assert not os.path.exists(wip)
            return live, dead

        live, dead = both(scenario, tmp_path)
        assert live["skipped_live_writer"] and live["quarantined_dirs"] == 0
        assert dead["quarantined_dirs"] == 1 and not dead["skipped_live_writer"]

    def test_gc_respects_pins_and_grace(self, tmp_path):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            index_path = log_mgr.index_path
            orphan_dir = os.path.join(index_path, "v__=9")
            os.makedirs(orphan_dir)
            orphan = os.path.join(orphan_dir, "part-orphan.parquet")
            with open(orphan, "w") as f:
                f.write("x")
            assert P.recovery.find_orphans(index_path) == [orphan]
            entry = log_mgr.get_latest_stable_log().copy()
            entry.content = P.Content.from_leaf_files([(orphan, 1, 1)])
            token = P.recovery.register_pins([entry])
            pinned = P.recovery.gc_orphans(index_path, grace_ms=0)
            assert os.path.isfile(orphan)
            P.recovery.release_pins(token)
            kept = P.recovery.gc_orphans(index_path, grace_ms=10 * 60_000)
            assert not os.path.exists(orphan)
            qroot = os.path.join(index_path, P.C.HYPERSPACE_QUARANTINE_DIR)
            held = quarantine(index_path)
            purged = P.recovery.gc_orphans(
                index_path, grace_ms=10 * 60_000, now=P.recovery.now_ms() + 11 * 60_000
            )
            assert not os.path.exists(qroot)
            return pinned, kept, held, purged

        pinned, kept, held, purged = both(scenario, tmp_path)
        assert pinned["kept_pinned"] == 1
        assert kept["quarantined_dirs"] == 1 and kept["purged_stamps"] == 0
        assert held == {"v__=9/part-orphan.parquet"}
        assert purged["purged_stamps"] == 1

    def test_torn_entry_is_stranded_not_fatal(self, tmp_path):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            tip = log_mgr.get_latest_id() + 1
            with open(log_mgr._path_for(tip), "w") as f:
                f.write('{"state": "REFRESH')
            with pytest.raises(P.exc.LogCorruptedError):
                log_mgr.get_log(tip)
            assert log_mgr.get_latest_stable_log().state == "ACTIVE"
            rep = P.recovery.ensure_recovered(log_mgr, LEASE_MS)
            return rep, log_mgr.get_latest_log().state

        rep, state = both(scenario, tmp_path)
        assert rep["rolled_back"] and state == "ACTIVE"

    def test_torn_first_create_clears_to_doesnotexist(self, tmp_path):
        def scenario(P, root):
            log_mgr = P.IndexLogManager(str(root / "fresh_idx"))
            os.makedirs(log_mgr.log_dir)
            with open(log_mgr._path_for(1), "w") as f:
                f.write("{notjson")
            rep = P.recovery.ensure_recovered(log_mgr, LEASE_MS)
            return rep, log_mgr.get_latest_id()

        rep, latest = both(scenario, tmp_path)
        assert rep["rolled_back"] and latest is None

    def test_recover_all_invalidates_entry_cache(self, tmp_path):
        def scenario(P, root):
            s, _hs, _src, log_mgr = mk_index(P, root)
            s.index_manager.get_indexes()
            _strand(P, log_mgr, P.States.REFRESHING, "dead", 1)
            wait_lease()
            reports = s.index_manager.recover_all()
            assert any(r["rolled_back"] for r in reports)
            fresh = s.index_manager.get_indexes([P.States.ACTIVE])
            assert [e.id for e in fresh] == [log_mgr.get_latest_id()]
            for r in reports:
                r.pop("index_path")
            return reports

        both(scenario, tmp_path)

    def test_session_attach_sweeps_stranded_entries(self, tmp_path):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            _strand(P, log_mgr, P.States.REFRESHING, "dead", 1)
            wait_lease()
            s2 = P.session(str(root / "sys"))
            assert s2.index_manager is not None  # the attach sweep
            return log_mgr.get_latest_log().state

        assert both(scenario, tmp_path) == "ACTIVE"

    def test_recovery_off_writes_no_lease_and_does_not_retry(self, tmp_path):
        def scenario(P, root):
            src = sample_source(root)
            s = P.session(str(root / "sys"))
            s.conf.set(P.C.RECOVERY_ENABLED, False)
            hs = P.Hyperspace(s)
            P.faults.set_crash("after_begin_log", "raise")
            with pytest.raises(P.faults.SimulatedCrash):
                hs.create_index(s.read.parquet(src),
                                P.CoveringIndexConfig("idx", ["clicks"], ["query"]))
            log_mgr, _ = s.index_manager._managers("idx")
            tip = log_mgr.get_latest_log()
            props = sorted(tip.properties)
            wait_lease()
            # no recovery at the next action's start: the tip blocks it
            with pytest.raises(P.exc.HyperspaceException):
                hs.create_index(s.read.parquet(src),
                                P.CoveringIndexConfig("idx", ["clicks"], ["query"]))
            return tip.state, P.recovery.LEASE_OWNER_PROP in props

        assert both(scenario, tmp_path) == ("CREATING", False)


def test_recovery_defaults_equal_reference():
    from hyperspace_tpu.config import Config as JConfig
    from hyperspace_tpu_torch.config import Config as TConfig

    t, j = TConfig(), JConfig()
    for key in ("recovery_enabled", "recovery_lease_ms", "recovery_orphan_grace_ms",
                "recovery_retry_max_attempts", "recovery_retry_backoff_ms",
                "serve_spill_orphan_ttl_ms"):
        assert getattr(t, key) == getattr(j, key), key
    assert (t.recovery_enabled, t.recovery_lease_ms, t.recovery_orphan_grace_ms,
            t.recovery_retry_max_attempts, t.recovery_retry_backoff_ms) == (
        True, 60_000, 600_000, 3, 10)
    JC, TC = pkg("jax").C, pkg("port").C
    for name in ("RECOVERY_ENABLED", "RECOVERY_LEASE_MS", "RECOVERY_ORPHAN_GRACE_MS",
                 "RECOVERY_RETRY_MAX_ATTEMPTS", "RECOVERY_RETRY_BACKOFF_MS", "FAULTS_KEY_PREFIX",
                 "CRASH_KEY_PREFIX", "HYPERSPACE_QUARANTINE_DIR", "HYPERSPACE_PINS_DIR",
                 "HYPERSPACE_SPILL_DIR", "FLEET_PIN_LEASE_MS_DEFAULT",
                 "SERVE_SPILL_ORPHAN_TTL_MS"):
        assert getattr(TC, name) == getattr(JC, name), name


# ---------------------------------------------------------------------------
# The sidecar publish seam
# ---------------------------------------------------------------------------


class TestSidecarPublishCrash:
    @pytest.mark.parametrize("match", ["_aggstate", "_aggsample"])
    def test_create_crashed_at_sidecar_publish_recovers(self, tmp_path, match):
        def scenario(P, root):
            src = sample_source(root)
            s = P.session(str(root / "sys"))
            hs = P.Hyperspace(s)
            cfg = P.CoveringIndexConfig("idx", ["clicks"], ["query"])
            log_mgr, _ = s.index_manager._managers("idx")
            P.faults.set_crash("mid_sidecar_publish", f"raise;match={match}")
            with pytest.raises(P.faults.SimulatedCrash):
                hs.create_index(s.read.parquet(src), cfg)
            crashed = log_mgr.get_latest_log().state
            wait_lease()
            rep = hs.recover("idx")
            hs.create_index(s.read.parquet(src), cfg)
            found = sorted(
                os.path.relpath(os.path.join(d, n), log_mgr.index_path)
                for d, _dirs, names in os.walk(log_mgr.index_path)
                for n in names if n == "_aggstate.json"
            )
            for f in found:
                with open(os.path.join(log_mgr.index_path, f)) as fh:
                    assert json.load(fh).get("files")
            serve_matches_source(s, src)
            return P.faults.stats(), crashed, rep, found, log_mgr.get_latest_log().state

        stats, crashed, rep, found, state = both(scenario, tmp_path)
        assert stats == {"crash.mid_sidecar_publish": 1}
        assert crashed == "CREATING" and rep["rolled_back"] and found and state == "ACTIVE"


# ---------------------------------------------------------------------------
# Cancel
# ---------------------------------------------------------------------------


class TestCancelDirect:
    @pytest.mark.parametrize(
        "transient", sorted(["CREATING", "REFRESHING", "OPTIMIZING", "VACUUMINGOUTDATED",
                             "DELETING", "RESTORING", "VACUUMING"])
    )
    def test_cancel_each_transient_state(self, tmp_path, transient):
        def scenario(P, root):
            s, hs, _src, log_mgr = mk_index(P, root)
            expect = P.States.ROLLBACK[transient]
            if expect == P.States.DELETED:
                hs.delete_index("idx")
            _strand(P, log_mgr, transient, "dead", 60_000)
            s.index_manager.clear_cache()
            hs.cancel("idx")
            tip = log_mgr.get_latest_log()
            return tip.state, P.recovery.LEASE_OWNER_PROP in tip.properties

        state, leased = both(scenario, tmp_path)
        assert not leased
        assert state == ("ACTIVE" if transient in ("CREATING", "REFRESHING", "OPTIMIZING",
                                                   "VACUUMINGOUTDATED", "DELETING")
                         else "DELETED")

    def test_cancel_of_failed_first_create(self, tmp_path, monkeypatch):
        def scenario(P, root):
            src = sample_source(root)
            s = P.session(str(root / "sys"))
            hs = P.Hyperspace(s)

            def boom(self):
                raise RuntimeError("op died")

            monkeypatch.setattr(P.actions["create"].CreateAction, "op", boom)
            with pytest.raises(RuntimeError):
                hs.create_index(s.read.parquet(src), P.CoveringIndexConfig("idx", ["clicks"]))
            monkeypatch.undo()
            log_mgr, _ = s.index_manager._managers("idx")
            failed = log_mgr.get_latest_log().state
            hs.cancel("idx")
            cancelled = log_mgr.get_latest_log().state
            hs.create_index(s.read.parquet(src), P.CoveringIndexConfig("idx", ["clicks"]))
            return failed, cancelled, log_mgr.get_latest_log().state

        assert both(scenario, tmp_path) == ("CREATING", "DOESNOTEXIST", "ACTIVE")

    def test_cancel_losing_commit_race_raises(self, tmp_path, monkeypatch):
        def scenario(P, root):
            s, _hs, _src, log_mgr = mk_index(P, root)
            stable = log_mgr.get_latest_stable_log()
            tip = _strand(P, log_mgr, P.States.REFRESHING, "live", 60_000)
            real_write = log_mgr.write_log
            done = []

            def writer_sneaks_in(log_id, entry):
                if log_id == tip + 1 and not done:
                    done.append(1)
                    real_write(tip + 1, stable.copy())
                return real_write(log_id, entry)

            monkeypatch.setattr(log_mgr, "write_log", writer_sneaks_in)
            with pytest.raises(P.exc.ConcurrentWriteException):
                P.actions["cancel"].CancelAction(s, "idx", log_mgr).run()
            monkeypatch.undo()
            return log_mgr.get_latest_log().state

        assert both(scenario, tmp_path) == "ACTIVE"

    def test_cancel_clears_torn_tip(self, tmp_path):
        def scenario(P, root):
            src = sample_source(root)
            s = P.session(str(root / "sys"))
            s.conf.set(P.C.RECOVERY_ENABLED, False)
            hs = P.Hyperspace(s)
            hs.create_index(s.read.parquet(src), P.CoveringIndexConfig("idx", ["clicks"], ["query"]))
            log_mgr, _ = s.index_manager._managers("idx")
            with open(log_mgr._path_for(log_mgr.get_latest_id() + 1), "w") as f:
                f.write('{"state": "REFRESH')
            hs.cancel("idx")
            return log_mgr.get_latest_log().state

        assert both(scenario, tmp_path) == "ACTIVE"

    def test_cancel_racing_live_writer_lease(self, tmp_path, monkeypatch):
        def scenario(P, root):
            s, hs, src, log_mgr = mk_index(P, root)
            # a lease that stays live however long the gated op waits
            s.conf.set(P.C.RECOVERY_LEASE_MS, 60_000)
            append_file(src)
            cls = P.actions["refresh"].RefreshAction
            in_op, release = threading.Event(), threading.Event()
            orig_op = cls.op

            def gated_op(self):
                in_op.set()
                assert release.wait(10)
                return orig_op(self)

            monkeypatch.setattr(cls, "op", gated_op)
            errors = []

            def run_refresh():
                try:
                    hs.refresh_index("idx", "full")
                except Exception as exc:
                    errors.append(exc)

            t = threading.Thread(target=run_refresh)
            t.start()
            assert in_op.wait(10)
            live = log_mgr.get_latest_log()
            assert not P.recovery.is_stranded(live, 60_000)
            hs.cancel("idx")
            release.set()
            t.join(30)
            monkeypatch.undo()
            return (live.state, [type(e).__name__ for e in errors],
                    log_mgr.get_latest_log().state)

        assert both(scenario, tmp_path) == (
            "REFRESHING", ["ConcurrentWriteException"], "ACTIVE")


def test_cancel_has_no_inlined_rollback():
    from hyperspace_tpu_torch.actions import cancel

    assert not hasattr(cancel, "rollback") and not hasattr(cancel, "_latest_stable_by_scan")


# ---------------------------------------------------------------------------
# base_id snapshot at run(), and the OCC retry
# ---------------------------------------------------------------------------


class TestBaseIdResnapshot:
    def test_queued_action_does_not_clobber(self, tmp_path):
        def scenario(P, root):
            s, hs, src, log_mgr = mk_index(P, root)
            queued = P.actions["delete"].DeleteAction(s, "idx", log_mgr)
            stale = queued.base_id
            append_file(src)
            hs.refresh_index("idx", "full")
            queued.run()
            tip = log_mgr.get_latest_log()
            return queued.base_id - stale, tip.state, tip.id - stale

        assert both(scenario, tmp_path) == (2, "DELETED", 4)

    def test_occ_loser_retries_from_fresh_snapshot(self, tmp_path, monkeypatch):
        def scenario(P, root):
            s, _hs, _src, log_mgr = mk_index(P, root)
            real_write = log_mgr.write_log
            fired = []
            dm = P.actions["delete"]

            def racing_write(log_id, entry):
                if not fired:
                    fired.append(1)
                    dm.DeleteAction(s, "idx", log_mgr).run()
                return real_write(log_id, entry)

            monkeypatch.setattr(log_mgr, "write_log", racing_write)
            with pytest.raises(P.exc.HyperspaceException, match="requires state"):
                dm.DeleteAction(s, "idx", log_mgr).run()
            monkeypatch.undo()
            dm.RestoreAction(s, "idx", log_mgr).run()
            return log_mgr.get_latest_log().state

        assert both(scenario, tmp_path) == "ACTIVE"

    def test_retries_stop_after_max_attempts(self, tmp_path, monkeypatch):
        def scenario(P, root):
            s, _hs, _src, log_mgr = mk_index(P, root)
            s.conf.set(P.C.RECOVERY_RETRY_MAX_ATTEMPTS, 2)
            calls = []
            monkeypatch.setattr(log_mgr, "write_log", lambda i, e: calls.append(i) or False)
            with pytest.raises(P.exc.ConcurrentWriteException, match="after 2 attempts"):
                P.actions["delete"].DeleteAction(s, "idx", log_mgr).run()
            monkeypatch.undo()
            return calls

        # the create wrote ids 1 and 2, so each attempt's begin id is 3
        assert both(scenario, tmp_path) == [3, 3]


# ---------------------------------------------------------------------------
# Kernel faults: never retried, never hidden (port only)
# ---------------------------------------------------------------------------


def test_a_kernel_fault_is_raised_once_and_the_next_action_rolls_it_back(
    tmp_path, monkeypatch
):
    """A ``KernelLaunchError`` out of ``op()`` propagates on the first
    attempt (no retry), leaves a leased REFRESHING entry, and the next
    refresh rolls it back by itself once the lease has expired."""
    from hyperspace_tpu_torch.actions import refresh as refresh_mod
    from hyperspace_tpu_torch.kernels import KERNEL_FAULTS, KernelLaunchError
    from hyperspace_tpu_torch.metadata import recovery

    P = pkg("port")
    s, hs, src, log_mgr = mk_index(P, tmp_path)
    append_file(src)
    calls = []
    orig_op = refresh_mod.RefreshIncrementalAction.op

    def faulty_op(self):
        calls.append(1)
        raise KernelLaunchError("hs_bucket_ids returned 700")

    monkeypatch.setattr(refresh_mod.RefreshIncrementalAction, "op", faulty_op)
    with pytest.raises(KERNEL_FAULTS):
        hs.refresh_index("idx", "incremental")
    assert calls == [1]
    tip = log_mgr.get_latest_log()
    assert tip.state == "REFRESHING"
    assert len(tip.properties[recovery.LEASE_OWNER_PROP]) == 32
    monkeypatch.setattr(refresh_mod.RefreshIncrementalAction, "op", orig_op)
    wait_lease()
    hs.refresh_index("idx", "incremental")
    states = [log_mgr.get_log(i).state for i in range(log_mgr.get_latest_id() + 1)
              if log_mgr.get_log(i) is not None]
    assert states[-4:] == ["REFRESHING", "ACTIVE", "REFRESHING", "ACTIVE"]
    assert recovery.find_orphans(log_mgr.index_path) == []
    serve_matches_source(s, src)


def test_a_kernel_fault_with_a_live_lease_blocks_the_next_action(tmp_path, monkeypatch):
    """Before its lease expires a faulted action's entry is a live writer's:
    the next action refuses, nothing rolls it back."""
    from hyperspace_tpu_torch.actions import refresh as refresh_mod
    from hyperspace_tpu_torch.kernels import KernelLaunchError

    P = pkg("port")
    s, hs, src, log_mgr = mk_index(P, tmp_path)
    s.conf.set(P.C.RECOVERY_LEASE_MS, 60_000)
    append_file(src)

    def faulty_op(self):
        raise KernelLaunchError("hs_zorder_interleave returned 700")

    monkeypatch.setattr(refresh_mod.RefreshAction, "op", faulty_op)
    with pytest.raises(KernelLaunchError):
        hs.refresh_index("idx", "full")
    monkeypatch.undo()
    with pytest.raises(T.HyperspaceException):
        hs.refresh_index("idx", "full")
    assert hs.recover("idx")["live_writer"]
    assert log_mgr.get_latest_log().state == "REFRESHING"


# ---------------------------------------------------------------------------
# Durable cross-process pins
# ---------------------------------------------------------------------------


class TestCrossProcessPins:
    def test_pin_file_published_and_released(self, tmp_path):
        def scenario(P, root):
            s, _hs, _src, log_mgr = mk_index(P, root)
            entries = s.index_manager.get_indexes([P.States.ACTIVE])
            token = P.recovery.register_pins(entries, durable=True, lease_ms=5_000)
            pins_dir = os.path.join(log_mgr.index_path, P.C.HYPERSPACE_PINS_DIR)
            names = os.listdir(pins_dir)
            assert len(names) == 1 and names[0].endswith(".json")
            pinned = P.recovery.durable_pinned_files(log_mgr.index_path)
            assert pinned == {p.replace("\\", "/") for p in entries[0].content.files}
            P.recovery.release_pins(token)
            assert P.recovery.durable_pinned_files(log_mgr.index_path) == set()
            return len(pinned), (not os.path.isdir(pins_dir) or not os.listdir(pins_dir))

        assert both(scenario, tmp_path)[1]

    def test_gc_from_process_b_respects_live_pin(self, tmp_path, monkeypatch):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            index_path = log_mgr.index_path
            orphan_dir = os.path.join(index_path, "v__=9")
            os.makedirs(orphan_dir)
            orphan = os.path.join(orphan_dir, "part-orphan.parquet")
            with open(orphan, "w") as f:
                f.write("x")
            entry = log_mgr.get_latest_stable_log().copy()
            entry.content = P.Content.from_leaf_files([(orphan, 1, 1)])
            token = P.recovery.register_pins([entry], durable=True, lease_ms=60_000,
                                             heartbeat=False)
            monkeypatch.setattr(P.recovery, "_active_pins", {})  # process B
            held = P.recovery.gc_orphans(index_path, grace_ms=0)
            assert os.path.isfile(orphan)
            expired = P.recovery.gc_orphans(index_path, grace_ms=0,
                                            now=P.recovery.now_ms() + 120_000)
            assert not os.path.exists(orphan)
            again = P.recovery.gc_orphans(index_path, grace_ms=0)
            monkeypatch.undo()
            P.recovery.release_pins(token)
            return held, expired, again

        held, expired, again = both(scenario, tmp_path)
        assert held["kept_pinned"] == 1 and held["reaped_pins"] == 0
        assert expired["reaped_pins"] == 1 and expired["quarantined_dirs"] == 1
        assert again["quarantined_files"] == 0 and again["quarantined_dirs"] == 0

    def test_vacuum_from_process_b_respects_live_pin(self, tmp_path, monkeypatch):
        def scenario(P, root):
            s, hs, src, log_mgr = mk_index(P, root)
            index_path = log_mgr.index_path
            old_files = set(log_mgr.get_latest_stable_log().content.files)
            entries = s.index_manager.get_indexes([P.States.ACTIVE])
            token = P.recovery.register_pins(entries, durable=True, lease_ms=60_000,
                                             heartbeat=False)
            append_file(src)
            hs.refresh_index("idx", "full")
            monkeypatch.setattr(P.recovery, "_active_pins", {})
            hs.vacuum_index("idx")
            kept = sorted(os.path.relpath(p, index_path) for p in old_files if os.path.isfile(p))
            assert len(kept) == len(old_files)
            pins_dir = os.path.join(index_path, P.C.HYPERSPACE_PINS_DIR)
            for name in os.listdir(pins_dir):
                p = os.path.join(pins_dir, name)
                with open(p) as fh:
                    doc = json.load(fh)
                doc["expiresAtMs"] = P.recovery.now_ms() - 1
                with open(p, "w") as fh:
                    json.dump(doc, fh)
            hs.vacuum_index("idx")
            assert not any(os.path.exists(p) for p in old_files)
            assert P.recovery.find_orphans(index_path) == []
            serve_matches_source(s, src)
            monkeypatch.undo()
            P.recovery.release_pins(token)
            return kept, sorted(os.listdir(index_path))

        both(scenario, tmp_path)

    def test_heartbeat_keeps_pin_alive(self, tmp_path):
        P = pkg("port")
        s, _hs, _src, log_mgr = mk_index(P, tmp_path)
        entries = s.index_manager.get_indexes([P.States.ACTIVE])
        token = P.recovery.register_pins(entries, durable=True, lease_ms=60)
        pins_dir = os.path.join(log_mgr.index_path, P.C.HYPERSPACE_PINS_DIR)

        def pin_names():
            return [n for n in os.listdir(pins_dir) if not n.startswith(".tmp_")]

        name = pin_names()[0]
        time.sleep(0.25)
        assert P.recovery.durable_pinned_files(log_mgr.index_path)
        assert pin_names() == [name]
        P.recovery.release_pins(token)

    def test_torn_pin_file_is_reaped(self, tmp_path):
        def scenario(P, root):
            _s, _hs, _src, log_mgr = mk_index(P, root)
            pins_dir = os.path.join(log_mgr.index_path, P.C.HYPERSPACE_PINS_DIR)
            os.makedirs(pins_dir, exist_ok=True)
            with open(os.path.join(pins_dir, "dead.1.json"), "w") as f:
                f.write('{"owner": "dead", "expi')
            files = P.recovery.durable_pinned_files(log_mgr.index_path)
            return files, (not os.path.isdir(pins_dir) or not os.listdir(pins_dir))

        assert both(scenario, tmp_path) == (set(), True)


# ---------------------------------------------------------------------------
# The spill tier's crash seam and the reaper's live set
# ---------------------------------------------------------------------------


def _spill_modules(P):
    import importlib

    root = "hyperspace_tpu_torch" if P.name == "port" else "hyperspace_tpu"
    sc = importlib.import_module(f"{root}.execution.serve_cache")
    col = importlib.import_module(f"{root}.io.columnar")
    return sc, col


class TestSpillWriteCrash:
    """``mid_spill_write``: a demotion killed between choosing its spill
    path and the atomic publish leaves no final ``.spill`` file, so a torn
    spill is never served, the reaper clears what is left, and the tier
    heals on the next demote."""

    def test_crash_mid_spill_write_never_serves_torn_state(self, tmp_path):
        import pyarrow as pa

        def scenario(P, root):
            sc, col = _spill_modules(P)
            rng = np.random.default_rng(11)
            batch = col.ColumnarBatch.from_arrow(pa.table({
                "k": rng.integers(0, 50, 2_000).astype(np.int64),
                "v": rng.normal(0, 1, 2_000)}))
            spill_dir = root / P.C.HYPERSPACE_SPILL_DIR
            nb = sc.batch_nbytes(batch)
            c = sc.ServeCache(max_bytes=nb + 16, spill_dir=str(spill_dir),
                              spill_max_bytes=1 << 30)
            c.put(("scan", "fp-a", ("k",)), batch, nb)
            P.faults.set_crash("mid_spill_write", "raise")
            # displacing fp-a pushes its demotion across the crash seam
            with pytest.raises(P.faults.SimulatedCrash):
                c.put(("zonemap", "fp-b"), "displacer", nb)
            fired = P.faults.stats().get("crash.mid_spill_write", 0)
            P.faults.reset()
            torn = [p for p in os.listdir(spill_dir) if p.endswith(".spill")] \
                if spill_dir.is_dir() else []
            miss = c.get(("scan", "fp-a", ("k",)))
            # the reaper clears the wreckage (ttl 0: all that no live cache
            # indexes has expired)
            P.recovery.reap_spill_orphans(str(root), ttl_ms=0)
            left = os.listdir(spill_dir) if spill_dir.is_dir() else []
            # the tier heals: a retried demote and restore round-trip
            c.put(("scan", "fp-a", ("k",)), batch, nb)
            c.put(("zonemap", "fp-c"), "displacer", nb)
            restored = c.get(("scan", "fp-a", ("k",)))
            return (fired, torn, c.spill_paths(), miss, left, c.spill_demotes,
                    restored.to_arrow().equals(batch.to_arrow()))

        assert both(scenario, tmp_path) == (1, [], set(), None, [], 1, True)

    def test_recover_keeps_live_spill_files(self, tmp_path):
        """``hs.recover`` with a live session cache whose spill tier holds
        demoted entries keeps their files (``kept_live``) and reaps an
        expired orphan beside them, in both packages."""

        def scenario(P, root):
            sc, _col = _spill_modules(P)
            s, hs, src, _log = mk_index(P, root)
            s.conf.set(P.C.SERVE_SPILL_ORPHAN_TTL_MS, 1)
            s.conf.set(P.C.SERVE_CACHE_ENABLED, True)
            s.conf.set(P.C.SERVE_SPILL_MAX_BYTES, 1 << 30)
            s.conf.set(P.C.SERVE_CACHE_MAX_BYTES, 1_000)
            cache = s.serve_cache
            for i in range(3):
                cache.put(("scan", f"fp-{i}"), np.arange(100, dtype=np.int64) + i, 800)
            spill = os.path.join(str(root / "sys"), P.C.HYPERSPACE_SPILL_DIR)
            with open(os.path.join(spill, "dead.spill"), "wb") as f:
                f.write(b"x")
            time.sleep(0.01)
            report = hs.recover("idx")["spill_gc"]
            live = sorted(os.path.basename(p) for p in cache.spill_paths())
            return report, len(live), sorted(os.listdir(spill)) == live

        assert both(scenario, tmp_path) == ({"reaped": 1, "kept_live": 2, "kept_young": 0}, 2,
                                            True)


def test_spill_reaper_finds_nothing_without_a_spill_tier_and_reaps_expired_files(tmp_path):
    from hyperspace_tpu_torch.metadata import recovery

    assert recovery.reap_spill_orphans(str(tmp_path)) == {
        "reaped": 0, "kept_live": 0, "kept_young": 0}
    spill = tmp_path / "_hyperspace_spill"
    spill.mkdir()
    (spill / "a.spill").write_bytes(b"x")
    (spill / ".tmp_spool_1").write_bytes(b"x")
    assert recovery.reap_spill_orphans(str(tmp_path), ttl_ms=10 * 60_000)["kept_young"] == 2
    assert recovery.reap_spill_orphans(str(tmp_path), ttl_ms=0)["reaped"] == 2


# ---------------------------------------------------------------------------
# A real process death (port only: a fresh interpreter, no JAX)
# ---------------------------------------------------------------------------

CHILD = """
import sys
import torch
torch.set_num_threads(1)  # as tests/torch_threads.py caps the workers
sys.path.insert(0, {repo!r})
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, CoveringIndexConfig
from hyperspace_tpu_torch.testing import faults

s = HyperspaceSession(device="cpu")
s.conf.set("hyperspace.system.path", {index_root!r})
s.conf.set("hyperspace.index.num_buckets", 8)
s.conf.set("hyperspace.index.lineage.enabled", True)
s.conf.set("hyperspace.recovery.leaseMs", {lease!r})
hs = Hyperspace(s)
faults.set_crash({point!r}, {spec!r})
{body}
raise SystemExit(7)  # never reached: the crash point exits first
"""

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_child(body, index_root, point, spec="exit", lease=LEASE_MS):
    code = CHILD.format(repo=REPO, index_root=index_root, point=point, spec=spec,
                        lease=lease, body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(index_root))
    assert proc.returncode == tfaults.CRASH_EXIT_CODE, (proc.returncode, proc.stderr[-2000:])


class TestSubprocessCrash:
    @pytest.mark.parametrize(("point", "spec"), [("mid_data_write", "exit;at=3"),
                                                 ("after_begin_log", "exit")])
    def test_child_create_killed_then_recovered(self, tmp_path, point, spec):
        P = pkg("port")
        src = sample_source(tmp_path)
        root = str(tmp_path / "sys")
        os.makedirs(root)
        # the parent's session attaches (and sweeps) before the child runs
        s = P.session(root)
        hs = P.Hyperspace(s)
        body = (f"hs.create_index(s.read.parquet({src!r}), "
                "CoveringIndexConfig('idx', ['clicks'], ['query']))")
        run_child(body, root, point, spec)
        log_mgr, _ = s.index_manager._managers("idx")
        assert log_mgr.get_latest_log().state == "CREATING"
        landed = data_files(log_mgr.index_path)
        assert len(landed) == (2 if point == "mid_data_write" else 0)
        wait_lease()
        rep = hs.recover("idx")
        assert rep["rolled_back"] and log_mgr.get_latest_log().state == "DOESNOTEXIST"
        assert rep["gc"]["quarantined_dirs"] == (1 if landed else 0)
        assert P.recovery.find_orphans(log_mgr.index_path) == []
        hs.create_index(s.read.parquet(src), P.CoveringIndexConfig("idx", ["clicks"], ["query"]))
        serve_matches_source(s, src)

    def test_child_before_its_lease_expires_is_a_live_writer(self, tmp_path):
        P = pkg("port")
        src = sample_source(tmp_path)
        root = str(tmp_path / "sys")
        os.makedirs(root)
        body = (f"hs.create_index(s.read.parquet({src!r}), "
                "CoveringIndexConfig('idx', ['clicks'], ['query']))")
        run_child(body, root, "mid_data_write", "exit;at=3", lease=60_000)
        s = P.session(root, lease_ms=60_000)
        hs = P.Hyperspace(s)
        log_mgr, _ = s.index_manager._managers("idx")
        files = data_files(log_mgr.index_path)
        rep = hs.recover("idx")
        assert rep["live_writer"] and rep["gc"]["skipped_live_writer"]
        assert data_files(log_mgr.index_path) == files and len(files) == 2
        assert log_mgr.get_latest_log().state == "CREATING"
        # once the child's lease has expired, the same repair rolls back
        later = P.recovery.now_ms() + 120_000
        assert P.recovery.ensure_recovered(log_mgr, 60_000, now=later)["rolled_back"]
        gc = P.recovery.gc_orphans(log_mgr.index_path, grace_ms=0, now=later, lease_ms=60_000)
        assert gc["quarantined_dirs"] == 1 and data_files(log_mgr.index_path) == set()

    def test_child_refresh_killed_after_end_log(self, tmp_path):
        P = pkg("port")
        s, hs, src, log_mgr = mk_index(P, tmp_path)
        append_file(src)
        run_child("hs.refresh_index('idx', 'full')", s.conf.get(P.C.INDEX_SYSTEM_PATH),
                  "after_end_log")
        tip_id = log_mgr.get_latest_id()
        assert log_mgr.get_latest_stable_pointer_id() != tip_id
        rep = hs.recover("idx")
        assert rep["healed_pointer"] and log_mgr.get_latest_stable_pointer_id() == tip_id
        assert P.recovery.find_orphans(log_mgr.index_path) == []
        serve_matches_source(s, src)


def test_a_crashed_create_after_a_hard_vacuum_is_not_collected_in_either_package(tmp_path):
    """A fault of the reference that the port reproduces (ROADMAP C.12): a
    hard vacuum empties the index, but the log keeps its stable entries,
    whose contents name the vacuumed ``v__=1`` files. A create of the same
    name writes ``v__=1`` again; if it crashes, the orphan GC reads those
    old entries, takes its half-written files for referenced, and leaves
    them. The retried create overwrites them, so the index ends right. (The
    crash fires in the pipelined writer's thread, so every bucket file but
    the crashed one landed.)"""

    def scenario(P, root):
        s, hs, src, log_mgr = mk_index(P, root)
        hs.delete_index("idx")
        hs.vacuum_index("idx")
        assert data_files(log_mgr.index_path) == set()
        cfg = P.CoveringIndexConfig("idx", ["clicks"], ["query"])
        P.faults.set_crash("mid_data_write", "raise;at=3")
        with pytest.raises(P.faults.SimulatedCrash):
            hs.create_index(s.read.parquet(src), cfg)
        wait_lease()
        rep = hs.recover("idx")
        left = sorted(data_files(log_mgr.index_path))
        orphans = P.recovery.find_orphans(log_mgr.index_path)
        hs.create_index(s.read.parquet(src), cfg)
        serve_matches_source(s, src)
        written = len(s.index_manager.get_index_log_entry("idx").content.files)
        return rep["rolled_back"], rep["gc"]["quarantined_dirs"], left, orphans, written

    rolled, moved, left, orphans, written = both(scenario, tmp_path)
    assert rolled and moved == 0 and len(left) == written - 1 and orphans == []
