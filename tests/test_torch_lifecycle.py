"""The port's index lifecycle against the JAX package: every case of
``tests/test_lifecycle.py`` and ``tests/test_factories.py`` as a
differential (``tests/torch_lifecycle_twin.py``: both packages in
lockstep over one source; log entries, index files and query rows
compared), an index maintained by one package and served by the other,
and a kernel fault during a refresh.

Three reference cases serve a quick-refreshed index through Hybrid
Scan's compensating ``Union``, in exact mode or with Hybrid Scan on: the
port serves it as the reference does, plan, tags and rows in order.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from hyperspace_tpu import constants as JC
from hyperspace_tpu_torch import constants as TC
from torch_lifecycle_twin import Twin, append_file

States = TC.States
HYBRID = "hyperspace.index.hybridscan.enabled"


@pytest.fixture
def twin(tmp_path, sample_parquet):
    return Twin(tmp_path / "sys", sample_parquet)


def _q_ge(lo):
    return lambda d: d.filter(d["clicks"] >= lo).select("clicks", "query")


def _port_serves(text: str) -> bool:
    return "Hyperspace" in text.split("Plan without indexes:")[0]


class TestDeleteRestoreVacuum:
    def test_delete_restore_roundtrip(self, twin):
        twin.create("covering", "idx", ["clicks"], ["query"])
        twin.run("delete_index", "idx")
        assert twin.state("idx") == States.DELETED
        _rows, text = twin.query(_q_ge(1))
        assert not _port_serves(text)
        twin.run("restore_index", "idx")
        assert twin.state("idx") == States.ACTIVE
        _rows, text = twin.query(_q_ge(1))
        assert "Name: idx" in text
        twin.assert_equal("idx")

    def test_delete_requires_active(self, twin):
        twin.create("covering", "idx", ["clicks"])
        twin.run("delete_index", "idx")
        twin.run_raises("requires state ACTIVE", "delete_index", "idx")
        twin.assert_equal("idx")

    def test_vacuum_deleted_removes_everything(self, twin):
        twin.create("covering", "idx", ["clicks"])
        twin.run("delete_index", "idx")
        twin.run("vacuum_index", "idx")
        assert twin.state("idx") == States.DOESNOTEXIST
        for sys_path in (twin.tsys, twin.jsys):
            assert os.listdir(os.path.join(sys_path, "idx")) == ["_hyperspace_log"]
        twin.assert_equal("idx")
        # the name is reusable after vacuum
        twin.create("covering", "idx", ["clicks"])
        assert twin.state("idx") == States.ACTIVE
        twin.assert_equal("idx")

    def test_vacuum_outdated_keeps_only_live_versions(self, twin):
        twin.create("covering", "idx", ["clicks"], ["query"])
        append_file(twin.src)
        twin.run("refresh_index", "idx", "full")  # new version dir v__=2
        twin.run("vacuum_index", "idx")  # ACTIVE -> vacuum outdated
        assert twin.state("idx") == States.ACTIVE
        assert twin.versions("idx") == twin.versions("idx", "jax") == ["v__=2"]
        rows, text = twin.query(_q_ge(9000))
        assert "Name: idx" in text and rows.num_rows == 3
        twin.assert_equal("idx")


class TestCancel:
    def test_cancel_rolls_back_transient_state(self, twin, monkeypatch):
        from hyperspace_tpu.actions import refresh as jrefresh
        from hyperspace_tpu_torch.actions import refresh as trefresh

        twin.create("covering", "idx", ["clicks"], ["query"])

        def boom(self):
            raise RuntimeError("simulated op failure")

        append_file(twin.src)
        monkeypatch.setattr(trefresh.RefreshAction, "op", boom)
        monkeypatch.setattr(jrefresh.RefreshAction, "op", boom)
        for _pkg, _s, hs in twin.sides():
            with pytest.raises(RuntimeError):
                hs.refresh_index("idx", "full")
        assert twin.latest_state("idx") == States.REFRESHING
        monkeypatch.undo()
        # every operation is blocked until cancel
        twin.run_raises("requires state ACTIVE", "delete_index", "idx")
        twin.run("cancel", "idx")
        assert twin.latest_state("idx") == States.ACTIVE
        twin.run("delete_index", "idx")
        assert twin.state("idx") == States.DELETED
        twin.assert_equal("idx")

    def test_cancel_requires_transient(self, twin):
        twin.create("covering", "idx", ["clicks"])
        twin.run_raises("transient", "cancel", "idx")
        twin.assert_equal("idx")


class TestRefresh:
    def _mk(self, twin, lineage=False):
        twin.set(JC.INDEX_LINEAGE_ENABLED, lineage)
        twin.create("covering", "idx", ["clicks"], ["query"])

    def test_refresh_full_after_append(self, twin):
        self._mk(twin)
        append_file(twin.src)
        twin.run("refresh_index", "idx", "full")
        rows, text = twin.query(_q_ge(9000))
        assert "Hyperspace(Type: CI, Name: idx" in text
        assert rows.num_rows == 3
        twin.assert_equal("idx")

    def test_refresh_noop_when_unchanged(self, twin):
        self._mk(twin)
        twin.run("refresh_index", "idx", "full")  # NoChangesException swallowed
        for _pkg, s, _hs in twin.sides():
            assert s.index_manager._managers("idx")[0].get_latest_id() == 2
        twin.assert_equal("idx")

    def test_refresh_incremental_append_only(self, twin):
        self._mk(twin)
        append_file(twin.src)
        twin.run("refresh_index", "idx", "incremental")
        entry = twin.t.index_manager.get_index_log_entry("idx")
        # the merged content spans two version dirs
        assert {f.split("v__=")[1].split("/")[0] for f in entry.content.files} == {"1", "2"}
        _rows, text = twin.query(_q_ge(500))
        assert "Name: idx" in text
        twin.assert_equal("idx")

    def test_refresh_incremental_delete_requires_lineage(self, twin):
        self._mk(twin, lineage=False)
        os.remove(os.path.join(twin.src, "part-0.parquet"))
        twin.run_raises("lineage", "refresh_index", "idx", "incremental")
        twin.assert_equal("idx")

    def test_refresh_incremental_with_deletes(self, twin):
        self._mk(twin, lineage=True)
        os.remove(os.path.join(twin.src, "part-0.parquet"))
        append_file(twin.src)
        twin.run("refresh_index", "idx", "incremental")
        rows, text = twin.query(_q_ge(0))
        assert "Name: idx" in text
        assert rows.num_rows == 203  # 300 - 100 deleted + 3 appended
        twin.assert_equal("idx")

    def test_refresh_quick_then_hybrid_serve(self, twin):
        self._mk(twin, lineage=True)
        append_file(twin.src)
        twin.run("refresh_index", "idx", "quick")
        entry = twin.t.index_manager.get_index_log_entry("idx")
        assert entry.relation.update is not None
        assert entry.relation.update.appended_files is not None
        twin.set(HYBRID, True)
        rows, text = twin.query(_q_ge(500))
        # the index serves through a compensating Union, as in the reference
        assert _port_serves(text) and "Union" in text
        assert "appended" in rows.column("query").to_pylist()
        twin.assert_equal("idx")

    def test_quick_then_incremental_materializes_pending_files(self, twin):
        """Files recorded by a quick refresh were never indexed; a later
        incremental refresh must still materialize them."""
        self._mk(twin, lineage=True)
        append_file(twin.src)
        twin.run("refresh_index", "idx", "quick")
        twin.run("refresh_index", "idx", "incremental")  # must NOT be a no-op
        entry = twin.t.index_manager.get_index_log_entry("idx")
        assert not entry.has_source_update
        rows, text = twin.query(_q_ge(9000))
        assert "Name: idx" in text and "Union" not in text
        assert rows.num_rows == 3  # the appended rows served from index data
        twin.assert_equal("idx")

    def test_refresh_quick_serves_in_exact_mode(self, twin):
        """A quick-refreshed index stays usable WITHOUT hybrid scan,
        compensated from the recorded Update delta, in both packages."""
        self._mk(twin, lineage=True)
        append_file(twin.src)
        twin.run("refresh_index", "idx", "quick")
        rows, text = twin.query(_q_ge(500))
        assert _port_serves(text) and "Union" in text
        assert "appended" in rows.column("query").to_pylist()
        twin.assert_equal("idx")

    def test_quick_refresh_delete_without_lineage_rejected_not_crashed(self, twin):
        """A lineage-less quick-refreshed index that recorded deletes is
        rejected (not crashed on) by both packages."""
        self._mk(twin, lineage=False)
        os.remove(os.path.join(twin.src, "part-0.parquet"))
        twin.run("refresh_index", "idx", "quick")
        rows, text = twin.query(_q_ge(0))
        assert not _port_serves(text)
        assert rows.num_rows == 200  # correct rows from the source scan
        twin.assert_equal("idx")

    def test_second_quick_refresh_after_delete(self, twin):
        self._mk(twin, lineage=True)
        os.remove(os.path.join(twin.src, "part-0.parquet"))
        twin.run("refresh_index", "idx", "quick")
        append_file(twin.src)
        twin.run("refresh_index", "idx", "quick")  # must not KeyError
        twin.set(HYBRID, True)
        rows, text = twin.query(_q_ge(0))
        # a third of the indexed bytes deleted passes the 0.2 limit: both
        # packages read the source, with the same plan
        assert not _port_serves(text)
        assert rows.num_rows == 203
        twin.assert_equal("idx")


class TestOptimize:
    def test_optimize_compacts_buckets(self, twin):
        twin.create("covering", "idx", ["clicks"], ["query"])
        append_file(twin.src, "e1")
        twin.run("refresh_index", "idx", "incremental")
        append_file(twin.src, "e2", clicks=(9101, 9102))
        twin.run("refresh_index", "idx", "incremental")
        files_before = len(twin.t.index_manager.get_index_log_entry("idx").content.files)
        twin.run("optimize_index", "idx", "full")
        entry = twin.t.index_manager.get_index_log_entry("idx")
        assert len(entry.content.files) < files_before
        _rows, text = twin.query(_q_ge(500))
        assert "Name: idx" in text
        twin.assert_equal("idx")

    def test_optimize_noop_single_files(self, twin):
        twin.create("covering", "idx", ["clicks"])
        twin.run("optimize_index", "idx", "full")  # one file a bucket: no-op
        for _pkg, s, _hs in twin.sides():
            assert s.index_manager._managers("idx")[0].get_latest_id() == 2
        twin.assert_equal("idx")

    def test_optimize_invalid_mode(self, twin):
        twin.create("covering", "idx", ["clicks"])
        twin.run_raises("mode", "optimize_index", "idx", "bogus")
        twin.assert_equal("idx")


# -- tests/test_factories.py: failing managers injected through the seams ----


@pytest.fixture
def kv_src(tmp_path):
    import numpy as np

    d = tmp_path / "src"
    d.mkdir()
    rng = np.random.default_rng(0)
    pq.write_table(
        pa.table(
            {
                "k": pa.array(rng.integers(0, 20, 100), type=pa.int64()),
                "v": pa.array(rng.normal(size=100)),
            }
        ),
        d / "a.parquet",
    )
    return str(d)


def _packages():
    """(name, factories module, log manager class, data manager class)."""
    from hyperspace_tpu import factories as jf
    from hyperspace_tpu.metadata.data_manager import IndexDataManager as JData
    from hyperspace_tpu.metadata.log_manager import IndexLogManager as JLog
    from hyperspace_tpu_torch import factories as tf
    from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager as TData
    from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager as TLog

    return (("port", tf, TLog, TData), ("jax", jf, JLog, JData))


def _failing_end(base):
    class FailingEndLogManager(base):
        """Crashes on the action's end-phase write (the second write_log)."""

        def __init__(self, path):
            super().__init__(path)
            self._writes = 0

        def write_log(self, log_id, entry):
            self._writes += 1
            if self._writes >= 2:
                raise OSError("injected: storage failed at end()")
            return super().write_log(log_id, entry)

    return FailingEndLogManager


def _fail_after(base, n):
    class FailAfterNWritesLogManager(base):
        """Crashes on the nth write_log call across all instances."""

        count = 0

        def write_log(self, log_id, entry):
            type(self).count += 1
            if type(self).count == n:
                raise OSError("injected: crash mid-refresh")
            return super().write_log(log_id, entry)

    return FailAfterNWritesLogManager


class TestFactories:
    def test_crash_at_end_leaves_transient_state_cancel_recovers(
        self, tmp_path, kv_src, monkeypatch
    ):
        twin = Twin(tmp_path / "sys", kv_src)
        for (pkg, s, hs), (_n, fac, log_cls, _d) in zip(twin.sides(), _packages()):
            monkeypatch.setattr(fac, "log_manager_factory", _failing_end(log_cls))
            with pytest.raises(OSError, match="injected"):
                hs.create_index(s.read.parquet(kv_src),
                                _config(pkg, "fidx", ["k"], ["v"]))
            monkeypatch.setattr(fac, "log_manager_factory", log_cls)
        twin.clear_cache()
        assert twin.latest_state("fidx") == States.CREATING
        # further operations are blocked until cancel
        twin.run_raises("requires ACTIVE", "refresh_index", "fidx")
        twin.run("cancel", "fidx")
        assert twin.latest_state("fidx") in States.STABLE_STATES
        twin.assert_equal("fidx")
        twin.clear_cache()
        twin.create("covering", "fidx2", ["k"], ["v"])
        assert twin.state("fidx2") == States.ACTIVE
        twin.assert_equal("fidx2")

    def test_data_manager_failure_does_not_corrupt_log(self, tmp_path, kv_src, monkeypatch):
        class FailingDataManager:
            def __init__(self, path):
                raise OSError("injected: data manager unavailable")

        twin = Twin(tmp_path / "sys", kv_src)
        for (pkg, s, hs), (_n, fac, _l, data_cls) in zip(twin.sides(), _packages()):
            monkeypatch.setattr(fac, "data_manager_factory", FailingDataManager)
            with pytest.raises(OSError, match="injected"):
                hs.create_index(s.read.parquet(kv_src), _config(pkg, "didx", ["k"], ["v"]))
            monkeypatch.setattr(fac, "data_manager_factory", data_cls)
            s.index_manager.clear_cache()
            # nothing was written: the index does not exist
            assert s.index_manager.get_index_log_entry("didx") is None
        twin.create("covering", "didx", ["k"], ["v"])
        assert twin.state("didx") == States.ACTIVE
        twin.assert_equal("didx")

    def test_crash_during_refresh_recovers_to_previous_version(
        self, tmp_path, kv_src, monkeypatch
    ):
        """A refresh that crashes at end() leaves REFRESHING; cancel() rolls
        back to the previous ACTIVE version and the index still serves."""
        import numpy as np

        twin = Twin(tmp_path / "sys", kv_src)
        twin.create("covering", "ridx", ["k"], ["v"])
        rng = np.random.default_rng(1)
        pq.write_table(
            pa.table({"k": pa.array(rng.integers(0, 20, 30), type=pa.int64()),
                      "v": pa.array(rng.normal(size=30))}),
            os.path.join(kv_src, "b.parquet"),
        )
        twin.clear_cache()
        for (_pkg, _s, hs), (_n, fac, log_cls, _d) in zip(twin.sides(), _packages()):
            monkeypatch.setattr(fac, "log_manager_factory", _fail_after(log_cls, 2))
            with pytest.raises(OSError, match="injected"):
                hs.refresh_index("ridx", "full")
            monkeypatch.setattr(fac, "log_manager_factory", log_cls)
        twin.clear_cache()
        assert twin.latest_state("ridx") == States.REFRESHING
        twin.run("cancel", "ridx")
        twin.clear_cache()
        assert twin.state("ridx") == States.ACTIVE
        # the rolled-back index still serves the ORIGINAL data correctly
        one = Twin(tmp_path / "sys", os.path.join(kv_src, "a.parquet"))
        rows, text = one.query(lambda d: d.filter(d["k"] == 3).select("k", "v"))
        assert "Name: ridx" in text and rows.num_rows > 0
        twin.assert_equal("ridx")


def _config(pkg, name, indexed, included):
    from torch_lifecycle_twin import config

    return config(pkg, "covering", name, indexed, included)


# -- one package maintains, the other serves ---------------------------------


@pytest.mark.parametrize("maintainer", ["port", "jax", "alternating"])
def test_each_package_serves_the_index_the_other_maintained(tmp_path, sample_parquet,
                                                            maintainer):
    """An index refreshed (incremental, after an append and a delete),
    optimized and vacuumed by one package, or by the two in turns, is
    served by either with equal rows; every file and entry it wrote equals
    what the other package writes for the same steps."""
    from torch_lifecycle_twin import config

    ref = Twin(tmp_path / "ref", sample_parquet, lineage=True)
    ref.create("covering", "idx", ["clicks"], ["query"])
    shared = Twin(tmp_path / "shared", sample_parquet, lineage=True)
    # one system path for both packages: the port's session over the jax one
    shared.t.conf.set("hyperspace.system.path", shared.jsys)
    shared.tsys = shared.jsys
    order = {"port": ["port"] * 4, "jax": ["jax"] * 4,
             "alternating": ["port", "jax", "port", "jax"]}[maintainer]
    hs = {"port": shared.ths, "jax": shared.jhs}
    sess = {"port": shared.t, "jax": shared.j}
    hs[order[0]].create_index(sess[order[0]].read.parquet(sample_parquet),
                              config(order[0], "covering", "idx", ["clicks"], ["query"]))
    append_file(sample_parquet, "e1")
    os.remove(os.path.join(sample_parquet, "part-1.parquet"))
    steps = [("refresh_index", "idx", "incremental"), ("optimize_index", "idx", "full"),
             ("vacuum_index", "idx")]
    for who, (op, *args) in zip(order[1:], steps):
        sess[who].index_manager.clear_cache()
        getattr(hs[who], op)(*args)
        ref.run(op, *args)
    assert ref.versions("idx") == shared.versions("idx", "jax")
    assert ref.log_entries("idx", "jax") == shared.log_entries("idx", "jax")
    assert ref.index_files("idx", "jax") == shared.index_files("idx", "jax")
    rows, text = shared.query(_q_ge(500))
    assert "Name: idx" in text
    assert rows.equals(ref.query(_q_ge(500))[0])


# -- a kernel fault during a refresh ------------------------------------------


def test_a_b1_fault_during_refresh_fails_it_and_leaves_the_transient_entry(
    tmp_path, sample_parquet, monkeypatch
):
    """A fault of kernel B1 (here raised where the build calls it, as the
    wrapper raises an error code on the card) fails the refresh: nothing
    catches it, the REFRESHING entry stays for cancel, and after cancel the
    refresh runs as the JAX package's. The same fault from the real
    wrapper on a CUDA tensor: ``tests/test_torch_cuda.py``."""
    from hyperspace_tpu_torch.indexes import covering_build
    from hyperspace_tpu_torch.kernels import KernelLaunchError

    twin = Twin(tmp_path / "sys", sample_parquet)
    twin.create("covering", "idx", ["clicks"], ["query"])
    append_file(twin.src)

    def faulty(reps, num_buckets, seed=42):
        raise KernelLaunchError("murmur3 bucket kernel launch failed: CUDA error 700")

    monkeypatch.setattr(covering_build, "bucket_ids", faulty)
    with pytest.raises(KernelLaunchError):
        twin.ths.refresh_index("idx", "incremental")
    log = twin.t.index_manager._managers("idx")[0]
    assert log.get_latest_log().state == States.REFRESHING
    assert twin.t.index_manager.get_index_log_entry("idx").state == States.ACTIVE
    monkeypatch.undo()
    twin.ths.cancel("idx")
    twin.t.index_manager.clear_cache()
    twin.ths.refresh_index("idx", "incremental")
    twin.jhs.refresh_index("idx", "incremental")
    assert twin.index_files("idx", "port") == twin.index_files("idx", "jax")
    entries = twin.log_entries("idx", "port")
    assert [entries[str(i)]["state"] for i in range(1, 7)] == [
        "CREATING", "ACTIVE", "REFRESHING", "ACTIVE", "REFRESHING", "ACTIVE"]
    assert entries["6"] == twin.log_entries("idx", "jax")["4"]


def test_log_manager_versions_pointer_and_deletes_match_reference(twin):
    """The log manager's lifecycle reads and deletes: the ids of entries
    in given states (newest first, also through the manager), the id the
    latestStable pointer records, the pointer's delete (the backward scan
    still finds the stable entry) and the whole log's delete."""
    twin.create("covering", "idx", ["clicks"], ["query"])
    twin.run("delete_index", "idx")
    twin.run("restore_index", "idx")
    append_file(twin.src)
    twin.run("refresh_index", "idx", "full")
    logs = [s.index_manager._managers("idx")[0] for _p, s, _h in twin.sides()]
    for states in ([States.ACTIVE], [States.DELETED, States.DELETING], [States.VACUUMING]):
        got = [log.get_index_versions(states) for log in logs]
        assert got[0] == got[1]
        assert twin.t.index_manager.get_index_versions("idx", states) == got[0]
    assert logs[0].get_index_versions([States.ACTIVE]) == [8, 6, 2]
    assert [log.get_latest_stable_pointer_id() for log in logs] == [8, 8]
    for log in logs:
        log.delete_latest_stable_log()
    assert [log.get_latest_stable_pointer_id() for log in logs] == [None, None]
    assert [log.get_latest_stable_log().id for log in logs] == [8, 8]
    for log in logs:
        log.delete_log()
        assert log.get_latest_id() is None and not os.path.exists(log.log_dir)
