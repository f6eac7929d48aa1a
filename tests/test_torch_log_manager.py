"""The port's twin of ``tests/test_log_manager.py``: the operation log
(``metadata/log_manager.py``), the data manager's versions, the path
resolver and torn-entry handling, each case through both packages.

Each case runs the reference's steps on each package's manager, in a
directory of its own, keeps the reference's asserts and holds the port's
answers to the JAX package's: ``write_log``'s OCC results, ids, states,
``latestStable``, versions, errors, and the log files byte for byte. Log
entries written by one package are read by the other's manager.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re
import threading

import pytest
from test_torch_metadata_entry import make_entry
from torch_corpus_twin import JAX, PORT, assert_same

BOTH = (PORT, JAX)


def _log_files(root) -> dict:
    """Name -> bytes of each log file, the entry's timestamp (the time of
    the write) replaced by 0."""
    d = os.path.join(root, "_hyperspace_log")
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = re.sub(rb'"timestamp": \d+', b'"timestamp": 0', f.read())
    return out


def _each(tmp_path, case):
    """``case(P, index_path)`` for each package in a directory of its own;
    the observations equal; returns the two index paths."""
    obs, paths = {}, {}
    for P in BOTH:
        paths[P.name] = str(tmp_path / P.name / "idx")
        obs[P.name] = case(P, paths[P.name])
    assert_same(obs["port"], obs["jax"])
    return paths


def test_write_and_read_log(tmp_path):
    def case(P, path):
        mgr = P.IndexLogManager(path)
        assert mgr.write_log(0, make_entry(P, state=P.States.CREATING)) is True
        got = mgr.get_log(0)
        assert got is not None and got.state == P.States.CREATING
        assert mgr.get_latest_id() == 0
        return _log_files(path)

    paths = _each(tmp_path, case)
    # each package reads the other's entry as it reads its own
    for reader, writer in ((PORT, "jax"), (JAX, "port")):
        got = reader.IndexLogManager(paths[writer]).get_log(0)
        assert got == reader.IndexLogManager(paths[reader.name]).get_log(0)


def test_write_log_occ_conflict(tmp_path):
    def case(P, path):
        mgr = P.IndexLogManager(path)
        first = mgr.write_log(0, make_entry(P, state=P.States.CREATING))
        second = mgr.write_log(0, make_entry(P, state=P.States.CREATING))
        assert (first, second) == (True, False)
        return _log_files(path)

    paths = _each(tmp_path, case)
    # a writer of the other package loses the race on the same id, too
    assert PORT.IndexLogManager(paths["jax"]).write_log(0, make_entry(PORT)) is False
    assert JAX.IndexLogManager(paths["port"]).write_log(0, make_entry(JAX)) is False


def test_latest_stable_pointer_and_fallback(tmp_path):
    def case(P, path):
        S = P.States
        mgr = P.IndexLogManager(path)
        obs = [mgr.get_latest_stable_log()]
        assert obs[0] is None
        assert mgr.write_log(0, make_entry(P, state=S.CREATING))
        assert mgr.get_latest_stable_log() is None
        assert mgr.write_log(1, make_entry(P, state=S.ACTIVE))
        found = mgr.get_latest_stable_log()
        assert found is not None and found.state == S.ACTIVE and found.id == 1
        assert mgr.create_latest_stable_log(1) is True
        found2 = mgr.get_latest_stable_log()
        assert found2 is not None and found2.id == 1
        assert mgr.write_log(2, make_entry(P, state=S.REFRESHING))
        refused = mgr.create_latest_stable_log(2)
        assert refused is False
        return {"files": _log_files(path), "pointer": mgr.get_latest_stable_pointer_id()}

    paths = _each(tmp_path, case)
    for reader, writer in ((PORT, "jax"), (JAX, "port")):
        mgr = reader.IndexLogManager(paths[writer])
        assert mgr.get_latest_stable_pointer_id() == 1
        assert mgr.get_latest_stable_log().id == 1


def test_get_index_versions(tmp_path):
    def case(P, path):
        S = P.States
        mgr = P.IndexLogManager(path)
        for i, st in enumerate((S.CREATING, S.ACTIVE, S.REFRESHING, S.ACTIVE)):
            mgr.write_log(i, make_entry(P, state=st))
        active = mgr.get_index_versions([S.ACTIVE])
        transient = mgr.get_index_versions([S.CREATING, S.REFRESHING])
        assert (active, transient) == ([3, 1], [2, 0])
        return [active, transient]

    paths = _each(tmp_path, case)
    assert PORT.IndexLogManager(paths["jax"]).get_index_versions([PORT.States.ACTIVE]) == [3, 1]


def test_data_manager_versions(tmp_path):
    def case(P, path):
        dm = P.IndexDataManager(path)
        assert dm.get_latest_version_id() is None
        os.makedirs(dm.get_path(0))
        os.makedirs(dm.get_path(3))
        obs = [dm.get_all_versions(), dm.get_latest_version_id(), os.path.relpath(dm.get_path(3), path)]
        assert obs == [[0, 3], 3, "v__=3"]
        dm.delete(3)
        obs.append(dm.get_latest_version_id())
        assert obs[-1] == 0
        return obs

    _each(tmp_path, case)


@pytest.mark.parametrize("path", ["/idx/v__=7/part-0.parquet", "/idx/v__=12", "/idx/nope/part-0.parquet",
                                  "/a/v__=3/b/v__=9/x.parquet", "v__=0"])
def test_version_from_path(path):
    mine, ref = (P.m("metadata.data_manager").version_from_path(path) for P in BOTH)
    assert mine == ref
    want = {"/idx/v__=7/part-0.parquet": 7, "/idx/v__=12": 12, "/idx/nope/part-0.parquet": None}
    if path in want:
        assert mine == want[path]


def test_path_resolver_case_insensitive(tmp_path):
    os.makedirs(str(tmp_path / "MyIndex"))
    out = []
    for P in BOTH:
        conf = P.m("config").Config({P.C.INDEX_SYSTEM_PATH: str(tmp_path)})
        r = P.m("metadata.path_resolver").PathResolver(conf)
        got = [r.get_index_path("myindex"), r.get_index_path("other"), r.all_index_paths()]
        assert got == [str(tmp_path / "MyIndex"), str(tmp_path / "other"), [str(tmp_path / "MyIndex")]]
        out.append(got)
    assert out[0] == out[1]


def test_write_log_does_not_stamp_id_on_conflict(tmp_path):
    def case(P, path):
        mgr = P.IndexLogManager(path)
        winner = make_entry(P, state=P.States.CREATING)
        assert mgr.write_log(0, winner) and winner.id == 0
        loser = make_entry(P, state=P.States.CREATING)
        loser.id = 99
        assert mgr.write_log(0, loser) is False
        assert loser.id == 99
        return [winner.id, loser.id]

    _each(tmp_path, case)


def test_concurrent_writers_exactly_one_wins(tmp_path):
    """8 threads, four of each package, race to write one log id: exactly
    one create-if-absent succeeds, and the stored entry, read by either
    package, is the winner's."""
    path = str(tmp_path / "idx")
    results = {}
    barrier = threading.Barrier(8)

    def writer(i):
        P = BOTH[i % 2]
        mgr = P.IndexLogManager(path)
        entry = make_entry(P, state=P.States.CREATING)
        entry.name = f"writer-{i}"
        barrier.wait()
        results[i] = mgr.write_log(1, entry)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    winners = [i for i, ok in results.items() if ok]
    assert len(winners) == 1, results
    for P in BOTH:
        assert P.IndexLogManager(path).get_log(1).name == f"writer-{winners[0]}"


def test_torn_entry_raises_typed_error(tmp_path):
    def case(P, path):
        LogCorruptedError = P.m("exceptions").LogCorruptedError
        mgr = P.IndexLogManager(path)
        assert mgr.write_log(0, make_entry(P, state=P.States.ACTIVE))
        with open(mgr._path_for(1), "w") as f:
            f.write('{"state": "REFRESH')
        with pytest.raises(LogCorruptedError) as e:
            mgr.get_log(1)
        assert "1" in e.value.path and e.value.reason
        return [os.path.relpath(e.value.path, path), e.value.reason]

    _each(tmp_path, case)


def test_stable_scan_and_versions_skip_torn_entries(tmp_path):
    def case(P, path):
        mgr = P.IndexLogManager(path)
        assert mgr.write_log(0, make_entry(P, state=P.States.CREATING))
        assert mgr.write_log(1, make_entry(P, state=P.States.ACTIVE))
        with open(mgr._path_for(2), "w") as f:
            f.write("not json at all")
        found = mgr.get_latest_stable_log()
        assert found is not None and found.id == 1
        assert mgr.get_index_versions([P.States.ACTIVE]) == [1]
        return found.id

    _each(tmp_path, case)


def test_torn_pointer_falls_back_to_scan(tmp_path):
    def case(P, path):
        mgr = P.IndexLogManager(path)
        assert mgr.write_log(0, make_entry(P, state=P.States.ACTIVE))
        assert mgr.create_latest_stable_log(0)
        with open(mgr._latest_stable_path, "w") as f:
            f.write('{"truncat')
        assert mgr.get_latest_stable_pointer_id() is None
        found = mgr.get_latest_stable_log()
        assert found is not None and found.id == 0
        return found.id

    _each(tmp_path, case)


def test_overwrite_log_replaces_in_place(tmp_path):
    def case(P, path):
        mgr = P.IndexLogManager(path)
        entry = make_entry(P, state=P.States.REFRESHING)
        assert mgr.write_log(3, entry)
        entry.properties["recovery.leaseExpiresAtMs"] = "12345"
        mgr.overwrite_log(3, entry)
        got = mgr.get_log(3)
        assert got.properties["recovery.leaseExpiresAtMs"] == "12345" and got.id == 3
        return _log_files(path)

    paths = _each(tmp_path, case)
    for reader, writer in ((PORT, "jax"), (JAX, "port")):
        got = reader.IndexLogManager(paths[writer]).get_log(3)
        assert got.properties["recovery.leaseExpiresAtMs"] == "12345"
