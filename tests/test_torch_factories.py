"""The port's twin of ``tests/test_factories.py``: a failing log or data
manager injected through each package's ``factories`` seam, and the
action protocol's recovery contract, through both packages
(``torch_corpus_twin.twin``) at the reference's mesh sizes.

A crash at the end of an action leaves the same transient state in both
packages, which blocks further actions until ``cancel()`` rolls it back
to the last stable state; a data manager that fails writes nothing; a
refresh that crashes at its end rolls back to the previous version,
which still serves. The log entries after each step, the index files
byte for byte and the served rows equal the JAX package's, and each
package serves the other's rolled-back index.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pytest
from torch_corpus_twin import shards, sorted_table, twin, write  # noqa: F401


def _src(ctx):
    rng = np.random.default_rng(0)
    d = ctx.path("src")
    write(os.path.join(d, "a.parquet"), pa.table({
        "k": pa.array(rng.integers(0, 20, 100), type=pa.int64()),
        "v": pa.array(rng.normal(size=100))}))
    return d


def _failing_end(P):
    class FailingEndLogManager(P.IndexLogManager):
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


def _latest_state(P, s, name):
    return s.index_manager._managers(name)[0].get_latest_log().state


def test_crash_at_end_leaves_transient_state_cancel_recovers(tmp_path, shards, monkeypatch):
    def scenario(P, ctx):
        s, hs = ctx.session, ctx.hs
        df = s.read.parquet(_src(ctx))
        ctx.monkeypatch.setattr(P.factories, "log_manager_factory", _failing_end(P))
        with pytest.raises(OSError, match="injected"):
            hs.create_index(df, P.CoveringIndexConfig("fidx", ["k"], ["v"]))
        ctx.monkeypatch.setattr(P.factories, "log_manager_factory", P.IndexLogManager)
        s.index_manager.clear_cache()
        states = [_latest_state(P, s, "fidx")]
        assert states[0] == P.States.CREATING
        with pytest.raises(P.HyperspaceException) as blocked:
            hs.refresh_index("fidx")
        hs.cancel("fidx")
        states.append(_latest_state(P, s, "fidx"))
        assert states[1] in P.States.STABLE_STATES
        s.index_manager.clear_cache()
        hs.create_index(df, P.CoveringIndexConfig("fidx2", ["k"], ["v"]))
        states.append(s.index_manager.get_index_log_entry("fidx2").state)
        assert states[2] == P.States.ACTIVE
        ctx.cross(lambda P, s: s.read.parquet(ctx.path("src")).filter(
            s.read.parquet(ctx.path("src"))["k"] == 3).select("k", "v"))
        return {"states": states, "blocked": str(blocked.value)}

    twin(tmp_path, scenario, shards, monkeypatch)


def test_data_manager_failure_does_not_corrupt_log(tmp_path, shards, monkeypatch):
    def scenario(P, ctx):
        s, hs = ctx.session, ctx.hs
        df = s.read.parquet(_src(ctx))

        class FailingDataManager:
            def __init__(self, path):
                raise OSError("injected: data manager unavailable")

        ctx.monkeypatch.setattr(P.factories, "data_manager_factory", FailingDataManager)
        with pytest.raises(OSError, match="injected"):
            hs.create_index(df, P.CoveringIndexConfig("didx", ["k"], ["v"]))
        ctx.monkeypatch.setattr(P.factories, "data_manager_factory", P.IndexDataManager)
        s.index_manager.clear_cache()
        assert s.index_manager.get_index_log_entry("didx") is None
        left = sorted(os.listdir(ctx.sys)) if os.path.isdir(ctx.sys) else []
        hs.create_index(df, P.CoveringIndexConfig("didx", ["k"], ["v"]))
        assert s.index_manager.get_index_log_entry("didx").state == P.States.ACTIVE
        return {"left": left}

    twin(tmp_path, scenario, shards, monkeypatch)


def test_crash_during_refresh_recovers_to_previous_version(tmp_path, shards, monkeypatch):
    def scenario(P, ctx):
        s, hs = ctx.session, ctx.hs
        src = _src(ctx)
        df = s.read.parquet(src)
        hs.create_index(df, P.CoveringIndexConfig("ridx", ["k"], ["v"]))
        rng2 = np.random.default_rng(1)
        write(os.path.join(src, "b.parquet"), pa.table({
            "k": pa.array(rng2.integers(0, 20, 30), type=pa.int64()), "v": pa.array(rng2.normal(size=30))}))
        s.index_manager.clear_cache()

        class FailAfterNWritesLogManager(P.IndexLogManager):
            fail_at, count = 2, [0]

            def write_log(self, log_id, entry):
                self.count[0] += 1
                if self.count[0] == self.fail_at:
                    raise OSError("injected: crash mid-refresh")
                return super().write_log(log_id, entry)

        ctx.monkeypatch.setattr(P.factories, "log_manager_factory", FailAfterNWritesLogManager)
        with pytest.raises(OSError, match="injected"):
            hs.refresh_index("ridx", P.C.REFRESH_MODE_FULL)
        ctx.monkeypatch.setattr(P.factories, "log_manager_factory", P.IndexLogManager)
        s.index_manager.clear_cache()
        states = [_latest_state(P, s, "ridx")]
        assert states[0] == P.States.REFRESHING
        hs.cancel("ridx")
        s.index_manager.clear_cache()
        states.append(s.index_manager.get_index_log_entry("ridx").state)
        assert states[1] == P.States.ACTIVE

        def q(P, s):
            df0 = s.read.parquet(os.path.join(src, "a.parquet"))
            return df0.filter(df0["k"] == 3).select("k", "v")

        s.enable_hyperspace()
        plan, got = q(P, s).explain(), q(P, s).collect()
        ctx.cross(q)
        s.disable_hyperspace()
        base = q(P, s).collect()
        assert sorted_table(got).equals(sorted_table(base))
        return {"states": states, "plan": plan, "got": got, "base": base}

    twin(tmp_path, scenario, shards, monkeypatch)
