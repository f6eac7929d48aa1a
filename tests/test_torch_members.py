"""The public members of ROADMAP A.11 that the reference's tests call,
held to the JAX package's on the CPU: ``FileIdTracker.get_file_id`` and
``.id_to_file_mapping``, ``IndexLogEntry.source_file_info_set`` and
``.index_data_dir_id``, ``ResolvedColumn.from_normalized``,
``join_exec.co_bucketed_join``, ``Config.unset`` and ``faults.clear``.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_b5_cases import same_rows

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.config import Config as JConfig
from hyperspace_tpu.execution import join_exec as jjoin
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JCfg
from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.metadata.entry import FileIdTracker as JTracker
from hyperspace_tpu.metadata.entry import FileInfo as JFileInfo
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu.testing import faults as jfaults
from hyperspace_tpu.utils.resolver import ResolvedColumn as JResolved
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.config import Config
from hyperspace_tpu_torch.execution import join_exec
from hyperspace_tpu_torch.io.columnar import ColumnarBatch
from hyperspace_tpu_torch.metadata.entry import FileIdTracker, FileInfo
from hyperspace_tpu_torch.testing import faults
from hyperspace_tpu_torch.utils.resolver import NESTED_FIELD_PREFIX, ResolvedColumn


def _fill(tracker, info_cls):
    tracker.add_file("/lake/a.parquet", 10, 1)
    tracker.add_file("/lake/b.parquet", 20, 2)
    tracker.add_file_info("/lake/c.parquet", info_cls("/lake/c.parquet", 30, 3, 7))
    return tracker


def test_file_id_tracker_lookups_equal_the_reference():
    mine, ref = _fill(FileIdTracker(), FileInfo), _fill(JTracker(), JFileInfo)
    for key in (("/lake/a.parquet", 10, 1), ("/lake/c.parquet", 30, 3),
                ("/lake/a.parquet", 11, 1), ("/nope", 0, 0)):
        assert mine.get_file_id(*key) == ref.get_file_id(*key)
    assert mine.get_file_id("/lake/c.parquet", 30, 3) == 7
    assert mine.get_file_id("/nope", 0, 0) is None
    assert sorted(mine.id_to_file_mapping()) == sorted(ref.id_to_file_mapping())
    assert sorted(mine.id_to_file_mapping())[-1] == (7, "/lake/c.parquet")


@pytest.mark.parametrize("name", ["k", "a.b.c", NESTED_FIELD_PREFIX + "a.b", NESTED_FIELD_PREFIX])
def test_resolved_column_from_normalized_equals_the_reference(name):
    mine, ref = ResolvedColumn.from_normalized(name), JResolved.from_normalized(name)
    assert (mine.name, mine.is_nested) == (ref.name, ref.is_nested)
    assert mine.normalized_name == ref.normalized_name == name


def test_config_unset_equals_the_reference():
    mine, ref = Config(), JConfig()
    for c in (mine, ref):
        c.set("hyperspace.x", 1)
        v = c.version
        c.unset("hyperspace.x")
        assert c.get("hyperspace.x") is None and c.version == v + 1
        c.unset("hyperspace.x")  # absent: no change, no version bump
        assert c.version == v + 1


def test_faults_clear_disarms_and_keeps_the_totals():
    for f in (faults, jfaults):
        f.reset()
        try:
            f.set_fault("parquet_read", "persistent")
            with pytest.raises(OSError):
                f.check("parquet_read", "x")
            fired = f.stats()
            f.clear()
            f.check("parquet_read", "x")  # disarmed
            assert f.stats() == fired and fired.get("parquet_read") == 1
        finally:
            f.reset()
        assert f.stats() == {}


def _sides(batch_cls, seed=3):
    rng = np.random.default_rng(seed)
    lbs, rbs = {}, {}
    for b in range(4):
        lbs[b] = batch_cls.from_arrow(pa.table({"k": rng.integers(0, 20, 50),
                                                "v": rng.integers(0, 1000, 50)}))
        if b != 2:  # a bucket on the left side only
            rbs[b] = batch_cls.from_arrow(pa.table({"j": rng.integers(0, 20, 30),
                                                    "w": rng.normal(0.0, 1.0, 30)}))
    return lbs, rbs


def test_co_bucketed_join_equals_the_reference():
    lbs, rbs = _sides(ColumnarBatch)
    jl, jr = _sides(JBatch)
    got = join_exec.co_bucketed_join(lbs, rbs, [("k", "j")], None, device="cpu").to_arrow()
    want = jjoin.co_bucketed_join(jl, jr, [("k", "j")]).to_arrow()
    assert got.num_rows > 0 and same_rows(got, want)
    assert join_exec.co_bucketed_join(lbs, {}, [("k", "j")], device="cpu") is None
    assert join_exec.co_bucketed_join({0: lbs[2]}, {1: rbs[1]}, [("k", "j")],
                                      device="cpu") is None


def test_co_bucketed_join_defaults_to_the_card(monkeypatch):
    import torch

    from hyperspace_tpu_torch.exceptions import HyperspaceException

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lbs, rbs = _sides(ColumnarBatch)
    with pytest.raises(HyperspaceException, match="CUDA"):
        join_exec.co_bucketed_join(lbs, rbs, [("k", "j")])


def test_entry_members_equal_the_reference(tmp_path):
    """``source_file_info_set`` (after a quick refresh recorded an append
    and a delete) and ``index_data_dir_id`` (after a full refresh) of the
    port's entry equal the JAX package's over one lake."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(7)
    for i in range(3):
        pq.write_table(pa.table({"k": rng.integers(0, 100, 200), "v": rng.integers(0, 9, 200)}),
                       str(src / f"p{i}.parquet"))
    roots = {"port": tmp_path / "tix", "jax": tmp_path / "jix"}
    t = T.HyperspaceSession(device="cpu")
    t.conf.set(TC.INDEX_SYSTEM_PATH, str(roots["port"]))
    t.conf.set(TC.INDEX_LINEAGE_ENABLED, True)
    j = JSession()
    j.conf.set(JC.INDEX_SYSTEM_PATH, str(roots["jax"]))
    j.conf.set(JC.INDEX_LINEAGE_ENABLED, True)
    ths, jhs = T.Hyperspace(t), JHyperspace(j)
    ths.create_index(t.read.parquet(str(src)), T.CoveringIndexConfig("ix", ["k"], ["v"]))
    jhs.create_index(j.read.parquet(str(src)), JCfg("ix", ["k"], ["v"]))

    def entries():
        return [next(e for e in s.index_manager.get_indexes() if e.name == "ix") for s in (t, j)]

    def infos(entry):
        return {p: (i.size, i.modified_time, i.id) for p, i in entry.source_file_info_set().items()}

    te, je = entries()
    assert te.index_data_dir_id() == je.index_data_dir_id()
    assert infos(te) == infos(je) and len(infos(te)) == 3
    pq.write_table(pa.table({"k": rng.integers(0, 100, 50), "v": rng.integers(0, 9, 50)}),
                   str(src / "p3.parquet"))
    (src / "p0.parquet").unlink()
    ths.refresh_index("ix", "quick")
    jhs.refresh_index("ix", "quick")
    te, je = entries()
    assert te.has_source_update and je.has_source_update
    assert infos(te) == infos(je)
    assert any(p.endswith("p3.parquet") for p in infos(te))
    assert not any(p.endswith("p0.parquet") for p in infos(te))
    first = te.index_data_dir_id()
    ths.refresh_index("ix", "full")
    jhs.refresh_index("ix", "full")
    te, je = entries()
    assert te.index_data_dir_id() == je.index_data_dir_id() == first + 1
