"""The public members of ROADMAP A.11, held to the JAX package's on the
CPU. Those the reference's tests call: ``FileIdTracker.get_file_id`` and
``.id_to_file_mapping``, ``IndexLogEntry.source_file_info_set`` and
``.index_data_dir_id``, ``ResolvedColumn.from_normalized``,
``join_exec.co_bucketed_join``, ``Config.unset`` and ``faults.clear``.
Those with no caller in either package: ``IndexSignatureProvider.
fingerprint_source_only``, ``utils/files.write_text`` and ``dir_size``,
``utils/paths.normalize``, ``io/parquet.read_batch``, and the ``Config``
properties of four keys that nothing reads (``device_filter_min_rows``,
``device_join_min_rows``, ``dataskipping_target_index_data_file_size``,
``dataskipping_auto_partition_sketch``).
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


# -- the members with no caller in either package (A.11) ---------------------


def test_fingerprint_source_only_equals_the_reference(tmp_path):
    """The source-only signature of a scan, before and after an append,
    equals the JAX package's, and equals the file signature inside the full
    fingerprint."""
    from hyperspace_tpu.signatures import IndexSignatureProvider as JProvider
    from hyperspace_tpu_torch.signatures import IndexSignatureProvider

    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(pa.table({"k": np.arange(20, dtype=np.int64)}), str(src / "a.parquet"))
    t, j = T.HyperspaceSession(device="cpu"), JSession()

    def sigs():
        out = []
        for s, cls in ((t, IndexSignatureProvider), (j, JProvider)):
            scan = s.read.parquet(str(src)).logical_plan
            p = cls(s.source_manager)
            sig = p.fingerprint_source_only(scan)
            assert sig == p.fingerprint(scan).signatures[0]
            out.append((sig.provider, sig.value))
        assert out[0] == out[1]
        return out[0]

    before = sigs()
    pq.write_table(pa.table({"k": np.arange(5, dtype=np.int64)}), str(src / "b.parquet"))
    assert sigs() != before


def test_write_text_and_dir_size_equal_the_reference(tmp_path):
    from hyperspace_tpu.utils import files as jfiles
    from hyperspace_tpu_torch.utils import files

    for mod, root in ((files, tmp_path / "port"), (jfiles, tmp_path / "jax")):
        mod.write_text(str(root / "a" / "b" / "x.txt"), "héllo")  # makes its dirs
        mod.write_text(str(root / "a" / "y.txt"), "yy")
        mod.write_text(str(root / "a" / "y.txt"), "yyy")  # overwrites
        assert mod.read_text(str(root / "a" / "b" / "x.txt")) == "héllo"
    assert files.dir_size(str(tmp_path / "port")) == jfiles.dir_size(str(tmp_path / "jax")) == 9
    assert files.dir_size(str(tmp_path / "none")) == jfiles.dir_size(str(tmp_path / "none")) == 0


@pytest.mark.parametrize("path", ["rel/dir/", "/abs/x/../y", "gs://bucket/data/", "s3://b",
                                  ".", "/a//b/"])
def test_paths_normalize_equals_the_reference(path, monkeypatch, tmp_path):
    from hyperspace_tpu.utils import paths as jpaths
    from hyperspace_tpu_torch.utils import paths

    monkeypatch.chdir(tmp_path)
    assert paths.normalize(path) == jpaths.normalize(path)


def test_read_batch_equals_the_reference(tmp_path):
    from hyperspace_tpu.io import parquet as jpio
    from hyperspace_tpu_torch.io import parquet as pio

    rng = np.random.default_rng(2)
    files = []
    for i in range(2):
        p = str(tmp_path / f"p{i}.parquet")
        pq.write_table(pa.table({"k": rng.integers(0, 9, 30), "f": rng.normal(size=30),
                                 "s": [f"s{x}" for x in rng.integers(0, 4, 30)]}), p)
        files.append(p)
    for cols in (None, ["f", "k"]):
        got = pio.read_batch(files, cols)
        assert isinstance(got, ColumnarBatch) and got.num_rows == 60
        assert same_rows(got.to_arrow(), jpio.read_batch(files, cols).to_arrow())


@pytest.mark.parametrize("prop,key,value", [
    ("device_filter_min_rows", "EXECUTION_DEVICE_FILTER_MIN_ROWS", 12),
    ("device_join_min_rows", "EXECUTION_DEVICE_JOIN_MIN_ROWS", 7),
    ("dataskipping_target_index_data_file_size", "DATASKIPPING_TARGET_INDEX_DATA_FILE_SIZE", 1024),
    ("dataskipping_auto_partition_sketch", "DATASKIPPING_AUTO_PARTITION_SKETCH", False),
])
def test_unread_config_properties_equal_the_reference(prop, key, value):
    """Each property returns its key's value with the reference's default;
    no module of the port reads it."""
    mine, ref = Config(), JConfig()
    assert getattr(TC, key) == getattr(JC, key)
    assert getattr(mine, prop) == getattr(ref, prop) == getattr(TC, key + "_DEFAULT")
    for c, C in ((mine, TC), (ref, JC)):
        c.set(getattr(C, key), str(value))
    assert getattr(mine, prop) == getattr(ref, prop) == value
