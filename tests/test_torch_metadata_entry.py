"""The port's twin of ``tests/test_metadata_entry.py``: the log-entry model
(``metadata/entry.py``), each case through both packages.

Every case builds the same entry, content tree or tracker in each
package, keeps the reference's asserts and holds the port's result to
the JAX package's: the serialized dict (``to_dict``) as JSON text equal
apart from the entry's timestamp, and an entry serialized by either
package reads back in the other equal to its own.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import json

import pytest
from torch_corpus_twin import JAX, PORT

BOTH = (PORT, JAX)


def make_entry(P, state="ACTIVE", num_buckets=8):
    """``tests/test_metadata_entry.py::make_entry`` in package ``P``."""
    M = P.m("metadata.entry")
    src_content = M.Content.from_leaf_files(
        [("/data/t/part-0.parquet", 100, 1000), ("/data/t/part-1.parquet", 200, 2000)])
    idx_content = M.Content.from_leaf_files([("/idx/v__=0/part-00000.parquet", 10, 1)])
    index = P.m("indexes.covering").CoveringIndex(["k"], ["v"], "{}", num_buckets)
    rel = M.Relation(["/data/t"], src_content, "{}", "parquet")
    return M.IndexLogEntry(
        name="myIndex", derived_dataset=index, content=idx_content,
        source=M.Source(M.SourcePlan([rel])),
        fingerprint=M.LogicalPlanFingerprint([M.Signature("file", "abc123")]),
        state=state, id=2)


def _text(d) -> str:
    """The serialized entry as JSON text, without its timestamp (the time
    the entry was made)."""
    d = dict(d)
    d.pop("timestamp", None)
    return json.dumps(d, sort_keys=True)


def test_fileinfo_equality_ignores_id():
    for P in BOTH:
        FileInfo = P.m("metadata.entry").FileInfo
        a, b = FileInfo("f", 1, 2, id=5), FileInfo("f", 1, 2, id=9)
        assert a == b and hash(a) == hash(b)
        assert a != FileInfo("f", 1, 3, id=5)
    assert hash(PORT.m("metadata.entry").FileInfo("f", 1, 2, id=5)) == hash(
        JAX.m("metadata.entry").FileInfo("f", 1, 2, id=5))


def test_directory_from_leaf_files_builds_tree():
    out = []
    for P in BOTH:
        c = P.m("metadata.entry").Content.from_leaf_files(
            [("/a/b/f1", 1, 10), ("/a/b/f2", 2, 20), ("/a/c/f3", 3, 30)])
        assert sorted(c.files) == ["/a/b/f1", "/a/b/f2", "/a/c/f3"]
        assert c.size_in_bytes == 6
        root = c.root
        assert root.name == "/" and [d.name for d in root.subdirs] == ["a"]
        assert sorted(d.name for d in root.subdirs[0].subdirs) == ["b", "c"]
        out.append(_text(c.to_dict()))
    assert out[0] == out[1]


def test_directory_merge_unions_files():
    out = []
    for P in BOTH:
        Content = P.m("metadata.entry").Content
        c1 = Content.from_leaf_files([("/a/b/f1", 1, 10), ("/a/b/f2", 2, 20)])
        c2 = Content.from_leaf_files([("/a/b/f2", 2, 20), ("/a/d/f4", 4, 40)])
        merged = c1.merge(c2)
        assert sorted(merged.files) == ["/a/b/f1", "/a/b/f2", "/a/d/f4"]
        assert merged.size_in_bytes == 7
        out.append(_text(merged.to_dict()))
    assert out[0] == out[1]


def test_directory_merge_name_mismatch_raises():
    msgs = []
    for P in BOTH:
        with pytest.raises(P.HyperspaceException) as e:
            P.m("metadata.entry").Directory("a").merge(P.m("metadata.entry").Directory("b"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_file_id_tracker_stable_ids():
    out = []
    for P in BOTH:
        t = P.m("metadata.entry").FileIdTracker()
        a, b = t.add_file("/x/f1", 1, 10), t.add_file("/x/f2", 2, 20)
        assert (a, b) == (0, 1)
        assert t.add_file("/x/f1", 1, 10) == 0
        assert t.add_file("/x/f1", 1, 99) == 2
        assert t.max_id == 2
        mapping = dict(t.id_to_file_mapping())
        assert mapping[0] == "/x/f1" and mapping[1] == "/x/f2"
        out.append(sorted(t.id_to_file_mapping()))
    assert out[0] == out[1]


def test_file_id_tracker_seed_conflict():
    msgs = []
    for P in BOTH:
        M = P.m("metadata.entry")
        t = M.FileIdTracker()
        t.add_file_info("/x/f1", M.FileInfo("f1", 1, 10, id=7))
        assert t.get_file_id("/x/f1", 1, 10) == 7 and t.max_id == 7
        with pytest.raises(P.HyperspaceException) as e:
            t.add_file_info("/x/f1", M.FileInfo("f1", 1, 10, id=8))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_log_entry_json_roundtrip():
    dicts = {}
    for P in BOTH:
        entry = make_entry(P)
        d = entry.to_dict()
        back = P.m("metadata.entry").IndexLogEntry.from_dict(d)
        assert back == entry
        assert back.derived_dataset.indexed_columns == ["k"]
        assert back.derived_dataset.num_buckets == 8
        assert back.relation.root_paths == ["/data/t"]
        assert back.source_files_size_in_bytes == 300
        dicts[P.name] = d
    assert _text(dicts["port"]) == _text(dicts["jax"])
    # each package reads the other's serialized entry as its own
    for reader, writer in ((PORT, "jax"), (JAX, "port")):
        back = reader.m("metadata.entry").IndexLogEntry.from_dict(json.loads(json.dumps(dicts[writer])))
        assert _text(back.to_dict()) == _text(make_entry(reader).to_dict())


def test_copy_with_update_records_delta():
    out = []
    for P in BOTH:
        M = P.m("metadata.entry")
        entry = make_entry(P)
        appended = M.Content.from_leaf_files([("/data/t/part-2.parquet", 50, 3000)])
        deleted = M.Content.from_leaf_files([("/data/t/part-0.parquet", 100, 1000)])
        fp = M.LogicalPlanFingerprint([M.Signature("file", "newsig")])
        updated = entry.copy_with_update(appended, deleted, fp)
        assert entry.relation.update is None
        files = updated.source_file_info_set()
        assert "/data/t/part-2.parquet" in files and "/data/t/part-1.parquet" in files
        assert "/data/t/part-0.parquet" not in files
        assert updated.fingerprint.signatures[0].value == "newsig"
        back = M.IndexLogEntry.from_dict(updated.to_dict())
        assert back.source_file_info_set().keys() == files.keys()
        out.append((_text(updated.to_dict()), sorted(files)))
    assert out[0] == out[1]


def test_tags_are_per_plan_and_not_serialized():
    out = []
    for P in BOTH:
        entry = make_entry(P)
        entry.set_tag("plan1", "HYBRIDSCAN_REQUIRED", True)
        assert entry.get_tag("plan1", "HYBRIDSCAN_REQUIRED") is True
        assert entry.get_tag("plan2", "HYBRIDSCAN_REQUIRED") is None
        back = P.m("metadata.entry").IndexLogEntry.from_dict(entry.to_dict())
        assert back.get_tag("plan1", "HYBRIDSCAN_REQUIRED") is None
        out.append(_text(entry.to_dict()))
    assert out[0] == out[1]


def test_index_data_dir_id():
    assert make_entry(PORT).index_data_dir_id() == make_entry(JAX).index_data_dir_id() == 0


def test_scheme_qualified_paths_roundtrip():
    out = []
    for P in BOTH:
        Content = P.m("metadata.entry").Content
        c = Content.from_leaf_files([("gs://bucket/data/f1.parquet", 5, 1),
                                     ("gs://bucket/data/sub/f2.parquet", 6, 2)])
        assert sorted(c.files) == ["gs://bucket/data/f1.parquet", "gs://bucket/data/sub/f2.parquet"]
        back = Content.from_dict(c.to_dict())
        assert sorted(back.files) == sorted(c.files)
        out.append(_text(c.to_dict()))
    assert out[0] == out[1]
