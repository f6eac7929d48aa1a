"""The port's twin of ``tests/test_utils.py``: the filesystem helpers, the
data-path filter, column resolution and the multi-file read, each case
through both packages on the same files.

Each case keeps the reference's asserts and holds the port's answers to
the JAX package's: the OCC create-if-absent (also with writers of both
packages racing for one path), listings, resolved columns and read
tables (rows in order).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_b5_cases import same_rows
from torch_corpus_twin import JAX, PORT

BOTH = (PORT, JAX)


def test_atomic_write_if_absent(tmp_path):
    out = []
    for P in BOTH:
        files = P.m("utils.files")
        p = str(tmp_path / P.name / "log" / "1")
        got = [files.atomic_write_if_absent(p, "first"), files.atomic_write_if_absent(p, "second"),
               files.read_text(p)]
        assert got == [True, False, "first"]
        out.append(got)
    assert out[0] == out[1]
    # a writer of the other package loses the race on the path, too
    assert JAX.m("utils.files").atomic_write_if_absent(str(tmp_path / "port" / "log" / "1"), "x") is False
    assert PORT.m("utils.files").atomic_write_if_absent(str(tmp_path / "jax" / "log" / "1"), "x") is False


def test_atomic_write_concurrent(tmp_path):
    """16 writers, eight of each package, race for one path: exactly one
    wins (the OCC contract across the two packages)."""
    p = str(tmp_path / "log" / "7")
    results = []

    def writer(i):
        results.append(BOTH[i % 2].m("utils.files").atomic_write_if_absent(p, f"writer-{i}"))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(results) == 1
    assert PORT.m("utils.files").read_text(p) == JAX.m("utils.files").read_text(p)
    assert PORT.m("utils.files").read_text(p).startswith("writer-")


def test_list_leaf_files(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "x.txt").write_text("xx")
    (tmp_path / "a" / "b" / "y.txt").write_text("yyy")
    (tmp_path / "a" / "_hidden").write_text("h")
    out = []
    for P in BOTH:
        files = P.m("utils.files")
        listed = files.list_leaf_files(str(tmp_path))
        names = sorted(os.path.basename(p) for p, _, _ in listed)
        assert names == ["_hidden", "x.txt", "y.txt"]
        sizes = {os.path.basename(p): s for p, s, _ in listed}
        assert sizes == {"_hidden": 1, "x.txt": 2, "y.txt": 3}
        out.append((listed, files.list_leaf_files(str(tmp_path), data_only=True),
                    files.list_leaf_files(str(tmp_path), suffix=".txt")))
    assert out[0] == out[1]


@pytest.mark.parametrize("path", ["/x/part-0.parquet", "/x/_hyperspace_log", "/x/.hidden", "/x/_SUCCESS",
                                  "part-1.c000.parquet"])
def test_data_path_filter(path):
    mine, ref = (P.m("utils.paths").is_data_path(path) for P in BOTH)
    assert mine == ref == (path.endswith(".parquet"))


def test_resolve_case_insensitive():
    out = []
    for P in BOTH:
        R = P.m("utils.resolver")
        got = [R.resolve(["Query", "CLICKS"], ["query", "clicks", "imprs"]),
               R.resolve(["nope"], ["query"]), R.resolve(["Query"], ["query"], case_sensitive=True)]
        assert got == [[R.ResolvedColumn("query"), R.ResolvedColumn("clicks")], None, None]
        out.append([None if g is None else [(c.name, c.is_nested) for c in g] for g in got])
    assert out[0] == out[1]


def test_resolve_nested():
    out = []
    for P in BOTH:
        R = P.m("utils.resolver")
        r = R.resolve(["a.b"], ["x"], nested_available=["a.b"])
        assert r == [R.ResolvedColumn("a.b", True)]
        assert r[0].normalized_name == "__hs_nested.a.b"
        back = R.ResolvedColumn.from_normalized("__hs_nested.a.b")
        assert back.is_nested and back.name == "a.b"
        out.append((r[0].name, r[0].is_nested, r[0].normalized_name))
    assert out[0] == out[1]


def test_multi_file_type_widening(tmp_path):
    p1, p2 = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"y": pa.array([1, 2], type=pa.int32())}), p1)
    big = 1 << 40
    pq.write_table(pa.table({"y": pa.array([big], type=pa.int64())}), p2)
    mine, ref = (P.pio.read_table([p1, p2]) for P in BOTH)
    assert mine.column("y").type == pa.int64() and mine.column("y").to_pylist() == [1, 2, big]
    assert same_rows(mine, ref)


def test_multi_file_same_schema_order(tmp_path):
    paths = []
    for i in range(6):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"x": pa.array([i] * 3)}), p)
        paths.append(p)
    mine, ref = (P.pio.read_table(paths) for P in BOTH)
    assert mine.column("x").to_pylist() == [v for i in range(6) for v in [i] * 3]
    assert same_rows(mine, ref)
    shuffled = [paths[i] for i in np.random.default_rng(4).permutation(len(paths))]
    mine, ref = (P.pio.read_table(shuffled) for P in BOTH)
    assert mine.column("x").to_pylist() == [int(p[-9]) for p in shuffled for _ in range(3)]
    assert same_rows(mine, ref)
