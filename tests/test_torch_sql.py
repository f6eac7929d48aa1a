"""The port's SQL surface against the JAX package, on the CPU.

Every case of ``tests/test_sql.py`` runs through both packages over the
same seeded views: ``session.sql`` parses to the same logical plan
(``pretty()`` equal), the optimizer rewrites it alike (equal apart from
the system path) and the rows are equal in order, floats bit for bit.
Each reference assertion is held on the port too. The plan checks cover
the three spots the grammar could drift on: the ``DATE`` literal and its
type, negative literals, and ``NOT IN`` with a ``NULL``.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_b5_cases import same_rows

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.exceptions import HyperspaceException as JHyperspaceException
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes.covering import CoveringIndexConfig as JCoveringIndexConfig
from hyperspace_tpu.session import HyperspaceSession as JSession


def sorted_table(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


class Pair:
    """A port session (``device="cpu"``) and a JAX-package session, each
    with its own system path, over the same views."""

    def __init__(self, root):
        self.tsys, self.jsys = os.path.join(root, "port"), os.path.join(root, "jax")
        self.t = T.HyperspaceSession(device="cpu")
        self.t.conf.set("hyperspace.system.path", self.tsys)
        self.t.conf.set("hyperspace.index.num_buckets", 8)
        self.j = JSession()
        self.j.conf.set(JC.INDEX_SYSTEM_PATH, self.jsys)
        self.j.conf.set(JC.INDEX_NUM_BUCKETS, 8)
        self.j.conf.set(JC.BUILD_NUM_SHARDS, 1)

    def sides(self):
        return (("port", self.t), ("jax", self.j))

    def register(self, name: str, path: str, via_df: bool = True) -> None:
        for _pkg, s in self.sides():
            df = s.read.parquet(path)
            if via_df:
                df.create_or_replace_temp_view(name)
            else:
                s.register_view(name, df)

    def sql(self, query: str):
        """Both packages' DataFrames for ``query``: logical plans equal,
        optimized plans equal apart from the system path, rows equal in
        order. Returns (port rows, jax rows, port DataFrame)."""
        tdf, jdf = self.t.sql(query), self.j.sql(query)
        assert tdf.logical_plan.pretty() == jdf.logical_plan.pretty()
        topt = self.t.optimize(tdf.logical_plan).pretty().replace(self.tsys, "<sys>")
        jopt = self.j.optimize(jdf.logical_plan).pretty().replace(self.jsys, "<sys>")
        assert topt == jopt
        got, want = tdf.collect(), jdf.collect()
        assert same_rows(got, want), query
        return got, want, tdf


@pytest.fixture
def pair(tmp_path):
    rng = np.random.default_rng(4)
    d1 = tmp_path / "items"
    d1.mkdir()
    pq.write_table(
        pa.table(
            {
                "k": pa.array(rng.integers(0, 30, 400), type=pa.int64()),
                "qty": pa.array(rng.integers(1, 10, 400), type=pa.int64()),
                "tag": pa.array([["red", "blue", "green"][i % 3] for i in range(400)]),
            }
        ),
        d1 / "a.parquet",
    )
    d2 = tmp_path / "dims"
    d2.mkdir()
    pq.write_table(
        pa.table(
            {
                "dk": pa.array(np.arange(30), type=pa.int64()),
                "w": pa.array(rng.normal(size=30)),
            }
        ),
        d2 / "a.parquet",
    )
    p = Pair(str(tmp_path / "sys"))
    p.items_dir, p.dims_dir = str(d1), str(d2)
    p.register("items", str(d1))
    p.register("dims", str(d2))
    return p


class TestSqlBasics:
    def test_select_star_where(self, pair):
        out, _, _ = pair.sql("SELECT * FROM items WHERE k = 3")
        items = pair.t.read.parquet(pair.items_dir)
        want = items.filter(items["k"] == 3).collect()
        assert sorted_table(out).equals(sorted_table(want))

    def test_projection_and_operators(self, pair):
        out, _, _ = pair.sql("SELECT k, qty FROM items WHERE qty >= 5 AND tag <> 'red'")
        assert out.column_names == ["k", "qty"]
        assert all(q >= 5 for q in out.column("qty").to_pylist())

    def test_in_and_null_and_not(self, pair):
        out, _, _ = pair.sql("SELECT k FROM items WHERE k IN (1, 2, 3) AND tag IS NOT NULL")
        assert set(out.column("k").to_pylist()) <= {1, 2, 3}

    def test_group_by_order_limit(self, pair):
        out, _, _ = pair.sql(
            "SELECT tag, SUM(qty) AS total, COUNT(*) AS n FROM items "
            "GROUP BY tag ORDER BY tag ASC LIMIT 2"
        )
        assert out.column_names == ["tag", "total", "n"]
        assert out.num_rows == 2
        assert out.column("tag").to_pylist() == ["blue", "green"]

    def test_join(self, pair):
        out, _, _ = pair.sql("SELECT k, qty, w FROM items JOIN dims ON k = dk WHERE qty > 7")
        items = pair.t.read.parquet(pair.items_dir)
        dims = pair.t.read.parquet(pair.dims_dir)
        want = (
            items.join(dims, on=items["k"] == dims["dk"])
            .filter(items["qty"] > 7)
            .select("k", "qty", "w")
            .collect()
        )
        assert sorted_table(out).equals(sorted_table(want))

    def test_group_by_case_insensitive_spelling(self, pair):
        out, _, _ = pair.sql("SELECT Tag, SUM(qty) AS t FROM items GROUP BY tag")
        assert out.column_names == ["tag", "t"]
        assert out.num_rows == 3

    def test_between(self, pair):
        out, _, _ = pair.sql("SELECT k, qty FROM items WHERE qty BETWEEN 3 AND 5")
        assert out.num_rows > 0
        assert all(3 <= q <= 5 for q in out.column("qty").to_pylist())
        out2, _, _ = pair.sql("SELECT k FROM items WHERE qty NOT BETWEEN 3 AND 5 AND k = 1")
        items = pair.t.read.parquet(pair.items_dir)
        want = items.filter(
            ~((items["qty"] >= 3) & (items["qty"] <= 5)) & (items["k"] == 1)
        ).collect()
        assert out2.num_rows == want.num_rows

    def test_order_by_unselected_column(self, pair):
        out, _, _ = pair.sql("SELECT k FROM items ORDER BY qty DESC LIMIT 5")
        assert out.column_names == ["k"] and out.num_rows == 5
        items = pair.t.read.parquet(pair.items_dir)
        want = items.sort(("qty", False)).limit(5).select("k").collect()
        assert out.column("k").to_pylist() == want.column("k").to_pylist()

    def test_negative_literal(self, pair):
        out, _, tdf = pair.sql("SELECT k FROM items WHERE k > -1")
        assert out.num_rows == 400
        lit = tdf.logical_plan.child.condition.right.value
        assert lit == -1 and type(lit) is int
        _, _, fdf = pair.sql("SELECT k FROM items WHERE qty > -1.5")
        lit = fdf.logical_plan.child.condition.right.value
        assert lit == -1.5 and type(lit) is float

    def test_not_in_with_null_returns_no_rows(self, pair):
        # SQL three-valued logic: x NOT IN (1, NULL) is never TRUE
        out, _, _ = pair.sql("SELECT k FROM items WHERE k NOT IN (1, NULL)")
        assert out.num_rows == 0
        # while plain IN with a NULL still matches the listed value
        out, _, _ = pair.sql("SELECT k FROM items WHERE k IN (1, NULL)")
        assert set(out.column("k").to_pylist()) == {1}

    def test_errors(self, pair):
        for exc, s in ((T.HyperspaceException, pair.t), (JHyperspaceException, pair.j)):
            with pytest.raises(exc, match="Unknown table"):
                s.sql("SELECT * FROM nope")
            with pytest.raises(exc, match="GROUP BY"):
                s.sql("SELECT k, SUM(qty) FROM items")
            with pytest.raises(exc, match="syntax"):
                s.sql("SELECT k FROM items WHERE k ~ 3")

    def test_aliases_and_alias_method(self, pair):
        # the Spark spelling and MEAN, AVG, MIN, MAX alike
        for _pkg, s in pair.sides():
            s.read.parquet(pair.items_dir).createOrReplaceTempView("items2")
        out, _, _ = pair.sql(
            "SELECT tag, MEAN(qty) AS m, AVG(qty) AS a, MIN(k), MAX(k) FROM items2 "
            "GROUP BY tag ORDER BY tag DESC"
        )
        assert out.column("m").to_pylist() == out.column("a").to_pylist()


class TestSqlUsesIndexes:
    def test_sql_filter_is_index_served(self, pair):
        T.Hyperspace(pair.t).create_index(
            pair.t.read.parquet(pair.items_dir), T.CoveringIndexConfig("sqlidx", ["k"], ["qty"])
        )
        JHyperspace(pair.j).create_index(
            pair.j.read.parquet(pair.items_dir), JCoveringIndexConfig("sqlidx", ["k"], ["qty"])
        )
        for _pkg, s in pair.sides():
            s.enable_hyperspace()
        got, _, tdf = pair.sql("SELECT k, qty FROM items WHERE k = 7")
        assert "Hyperspace(Type: CI, Name: sqlidx" in tdf.explain()
        for _pkg, s in pair.sides():
            s.disable_hyperspace()
        base, _, _ = pair.sql("SELECT k, qty FROM items WHERE k = 7")
        assert sorted_table(got).equals(sorted_table(base))
        assert got.num_rows > 0


class TestDateKeywordDisambiguation:
    """`DATE` is a keyword only when a quoted string follows; a column
    literally named `date` stays usable as a comparison operand."""

    @pytest.fixture
    def dated(self, pair, tmp_path):
        d = tmp_path / "dated"
        d.mkdir()
        pq.write_table(
            pa.table(
                {
                    "a": pa.array(["x", "y", "z", "y"]),
                    "date": pa.array(["x", "q", "z", "n"]),
                    "d": pa.array(
                        np.array(
                            ["1994-01-01", "1995-06-01", "1994-01-01", "1996-01-01"],
                            dtype="datetime64[D]",
                        )
                    ),
                }
            ),
            d / "a.parquet",
        )
        pair.register("dated", str(d), via_df=False)
        return pair

    def test_column_named_date_as_operand(self, dated):
        out, _, _ = dated.sql("SELECT a FROM dated WHERE a = date")
        assert sorted(out.column("a").to_pylist()) == ["x", "z"]

    def test_date_literal_still_parses(self, dated):
        out, _, tdf = dated.sql("SELECT a FROM dated WHERE d = DATE '1994-01-01'")
        assert sorted(out.column("a").to_pylist()) == ["x", "z"]
        lit = tdf.logical_plan.child.condition.right.value
        jlit = dated.j.sql("SELECT a FROM dated WHERE d = DATE '1994-01-01'").logical_plan
        jlit = jlit.child.condition.right.value
        assert lit == np.datetime64("1994-01-01") and lit.dtype == jlit.dtype

    def test_column_named_date_on_left(self, dated):
        out, _, _ = dated.sql("SELECT date FROM dated WHERE date = 'q'")
        assert out.column("date").to_pylist() == ["q"]
