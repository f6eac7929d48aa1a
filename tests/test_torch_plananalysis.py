"""The port's plan analysis against the JAX package, on the CPU.

Every case of ``tests/test_plananalysis.py`` (explain and its display
modes, why_not and its golden files) and ``tests/test_minmax_analysis.py``
(the overlap analysis, the layout comparison, quantile against min/max
z-order) runs through both packages over the same seeded sources
(``torch_lifecycle_twin.Twin``): ``hs.explain`` (plaintext, console, html;
verbose and not), ``hs.why_not`` (plain and extended, all indexes or one)
and the min/max texts are equal as strings, the system paths aside; each
reference assertion is held on the port too. Two why_not calls on
different plans leak no reason from one to the other. The reference's
profiler-trace case runs on the port: ``hyperspace.profile.traceDir``
makes ``session.execute`` write a ``torch.profiler`` Chrome trace (CPU
activity here; CUDA activity too on the card, ``tests/test_torch_cuda.py``).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_lifecycle_twin import Twin

import hyperspace_tpu_torch as T
from hyperspace_tpu.exceptions import HyperspaceException as JHyperspaceException
from hyperspace_tpu.plananalysis import minmax_analysis as JM
from hyperspace_tpu_torch.plananalysis import minmax_analysis as TM

GOLDEN = os.path.join(os.path.dirname(__file__), "goldstandard")
MODE = "hyperspace.explain.displayMode"


@pytest.fixture
def twin(tmp_path, sample_parquet):
    return Twin(tmp_path / "sys", sample_parquet)


def _texts(twin, call, q) -> dict:
    """``call(hs, q(df))`` in each package, its system path replaced by
    ``<sys>``: pkg -> text."""
    out = {}
    for pkg, s, hs in twin.sides():
        text = call(hs, q(s.read.parquet(twin.src)))
        out[pkg] = text.replace(twin.tsys if pkg == "port" else twin.jsys, "<sys>")
    return out


def _equal(twin, call, q) -> str:
    """:func:`_texts`, equal across the packages; returns the port's."""
    out = _texts(twin, call, q)
    assert out["port"] == out["jax"]
    return out["port"]


def explain(twin, q, **kw) -> str:
    return _equal(twin, lambda hs, p: hs.explain(p, **kw), q)


def why_not(twin, q, **kw) -> str:
    return _equal(twin, lambda hs, p: hs.why_not(p, **kw), q)


def _filter_100(d):
    return d.filter(d["clicks"] == 100).select("query")


def _dm_query(d):
    return d.filter(d["clicks"] >= 100).select("clicks", "query")


def _dim_table(tmp_path) -> str:
    """A second source to join the sample with on clicks."""
    d = tmp_path / "dim"
    d.mkdir()
    pq.write_table(pa.table({
        "d_clicks": pa.array(np.arange(0, 1000, 7), type=pa.int64()),
        "d_name": pa.array([f"n{i}" for i in range(0, 1000, 7)]),
    }), d / "part-0.parquet")
    return str(d)


def _join(d, dim):
    other = d._session.read.parquet(dim)
    return d.join(other, on=d["clicks"] == other["d_clicks"]).select("clicks", "query",
                                                                     "d_name")


def _golden(name: str, text: str, src: str) -> None:
    norm = text.replace(src, "<src>")
    norm = re.sub(r"LogVersion: \d+", "LogVersion: N", norm)
    norm = re.sub(r"\(v\d+\): \S+", "(vN): <index-path>", norm)
    with open(os.path.join(GOLDEN, name)) as f:
        assert norm == f.read()


class TestExplain:
    def test_explain_shows_used_index_and_diff(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        out = explain(twin, _filter_100)
        assert "Plan with indexes:" in out
        assert "Plan without indexes:" in out
        assert "Indexes used:" in out
        assert "cl_idx" in out
        assert "<----" in out  # changed scan highlighted
        with_part = out.split("Plan without indexes:")[0]
        assert "Hyperspace(Type: CI, Name: cl_idx" in with_part

    def test_explain_no_index_used(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        out = explain(twin, lambda d: d.filter(d["imprs"] == 5).select("date"))
        assert "(none)" in out.split("Indexes used:")[1]

    def test_explain_verbose_operator_diff(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        out = explain(twin, _filter_100, verbose=True)
        assert "Operator diff:" in out
        assert "Applicable indexes:" in out
        assert "cl_idx: kind=CoveringIndex" in out

    def test_explain_does_not_toggle_session_state(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        for _pkg, s, hs in twin.sides():
            df = s.read.parquet(twin.src)
            s.disable_hyperspace()
            hs.explain(_filter_100(df))
            assert not s.is_hyperspace_enabled()
            s.enable_hyperspace()
            hs.explain(_filter_100(df))
            assert s.is_hyperspace_enabled()


class TestDisplayModes:
    def test_console_mode_ansi_highlight(self, twin):
        twin.create("covering", "dm_idx", ["clicks"], ["query"])
        out = explain(twin, _dm_query, mode="console")
        assert "\x1b[93m" in out and "\x1b[0m" in out
        assert "dm_idx" in out

    def test_html_mode_escapes_and_bolds(self, twin):
        twin.create("covering", "dm_idx", ["clicks"], ["query"])
        out = explain(twin, _dm_query, mode="html")
        assert "<b>" in out and "</b>" in out and "<br/>" in out
        assert "&gt;=" in out  # the >= in the filter condition

    def test_mode_from_conf(self, twin):
        twin.create("covering", "dm_idx", ["clicks"], ["query"])
        twin.set(MODE, "console")
        assert "\x1b[93m" in explain(twin, _dm_query)
        twin.set(MODE, "html")
        assert "<br/>" in explain(twin, _dm_query, verbose=True)

    def test_unknown_mode_rejected(self, twin):
        twin.create("covering", "dm_idx", ["clicks"], ["query"])
        for pkg, s, hs in twin.sides():
            exc = T.HyperspaceException if pkg == "port" else JHyperspaceException
            with pytest.raises(exc, match="display mode"):
                hs.explain(_dm_query(s.read.parquet(twin.src)), mode="nope")

    @pytest.mark.parametrize("mode", ["plaintext", "console", "html"])
    @pytest.mark.parametrize("verbose", [False, True], ids=["brief", "verbose"])
    def test_every_mode_equal_to_the_reference(self, twin, tmp_path, mode, verbose):
        """Both index kinds, one applied and one not, and a join whose two
        sides are index-served: the text equal in every mode."""
        from torch_lifecycle_twin import config

        dim = _dim_table(tmp_path)
        twin.create("covering", "dm_idx", ["clicks"], ["query"])
        twin.create("zorder", "dm_z", ["imprs", "clicks"], ["date"])
        for pkg, s, hs in twin.sides():
            hs.create_index(s.read.parquet(dim), config(pkg, "covering", "dim_idx",
                                                        ["d_clicks"], ["d_name"]))
        explain(twin, _dm_query, verbose=verbose, mode=mode)
        explain(twin, lambda d: d.filter((d["imprs"] >= 10) & (d["imprs"] < 20)).select(
            "imprs", "date"), verbose=verbose, mode=mode)
        text = explain(twin, lambda d: _join(d, dim), verbose=verbose, mode=mode)
        assert "Name: dim_idx" in text and "Name: dm_idx" in text

    def test_explain_golden(self, twin):
        """``tests/goldstandard/explain_filter.txt``, the reference's golden
        file, on the port's output too."""
        twin.create("covering", "dm_idx", ["clicks"], ["query"])
        _golden("explain_filter.txt", explain(twin, _dm_query), twin.src)


class TestProfilerIntegration:
    def test_trace_dir_produces_trace(self, twin, tmp_path):
        import json

        s = twin.t
        df = s.read.parquet(twin.src)
        trace_dir = str(tmp_path / "trace")
        s.conf.set("hyperspace.profile.traceDir", trace_dir)
        got = df.filter(df["clicks"] >= 100).select("clicks").collect()
        s.conf.set("hyperspace.profile.traceDir", "")
        found = []
        for root, _dirs, files in os.walk(trace_dir):
            found.extend(os.path.join(root, f) for f in files)
        assert found, "no profiler trace files written"
        with open(found[0]) as fh:
            doc = json.load(fh)
        assert doc["traceEvents"], "an empty trace"
        # traced or not, the rows are the same
        assert got.equals(df.filter(df["clicks"] >= 100).select("clicks").collect())
        assert len(os.listdir(trace_dir)) == 1
        # a CPU session runs no pads and has no launches to lose
        assert not any(e.get("name") == "hyperspace.profile.pad" for e in doc["traceEvents"])

    @pytest.mark.parametrize("pads", [False, True])
    def test_launches_without_kernels_counts_the_querys_lost_kernels(self, tmp_path, pads):
        """The check behind the session's warning, on a written trace: a
        launch whose correlation id no kernel event carries counts, unless
        it falls in a pad."""
        import json

        from hyperspace_tpu_torch.session import PROFILE_PAD, launches_without_kernels

        def launch(ts, corr):
            return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ph": "X", "ts": ts,
                    "dur": 2, "args": {"correlation": corr}}

        def kernel(ts, corr):
            return {"cat": "kernel", "name": "k", "ph": "X", "ts": ts, "dur": 1,
                    "args": {"correlation": corr}}

        events = [launch(10, 1), launch(12, 2), launch(60, 6), launch(100, 3), kernel(101, 3),
                  launch(110, 4),
                  {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ph": "X", "ts": 120,
                   "dur": 1, "args": {"correlation": 5}}]
        if pads:
            events += [{"cat": "user_annotation", "name": PROFILE_PAD, "ph": "X", "ts": lo,
                        "dur": 20} for lo in (5, 105)]
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"traceEvents": events}))
        # launches 1, 2, 4 and 6 lost; with pads all but 6 fall in one
        assert launches_without_kernels(str(path)) == (1 if pads else 4)


class TestWhyNot:
    def test_why_not_golden(self, twin):
        twin.create("covering", "wn_idx", ["clicks"], ["query"])
        twin.enable()
        out = why_not(twin, lambda d: d.filter(d["query"] == "banana").select("query", "imprs"))
        _golden("why_not_filter.txt", out, twin.src)

    def test_why_not_reports_reasons(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        out = why_not(twin, lambda d: d.filter(d["clicks"] == 100).select("imprs"))
        assert "Non-applicable indexes:" in out
        assert "cl_idx" in out
        assert "MISSING_REQUIRED_COL" in out

    def test_why_not_applied_index_listed_applicable(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        assert "cl_idx: applied" in why_not(twin, _filter_100)

    @pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
    def test_why_not_first_indexed_col_reason(self, twin, extended):
        twin.create("covering", "iq_idx", ["imprs", "clicks"], ["query"])
        out = why_not(twin, _filter_100, extended=extended)
        assert "NO_FIRST_INDEXED_COL_COND" in out
        # the verbose text in extended mode, the arguments otherwise
        assert ("first indexed column" in out) == extended
        assert ("firstIndexedCol=imprs" in out) != extended

    def test_why_not_named_index_filter(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        twin.create("covering", "other", ["imprs"], ["date"])
        q = lambda d: d.filter(d["clicks"] == 100).select("imprs")  # noqa: E731
        out = why_not(twin, q, index_name="cl_idx")
        assert "cl_idx" in out and "other" not in out
        for pkg, s, hs in twin.sides():
            exc = T.HyperspaceException if pkg == "port" else JHyperspaceException
            with pytest.raises(exc, match="No ACTIVE index"):
                hs.why_not(q(s.read.parquet(twin.src)), index_name="nope")

    def test_why_not_no_active_index(self, twin):
        assert why_not(twin, _filter_100) == "No ACTIVE indexes to analyze."

    def test_why_not_source_changed_reason(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        pq.write_table(pa.table({
            "date": ["2018-01-01"],
            "rguid": ["g"],
            "clicks": pa.array([1], type=pa.int64()),
            "query": ["zzz"],
            "imprs": pa.array([2], type=pa.int64()),
        }), os.path.join(twin.src, "extra.parquet"))
        twin.clear_cache()
        assert "SOURCE_DATA_CHANGED" in why_not(twin, _filter_100)

    def test_why_not_reasons_do_not_accumulate(self, twin):
        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        q = lambda d: d.filter(d["clicks"] == 100).select("imprs")  # noqa: E731
        out1, out2 = why_not(twin, q), why_not(twin, q)
        assert out1 == out2
        assert out1.count("MISSING_REQUIRED_COL") == out2.count("MISSING_REQUIRED_COL") > 0

    def test_no_reason_leaks_between_plans(self, twin):
        """A second why_not over another plan sees none of the first one's
        reasons, and the analysis tag is off on every entry after each."""
        from hyperspace_tpu_torch.rules import tags

        twin.create("covering", "cl_idx", ["clicks"], ["query"])
        first = why_not(twin, lambda d: d.filter(d["clicks"] == 100).select("imprs"))
        second = why_not(twin, lambda d: d.filter(d["query"] == "x").select("query"))
        assert "MISSING_REQUIRED_COL" in first
        assert "MISSING_REQUIRED_COL" not in second
        assert "NO_FIRST_INDEXED_COL_COND" in second
        for e in twin.t.index_manager.get_indexes():
            assert e.get_tag(None, tags.INDEX_PLAN_ANALYSIS_ENABLED) is None

    @pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
    def test_why_not_zorder_and_join(self, twin, tmp_path, extended):
        """The z-order index's reasons, and a join's whose one side is
        covered and the other not: equal strings."""
        from torch_lifecycle_twin import config

        dim = _dim_table(tmp_path)
        twin.create("zorder", "wz", ["imprs"], ["date"])
        twin.create("covering", "wj", ["clicks"], ["query"])
        for pkg, s, hs in twin.sides():
            hs.create_index(s.read.parquet(dim), config(pkg, "covering", "wd",
                                                        ["d_clicks"], []))
        why_not(twin, lambda d: d.filter(d["imprs"] == 3).select("rguid"), extended=extended)
        out = why_not(twin, lambda d: _join(d, dim), extended=extended)
        assert "wd (CoveringIndex):" in out


# ---------------------------------------------------------------------------
# tests/test_minmax_analysis.py
# ---------------------------------------------------------------------------


def _column_both(*args):
    t, j = TM.analyze_column(*args), JM.analyze_column(*args)
    assert t.to_text() == j.to_text()
    assert dataclass_fields(t) == dataclass_fields(j)
    return t


def dataclass_fields(r) -> dict:
    import dataclasses

    return dataclasses.asdict(r)


class TestAnalyzeColumn:
    def test_disjoint_intervals_touch_one_file(self):
        res = _column_both("c", [(0, 9), (10, 19), (20, 29)], [100, 100, 100], 3, 300)
        assert res.max_files_per_lookup == 1
        assert res.max_bytes_per_lookup == 100

    def test_identical_intervals_touch_all(self):
        res = _column_both("c", [(0, 10)] * 4, [50] * 4, 4, 200)
        assert res.max_files_per_lookup == 4
        assert res.max_bytes_per_lookup == 200

    def test_shared_endpoint_counts_both(self):
        res = _column_both("c", [(0, 10), (10, 20)], [1, 1], 2, 2)
        assert res.max_files_per_lookup == 2

    def test_all_null(self):
        res = _column_both("c", [], [], 3, 300)
        assert res.min_val is None
        assert "null" in res.to_text()


def _minmax_both(twin, src, cols):
    """``analyze_min_max`` and its string over ``src`` in both packages."""
    out = {}
    for pkg, s, _hs in twin.sides():
        mod = TM if pkg == "port" else JM
        df = s.read.parquet(src)
        out[pkg] = (mod.analyze_min_max(df, cols), mod.analyze_min_max_string(df, cols))
    assert out["port"][1] == out["jax"][1]
    assert [dataclass_fields(r) for r in out["port"][0]] == \
        [dataclass_fields(r) for r in out["jax"][0]]
    return out["port"]


class TestAnalyzeDataFrame:
    def test_nan_rows_do_not_poison_file_range(self, tmp_path):
        d = tmp_path / "nan"
        d.mkdir()
        pq.write_table(pa.table({"x": pa.array([1.0, 2.0, float("nan")])}), d / "a.parquet")
        pq.write_table(pa.table({"x": pa.array([1.5, 3.0])}), d / "b.parquet")
        twin = Twin(tmp_path / "sys", str(d))
        (res,), _text = _minmax_both(twin, str(d), ["x"])
        assert res.max_files_per_lookup == 2
        assert res.min_val == 1.0 and res.max_val == 3.0

    def test_clustered_vs_random_layout(self, tmp_path):
        rng = np.random.default_rng(2)
        d = tmp_path / "lay"
        d.mkdir()
        vals = np.arange(4000)
        rand = rng.permutation(vals)
        for i in range(8):
            sl = slice(i * 500, (i + 1) * 500)
            pq.write_table(pa.table({
                "clustered": pa.array(vals[sl], type=pa.int64()),
                "random": pa.array(rand[sl], type=pa.int64()),
                "name": pa.array([f"r{j}" for j in range(500)]),
                "when": pa.array((np.datetime64("2020-01-01") + vals[sl]).astype("datetime64[D]")),
            }), d / f"f{i}.parquet")
        twin = Twin(tmp_path / "sys", str(d))
        results, _ = _minmax_both(twin, str(d), ["clustered", "random", "when"])
        res = {r.column: r for r in results}
        assert res["clustered"].max_files_per_lookup == 1
        assert res["random"].max_files_per_lookup == 8
        assert res["when"].max_files_per_lookup == 1
        assert res["clustered"].avg_files_per_lookup < res["random"].avg_files_per_lookup
        _results, text = _minmax_both(twin, str(d), ["clustered", "name"])
        assert "Max files for a point lookup: 1" in text
        assert "non-numeric" in text
        for pkg, s, _hs in twin.sides():
            exc = T.HyperspaceException if pkg == "port" else JHyperspaceException
            mod = TM if pkg == "port" else JM
            with pytest.raises(exc, match="No such column"):
                mod.analyze_min_max(s.read.parquet(str(d)), ["nope"])


def test_quantile_beats_minmax_on_skew(tmp_path):
    """``TestQuantileZOrder``: over a skewed key, min/max z-order encoding
    leaves every file spanning the dense region and quantile encoding
    keeps lookups local, in both packages, the analysis texts equal over
    each package's index files."""
    rng = np.random.default_rng(7)
    d = tmp_path / "skew"
    d.mkdir()
    n = 8000
    dense = rng.integers(0, 1000, n, dtype=np.int64)
    outlier_at = rng.random(n) < 0.01
    skewed = np.where(outlier_at, rng.integers(1, 10**12, n, dtype=np.int64), dense)
    t = pa.table({
        "skewed": pa.array(skewed, type=pa.int64()),
        "uniform": pa.array(rng.integers(0, 10**6, n, dtype=np.int64)),
    })
    for i in range(4):
        pq.write_table(t.slice(i * (n // 4), n // 4), d / f"p{i}.parquet")
    twin = Twin(tmp_path / "sys", str(d))
    twin.set("hyperspace.index.zorder.targetSourceBytesPerPartition", 8_000)
    res = {}
    for quantile, name in ((False, "z_mm"), (True, "z_qt")):
        twin.set("hyperspace.index.zorder.quantile.enabled", quantile)
        twin.create("zorder", name, ["skewed", "uniform"])
        twin.assert_equal(name)
        texts = {}
        for pkg, s, _hs in twin.sides():
            mod = TM if pkg == "port" else JM
            files = s.index_manager.get_index_log_entry(name).content.files
            assert len(files) > 4, "need a multi-file layout to measure"
            idx_df = s.read.parquet(os.path.dirname(files[0]))
            (r,) = mod.analyze_min_max(idx_df, ["skewed"])
            texts[pkg] = r.to_text()
            res[(pkg, name)] = r
        assert texts["port"] == texts["jax"]
    mm, qt = res[("port", "z_mm")], res[("port", "z_qt")]
    assert mm.max_files_per_lookup == mm.total_files
    assert qt.max_files_per_lookup < mm.max_files_per_lookup
