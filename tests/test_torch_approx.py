"""The port's approximate plane against the JAX package.

``tests/test_agg_index.py::TestApproxPlane`` as differentials: both
packages build the same z-order covering index (512-row groups, so a file
has several strata) over the same seeded source and answer the same
``collect_approx`` query. Where the reference raises ApproximationError
the port raises it too; where it answers, the port's table is equal to it
column for column, the float64 estimates and interval bounds bit for bit,
and the reference's own assertions (intervals hold the exact answer) are
checked on the port's table. The sample's mask runs through the port's
``executor._filter_mask`` (the plain B3a / B3 route on the CPU).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import functions as JF
from hyperspace_tpu.exceptions import ApproximationError as JApproximationError
from hyperspace_tpu.hyperspace import Hyperspace as JHyperspace
from hyperspace_tpu.indexes import aggindex as JA
from hyperspace_tpu.indexes import zonemaps as JZ
from hyperspace_tpu.indexes.zorder import ZOrderCoveringIndexConfig as JZConfig
from hyperspace_tpu.io import parquet as jpio
from hyperspace_tpu.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import functions as TF
from hyperspace_tpu_torch.exceptions import ApproximationError
from hyperspace_tpu_torch.execution import approx_exec
from hyperspace_tpu_torch.indexes import aggindex as TA
from hyperspace_tpu_torch.indexes import zonemaps as TZ
from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndexConfig as TZConfig
from hyperspace_tpu_torch.io import parquet as tpio
from torch_b5_cases import same_rows

APPROX = "hyperspace.serve.approx.enabled"
SAMPLE_ROWS = "hyperspace.index.agg.sampleRowsPerGroup"


@pytest.fixture(autouse=True)
def small_row_groups(monkeypatch):
    monkeypatch.setattr(tpio, "INDEX_ROW_GROUP_SIZE", 512)
    monkeypatch.setattr(jpio, "INDEX_ROW_GROUP_SIZE", 512)
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()
    yield
    for m in (TA, JA, TZ, JZ):
        m.invalidate_local_cache()


def _write_files(root, name, table, n_files=4):
    d = root / name
    d.mkdir()
    n = table.num_rows
    for i in range(n_files):
        lo, hi = i * n // n_files, (i + 1) * n // n_files
        pq.write_table(table.slice(lo, hi - lo), str(d / f"part{i}.parquet"))
    return str(d)


class Pair:
    """A port session (``device="cpu"``) and a JAX-package session, each
    with its own system path, over one source."""

    def __init__(self, root):
        self.t = T.HyperspaceSession(device="cpu")
        self.t.conf.set("hyperspace.system.path", str(root / "port"))
        self.j = JSession()
        self.j.conf.set(JC.INDEX_SYSTEM_PATH, str(root / "jax"))
        self.j.conf.set(JC.BUILD_NUM_SHARDS, 1)
        self.sys = {"port": str(root / "port"), "jax": str(root / "jax")}

    def sides(self):
        return (("port", self.t, TF), ("jax", self.j, JF))

    def set(self, key, value):
        self.t.conf.set(key, value)
        self.j.conf.set(key, value)

    def build(self, src, name, indexed, included):
        T.Hyperspace(self.t).create_index(
            self.t.read.parquet(src), TZConfig(name, indexed, included)
        )
        JHyperspace(self.j).create_index(
            self.j.read.parquet(src), JZConfig(name, indexed, included)
        )
        for _pkg, s, _f in self.sides():
            s.enable_hyperspace()
        self.src = src

    def approx(self, q, max_rel_error=None):
        """``q(df, F).collect_approx(...)`` in both packages: both raise
        (returns None), or both answer with equal tables (returns the
        port's)."""
        out = {}
        for pkg, s, f in self.sides():
            exc = ApproximationError if pkg == "port" else JApproximationError
            try:
                out[pkg] = q(s.read.parquet(self.src), f).collect_approx(max_rel_error)
            except exc:
                out[pkg] = None
        assert (out["port"] is None) == (out["jax"] is None), out
        if out["port"] is not None:
            assert same_rows(out["port"], out["jax"])
        return out["port"]

    def raises(self, q, max_rel_error=None):
        assert self.approx(q, max_rel_error) is None

    def exact(self, q):
        got = {pkg: q(s.read.parquet(self.src), f).collect() for pkg, s, f in self.sides()}
        assert same_rows(got["port"], got["jax"])
        return got["port"]


def _mk(tmp_path, n=20_000):
    pair = Pair(tmp_path)
    rng = np.random.default_rng(37)
    d = _write_files(
        tmp_path,
        "apx",
        pa.table({
            "c": pa.array(np.sort(rng.integers(0, 100_000, n)), type=pa.int64()),
            "p": pa.array(rng.integers(0, 6, n), type=pa.int64()),
            "v": pa.array(rng.gamma(4.0, 10.0, n)),  # positive: rel err sane
        }),
    )
    pair.build(d, "z_apx", ["c"], ["p", "v"])
    return pair


def test_keys_and_defaults_match_the_reference():
    assert (TC.SERVE_APPROX_ENABLED, TC.SERVE_APPROX_ENABLED_DEFAULT) == (
        JC.SERVE_APPROX_ENABLED, JC.SERVE_APPROX_ENABLED_DEFAULT)
    assert (TC.SERVE_APPROX_MAX_REL_ERROR, TC.SERVE_APPROX_MAX_REL_ERROR_DEFAULT) == (
        JC.SERVE_APPROX_MAX_REL_ERROR, JC.SERVE_APPROX_MAX_REL_ERROR_DEFAULT)


def test_disabled_raises_and_exact_never_substituted(tmp_path):
    pair = _mk(tmp_path, n=4000)

    def q(d, f):
        return d.filter(d["c"] >= 0).agg(f.count().alias("n"))

    pair.raises(q)
    pair.set(APPROX, True)
    exact = pair.exact(q)
    assert exact.column("n").to_pylist() == [4000]
    assert exact.schema.field("n").type == pa.int64()


def test_unapproximable_aggregates_raise(tmp_path):
    pair = _mk(tmp_path, n=4000)
    pair.set(APPROX, True)
    pair.raises(lambda d, f: d.filter(d["c"] >= 0).agg(f.min("v").alias("m")))
    pair.raises(
        lambda d, f: d.filter(d["c"] >= 0).group_by("p", "c").agg(f.count().alias("n"))
    )


def test_budget_violation_raises(tmp_path):
    pair = _mk(tmp_path)
    pair.set(APPROX, True)
    pair.raises(
        lambda d, f: d.filter(d["c"] < 3).agg(f.count().alias("n")), max_rel_error=0.01
    )


def test_ungrouped_estimates_equal_the_reference(tmp_path):
    pair = _mk(tmp_path)
    pair.set(APPROX, True)

    def q(d, f):
        return d.filter((d["c"] >= 20_000) & (d["c"] < 30_000)).agg(
            f.count().alias("n"), f.sum("v").alias("sv")
        )

    got = pair.approx(q, max_rel_error=0.9)
    assert got.column_names == ["n", "n_lo", "n_hi", "sv", "sv_lo", "sv_hi"]
    assert approx_exec.last_approx_stats["mode"] == "agg_approx"
    truth = pair.exact(q).to_pydict()
    e = got.to_pydict()
    assert e["n_lo"][0] <= truth["n"][0] <= e["n_hi"][0]


def test_grouped_estimates_with_per_group_cis(tmp_path):
    pair = _mk(tmp_path)
    pair.set(APPROX, True)

    def q(d, f):
        return d.filter(d["c"] < 60_000).group_by("p").agg(
            f.count().alias("n"), f.sum("v").alias("sv")
        )

    approx = pair.approx(q, max_rel_error=0.9)
    exact = pair.exact(q).sort_by([("p", "ascending")])
    assert approx.column_names == ["p", "n", "n_lo", "n_hi", "sv", "sv_lo", "sv_hi"]
    assert approx.column("p").to_pylist() == exact.column("p").to_pylist()
    an, en = approx.to_pydict(), exact.to_pydict()
    held = sum(1 for i in range(len(an["p"])) if an["n_lo"][i] <= en["n"][i] <= an["n_hi"][i])
    assert held >= len(an["p"]) - 1, (an, en)
    for i in range(len(an["p"])):
        assert an["n_lo"][i] <= an["n"][i] <= an["n_hi"][i]
        assert an["sv_lo"][i] <= an["sv"][i] <= an["sv_hi"][i]
    assert approx.schema.field("n").type == pa.float64()


def test_grouped_budget_applies_per_group(tmp_path):
    pair = _mk(tmp_path)
    pair.set(APPROX, True)
    pair.raises(
        lambda d, f: d.filter(d["c"] < 60_000).group_by("p").agg(f.count().alias("n")),
        max_rel_error=0.01,
    )


def test_single_sample_stratum_refused(tmp_path):
    pair = Pair(tmp_path)
    pair.set(SAMPLE_ROWS, 1)
    rng = np.random.default_rng(43)
    n = 4000
    d = _write_files(
        tmp_path,
        "one",
        pa.table({
            "c": pa.array(np.sort(rng.integers(0, 9000, n)), type=pa.int64()),
            "v": pa.array(rng.gamma(2.0, 3.0, n)),
        }),
    )
    pair.build(d, "z_one", ["c"], ["v"])
    pair.set(APPROX, True)
    pair.raises(
        lambda d, f: d.filter(d["c"] >= 0).agg(f.count().alias("n")), max_rel_error=1e9
    )


def test_rewritten_file_never_serves_stale_samples(tmp_path):
    """An index file whose identity changed samples from the backfill, in
    both packages alike, and the estimate still brackets the answer."""
    pair = _mk(tmp_path, n=4000)
    pair.set(APPROX, True)

    def q(d, f):
        return d.filter(d["c"] >= 0).agg(f.count().alias("n"))

    pair.approx(q, max_rel_error=1e9)
    for pkg in ("port", "jax"):
        root = os.path.join(pair.sys[pkg], "z_apx")
        victim = None
        for dirpath, _dirs, names in sorted(os.walk(root)):
            for nme in sorted(names):
                if nme.endswith(".parquet") and not nme.startswith("_"):
                    victim = os.path.join(dirpath, nme)
                    break
            if victim:
                break
        os.utime(victim, ns=(1, 1))
    TA.invalidate_local_cache()
    JA.invalidate_local_cache()
    est = pair.approx(q, max_rel_error=1e9).to_pydict()
    tn = pair.exact(q).column("n").to_pylist()[0]
    assert est["n_lo"][0] <= tn <= est["n_hi"][0], (est, tn)


def test_error_bounds_hold(tmp_path):
    """The reference's battery of 40 seeded windows: every estimate equal
    to the reference's, coverage of the exact COUNT and SUM at least 85 %."""
    pair = _mk(tmp_path)
    pair.set(APPROX, True)
    rng = np.random.default_rng(41)
    hits_n = hits_s = total = 0
    for _ in range(40):
        lo = int(rng.integers(0, 60_000))
        hi = lo + int(rng.integers(20_000, 40_000))

        def q(d, f, lo=lo, hi=hi):
            return d.filter((d["c"] >= lo) & (d["c"] < hi)).agg(
                f.count().alias("n"), f.sum("v").alias("sv")
            )

        est = pair.approx(q, max_rel_error=1e9).to_pydict()
        truth = pair.exact(q).to_pydict()
        total += 1
        hits_n += est["n_lo"][0] <= truth["n"][0] <= est["n_hi"][0]
        hits_s += est["sv_lo"][0] <= truth["sv"][0] <= est["sv_hi"][0]
    assert hits_n / total >= 0.85 and hits_s / total >= 0.85, (hits_n, hits_s, total)


def test_hybrid_compensation_is_not_approximable(tmp_path):
    """With Hybrid Scan's compensation in play (an appended file) the plan
    is no clean index scan: both packages refuse to estimate."""
    pair = _mk(tmp_path, n=4000)
    rng = np.random.default_rng(3)
    pq.write_table(
        pa.table({
            "c": pa.array(rng.integers(0, 100_000, 40), type=pa.int64()),
            "p": pa.array(rng.integers(0, 6, 40), type=pa.int64()),
            "v": pa.array(rng.gamma(4.0, 10.0, 40)),
        }),
        os.path.join(pair.src, "appended.parquet"),
    )
    pair.set("hyperspace.index.hybridscan.enabled", True)
    pair.set(APPROX, True)
    for _pkg, s, _f in pair.sides():
        s.index_manager.clear_cache()
    pair.raises(lambda d, f: d.filter(d["c"] >= 0).agg(f.count().alias("n")), max_rel_error=1e9)
