"""The port's observability plane against the JAX package's, on the CPU.

The cases of ``tests/test_obs.py`` that need no serve tier (the trace
core, ``merge_snapshots``, the metrics registry, telemetry events, the
actions' root spans) run through both packages' ``obs`` modules, plus the
port's own contract:

* the stage spans of a join under one root equal ``session.join_stats``
  on every route: sequential, pipelined, streamed in waves and over 4
  shards (each side thread carries the root through ``trace.carry``);
* an action's stage spans equal ``session.build_stats``;
* the breakdown instruments ``hs_serve_stage_seconds`` and
  ``hs_build_stage_seconds`` read the session's own dicts, and every
  instrument the port registers has the reference's name and type;
* tracing off records nothing and changes no row.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_b5_cases import same_rows

import hyperspace_tpu_torch as T
from hyperspace_tpu import telemetry as JT
from hyperspace_tpu.execution import join_exec as _jje  # noqa: F401  (registers its timer)
from hyperspace_tpu.indexes import covering_build as _jcb  # noqa: F401
from hyperspace_tpu.obs import merge_snapshots as j_merge
from hyperspace_tpu.obs import metrics as jmetrics
from hyperspace_tpu.obs import trace as jtrace
from hyperspace_tpu.testing import replay as _jreplay  # noqa: F401
from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch import telemetry as TT
from hyperspace_tpu_torch import functions as F
from hyperspace_tpu_torch.obs import merge_snapshots as t_merge
from hyperspace_tpu_torch.obs import metrics as tmetrics
from hyperspace_tpu_torch.obs import trace as ttrace
from hyperspace_tpu_torch.testing import replay as _treplay  # noqa: F401

TRACES = {"port": ttrace, "jax": jtrace}
PKGS = ["port", "jax"]


@pytest.fixture(autouse=True)
def _obs_isolation():
    """Tracing is a process-global switch in each package: leave it off
    and the ring empty for whatever test runs next."""
    for tr in TRACES.values():
        tr.reset()
    yield
    for tr in TRACES.values():
        tr.set_enabled(False)
        tr.reset()


def _assert_trace_integrity(root):
    by_id = {sp.span_id: sp for sp in root.spans}
    by_id[root.span_id] = root
    for sp in root.spans:
        assert sp.trace_id == root.trace_id, (sp.name, sp.trace_id)
        if sp is root:
            continue
        assert sp.parent_id in by_id, (sp.name, sp.parent_id)
        hops, cur = 0, sp
        while cur is not root:
            cur = by_id[cur.parent_id]
            hops += 1
            assert hops < 100, "parent cycle"
        assert sp.duration_s is not None and sp.duration_s >= 0.0


def _lake(tmp_path, n=20_000, n_orders=2_000):
    rng = np.random.default_rng(23)
    idir, odir = tmp_path / "items", tmp_path / "orders"
    idir.mkdir()
    odir.mkdir()
    items = pa.table({
        "k": rng.integers(0, n_orders, n).astype(np.int64),
        "q": rng.integers(1, 51, n).astype(np.int64),
    })
    orders = pa.table({
        "ok": np.arange(n_orders, dtype=np.int64),
        "cust": rng.integers(0, 500, n_orders).astype(np.int64),
    })
    for i in range(4):
        lo, hi = i * n // 4, (i + 1) * n // 4
        pq.write_table(items.slice(lo, hi - lo), str(idir / f"p{i}.parquet"))
        lo, hi = i * n_orders // 4, (i + 1) * n_orders // 4
        pq.write_table(orders.slice(lo, hi - lo), str(odir / f"p{i}.parquet"))
    return str(idir), str(odir)


def _session(tmp_path, name, devices=None):
    s = T.HyperspaceSession(device="cpu", devices=devices)
    s.conf.set(C.INDEX_SYSTEM_PATH, str(tmp_path / name))
    s.conf.set(C.INDEX_NUM_BUCKETS, 8)
    return s


@pytest.fixture
def lake(tmp_path):
    return _lake(tmp_path)


def _indexed(tmp_path, lake, name="sys", devices=None):
    s = _session(tmp_path, name, devices)
    hs = T.Hyperspace(s)
    idir, odir = lake
    hs.create_index(s.read.parquet(idir), T.CoveringIndexConfig("oi1", ["k"], ["q"]))
    hs.create_index(s.read.parquet(odir), T.CoveringIndexConfig("oo1", ["ok"], ["cust"]))
    s.enable_hyperspace()
    return s


def _join(s, lake):
    items, orders = s.read.parquet(lake[0]), s.read.parquet(lake[1])
    return orders.join(items, on=orders["ok"] == items["k"]).select("ok", "cust", "q")


def _assert_spans_equal_stats(spans: dict, stats: dict) -> None:
    """Span seconds equal the breakdown's: one measurement, summed in the
    order each side recorded it."""
    assert set(spans) == set(stats), (sorted(spans), sorted(stats))
    for k, v in stats.items():
        assert math.isclose(spans[k], v, rel_tol=1e-9, abs_tol=1e-12), (k, spans[k], v)


# ---------------------------------------------------------------------------
# Trace core (both packages)
# ---------------------------------------------------------------------------


class TestTraceCore:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_disabled_is_noop(self, pkg):
        trace = TRACES[pkg]
        trace.set_enabled(False)
        assert trace.root("serve.query") is trace.NOOP
        with trace.span("scan") as sp:
            assert sp is trace.NOOP
        trace.stage("scan", 0.0)
        assert trace.finished() == []
        assert trace.current_trace_id() is None
        f = lambda: 1  # noqa: E731
        assert trace.carry(f) is f

    @pytest.mark.parametrize("pkg", PKGS)
    def test_root_child_shape(self, pkg):
        trace = TRACES[pkg]
        trace.set_enabled(True)
        root = trace.root("serve.query", slo_class="t")
        with trace.activate(root):
            with trace.span("pin"):
                pass
            trace.stage("scan", seconds=0.25)
            trace.event("retry", attempt=2)
        root.finish()
        roots = trace.finished("serve.query")
        assert len(roots) == 1
        _assert_trace_integrity(roots[0])
        stages = roots[0].stage_seconds()
        assert set(stages) == {"pin", "scan"}
        assert abs(stages["scan"] - 0.25) < 0.02
        assert roots[0].events[0]["name"] == "retry"
        assert roots[0].attrs["slo_class"] == "t"

    def test_stage_seconds_are_taken_exactly(self):
        """The port's stage spans carry the seconds their hook measured, to
        the bit (the reference re-reads the clock at finish)."""
        ttrace.set_enabled(True)
        root = ttrace.root("serve.query")
        with ttrace.activate(root):
            ttrace.stage("scan", 0.0, seconds=0.123456789)
            ttrace.stage("scan", seconds=1e-7)
        root.finish()
        assert root.stage_seconds() == {"scan": 0.123456789 + 1e-7}

    @pytest.mark.parametrize("pkg", PKGS)
    def test_finish_idempotent_and_span_cap(self, pkg):
        trace = TRACES[pkg]
        trace.set_enabled(True)
        old = trace._max_spans
        trace._max_spans = 3
        try:
            root = trace.root("serve.query")
            with trace.activate(root):
                for _ in range(10):
                    with trace.span("scan"):
                        pass
            root.finish()
            root.finish()  # idempotent
            assert len(trace.finished()) == 1
            assert len(root.spans) == 3
            assert root.spans_dropped > 0
        finally:
            trace._max_spans = old

    @pytest.mark.parametrize("pkg", PKGS)
    def test_carry_propagates_across_pool(self, pkg):
        trace = TRACES[pkg]
        trace.set_enabled(True)
        root = trace.root("serve.query")
        with trace.activate(root):
            with ThreadPoolExecutor(max_workers=4) as pool:
                list(pool.map(trace.carry(lambda i: trace.stage("scan", 0.0)), range(8)))

                def bare(i):
                    assert trace.current() is None
                    return i

                list(pool.map(bare, range(4)))
        root.finish()
        _assert_trace_integrity(root)
        assert len([s for s in root.spans if s.name == "scan"]) == 8

    @pytest.mark.parametrize("pkg", PKGS)
    def test_ring_bounded_by_retain(self, pkg):
        from collections import deque

        trace = TRACES[pkg]
        trace.set_enabled(True)
        with trace._rec_lock:
            old = trace._finished.maxlen
            trace._finished = deque(maxlen=5)
        try:
            for _ in range(12):
                trace.root("serve.query").finish()
            assert len(trace.finished()) == 5
        finally:
            with trace._rec_lock:
                trace._finished = deque(maxlen=old)

    @pytest.mark.parametrize("pkg", PKGS)
    def test_accumulate_and_configure(self, pkg):
        trace = TRACES[pkg]
        conf = T.HyperspaceSession(device="cpu").conf if pkg == "port" else None
        if conf is None:
            from hyperspace_tpu.config import Config

            conf = Config()
        conf.set("hyperspace.obs.enabled", True)
        conf.set("hyperspace.obs.trace.maxSpans", 7)
        conf.set("hyperspace.obs.trace.retain", 9)
        try:
            assert trace.configure(conf) is True
            assert trace._max_spans == 7 and trace._finished.maxlen == 9
            root = trace.root("serve.query")
            with trace.activate(root):
                trace.accumulate("rows_pruned", 3)
                with trace.span("scan"):
                    trace.accumulate("rows_pruned", 4)
            root.finish()
            assert root.attrs["rows_pruned"] == 7
        finally:
            conf.set("hyperspace.obs.trace.maxSpans", 512)
            conf.set("hyperspace.obs.trace.retain", 256)
            conf.set("hyperspace.obs.enabled", False)
            trace.configure(conf)


class TestMergeSnapshots:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_sum_max_drop_semantics(self, pkg):
        merge = t_merge if pkg == "port" else j_merge
        a = {"completed": 3, "p50_ms": 10.0, "snapshot_at_ms": 100, "high_water_bytes": 50,
             "max_bytes": 100, "fleet": {"spool_hits": 1}, "name": "a"}
        b = {"completed": 4, "p50_ms": 99.0, "snapshot_at_ms": 200, "high_water_bytes": 70,
             "max_bytes": 100, "fleet": {"spool_hits": 2}, "name": "b"}
        m = merge(a, b)
        assert m == j_merge(a, b)
        assert m["completed"] == 7
        assert "p50_ms" not in m
        assert m["snapshot_at_ms"] == 200
        assert m["high_water_bytes"] == 70
        assert m["max_bytes"] == 100
        assert m["fleet"]["spool_hits"] == 3
        assert m["name"] == "a"

    @pytest.mark.parametrize("pkg", PKGS)
    def test_empty_and_non_dict_tolerated(self, pkg):
        merge = t_merge if pkg == "port" else j_merge
        assert merge() == {}
        assert merge({}, None, {"x": 1}) == {"x": 1}


# ---------------------------------------------------------------------------
# Join stage spans on every route
# ---------------------------------------------------------------------------


class TestJoinSpans:
    @pytest.mark.parametrize("route", ["sequential", "pipelined", "streamed"])
    def test_join_spans_equal_join_stats(self, tmp_path, lake, route):
        s = _indexed(tmp_path, lake)
        if route == "pipelined":
            s.conf.set(C.SERVE_PIPELINE_ENABLED, True)
        elif route == "streamed":
            s.conf.set(C.SERVE_STREAM_ENABLED, True)
            s.conf.set(C.SERVE_STREAM_MAX_BYTES, 64 << 10)
        q = _join(s, lake)
        ttrace.set_enabled(False)
        want = q.collect()
        assert ttrace.finished() == []
        ttrace.set_enabled(True)
        root = ttrace.root("serve.query")
        with ttrace.activate(root):
            got = q.collect()
        root.finish()
        assert same_rows(got, want)
        assert s.exec_stats.co_bucketed_joins == 2
        _assert_trace_integrity(root)
        spans = root.stage_seconds()
        _assert_spans_equal_stats(spans, s.join_stats)
        assert {"scan", "prepare", "match"} <= set(spans)
        if route == "streamed":
            from hyperspace_tpu_torch.execution import executor

            assert executor.last_stream_stats["stream_waves"] > 1
            assert "stream_wave" in spans

    def test_sharded_join_spans_equal_join_stats(self, tmp_path, lake):
        s = _indexed(tmp_path, lake, "sys4", devices=["cpu"] * 4)
        one = _indexed(tmp_path, lake, "sys1")
        want = _join(one, lake).collect()
        ttrace.set_enabled(True)
        root = ttrace.root("serve.query")
        with ttrace.activate(root):
            got = _join(s, lake).collect()
        root.finish()
        assert same_rows(got, want)
        _assert_trace_integrity(root)
        _assert_spans_equal_stats(root.stage_seconds(), s.join_stats)

    def test_aggregate_runs_under_one_agg_span(self, tmp_path, lake):
        s = _indexed(tmp_path, lake)
        items = s.read.parquet(lake[0])
        ttrace.set_enabled(True)
        root = ttrace.root("serve.query")
        with ttrace.activate(root):
            items.filter(items["k"] >= 10).group_by("k").agg(F.count().alias("n")).collect()
        root.finish()
        names = [sp.name for sp in root.spans if sp is not root]
        assert names.count("agg") == 1
        assert set(names) <= set(ttrace_stage_names())

    def test_range_prune_accumulates_on_the_root(self, tmp_path, lake):
        s = _indexed(tmp_path, lake)
        items = s.read.parquet(lake[0])
        ttrace.set_enabled(True)
        root = ttrace.root("serve.query")
        with ttrace.activate(root):
            items.filter((items["k"] >= 10) & (items["k"] < 20)).select("k", "q").collect()
        root.finish()
        from hyperspace_tpu_torch.indexes import zonemaps

        st = zonemaps.last_prune_stats
        assert root.attrs.get("rows_pruned", 0) == st["row_groups_total"] - st["row_groups_kept"]


def ttrace_stage_names():
    from hyperspace_tpu_torch.obs import sites

    return sites.STAGE_NAMES


# ---------------------------------------------------------------------------
# Metrics accounting
# ---------------------------------------------------------------------------


class TestMetricsAccounting:
    def test_breakdown_is_registry_instrument(self, tmp_path, lake):
        s = _indexed(tmp_path, lake)
        inst = tmetrics.registry.stage_timer("hs_serve_stage_seconds")
        binst = tmetrics.registry.stage_timer("hs_build_stage_seconds")
        assert binst.snapshot() == s.build_stats
        _join(s, lake).collect()
        assert inst.snapshot() == s.join_stats
        assert inst.snapshot(), "join recorded no stages"
        text = tmetrics.registry.render_prometheus()
        assert "# TYPE hs_serve_stage_seconds counter" in text
        assert '# TYPE hs_build_stage_seconds counter' in text
        for stage, sec in s.join_stats.items():
            assert f'hs_serve_stage_seconds{{stage="{stage}"}} {tmetrics._prom_num(sec)}' in text
        # the newest session wins, and a reset leaves the session's dict alone
        s2 = _session(tmp_path, "other")
        assert inst.snapshot() == s2.join_stats == {}
        tmetrics.registry.reset()
        assert s.join_stats

    def test_serve_cache_view_live(self, tmp_path, lake):
        s = _indexed(tmp_path, lake)
        s.conf.set(C.SERVE_CACHE_ENABLED, True)
        cache = s.serve_cache
        assert cache is not None
        items = s.read.parquet(lake[0])
        items.filter(items["k"] == 5).select("k", "q").collect()
        snap = tmetrics.registry.snapshot()["views"]["serve_cache"]
        strip = lambda d: {k: v for k, v in d.items() if k != "snapshot_at_ms"}  # noqa: E731
        assert strip(snap) == strip(cache.stats())
        text = tmetrics.registry.render_prometheus()
        assert "hs_view_serve_cache" in text

    def test_prometheus_names_match_the_reference(self):
        """Every instrument the port registers carries the reference's name
        and type, and renders under the same Prometheus header."""
        with tmetrics.registry._lock:
            port = {n: type(i).__name__ for n, i in tmetrics.registry._instruments.items()}
        with jmetrics.registry._lock:
            ref = {n: type(i).__name__ for n, i in jmetrics.registry._instruments.items()}
        assert port and set(port) <= set(ref)
        assert {n: ref[n] for n in port} == port
        for name in ("hs_serve_stage_seconds", "hs_build_stage_seconds", "hs_obs_traces_total",
                     "hs_events_total", "hs_replay_queries_total"):
            assert name in port
        ptext, jtext = tmetrics.registry.render_prometheus(), jmetrics.registry.render_prometheus()
        headers = lambda t: {l for l in t.splitlines() if l.startswith("# TYPE hs_") and "view" not in l}  # noqa: E731,E741
        assert headers(ptext) <= headers(jtext)

    def test_prometheus_render_contains_instruments(self, tmp_path, lake):
        s = _indexed(tmp_path, lake)
        s.conf.set(C.OBS_ENABLED, True)
        T.Hyperspace(s).create_index(
            s.read.parquet(lake[0]), T.CoveringIndexConfig("oi2", ["q"], ["k"])
        )
        text = tmetrics.registry.render_prometheus()
        assert "# TYPE hs_obs_traces_total counter" in text
        assert 'hs_events_total{label="CreateActionEvent"}' in text

    def test_events_counter_and_emit_time_stamp(self, tmp_path):
        s = _session(tmp_path, "sys")
        before = tmetrics.events_total.snapshot().get("CreateActionEvent", 0)
        ev = TT.CreateActionEvent(index_name="x")
        assert ev.timestamp_ms == 0
        s.event_logging.log_event(ev)
        assert ev.timestamp_ms > 0
        after = tmetrics.events_total.snapshot().get("CreateActionEvent", 0)
        assert after == before + 1

    def test_jsonl_event_logger_writes(self, tmp_path):
        s = _session(tmp_path, "sys")
        path = str(tmp_path / "events.jsonl")
        s.conf.set(C.OBS_EVENTLOG_PATH, path)
        s.conf.set(C.EVENT_LOGGER_CLASS, "hyperspace_tpu_torch.telemetry.JsonlEventLogger")
        s.event_logging.log_event(TT.RefreshActionEvent(index_name="idx"))
        s.event_logging.log_event(TT.VacuumActionEvent(index_name="idx"))
        recs = tmetrics.read_jsonl(path)
        assert [r["event"] for r in recs] == ["RefreshActionEvent", "VacuumActionEvent"]
        assert all(r["timestamp_ms"] > 0 for r in recs)
        assert recs[0]["index_name"] == "idx"

    def test_event_classes_are_the_reference_classes(self):
        names = lambda m: {n for n in dir(m) if n.endswith("Event") or n == "AppInfo"}  # noqa: E731
        assert names(TT) == names(JT)


# ---------------------------------------------------------------------------
# Lifecycle action spans
# ---------------------------------------------------------------------------


class TestActionSpans:
    def test_create_action_root_with_build_stages(self, tmp_path, lake):
        s = _session(tmp_path, "sys")
        s.conf.set(C.OBS_ENABLED, True)
        T.Hyperspace(s).create_index(
            s.read.parquet(lake[0]), T.CoveringIndexConfig("ai1", ["k"], ["q"])
        )
        roots = ttrace.finished("action.CreateAction")
        assert len(roots) == 1
        root = roots[0]
        _assert_trace_integrity(root)
        assert root.attrs["status"] == "ok"
        assert root.attrs["index"] == "ai1"
        stages = root.stage_seconds()
        for want in ("scan", "sort", "write", "log_commit", "sidecar_capture"):
            assert want in stages, (want, sorted(stages))
        timed = {k: v for k, v in s.build_stats.items()
                 if not k.startswith("sidecar_capture_") and k not in ("tail_wall", "tail_shards")}
        _assert_spans_equal_stats({k: v for k, v in stages.items() if k != "log_commit"}, timed)

    def test_sharded_create_spans_equal_build_stats(self, tmp_path, lake):
        s = _session(tmp_path, "sys4", devices=["cpu"] * 4)
        s.conf.set(C.OBS_ENABLED, True)
        T.Hyperspace(s).create_index(
            s.read.parquet(lake[0]), T.CoveringIndexConfig("ai4", ["k"], ["q"])
        )
        root = ttrace.finished("action.CreateAction")[-1]
        _assert_trace_integrity(root)
        stages = root.stage_seconds()
        derived = {"tail_wall", "tail_shards"}
        timed = {k: v for k, v in s.build_stats.items()
                 if not k.startswith("sidecar_capture_") and k not in derived}
        assert s.build_stats.get("tail_shards", 0) > 1
        _assert_spans_equal_stats(
            {k: v for k, v in stages.items() if k not in ("log_commit", "pack", "exchange", "unpack")},
            timed,
        )

    def test_failed_action_still_finishes_root(self, tmp_path, lake):
        s = _session(tmp_path, "sys")
        s.conf.set(C.OBS_ENABLED, True)
        hs = T.Hyperspace(s)
        items = s.read.parquet(lake[0])
        hs.create_index(items, T.CoveringIndexConfig("dup", ["k"], ["q"]))
        ttrace.reset()
        with pytest.raises(T.HyperspaceException):
            hs.create_index(items, T.CoveringIndexConfig("dup", ["k"], ["q"]))
        roots = ttrace.finished("action.CreateAction")
        assert len(roots) == 1
        assert roots[0].attrs["status"] == "failed"

    def test_obs_off_is_traceless_and_bit_identical(self, tmp_path, lake):
        s = _indexed(tmp_path, lake)
        q = _join(s, lake)
        s.conf.set(C.OBS_ENABLED, True)
        T.Hyperspace(s).refresh_index("oi1", "full")
        on = q.collect()
        assert ttrace.finished("action.RefreshAction")
        s.conf.set(C.OBS_ENABLED, False)
        ttrace.reset()
        T.Hyperspace(s).refresh_index("oi1", "full")
        assert ttrace.finished() == []
        assert same_rows(q.collect(), on)


# ---------------------------------------------------------------------------
# A key the port reads nowhere (ROADMAP A.11)
# ---------------------------------------------------------------------------


class TestDeviceFilterMinRows:
    def test_setting_it_changes_neither_rows_nor_route(self, tmp_path, lake):
        s = _indexed(tmp_path, lake)
        items = s.read.parquet(lake[0])
        queries = [
            items.filter(items["k"] == 7).select("k", "q"),
            items.filter((items["k"] >= 3) & (items["k"] < 90)).select("k", "q"),
            items.filter(items["q"].isin(1, 2, 3)).select("k", "q"),
        ]
        runs = []
        for value in (None, 1, 1 << 40):
            if value is not None:
                s.conf.set(C.EXECUTION_DEVICE_FILTER_MIN_ROWS, value)
            s.exec_stats.reset()
            rows = [q.collect() for q in queries]
            runs.append((rows, s.exec_stats.as_dict()))
        base_rows, base_stats = runs[0]
        assert base_stats["device_filter_evals"] + base_stats["fused_range_masks"] > 0
        for rows, stats in runs[1:]:
            assert stats == base_stats
            assert all(same_rows(a, b) for a, b in zip(rows, base_rows))
