"""Serve stress of the port's frontend against the JAX package, on the
CPU: the three cases of ``tests/test_serve_stress.py``.

Each case runs the port's frontend over one lake built by the JAX package:
at 64 clients (marked ``slow``, as the reference marks them) and at 16
clients in tier 1, the latter under the port's runtime lock witness
(``testing/lock_witness``), which must see the frontend's lock taken. Every
answer is held to the JAX package's serial answer to the same query.

* A fixed snapshot with a deliberately small serve-cache budget: every
  answer equals the JAX package's, and the budget holds at every probe.
* Tracing on: one root span per execution, every child chained to its own
  root, one valid query-log record per execution.
* Appends and incremental refreshes while the clients serve: every answer
  equals the JAX package's unindexed answer over the snapshot the query
  saw.
"""

from torch_frontend_twin import PKG, lake, session  # noqa: I001  (caps threads first)

import contextlib
import os
import threading

import pytest
from torch_b5_cases import same_rows

P = PKG["port"]

CASES = [pytest.param(16, id="16clients"),
         pytest.param(64, id="64clients", marks=pytest.mark.slow)]


@contextlib.contextmanager
def _witnessed(clients):
    """At 16 clients, the port's lock witness wraps every lock its
    SHARED_STATE names for the case; yields the snapshot holder."""
    box = {}
    if clients != 16:
        yield box
        return
    lw = P.lock_witness
    lw.reset()
    lw.install()
    try:
        yield box
        box["doc"] = lw.snapshot()
    finally:
        lw.uninstall()
        lw.reset()


def _check_witness(box):
    doc = box.get("doc")
    if doc is not None:
        assert doc["locks"].get("serve/frontend.py::ServeFrontend._lock", 0) > 0, doc["locks"]


def _point(df, k):
    return df.filter(df["k"] == k).select("q", "v")


def _fixed_lake(tmp_path):
    return lake(tmp_path, files=4, rows=30_000, key_hi=2_000, included=("q", "v"), float_col=True)


@pytest.mark.parametrize("clients", CASES)
def test_clients_budgeted_cache_bit_identical(tmp_path, clients):
    """Fixed snapshot, a cache budget far too small for every entry (the
    governor evicts continuously): every result equals the JAX package's
    serial answer and the budget holds at every probe."""
    src, sp = _fixed_lake(tmp_path)
    with _witnessed(clients) as box:
        s = session("port", sp, **{P.C.INDEX_FILTER_RULE_USE_BUCKET_SPEC: True})
        ref = session("jax", sp, **{PKG["jax"].C.INDEX_FILTER_RULE_USE_BUCKET_SPEC: True})
        df, rdf = s.read.parquet(src), ref.read.parquet(src)
        keys = list(range(0, 2_000, 37))
        baseline = {k: ref.execute(_point(rdf, k).logical_plan) for k in keys}
        s.conf.set(P.C.SERVE_CACHE_ENABLED, True)
        s.conf.set(P.C.SERVE_CACHE_MAX_BYTES, 2 << 20)
        cache = s.serve_cache
        fe = P.frontend.ServeFrontend(s)
        errors, violations = [], []
        stop = threading.Event()

        def prober():
            while not stop.is_set():
                if cache.resident_bytes > cache.max_bytes:
                    violations.append(cache.resident_bytes)

        def client(i):
            try:
                for j in range(8):
                    k = keys[(i * 5 + j) % len(keys)]
                    assert same_rows(fe.serve(_point(df, k)), baseline[k]), k
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        probe = threading.Thread(target=prober)
        try:
            for t in threads + [probe]:
                t.start()
            for t in threads:
                t.join(300)
            stop.set()
            probe.join(30)
            assert not errors, errors[:3]
            assert not violations, violations[:5]
            st = cache.stats()
            assert st["high_water_bytes"] <= st["max_bytes"]
            fes = fe.stats()
            assert fes["failed"] == 0
            assert fes["completed"] + fes["deduped"] >= clients * 8
        finally:
            stop.set()
            fe.close()
    _check_witness(box)


@pytest.mark.parametrize("clients", CASES)
def test_clients_obs_parent_child_integrity(tmp_path, clients):
    """Tracing on: every execution yields exactly one root span whose child
    spans all chain to it (no leak across traces through the shared scan
    pool), the query log holds one valid record per execution, and results
    equal the JAX package's serial ones."""
    src, sp = _fixed_lake(tmp_path)
    trace, querylog = P.trace, P.querylog
    with _witnessed(clients) as box:
        s = session("port", sp)
        ref = session("jax", sp)
        df, rdf = s.read.parquet(src), ref.read.parquet(src)
        keys = list(range(0, 2_000, 37))
        baseline = {k: ref.execute(_point(rdf, k).logical_plan) for k in keys}
        s.conf.set(P.C.OBS_ENABLED, True)
        s.conf.set(P.C.OBS_TRACE_RETAIN, 4096)
        trace.reset()
        fe = P.frontend.ServeFrontend(s)
        errors = []

        def client(i):
            try:
                for j in range(8):
                    k = keys[(i * 5 + j) % len(keys)]
                    assert same_rows(fe.serve(_point(df, k)), baseline[k]), k
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            assert not errors, errors[:3]
            stats = fe.stats()
        finally:
            fe.close()
            trace.set_enabled(False)
    _check_witness(box)
    try:
        assert stats["failed"] == 0
        assert stats["completed"] + stats["deduped"] == clients * 8
        roots = trace.finished("serve.query")
        assert len(roots) == stats["completed"]
        seen = set()
        for root in roots:
            assert root.trace_id not in seen
            seen.add(root.trace_id)
            by_id = {sp_.span_id: sp_ for sp_ in root.spans}
            by_id[root.span_id] = root
            for sp_ in root.spans:
                assert sp_.trace_id == root.trace_id
                hops, cur = 0, sp_
                while cur is not root:
                    assert cur.parent_id in by_id, (sp_.name, root.trace_id)
                    cur = by_id[cur.parent_id]
                    hops += 1
                    assert hops < 100
            assert root.attrs["status"] == "ok"
        records = querylog.read_records(querylog.obs_root(s.conf))
        assert len(records) == stats["completed"]
        for r in records:
            assert querylog.validate_record(r) is None, r
    finally:
        trace.reset()


@pytest.mark.parametrize("clients", CASES)
def test_clients_with_concurrent_refresh(tmp_path, clients):
    """Appends and incremental refreshes land while the clients serve: every
    result equals the JAX package's serial unindexed answer over the
    snapshot the query saw, and the index ends ACTIVE."""
    src, sp = lake(tmp_path, files=2, rows=20_000, key_hi=2_000, included=("q", "v"),
                   float_col=True)
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    from torch_frontend_twin import write_rows

    def agg(df, F=P.F):
        return df.filter((df["k"] >= 100) & (df["k"] < 900)).agg(
            F.count().alias("n"), F.sum("q").alias("sq"))

    with _witnessed(clients) as box:
        s = session("port", sp, **{P.C.INDEX_FILTER_RULE_USE_BUCKET_SPEC: True,
                                P.C.INDEX_HYBRID_SCAN_ENABLED: True,
                                P.C.SERVE_CACHE_ENABLED: True,
                                P.C.SERVE_CACHE_MAX_BYTES: 64 << 20})
        hs = P.Hyperspace(s)
        fe = P.frontend.ServeFrontend(s)
        errors, results = [], []
        res_lock = threading.Lock()

        def client(i):
            try:
                for _j in range(4):
                    df = s.read.parquet(src)
                    files = tuple(df.logical_plan.relation.files)
                    out = fe.serve(agg(df))
                    with res_lock:
                        results.append((files, out))
            except Exception as exc:
                errors.append(exc)

        def writer():
            try:
                for i in range(3):
                    tmp = str(scratch / f"a{i}.parquet")
                    write_rows(tmp, 2_000, 100 + i, key_hi=2_000, float_col=True)
                    os.rename(tmp, os.path.join(src, f"a{i}.parquet"))
                    s.index_manager.clear_cache()
                    hs.refresh_index("i1", "incremental")
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        threads.append(threading.Thread(target=writer))
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            assert not errors, errors[:3]
            assert fe.stats()["failed"] == 0
        finally:
            fe.close()
    _check_witness(box)
    ref = session("jax", sp)
    ref.disable_hyperspace()
    expected = {}
    for files, out in results:
        if files not in expected:
            expected[files] = ref.execute(agg(ref.read.parquet(*files), PKG["jax"].F).logical_plan)
        assert same_rows(out, expected[files]), files
    entry = s.index_manager.get_index_log_entry("i1")
    assert entry is not None and entry.state == P.C.States.ACTIVE
    assert s.serve_cache.resident_bytes <= s.serve_cache.max_bytes
    s.conf.set(P.C.SERVE_CACHE_ENABLED, False)
