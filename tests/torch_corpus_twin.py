"""One scenario through both packages, for the twins of the reference's
regression corpus (``tests/test_torch_{regressions, nested_columns,
engine, aggregates, join_rule, e2e_covering, factories, ...}.py``).

A scenario is a function ``scenario(P, ctx)`` written once against
:class:`Pkg`, the namespace of one package (``PORT`` or ``JAX``). It
makes its data under ``ctx.root``, drives ``ctx.session`` and returns its
observations: tables, masks, plan text, values. It keeps the reference
test's own oracle asserts (pyarrow or Python), which so hold for both
packages. :func:`twin` runs it once a package, in turn at the same
absolute root (the first run's tree is moved aside before the second
starts), so paths in plans and log entries are the same, and asserts:

1. the observations equal (:func:`assert_same`: tables in order with
   floats bit for bit, arrays bitwise, everything else by ``==``);
2. every index the runs left under the system path equal, its files
   byte for byte (``_zonemaps.json`` / ``_aggstate.json`` without their
   files' mtimes) and its log entries apart from ids and timestamps;
3. each query the scenario registered with :meth:`Ctx.cross` served by
   the other package over this package's tree and index: the same plan
   text and the same rows in order.

The port's session is ``device="cpu"`` (``devices=["cpu"] * n`` at n
shards); the JAX package's is its tests' own (``tests/conftest.py``:
``jax.devices()[:n]``, 8 buckets).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import importlib
import os

import numpy as np
import pyarrow as pa
import pytest
from torch_b5_cases import same_rows
from torch_index_files import LOG_DIR, index_files, normalized_log

#: the buckets of the reference's test sessions (tests/conftest.py)
NUM_BUCKETS = 8


class Pkg:
    """One package's modules and the calls whose signatures differ."""

    def __init__(self, name: str):
        self.name = name
        self.root = "hyperspace_tpu_torch" if name == "port" else "hyperspace_tpu"
        self.C = self.m("constants")
        self.States = self.C.States
        self.F = self.m("functions")
        self.E = self.m("plan.expressions")
        self.nodes = self.m("plan.nodes")
        self.columnar = self.m("io.columnar")
        self.ColumnarBatch = self.columnar.ColumnarBatch
        self.pio = self.m("io.parquet")
        self.executor = self.m("execution.executor")
        self.join_exec = self.m("execution.join_exec")
        self.filter_ops = self.m("ops.filter")
        self.factories = self.m("factories")
        self.HyperspaceException = self.m("exceptions").HyperspaceException
        self.Hyperspace = self.m("hyperspace").Hyperspace
        self.CoveringIndexConfig = self.m("indexes.covering").CoveringIndexConfig
        self.DataSkippingIndexConfig = self.m("indexes.dataskipping").DataSkippingIndexConfig
        self.MinMaxSketch = self.m("indexes.sketches").MinMaxSketch
        self.IndexLogManager = self.m("metadata.log_manager").IndexLogManager
        self.IndexDataManager = self.m("metadata.data_manager").IndexDataManager
        self._session_cls = self.m("session").HyperspaceSession

    def m(self, mod: str):
        return importlib.import_module(f"{self.root}.{mod}")

    @property
    def is_port(self) -> bool:
        return self.name == "port"

    def session(self, sys_path: str, shards: int = 1):
        if self.is_port:
            s = self._session_cls(device="cpu", devices=["cpu"] * shards)
        else:
            import jax

            s = self._session_cls(devices=jax.devices()[:shards])
        s.conf.set(self.C.INDEX_SYSTEM_PATH, sys_path)
        s.conf.set(self.C.INDEX_NUM_BUCKETS, NUM_BUCKETS)
        return s

    def device_mask(self, cond, batch) -> np.ndarray:
        """``ops.filter.device_filter_mask``; the port's on the CPU."""
        if self.is_port:
            return self.filter_ops.device_filter_mask(cond, batch, "cpu")
        return np.asarray(self.filter_ops.device_filter_mask(cond, batch))

    def bucket_pruned_scan(self, scan, cond, session):
        """``executor._bucket_pruned_scan``; the port's takes the session."""
        if self.is_port:
            return self.executor._bucket_pruned_scan(scan, cond, session)
        return self.executor._bucket_pruned_scan(scan, cond)

    def co_bucketed_join(self, left, right, keys):
        if self.is_port:
            return self.join_exec.co_bucketed_join(left, right, keys, None, device="cpu")
        return self.join_exec.co_bucketed_join(left, right, keys, None)


PORT, JAX = Pkg("port"), Pkg("jax")


class Ctx:
    """What one run of a scenario works in: its root, a session on the
    system path ``<root>/indexes`` and its Hyperspace, made on first use."""

    def __init__(self, P: Pkg, root: str, shards: int, monkeypatch=None):
        self.P, self.root, self.shards, self.monkeypatch = P, root, shards, monkeypatch
        self.sys = os.path.join(root, "indexes")
        self._session = self._hs = None
        self.cross_queries = []

    @property
    def session(self):
        if self._session is None:
            self._session = self.P.session(self.sys, self.shards)
        return self._session

    @property
    def hs(self):
        if self._hs is None:
            self._hs = self.P.Hyperspace(self.session)
        return self._hs

    def path(self, *parts) -> str:
        return os.path.join(self.root, *parts)

    def cross(self, query) -> None:
        """Register ``query(P, session) -> DataFrame`` for the other
        package to serve over this run's tree and index, with this run's
        conf and Hyperspace on; its plan text and rows are taken now."""
        s = self.session
        on = s.is_hyperspace_enabled()
        s.enable_hyperspace()
        try:
            df = query(self.P, s)
            self.cross_queries.append((query, df.explain(), df.collect()))
        finally:
            if not on:
                s.disable_hyperspace()

    def conf(self) -> dict:
        return dict(self.session.conf._values) if self._session is not None else {}


def assert_same(a, b, where="obs"):
    """Equal observations: tables in order with floats bit for bit,
    numpy arrays bitwise with equal dtypes, containers element by element,
    floats by their bits, everything else by ``==``."""
    if isinstance(a, pa.Table):
        assert isinstance(b, pa.Table) and same_rows(a, b), (where, a, b)
    elif isinstance(a, (pa.Array, pa.ChunkedArray)):
        assert_same(pa.table({"c": a}), pa.table({"c": b}), where)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (where, a, b)
        assert a.tobytes() == b.tobytes(), (where, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and np.float64(a).tobytes() == np.float64(b).tobytes(), (where, a, b)
    else:
        assert a == b, (where, a, b)


def _index_dirs(sys_path: str) -> list:
    if not os.path.isdir(sys_path):
        return []
    return sorted(d for d in os.listdir(sys_path)
                  if os.path.isdir(os.path.join(sys_path, d, LOG_DIR)))


def _cross_serve(ctx: Ctx, reader: Pkg) -> None:
    if not ctx.cross_queries:
        return
    s = reader.session(ctx.sys, ctx.shards)
    for k, v in ctx.conf().items():
        s.conf.set(k, v)
    s.enable_hyperspace()
    for query, plan, rows in ctx.cross_queries:
        df = query(reader, s)
        assert df.explain() == plan, (reader.name, plan, df.explain())
        assert same_rows(df.collect(), rows), (reader.name, plan)


def twin(tmp_path, scenario, shards: int = 1, monkeypatch=None):
    """Run ``scenario`` through the port, then the JAX package, at one
    root; hold the port to the JAX package (module docstring). Returns the
    port's observations."""
    tmp_path = str(tmp_path)
    run = os.path.join(tmp_path, "run")
    obs, ctxs = {}, {}
    for P in (PORT, JAX):
        os.makedirs(run)
        ctx = Ctx(P, run, shards, monkeypatch)
        obs[P.name] = scenario(P, ctx)
        if monkeypatch is not None:
            monkeypatch.undo()
        ctxs[P.name] = ctx
        os.rename(run, os.path.join(tmp_path, P.name))
    assert_same(obs["port"], obs["jax"])
    port_sys, jax_sys = (os.path.join(tmp_path, n, "indexes") for n in ("port", "jax"))
    names = _index_dirs(port_sys)
    assert names == _index_dirs(jax_sys), (names, _index_dirs(jax_sys))
    sys_path = os.path.join(run, "indexes")
    for name in names:
        mine, ref = (index_files(os.path.join(d, name)) for d in (port_sys, jax_sys))
        assert sorted(mine) == sorted(ref), (name, sorted(mine), sorted(ref))
        for rel in mine:
            assert mine[rel] == ref[rel], f"{name}/{rel} differs from the JAX package's"
        assert normalized_log(os.path.join(port_sys, name), sys_path) == normalized_log(
            os.path.join(jax_sys, name), sys_path), name
    for owner, reader in (("port", JAX), ("jax", PORT)):
        os.rename(os.path.join(tmp_path, owner), run)
        try:
            _cross_serve(ctxs[owner], reader)
        finally:
            os.rename(run, os.path.join(tmp_path, owner))
    return obs["port"]


def rows_of(mask) -> list:
    return np.nonzero(np.asarray(mask))[0].tolist()


def sorted_table(t: pa.Table) -> pa.Table:
    return t.sort_by([(c, "ascending") for c in t.column_names])


#: the mtime every source file of a scenario gets, so both packages' runs
#: sign the same files alike (a signature hashes path, size and mtime)
SOURCE_MTIME_NS = 1_600_000_000 * 10**9


def write(path: str, table: pa.Table) -> str:
    """``table`` as one parquet file at ``path``, with the pinned mtime."""
    import pyarrow.parquet as pq

    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(table, path)
    os.utime(path, ns=(SOURCE_MTIME_NS, SOURCE_MTIME_NS))
    return path


def pin_mtimes(root: str) -> str:
    """Give every file under ``root`` the pinned mtime (for data written by
    a reference test's own generator)."""
    for d, _dirs, files in os.walk(root):
        for f in files:
            os.utime(os.path.join(d, f), ns=(SOURCE_MTIME_NS, SOURCE_MTIME_NS))
    return root


def write_parts(path: str, table: pa.Table, n_files: int = 1, name="p{i}.parquet") -> str:
    """``table`` split into ``n_files`` parquet files under ``path``."""
    rows = table.num_rows
    for i in range(n_files):
        lo, hi = i * rows // n_files, (i + 1) * rows // n_files
        write(os.path.join(path, name.format(i=i)), table.slice(lo, hi - lo))
    return path


def sample_parquet(root: str) -> str:
    """``tests/conftest.py::sample_parquet``'s dataset under ``root``."""
    rng = np.random.default_rng(0)
    d = os.path.join(root, "sample")
    for i in range(3):
        n = 100
        write(
            os.path.join(d, f"part-{i}.parquet"),
            pa.table({
                "date": pa.array([f"2017-09-{(j % 28) + 1:02d}" for j in range(n)]),
                "rguid": pa.array([f"guid-{i}-{j}" for j in range(n)]),
                "clicks": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
                "query": pa.array([["ibraco", "facebook", "donde", "banana"][j % 4]
                                   for j in range(n)]),
                "imprs": pa.array(rng.integers(0, 100, n), type=pa.int64()),
            }),
        )
    return d


@pytest.fixture(params=[1, 8], ids=["mesh1", "mesh8"])
def shards(request):
    """The reference's ``session`` fixture runs every session-driven case
    at mesh sizes 1 and 8; the twins run both packages at each."""
    return request.param
