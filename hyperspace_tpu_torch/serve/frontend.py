"""ServeFrontend — the concurrent serve plane.

Counterpart of ``hyperspace_tpu/serve/frontend.py``. Everything below this
module executes ONE query; the frontend owns the boundary where many
clients meet:

* **Admission control.** Identical in-flight plans are deduplicated
  (single-flight by :func:`plan_fingerprint` + config version + pinned
  snapshot: N clients asking the same question cost one execution), and
  queries queued past ``hyperspace.serve.maxQueueDepth`` are shed with a
  typed :class:`ServeOverloadedError` at submit time, before any work is
  buffered. Per-tenant SLO classes (``hyperspace.fleet.class.<name>.*``)
  cap a class's running queries and shed its backlog first.

* **Snapshot-consistent serving.** At admission each query pins the set
  of latestStable ACTIVE log entries (one read, one consistent set) and
  the rewrite runs against that pin (``rules/apply.apply_hyperspace(
  entries=...)``): a refresh, optimize or vacuum landing mid-query never
  mixes index versions inside one query. Each pin is registered with the
  recovery plane (``metadata/recovery.register_pins``) for the life of
  the query, so orphan GC never quarantines a file a live serve reads.

* **Retry / degrade at the operation boundary.** Transient failures (real
  I/O errors, files vacuumed under the query, injected
  ``testing/faults.py`` faults) retry with exponential backoff
  (``hyperspace.serve.retry.*``), re-pinning the snapshot each attempt.
  Persistent I/O failures of an index-rewritten query degrade to the
  unrewritten plan (the source data: slower, the same rows).

* **Kernel faults fail the query** (ROADMAP C.7, C.11). The reference
  degrades a native kernel's fault to its numpy twin below this module.
  In the port a hand-written kernel's fault (``kernels.KERNEL_FAULTS``) is
  never retried and never degraded: it fails the query, counts in
  ``failed`` and reaches the caller.

Threading: queries run on the frontend's own pool (``hs-serve-*``), each
thread launching its kernels on ``torch.cuda.current_stream`` of its
tensors' device. Per-bucket parquet reads still go to the shared
``io/scan`` pool: serve workers block on scan futures, scan workers never
block on serve futures, so the two pools cannot deadlock. One frontend
lock guards admission state and counters; nothing blocking and no I/O runs
under it. The single-flight map is declared in ``SHARED_STATE``
(``concurrency.py``).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException, ServeOverloadedError
from hyperspace_tpu_torch.kernels import KERNEL_FAULTS
from hyperspace_tpu_torch.metadata import recovery
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import querylog as obs_querylog
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.plan.nodes import LogicalPlan
from hyperspace_tpu_torch.testing.faults import InjectedFault


def plan_fingerprint(plan: LogicalPlan) -> Tuple:
    """Identity of a logical plan for single-flight purposes: the node
    structure (``repr`` covers operators, conditions, projections) plus
    each leaf relation's concrete file snapshot; two scans of the same
    directory at different snapshots must not coalesce."""
    leaves = tuple(
        (
            leaf.relation.files,
            leaf.relation.fmt,
            leaf.relation.excluded_file_ids,
            leaf.relation.options,
        )
        for leaf in plan.collect_leaves()
    )
    return (repr(plan), leaves)


class _SloClass:
    """Per-tenant admission state (``hyperspace.fleet.class.<name>.*``):
    ``max_concurrency`` caps how many class queries RUN at once (excess
    admissions wait in ``pending`` without a worker thread),
    ``max_queue_depth`` sheds past that backlog; 0 = unlimited for
    either. Mutated only under the frontend lock."""

    __slots__ = (
        "name",
        "max_concurrency",
        "max_queue_depth",
        "running",
        "pending",
        "admitted",
        "shed",
    )

    def __init__(self, name: str, max_concurrency: int, max_queue_depth: int):
        self.name = name
        self.max_concurrency = max_concurrency
        self.max_queue_depth = max_queue_depth
        self.running = 0
        self.pending: deque = deque()
        self.admitted = 0
        self.shed = 0

    def has_slot(self) -> bool:
        return self.max_concurrency <= 0 or self.running < self.max_concurrency


def _chain_future(inner: Future, outer: Future) -> None:
    """Propagate ``inner``'s outcome onto the caller-visible ``outer``
    (deferred SLO-class dispatch hands out ``outer`` at submit time)."""

    def _done(f: Future) -> None:
        exc = f.exception()
        if exc is not None:
            outer.set_exception(exc)
        else:
            outer.set_result(f.result())

    inner.add_done_callback(_done)


def _is_transient(exc: BaseException) -> bool:
    """Retryable? Injected faults carry the answer; every real OSError
    (a file a concurrent vacuum removed, flaky storage, Arrow I/O errors)
    is worth the retry budget. Engine errors and kernel faults are
    deterministic, and a retry would repeat them."""
    if isinstance(exc, InjectedFault):
        return exc.transient
    return isinstance(exc, OSError)


class ServeFrontend:
    """Long-lived concurrent query frontend over one session.

    Usage (also ``session.serve_frontend`` for a shared instance)::

        fe = session.serve_frontend
        table = fe.serve(df)             # blocking
        fut = fe.submit(df)              # Future[pyarrow.Table]

    Deduplicated callers share one result; pyarrow Tables are immutable,
    so sharing is safe.
    """

    def __init__(self, session):
        self._session = session
        self._max_queue = session.conf.serve_max_queue_depth
        self.max_concurrency = session.conf.serve_max_concurrency
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_concurrency,
            thread_name_prefix="hs-serve",
        )
        self._lock = threading.Lock()
        self._inflight: dict = {}
        self._queued = 0
        self._closed = False
        # per-tenant SLO classes, frozen at construction like the pool
        # size; unknown class names see only the global bounds
        self._slo_classes = {
            name: _SloClass(name, caps[0], caps[1])
            for name, caps in session.conf.fleet_slo_classes.items()
        }
        # counters (read via stats(); all mutated under _lock)
        self._admitted = 0
        self._completed = 0
        self._deduped = 0
        self._shed = 0
        self._retries = 0
        self._degraded = 0
        self._degraded_pins = 0
        self._failed = 0
        self._latencies: deque = deque(maxlen=4096)
        # observability: adopt the session's hyperspace.obs.* settings
        # (process-global, last-writer-wins), open the query log next to
        # the lake, and export stats() as a live registry view
        self._obs_enabled = obs_trace.configure(session.conf)
        self._querylog = obs_querylog.open_log(session.conf) if self._obs_enabled else None
        self._stats_view = obs_metrics.registry.register_weak_view("serve_frontend", self)

    # -- snapshot pinning ---------------------------------------------------
    def _pin(self) -> Optional[Tuple]:
        """The latestStable ACTIVE entries, captured once: the query's
        index snapshot. Transient log-read failures retry inline with the
        serve backoff; a persistent failure degrades to pin=None (serve
        without indexes), because a dead metadata store must not take
        query serving down with it."""
        session = self._session
        if not session.is_hyperspace_enabled() or not session.conf.apply_enabled:
            return ()
        attempts = session.conf.serve_retry_max_attempts
        backoff = session.conf.serve_retry_backoff_ms / 1000.0
        for attempt in range(attempts):
            try:
                with obs_trace.span("pin"):
                    return tuple(session.index_manager.get_indexes([States.ACTIVE]))
            # catch-all IS the contract: a pin failure of any shape degrades
            # to serving without indexes, never fails the query
            except Exception as exc:  # hslint: disable=HS402
                if not _is_transient(exc) or attempt + 1 >= attempts:
                    with self._lock:
                        self._degraded_pins += 1
                    return None
                with self._lock:
                    self._retries += 1
                if backoff > 0:
                    time.sleep(backoff * (1 << attempt))
        return None

    def _register_pins(self, pin: Optional[Tuple]) -> int:
        """Record the pinned snapshot with the recovery plane. The fleet
        frontend overrides this to also publish a lease-expiring durable
        pin file per index, so a GC or vacuum in another process sees it."""
        return recovery.register_pins(pin)

    # -- admission ----------------------------------------------------------
    def submit(self, query, slo_class: Optional[str] = None) -> Future:
        """Admit one query (DataFrame or LogicalPlan). Returns a Future
        resolving to the pyarrow Table. Raises :class:`ServeOverloadedError`
        when the pending queue (or the class's) is full; nothing is
        buffered for a shed query. An unconfigured (or None) ``slo_class``
        sees only the global bounds."""
        plan = getattr(query, "logical_plan", query)
        if not isinstance(plan, LogicalPlan):
            raise HyperspaceException(
                f"serve() takes a DataFrame or LogicalPlan, got {type(query)}"
            )
        cls = self._slo_classes.get(slo_class) if slo_class else None
        # shed BEFORE pinning: an overloaded frontend rejects in O(1) with
        # no metadata I/O on the caller thread. Depth is re-checked at
        # enqueue (the pin read drops the lock in between).
        with self._lock:
            self._check_admittable_locked(cls)
        # the query ROOT span starts here so queue-wait is on the trace; a
        # query that dedups onto an in-flight twin abandons it unfinished
        # (one root span per EXECUTION)
        root = obs_trace.root("serve.query", slo_class=slo_class)
        with obs_trace.activate(root):
            pin = self._pin()
        pin_token = self._register_pins(pin)
        fp = (
            plan_fingerprint(plan),
            self._session.conf.version,
            None if pin is None else tuple((e.name, e.id) for e in pin),
        )
        if root.span_id is not None:
            root.set("fingerprint", hashlib.sha256(repr(fp).encode("utf-8")).hexdigest()[:16])
            for key, value in obs_querylog.plan_attrs(self._session.conf, plan).items():
                root.set(key, value)
        try:
            with self._lock:
                existing = self._inflight.get(fp)
                if existing is not None:
                    self._deduped += 1
                    recovery.release_pins(pin_token)
                    return existing
                self._check_admittable_locked(cls)
                self._queued += 1
                self._admitted += 1
                if cls is not None:
                    cls.admitted += 1
                if cls is None or cls.has_slot():
                    if cls is not None:
                        cls.running += 1
                    fut = self._pool.submit(self._run, plan, pin, pin_token, cls, root)
                else:
                    # class concurrency cap reached: park the admission; a
                    # finishing class query dispatches it
                    fut = Future()
                    cls.pending.append((plan, pin, pin_token, fut, root))
                self._inflight[fp] = fut
        except BaseException:
            recovery.release_pins(pin_token)
            raise
        fut.add_done_callback(lambda _f, fp=fp: self._forget(fp))
        return fut

    def _fleet_class_depth_locked(self, cls: _SloClass) -> int:
        """Peers' contribution to this class's queue depth (lock held).
        One process has no peers; ``FleetFrontend`` counts gossiped depths
        so a class bound holds fleet-wide."""
        return 0

    def _check_admittable_locked(self, cls: Optional[_SloClass] = None) -> None:
        """Raise unless a new query may enter (lock held). The class bound
        is checked first: a tenant over its own budget sheds with its class
        named, before it presses on the global queue."""
        if self._closed:
            raise HyperspaceException("ServeFrontend is closed")
        if cls is not None and cls.max_queue_depth > 0:
            fleet_depth = self._fleet_class_depth_locked(cls)
            if len(cls.pending) + cls.running + fleet_depth >= cls.max_queue_depth:
                cls.shed += 1
                self._shed += 1
                raise ServeOverloadedError(
                    f"SLO class {cls.name!r} queue full ({cls.running} "
                    f"running + {len(cls.pending)} pending + {fleet_depth} "
                    f"fleet >= maxQueueDepth {cls.max_queue_depth}); shedding"
                )
        if self._max_queue > 0 and self._queued >= self._max_queue:
            self._shed += 1
            raise ServeOverloadedError(
                f"serve queue full ({self._queued} pending >= "
                f"maxQueueDepth {self._max_queue}); shedding"
            )

    def _dispatch_pending_locked(self, cls: _SloClass) -> List[int]:
        """Hand parked class admissions to the pool while slots are free
        (lock held). Returns the pin tokens of cancelled parked admissions,
        which the caller releases outside the lock."""
        cancelled: List[int] = []
        while cls.pending and cls.has_slot():
            plan, pin, pin_token, outer, root = cls.pending.popleft()
            # a parked outer future may have been cancelled by its caller:
            # claim it (RUNNING blocks a later cancel) or drop the admission
            if not outer.set_running_or_notify_cancel():
                cancelled.append(pin_token)
                self._queued -= 1
                continue
            cls.running += 1
            inner = self._pool.submit(self._run, plan, pin, pin_token, cls, root)
            _chain_future(inner, outer)
        return cancelled

    def serve(self, query, slo_class: Optional[str] = None):
        """Blocking convenience: submit and wait."""
        return self.submit(query, slo_class=slo_class).result()

    def _forget(self, fp) -> None:
        with self._lock:
            self._inflight.pop(fp, None)

    # -- execution ----------------------------------------------------------
    def _execute_pinned(self, plan: LogicalPlan, pin: Optional[Tuple]):
        from hyperspace_tpu_torch.execution import execute
        from hyperspace_tpu_torch.rules.apply import apply_hyperspace

        session = self._session
        optimized = plan
        if pin:
            with obs_trace.span("rewrite"):
                optimized = apply_hyperspace(session, plan, entries=list(pin))
            cur = obs_trace.current()
            if cur is not None:
                cur.root.set("indexes", obs_querylog.indexes_in_plan(optimized))
                cur.root.set("rule", obs_querylog.rule_flavor(plan))
        with obs_trace.span("execute"):
            return execute(optimized, session)

    def _run(
        self,
        plan: LogicalPlan,
        pin: Optional[Tuple],
        pin_token: int,
        cls: Optional[_SloClass] = None,
        root=obs_trace.NOOP,
    ):
        with self._lock:
            self._queued -= 1
        with obs_trace.activate(root):
            if root.span_id is not None:
                # admission -> worker pickup, on the root's own clock
                obs_trace.stage("queue_wait", root._t0)
            try:
                out = self._run_attempts(plan, pin, pin_token, cls, root)
                if root.span_id is not None:
                    root.set("status", "ok")
                    root.set("rows_returned", int(out.num_rows))
                    self._querylog_append(root)
                return out
            except BaseException:
                if root.span_id is not None:
                    root.set("status", "failed")
                    root.set("rows_returned", 0)
                    self._querylog_append(root)
                raise
            finally:
                root.finish()

    def _run_attempts(
        self,
        plan: LogicalPlan,
        pin: Optional[Tuple],
        pin_token: int,
        cls: Optional[_SloClass],
        root,
    ):
        session = self._session
        attempts = session.conf.serve_retry_max_attempts
        backoff = session.conf.serve_retry_backoff_ms / 1000.0
        t_start = time.perf_counter()
        attempt = 1
        try:
            while True:
                try:
                    out = self._execute_pinned(plan, pin)
                    self._record(t_start)
                    return out
                except KERNEL_FAULTS:
                    # a hand-written kernel's fault: neither retried nor
                    # degraded to the source plan (ROADMAP C.7, C.11)
                    with self._lock:
                        self._failed += 1
                    raise
                except Exception as exc:  # classified below; always re-raised
                    if _is_transient(exc) and attempt < attempts:
                        attempt += 1
                        with self._lock:
                            self._retries += 1
                        root.add_event("retry", attempt=attempt, error=str(exc)[:200])
                        if backoff > 0:
                            time.sleep(backoff * (1 << (attempt - 2)))
                        # re-pin: a vacuum may have removed the pinned
                        # version's files; the current snapshot serves.
                        # Swap the GC pin along with it.
                        recovery.release_pins(pin_token)
                        pin = self._pin()
                        pin_token = self._register_pins(pin)
                        continue
                    if isinstance(exc, OSError) and pin:
                        # persistent I/O failure of the index-rewritten
                        # query: degrade to the unrewritten plan (the source
                        # data; the same rows)
                        with self._lock:
                            self._degraded += 1
                        root.add_event("degrade", error=str(exc)[:200])
                        try:
                            out = self._execute_pinned(plan, ())
                        except KERNEL_FAULTS:
                            with self._lock:
                                self._failed += 1
                            raise
                        except Exception:
                            with self._lock:
                                self._failed += 1
                            raise exc from None
                        self._record(t_start)
                        return out
                    with self._lock:
                        self._failed += 1
                    raise
        finally:
            recovery.release_pins(pin_token)
            if cls is not None:
                with self._lock:
                    cls.running -= 1
                    dropped = self._dispatch_pending_locked(cls)
                for token in dropped:
                    recovery.release_pins(token)

    def _querylog_append(self, root) -> None:
        """One record per executed query (best-effort: an unwritable
        sidecar never fails the query)."""
        if self._querylog is None:
            return
        self._querylog.append(obs_querylog.record_from_root(root))

    def _record(self, t_start: float) -> None:
        dt = time.perf_counter() - t_start
        with self._lock:
            self._completed += 1
            self._latencies.append(dt)

    # -- introspection / lifecycle ------------------------------------------
    def stats(self) -> dict:
        """One consistent snapshot of the frontend counters, plus p50/p99
        over the most recent completions (seconds). ``snapshot_at_ms``
        stamps when; merge several frontends' snapshots with
        ``obs.merge_snapshots``."""
        with self._lock:
            lat: List[float] = sorted(self._latencies)
            out = {
                "snapshot_at_ms": int(time.time() * 1000),
                "admitted": self._admitted,
                "completed": self._completed,
                "deduped": self._deduped,
                "shed": self._shed,
                "retries": self._retries,
                "degraded": self._degraded,
                "degraded_pins": self._degraded_pins,
                "failed": self._failed,
                "queued": self._queued,
                "inflight": len(self._inflight),
                "max_concurrency": self.max_concurrency,
            }
            if self._slo_classes:
                out["slo_classes"] = {
                    name: {
                        "admitted": cls.admitted,
                        "shed": cls.shed,
                        "running": cls.running,
                        "pending": len(cls.pending),
                        "max_concurrency": cls.max_concurrency,
                        "max_queue_depth": cls.max_queue_depth,
                    }
                    for name, cls in self._slo_classes.items()
                }
        if lat:
            out["p50_s"] = lat[len(lat) // 2]
            out["p99_s"] = lat[min(len(lat) - 1, (len(lat) * 99) // 100)]
        return out

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, wait: bool = True) -> None:
        with self._lock:
            self._closed = True
            parked = [item for cls in self._slo_classes.values() for item in cls.pending]
            for cls in self._slo_classes.values():
                cls.pending.clear()
        # parked class admissions can never dispatch once closed: fail their
        # futures and release their pins outside the lock (a caller-cancelled
        # future takes no exception)
        for _plan, _pin, pin_token, outer, _root in parked:
            recovery.release_pins(pin_token)
            if outer.set_running_or_notify_cancel():
                outer.set_exception(HyperspaceException("ServeFrontend closed while queued"))
        self._pool.shutdown(wait=wait)
        if self._querylog is not None:
            self._querylog.close()
        # provider-matched: closing an old frontend must not tear down a
        # newer live frontend's view
        obs_metrics.registry.unregister_view("serve_frontend", self._stats_view)

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
