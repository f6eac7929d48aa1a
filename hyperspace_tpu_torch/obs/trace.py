"""Structured tracing — one root span per query or lifecycle action.

Counterpart of ``hyperspace_tpu/obs/trace.py``, same surface and
semantics:

* A **root span** wraps every lifecycle action (``actions/base.py``) and
  any query a caller runs under :func:`root` (the serve tier, A.10b,
  opens one per admitted query). Child **stage spans** are recorded by
  the same ``_stage_add`` hooks that feed the session's breakdowns
  (``session.join_stats``, ``session.build_stats``), with the seconds
  those hooks add, so a trace's stage seconds equal the breakdown's by
  construction.

* **Context propagation.** The current span rides a ``contextvars``
  ContextVar. Thread pools do not propagate context, so every pool
  boundary on the serve and build paths wraps its submitted callables in
  :func:`carry`: identity when tracing is off, a parent hand-off when on.

* **Off path.** Every entry point checks one module bool (``_enabled``);
  with ``hyperspace.obs.enabled`` off (the default) :func:`span` returns
  a shared no-op singleton, :func:`carry` returns the callable untouched
  and :func:`stage` is one comparison. Tracing adds no device
  synchronisation and no host read: a join stage's seconds already hold
  its device work (``join_exec._sync``).

Finished roots land in a bounded in-memory ring (:func:`finished`) and
are counted in the metrics registry; the durable per-query record is the
query log's job (``obs/querylog.py``). Configuration is process-global,
last writer wins. Every span and metric site is declared in
``obs/sites.py`` (``OBS_SITES``).
"""

from __future__ import annotations

import contextvars
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

from hyperspace_tpu_torch import constants as C

# -- module state (SHARED_STATE-registered; hyperspace_tpu_torch/concurrency.py) --

#: master switch — rebind-only bool; a racy read costs one span, never a
#: torn value
_enabled = False

#: per-trace child-span cap / finished-trace ring size (rebind-only ints,
#: re-published whole by configure())
_max_spans = C.OBS_TRACE_MAX_SPANS_DEFAULT

_rec_lock = threading.Lock()
#: finished ROOT spans, oldest-first (guarded by _rec_lock)
_finished: deque = deque(maxlen=C.OBS_TRACE_RETAIN_DEFAULT)

#: the active span of the calling context (set via activate()/span())
_current: contextvars.ContextVar = contextvars.ContextVar(
    "hs_obs_span", default=None
)


def _now_ms() -> int:
    return int(time.time() * 1000)


class Span:
    """One timed operation. Roots own the flat list of their trace's
    finished spans (appended under ``_rec_lock`` — children finish on
    arbitrary pool threads); child spans carry a reference to their
    root. Attributes are plain JSON-able values."""

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "start_ms",
        "_t0",
        "duration_s",
        "attrs",
        "root",
        "spans",
        "events",
        "spans_dropped",
    )

    def __init__(
        self,
        name: str,
        parent: Optional["Span"] = None,
        attrs: Optional[dict] = None,
    ):
        self.name = name
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = (
            parent.trace_id if parent is not None else uuid.uuid4().hex[:32]
        )
        self.span_id = uuid.uuid4().hex[:16]
        self.start_ms = _now_ms()
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.attrs: Dict = dict(attrs) if attrs else {}
        self.root: "Span" = parent.root if parent is not None else self
        # root-only trace state
        self.spans: List["Span"] = []
        self.events: List[Dict] = []
        self.spans_dropped = 0

    # -- lifecycle ----------------------------------------------------------
    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def add_event(self, name: str, **attrs) -> None:
        """Attach a point-in-time event (retry, degrade, shed, link) to
        the trace; recorded on the ROOT under the record lock — events
        fire from arbitrary worker threads."""
        ev = {"name": name, "ts_ms": _now_ms(), **attrs}
        with _rec_lock:
            self.root.events.append(ev)

    def finish(self) -> "Span":
        return self._close(time.perf_counter() - self._t0)

    def _close(self, duration_s: float) -> "Span":
        if self.duration_s is not None:
            return self  # idempotent — double-finish keeps the first
        self.duration_s = duration_s
        root = self.root
        with _rec_lock:
            if len(root.spans) < _max_spans:
                root.spans.append(self)
            else:
                root.spans_dropped += 1
            if root is self:
                _finished.append(self)
        if root is self:
            from hyperspace_tpu_torch.obs import metrics as _m

            _m.traces_total.inc()
            _m.spans_total.inc(len(self.spans))
        return self

    # -- context-manager protocol ------------------------------------------
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": self.start_ms,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
        }

    def stage_seconds(self) -> Dict[str, float]:
        """Root-only: child span busy-seconds keyed by span name, summed
        — the same shape as ``last_serve_breakdown`` (stages overlap
        under the pipelined serve, so values are busy time and may sum
        past wall time, exactly like the breakdown they mirror)."""
        out: Dict[str, float] = {}
        with _rec_lock:
            spans = list(self.spans)
        for s in spans:
            if s is self or s.duration_s is None:
                continue
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out


class _NoopSpan:
    """The shared disabled-path span: every method is a no-op, so call
    sites never branch beyond the module-bool check in span()/root()."""

    __slots__ = ()
    trace_id = None
    span_id = None
    name = ""
    duration_s = None

    def set(self, key, value):
        return self

    def add_event(self, name, **attrs):
        pass

    def finish(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def stage_seconds(self):
        return {}


NOOP = _NoopSpan()


class _Activation:
    """Context manager installing ``span`` as the calling context's
    current span (and restoring the previous one on exit). With
    ``owned=True`` the span is also finished on exit (the ``with
    trace.span(...)`` shape); a plain activation leaves it open —
    activation and lifetime are decoupled because a root span outlives
    several activations (admission thread, then the worker running the
    query)."""

    __slots__ = ("_span", "_token", "_owned")

    def __init__(self, span, owned: bool = False):
        self._span = span
        self._token = None
        self._owned = owned

    def __enter__(self):
        if not isinstance(self._span, _NoopSpan):
            self._token = _current.set(self._span)
        return self._span

    def __exit__(self, *exc):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if self._owned:
            self._span.finish()


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------


def set_enabled(on: bool) -> None:
    """Flip the process-global tracing switch (rebind-only publish)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def configure(conf) -> bool:
    """Adopt a session's ``hyperspace.obs.*`` trace settings (process-
    global, last-writer-wins — the telemetry doctrine). Returns the
    resulting enabled state."""
    global _max_spans, _finished
    set_enabled(conf.obs_enabled)
    _max_spans = conf.obs_trace_max_spans
    retain = conf.obs_trace_retain
    with _rec_lock:
        if retain != _finished.maxlen:
            _finished = deque(_finished, maxlen=retain)
    return _enabled


def root(name: str, **attrs) -> Span:
    """Start a ROOT span (a new trace). Returns :data:`NOOP` when
    tracing is off — callers hold and finish the result either way."""
    if not _enabled:
        return NOOP
    return Span(name, parent=None, attrs=attrs)


def activate(span) -> _Activation:
    """Install ``span`` as the current span for a ``with`` block (does
    not finish it on exit — see :class:`_Activation`)."""
    return _Activation(span)


def span(name: str, **attrs):
    """Start a CHILD span of the current span, as a context manager
    that finishes it on exit. No-op when tracing is off or no trace is
    active in this context (stage instrumentation outside a root —
    e.g. a bare ``collect()`` with obs off — must cost nothing)."""
    if not _enabled:
        return NOOP
    parent = _current.get()
    if parent is None:
        return NOOP
    return _Activation(Span(name, parent=parent, attrs=attrs), owned=True)


def stage(
    name: str,
    t0: Optional[float] = None,
    seconds: Optional[float] = None,
    attrs: Optional[dict] = None,
) -> None:
    """Record an already-timed stage as a child span of the current
    context — either ``[t0, now]`` on the perf_counter clock or an
    explicit ``seconds`` duration taken as the span's duration exactly
    (the shuffle plane measures stage seconds itself; the port's
    ``_stage_add`` hooks pass the seconds they add to the breakdown). This is the hook ``_stage_add`` calls: the
    stage-span timing IS the breakdown increment, so trace and
    breakdown can never disagree."""
    if not _enabled:
        return
    parent = _current.get()
    if parent is None:
        return
    s = Span(name, parent=parent, attrs=attrs)
    if seconds is not None:
        # the caller's own measurement is the span's duration, to the bit:
        # a breakdown fed the same seconds agrees with the trace exactly
        dur = max(0.0, float(seconds))
        s._t0 = t0 if t0 is not None else time.perf_counter() - dur
    else:
        if t0 is not None:
            s._t0 = t0
        dur = time.perf_counter() - s._t0
    s.start_ms = parent.root.start_ms + int(
        max(0.0, s._t0 - parent.root._t0) * 1000
    )
    s._close(dur)


def event(name: str, **attrs) -> None:
    """Attach a point event to the current trace (retry, degrade,
    shed, cross-process link); dropped when no trace is active."""
    if not _enabled:
        return
    cur = _current.get()
    if cur is not None:
        cur.add_event(name, **attrs)


def accumulate(key: str, value) -> None:
    """Add ``value`` into the ROOT span's ``attrs[key]`` (numeric
    accumulator, taken under the record lock — hooks fire from
    arbitrary pool threads). This is how per-execution counters that
    are produced deep inside the engine (e.g. zone-map pruning's
    rows-pruned count) attribute to the query that caused them instead
    of to a process-global last-writer cell: each execution's root
    carries exactly its own deltas, so concurrent queries never
    cross-attribute. Dropped when tracing is off or no trace is
    active."""
    if not _enabled:
        return
    cur = _current.get()
    if cur is None:
        return
    root_span = cur.root
    with _rec_lock:
        root_span.attrs[key] = root_span.attrs.get(key, 0) + value


def current() -> Optional[Span]:
    if not _enabled:
        return None
    return _current.get()


def current_trace_id() -> Optional[str]:
    """The active trace id, for cross-process propagation (claim files,
    bus events) — None when tracing is off or no trace is active."""
    cur = current()
    return cur.trace_id if cur is not None else None


def carry(fn: Callable) -> Callable:
    """Capture the calling context's current span and re-install it
    around every invocation of ``fn`` — the pool-boundary propagation
    shim (``ThreadPoolExecutor`` does not propagate contextvars).
    Identity when tracing is off or no span is active, so wrapped
    submit sites cost nothing on the disabled path. Safe for
    ``pool.map``: each invocation sets/resets independently."""
    if not _enabled:
        return fn
    parent = _current.get()
    if parent is None:
        return fn

    def run(*args, **kwargs):
        token = _current.set(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            _current.reset(token)

    return run


def finished(name: Optional[str] = None) -> List[Span]:
    """Completed root spans, oldest first (optionally filtered by root
    name) — the bench/test introspection surface."""
    with _rec_lock:
        roots = list(_finished)
    if name is not None:
        roots = [r for r in roots if r.name == name]
    return roots


def reset() -> None:
    """Drop the finished-trace ring (test isolation)."""
    with _rec_lock:
        _finished.clear()
