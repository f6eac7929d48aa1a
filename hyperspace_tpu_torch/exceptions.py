"""Exception types.

Reference: ``HyperspaceException.scala:19`` (single exception type) and
``actions/NoChangesException.scala`` (no-op refresh/optimize marker).
"""


class HyperspaceException(Exception):
    """Any user-visible failure inside the framework."""


class NoChangesException(HyperspaceException):
    """Raised by refresh/optimize validation when there is nothing to do.

    ``Action.run`` treats it as a graceful no-op: the transient log entry is
    never written and the index stays in its previous stable state
    (reference: ``actions/Action.scala:84-105``).
    """


class ConcurrentWriteException(HyperspaceException):
    """Optimistic-concurrency conflict on the operation log.

    Equivalent to ``writeLog`` returning false in the reference
    (``index/IndexLogManager.scala:178-194``): another writer created the
    same log id first.
    """


class LogCorruptedError(HyperspaceException):
    """An operation-log entry exists but does not parse (truncated or
    torn JSON — e.g. a crash on a filesystem without atomic
    publish-by-link).

    Typed so a reader reports the torn entry by path instead of a raw
    decode traceback."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupted log entry {path}: {reason}")
        self.path = path
        self.reason = reason


class ApproximationError(HyperspaceException):
    """The approximate serve plane cannot honestly answer this query
    (``execution/approx_exec.py``): approximate serving is disabled, the
    plan is not served by a clean sampled covering-index scan, an
    aggregate is outside the estimable set (COUNT, SUM), or the 95 %
    confidence interval is wider than the query's error budget. Raised,
    never degraded to a number the caller would over-trust."""
