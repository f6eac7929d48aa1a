"""Column-name resolution (case-insensitive by default, nested fields).

Reference: ``util/ResolverUtils.scala`` — resolves requested column names
against a plan's schema, optionally case-sensitively; nested struct fields
are flattened into top-level index columns with the ``__hs_nested.``
prefix (``ResolvedColumn``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

from hyperspace_tpu_torch.constants import NESTED_FIELD_PREFIX
from hyperspace_tpu_torch.exceptions import HyperspaceException


@dataclasses.dataclass(frozen=True)
class ResolvedColumn:
    """A resolved column; ``is_nested`` marks a struct-path column.

    ``normalized_name`` is the name used inside index data (nested paths get
    the ``__hs_nested.`` prefix so they become legal flat column names —
    reference ResolverUtils.ResolvedColumn).
    """

    name: str
    is_nested: bool = False

    @property
    def normalized_name(self) -> str:
        return (NESTED_FIELD_PREFIX + self.name) if self.is_nested else self.name

    @staticmethod
    def from_normalized(name: str) -> "ResolvedColumn":
        if name.startswith(NESTED_FIELD_PREFIX):
            return ResolvedColumn(name[len(NESTED_FIELD_PREFIX):], True)
        return ResolvedColumn(name, False)


def nested_available_from(column_names: Iterable[str]) -> List[str]:
    """The dotted struct paths a relation surfaces, derived from its
    flattened ``__hs_nested.``-prefixed columns (io/columnar.py
    ``flatten_schema_fields``) — the ``nested_available`` input to
    :func:`resolve`."""
    return [
        c[len(NESTED_FIELD_PREFIX):]
        for c in column_names
        if c.startswith(NESTED_FIELD_PREFIX)
    ]


def resolve_one(
    requested: str, available: Sequence[str], case_sensitive: bool = False
) -> Optional[str]:
    """Return the matching available name, or None."""
    if case_sensitive:
        return requested if requested in available else None
    low = requested.lower()
    for a in available:
        if a.lower() == low:
            return a
    return None


def resolve(
    requested: Iterable[str],
    available: Sequence[str],
    case_sensitive: bool = False,
    nested_available: Sequence[str] = (),
) -> Optional[List[ResolvedColumn]]:
    """Resolve all names or return None (ResolverUtils.resolve).

    ``nested_available`` lists dotted struct paths (e.g. ``a.b.c``) that the
    relation can surface as nested index columns.
    """
    out: List[ResolvedColumn] = []
    for r in requested:
        m = resolve_one(r, available, case_sensitive)
        if m is not None:
            out.append(ResolvedColumn(m, False))
            continue
        m = resolve_one(r, nested_available, case_sensitive)
        if m is not None:
            out.append(ResolvedColumn(m, True))
            continue
        return None
    return out


def require_resolve(
    requested: Iterable[str],
    available: Sequence[str],
    case_sensitive: bool = False,
    nested_available: Sequence[str] = (),
) -> List[ResolvedColumn]:
    resolved = resolve(requested, available, case_sensitive, nested_available)
    if resolved is None:
        raise HyperspaceException(
            f"Columns {list(requested)} could not be resolved against "
            f"available columns {list(available)}"
        )
    return resolved
