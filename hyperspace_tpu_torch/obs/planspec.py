"""Replayable plan specs — the literal-bearing twin of predicate_shape.

The query log's ``predicate`` field deliberately scrubs literals
(``querylog.predicate_shape``), which makes records profile-safe but
NOT re-executable: the advisor's what-if scorer and the replay harness
(``testing/replay.py``) both need the recorded plan back as a live
``LogicalPlan``. This module is that bridge: :func:`to_spec` serializes
a plan into a small JSON-able dict (operators, columns, join keys,
aggregate specs — and, unlike the shape, the literals), and
:func:`from_spec` rebuilds it against a session, re-reading the source
at the CURRENT snapshot (replay serves today's lake, which is exactly
what a what-if comparison wants).

Recording is opt-in (``hyperspace.obs.querylog.recordPlans``) because
specs carry literals: the default query log stays literal-free, and an
operator turns plan recording on only where replay/advisor fidelity is
worth it. Scenario generators (``testing/replay.py``) always emit
specs — canned workloads have nothing to leak.

Both directions are strictly best-effort: :func:`to_spec` returns None
for any plan (or literal) outside the supported subset — the record
then simply has no ``replay`` field — and :func:`from_spec` raises
:class:`~hyperspace_tpu_torch.exceptions.HyperspaceException` with the
offending op so a replay reports the skip instead of crashing.

Supported subset: Scan (parquet/csv/json/orc/avro/text over root
paths), Filter, Project, inner equi-Join, Aggregate, Sort, Limit, with
comparison/boolean/In/IsNull predicates over int/float/str/bool/None
literals. ``SPEC_V`` bumps on change; readers skip unknown versions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import expressions as E
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    AggSpec,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Scan,
    Sort,
)

SPEC_V = 1

#: relation formats from_spec can re-read via session.read.<fmt>()
_FORMATS = ("parquet", "csv", "json", "orc", "avro", "text")

_BINARY_OPS = {
    E.Eq: "eq",
    E.Ne: "ne",
    E.Lt: "lt",
    E.Le: "le",
    E.Gt: "gt",
    E.Ge: "ge",
    E.And: "and",
    E.Or: "or",
}
_OP_CLASSES = {v: k for k, v in _BINARY_OPS.items()}


def _lit_ok(v: Any) -> bool:
    return v is None or isinstance(v, (bool, int, float, str))


def expr_to_spec(expr: E.Expr) -> Optional[Dict]:
    """Expression tree -> JSON-able dict; None outside the subset."""
    if isinstance(expr, E.Col):
        return {"op": "col", "name": expr.name}
    if isinstance(expr, E.Lit):
        return {"op": "lit", "value": expr.value} if _lit_ok(expr.value) else None
    if type(expr) in _BINARY_OPS:
        left = expr_to_spec(expr.left)
        right = expr_to_spec(expr.right)
        if left is None or right is None:
            return None
        return {"op": _BINARY_OPS[type(expr)], "left": left, "right": right}
    if isinstance(expr, E.Not):
        child = expr_to_spec(expr.child)
        return None if child is None else {"op": "not", "child": child}
    if isinstance(expr, E.In):
        child = expr_to_spec(expr.child)
        if child is None or not all(_lit_ok(v) for v in expr.values):
            return None
        return {"op": "in", "child": child, "values": list(expr.values)}
    if isinstance(expr, E.IsNull):
        child = expr_to_spec(expr.child)
        return None if child is None else {"op": "isnull", "child": child}
    return None


def expr_from_spec(spec: Dict) -> E.Expr:
    op = spec.get("op")
    if op == "col":
        return E.Col(spec["name"])
    if op == "lit":
        return E.Lit(spec["value"])
    if op in _OP_CLASSES:
        return _OP_CLASSES[op](
            expr_from_spec(spec["left"]), expr_from_spec(spec["right"])
        )
    if op == "not":
        return E.Not(expr_from_spec(spec["child"]))
    if op == "in":
        return E.In(expr_from_spec(spec["child"]), tuple(spec["values"]))
    if op == "isnull":
        return E.IsNull(expr_from_spec(spec["child"]))
    raise HyperspaceException(f"Unknown expression spec op {op!r}")


def to_spec(plan: LogicalPlan) -> Optional[Dict]:
    """Plan -> JSON-able spec dict, or None when the plan (or any
    literal in it) falls outside the replayable subset. Never raises —
    this runs on the serve path's querylog append."""
    try:
        node = _node_to_spec(plan)
    except Exception:  # hslint: disable=HS402
        # a recording helper must never fail the query it describes
        return None
    if node is None:
        return None
    node["spec_v"] = SPEC_V
    return node


def _node_to_spec(plan: LogicalPlan) -> Optional[Dict]:
    if isinstance(plan, Scan):
        rel = plan.relation
        if rel.fmt not in _FORMATS or not rel.root_paths:
            return None
        return {"op": "scan", "fmt": rel.fmt, "paths": list(rel.root_paths)}
    if isinstance(plan, Filter):
        child = _node_to_spec(plan.child)
        cond = expr_to_spec(plan.condition)
        if child is None or cond is None:
            return None
        return {"op": "filter", "cond": cond, "child": child}
    if isinstance(plan, Project):
        child = _node_to_spec(plan.child)
        if child is None:
            return None
        return {"op": "project", "cols": list(plan.columns), "child": child}
    if isinstance(plan, Join):
        left, right = _node_to_spec(plan.left), _node_to_spec(plan.right)
        cond = expr_to_spec(plan.condition)
        if left is None or right is None or cond is None:
            return None
        return {
            "op": "join",
            "how": plan.how,
            "cond": cond,
            "left": left,
            "right": right,
        }
    if isinstance(plan, Aggregate):
        child = _node_to_spec(plan.child)
        if child is None:
            return None
        return {
            "op": "aggregate",
            "group_by": list(plan.group_by),
            "aggs": [
                {"func": s.func, "column": s.column, "name": s.name}
                for s in plan.aggs
            ],
            "child": child,
        }
    if isinstance(plan, Sort):
        child = _node_to_spec(plan.child)
        if child is None:
            return None
        return {
            "op": "sort",
            "keys": [[name, bool(asc)] for name, asc in plan.keys],
            "child": child,
        }
    if isinstance(plan, Limit):
        child = _node_to_spec(plan.child)
        if child is None:
            return None
        return {"op": "limit", "n": int(plan.n), "child": child}
    return None


def from_spec(session, spec: Dict) -> LogicalPlan:
    """Spec dict -> live LogicalPlan against ``session`` (scans re-read
    the source paths at the CURRENT snapshot). Raises
    HyperspaceException for unknown spec versions or ops."""
    v = spec.get("spec_v", SPEC_V)
    if not isinstance(v, int) or v > SPEC_V:
        raise HyperspaceException(f"Unknown plan-spec version {v!r}")
    return _node_from_spec(session, spec)


def _node_from_spec(session, spec: Dict) -> LogicalPlan:
    op = spec.get("op")
    if op == "scan":
        fmt = spec.get("fmt", "parquet")
        if fmt not in _FORMATS:
            raise HyperspaceException(f"Unknown scan format {fmt!r}")
        reader = getattr(session.read, fmt)
        return reader(*spec["paths"]).logical_plan
    if op == "filter":
        return Filter(
            expr_from_spec(spec["cond"]),
            _node_from_spec(session, spec["child"]),
        )
    if op == "project":
        return Project(
            list(spec["cols"]), _node_from_spec(session, spec["child"])
        )
    if op == "join":
        return Join(
            _node_from_spec(session, spec["left"]),
            _node_from_spec(session, spec["right"]),
            expr_from_spec(spec["cond"]),
            spec.get("how", "inner"),
        )
    if op == "aggregate":
        return Aggregate(
            list(spec["group_by"]),
            [
                AggSpec(a["func"], a.get("column"), a["name"])
                for a in spec["aggs"]
            ],
            _node_from_spec(session, spec["child"]),
        )
    if op == "sort":
        return Sort(
            [(name, bool(asc)) for name, asc in spec["keys"]],
            _node_from_spec(session, spec["child"]),
        )
    if op == "limit":
        return Limit(int(spec["n"]), _node_from_spec(session, spec["child"]))
    raise HyperspaceException(f"Unknown plan spec op {op!r}")


def spec_scan_paths(spec: Dict) -> List[List[str]]:
    """Every scan's root paths in the spec, left-to-right — the
    advisor's source-identification helper."""
    out: List[List[str]] = []

    def walk(node: Dict) -> None:
        if not isinstance(node, dict):
            return
        if node.get("op") == "scan":
            out.append(list(node.get("paths", [])))
        for key in ("child", "left", "right"):
            sub = node.get(key)
            if sub is not None:
                walk(sub)

    walk(spec)
    return out
