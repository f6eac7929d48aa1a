"""`hs.explain(df)` — plan diff with vs. without Hyperspace.

Reference: ``plananalysis/PlanAnalyzer.scala:37-418`` — build the plan both
ways, highlight the subtrees that changed (the index scans: both sides
of a rewritten join), and list the indexes used. Counterpart of ``hyperspace_tpu/plananalysis/explain.py`` in
its plain-text form; the console/HTML display modes and the verbose
operator diff are not ported yet (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

_BAR = "=" * 65
_OPEN, _CLOSE = "<----", "---->"


def _highlighted_plan(plan, changed_scans) -> str:
    """Pretty plan string with changed Scan lines wrapped in highlight
    tags (the reference's BufferStream highlight tags)."""
    lines = []

    def walk(node, indent):
        text = node._node_string()
        if node in changed_scans:
            text = f"{_OPEN}{text}{_CLOSE}"
        lines.append("  " * indent + text)
        for c in node.children:
            walk(c, indent + 1)

    walk(plan, 0)
    return "\n".join(lines)


def _index_scans(plan) -> List:
    return [s for s in plan.collect_leaves() if s.relation.index_info]


def explain_string(df, session) -> str:
    """PlanAnalyzer.explainString: optimize the plan with the rule enabled
    and render the diff against the unoptimized plan."""
    original = df.logical_plan
    prev = session.is_hyperspace_enabled()
    try:
        session.enable_hyperspace()
        optimized = session.optimize(original)
    finally:
        if not prev:
            session.disable_hyperspace()

    used_scans = _index_scans(optimized)
    used: Dict[str, Tuple[int, str]] = {}
    for s in used_scans:
        name, ver, _abbr = s.relation.index_info
        used[name] = (ver, s.relation.root_paths[0] if s.relation.root_paths else "")

    buf = [
        _BAR,
        "Plan with indexes:",
        _BAR,
        _highlighted_plan(optimized, set(used_scans)),
        "",
        _BAR,
        "Plan without indexes:",
        _BAR,
        original.pretty(),
        "",
        _BAR,
        "Indexes used:",
        _BAR,
    ]
    for name in sorted(used):
        ver, root = used[name]
        buf.append(f"{name} (v{ver}): {root}")
    if not used:
        buf.append("(none)")
    buf.append("")
    return "\n".join(buf)
