"""`hs.explain(df)` — plan diff with vs. without Hyperspace.

Reference: ``plananalysis/PlanAnalyzer.scala:37-418`` — build the plan both
ways, highlight the subtrees that changed (the index scans: both sides of
a rewritten join), and list the indexes used plus, in verbose mode, all
ACTIVE candidate indexes and the operator-count diff
(``PhysicalOperatorAnalyzer.scala``). Counterpart of
``hyperspace_tpu/plananalysis/explain.py`` with its three display modes;
the text is the JAX package's byte for byte. Host code: no device work.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException

_BAR = "=" * 65


class DisplayMode:
    """Explain rendering mode (reference: ``plananalysis/DisplayMode.scala``
    — PlainText / Console / HTML variants differing in the highlight tags
    wrapped around index scans and in newline/escape handling)."""

    name = "plaintext"
    highlight_open = "<----"
    highlight_close = "---->"
    newline = "\n"

    def escape(self, text: str) -> str:
        return text


class ConsoleMode(DisplayMode):
    name = "console"
    highlight_open = "\x1b[93m"  # bright yellow
    highlight_close = "\x1b[0m"


class HTMLMode(DisplayMode):
    name = "html"
    highlight_open = "<b>"
    highlight_close = "</b>"
    newline = "<br/>"

    def escape(self, text: str) -> str:
        return (
            text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        )


_MODES = {m.name: m for m in (DisplayMode, ConsoleMode, HTMLMode)}


def get_display_mode(name: str) -> DisplayMode:
    cls = _MODES.get(name.lower())
    if cls is None:
        raise HyperspaceException(
            f"Unknown explain display mode {name!r}; one of {sorted(_MODES)}"
        )
    return cls()


def _highlighted_plan(plan, changed_scans, mode: DisplayMode) -> str:
    """Pretty plan string with changed Scan lines wrapped in the mode's
    highlight tags (the reference's BufferStream highlight tags)."""
    lines = []

    def walk(node, indent):
        text = mode.escape(node._node_string())
        if node in changed_scans:
            text = f"{mode.highlight_open}{text}{mode.highlight_close}"
        lines.append("  " * indent + text)
        for c in node.children:
            walk(c, indent + 1)

    walk(plan, 0)
    return "\n".join(lines)


def _index_scans(plan) -> List:
    return [s for s in plan.collect_leaves() if s.relation.index_info]


def _operator_counts(plan) -> Counter:
    c: Counter = Counter()

    def walk(node):
        c[type(node).__name__] += 1
        for ch in node.children:
            walk(ch)

    walk(plan)
    return c


def _operator_diff_table(with_plan, without_plan) -> str:
    """Operator-count comparison (PhysicalOperatorAnalyzer.scala)."""
    wc, woc = _operator_counts(with_plan), _operator_counts(without_plan)
    names = sorted(set(wc) | set(woc))
    rows = [("Operator", "Hyperspace", "Original")]
    rows += [(n, str(wc.get(n, 0)), str(woc.get(n, 0))) for n in names]
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    out = []
    for i, r in enumerate(rows):
        out.append(" | ".join(v.ljust(w) for v, w in zip(r, widths)))
        if i == 0:
            out.append("-+-".join("-" * w for w in widths))
    return "\n".join(out)


def explain_string(
    df, session, manager, verbose: bool = False, mode: str = None
) -> str:
    """PlanAnalyzer.explainString: optimize the plan with the rule enabled
    and render the diff against the unoptimized plan. ``mode`` overrides
    the session's ``hyperspace.explain.displayMode`` conf (plaintext /
    console / html)."""
    dm = get_display_mode(mode or session.conf.explain_display_mode)
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
        _highlighted_plan(optimized, set(used_scans), dm),
        "",
        _BAR,
        "Plan without indexes:",
        _BAR,
        dm.escape(original.pretty()),
        "",
        _BAR,
        "Indexes used:",
        _BAR,
    ]
    for name in sorted(used):
        ver, root = used[name]
        buf.append(dm.escape(f"{name} (v{ver}): {root}"))
    if not used:
        buf.append("(none)")
    buf.append("")

    if verbose:
        buf += [
            _BAR,
            "Operator diff:",
            _BAR,
            dm.escape(_operator_diff_table(optimized, original)),
            "",
            _BAR,
            "Applicable indexes:",
            _BAR,
        ]
        active = manager.get_indexes([States.ACTIVE])
        for e in sorted(active, key=lambda e: e.name):
            index = e.derived_dataset
            buf.append(
                dm.escape(
                    f"{e.name}: kind={index.kind}, "
                    f"indexed={list(index.indexed_columns)}"
                )
            )
        if not active:
            buf.append("(none)")
        buf.append("")
    # identity when dm.newline == "\n"; re-joins per-line for html's <br/>
    return dm.newline.join(line for chunk in buf for line in chunk.split("\n"))
