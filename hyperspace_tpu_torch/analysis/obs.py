"""HS9xx — observability-site lints.

The obs plane (``hyperspace_tpu_torch/obs/``, docs/observability.md) gives
every query a root span, every breakdown stage a child span and every
telemetry snapshot a registry instrument. Instrumentation has a failure
mode nothing else catches mechanically: it GROWS — a span per row in a
hot loop, a metric registered from a worker thread, a stage name
misspelled so the trace taxonomy silently forks from the breakdown keys
the querylog, bench gates and docs all key on. This checker makes the
instrumentation surface a declared contract, in the house registry
style (KERNEL_TWINS / SHARED_STATE / COLLECTIVE_SITES): every site is
in ``OBS_SITES`` (``obs/sites.py``) with a one-line justification.

* HS901 — a call that creates spans (``trace.root`` / ``trace.span`` /
  ``trace.stage``) or registers metrics (``registry.counter`` /
  ``gauge`` / ``labeled_counter`` / ``stage_timer`` /
  ``register_view`` / ``register_weak_view``) whose outermost
  enclosing function (or module, for import-time registration) has no
  ``OBS_SITES`` entry:
  undeclared instrumentation. Propagation shims (``trace.carry`` /
  ``activate``) and point events (``trace.event``) are exempt — they
  create no spans.
* HS902 — a CONSTANT span/stage name passed to ``trace.span`` /
  ``trace.stage`` that is not in the declared stage vocabulary
  (the ``*_STAGES`` tuples in ``obs/sites.py``), or a constant
  ``trace.root`` name not in ``ROOT_NAMES``: stage spans exist to
  mirror the breakdown keys — a drifted name forks the taxonomy.
* HS903 — a stale ``OBS_SITES`` entry: unresolved path, unknown kind,
  missing justification, or a declared site whose function no longer
  contains any obs primitive call.

The obs package itself (``obs/``) is exempt from HS901/902: it defines
the primitives and the vocabulary. Trees without an ``OBS_SITES``
registry skip the checker entirely (fixture mini-packages opt in by
shipping one).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from hyperspace_tpu_torch.analysis.core import (
    Finding,
    Project,
    const_str,
    dotted_name,
)

RULES = {
    "HS901": "obs span/metric call site absent from OBS_SITES",
    "HS902": "span/stage name outside the declared stage vocabulary",
    "HS903": "stale OBS_SITES registry entry",
}

#: candidate homes of the OBS_SITES literal, first hit wins
REGISTRY_FILES = ("obs/sites.py", "sites.py")

KINDS = ("span", "metric", "view")

#: span-creating trace primitives (module alias must look like a trace
#: module) and metric-registering registry primitives
TRACE_PRIMS = frozenset({"root", "span", "stage"})
METRIC_PRIMS = frozenset(
    {
        "counter",
        "gauge",
        "labeled_counter",
        "stage_timer",
        "register_view",
        "register_weak_view",
    }
)
_TRACE_BASES = frozenset({"trace", "obs_trace", "_obs_trace"})
_METRIC_BASES = frozenset(
    {"registry", "metrics", "obs_metrics", "_obs_metrics"}
)


@dataclasses.dataclass
class SiteEntry:
    path: str
    kind: str
    why: str
    line: int


# ---------------------------------------------------------------------------
# Registry parsing
# ---------------------------------------------------------------------------


def registry_file(project: Project) -> Optional[str]:
    for rel in REGISTRY_FILES:
        sf = project.file(rel)
        if sf is None or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            targets: List[str] = []
            if isinstance(node, ast.Assign):
                targets = [
                    t.id for t in node.targets if isinstance(t, ast.Name)
                ]
            elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name
            ):
                targets = [node.target.id]
            if "OBS_SITES" in targets:
                return rel
    return None


def parse_sites(
    project: Project,
) -> Tuple[List[SiteEntry], Set[str], Set[str], Optional[str]]:
    """(entries, stage vocabulary, root names, registry rel) from the
    OBS_SITES literal + the ``*_STAGES`` / ``ROOT_NAMES`` tuples;
    ([], set(), set(), None) when absent — trees without an obs plane
    skip the checker."""
    rel = registry_file(project)
    if rel is None:
        return [], set(), set(), None
    sf = project.file(rel)
    entries: List[SiteEntry] = []
    stages: Set[str] = set()
    roots: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            targets = [node.target.id]
        else:
            continue
        for name in targets:
            if name == "OBS_SITES" and isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    key = const_str(k) if k is not None else None
                    if key is None:
                        continue
                    kind = why = ""
                    if isinstance(v, (ast.Tuple, ast.List)) and len(v.elts) >= 2:
                        kind = const_str(v.elts[0]) or ""
                        why = const_str(v.elts[1]) or ""
                    entries.append(SiteEntry(key, kind, why, v.lineno))
            elif name.endswith("_STAGES") and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                stages.update(
                    s for s in (const_str(e) for e in node.value.elts) if s
                )
            elif name == "ROOT_NAMES" and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                roots.update(
                    s for s in (const_str(e) for e in node.value.elts) if s
                )
    return entries, stages, roots, rel


# ---------------------------------------------------------------------------
# Package function index + primitive-call scan
# ---------------------------------------------------------------------------


def _module_dotted(project: Project, rel: str) -> str:
    import os

    pkg = os.path.basename(project.package_dir)
    mod = rel[: -len(".py")] if rel.endswith(".py") else rel
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    mod = mod.replace("/", ".")
    return pkg if mod in ("__init__", "") else f"{pkg}.{mod}"


@dataclasses.dataclass
class _Call:
    rel: str
    line: int
    prim: str  # primitive name (span/root/stage/counter/...)
    site: str  # dotted site path (function, method, or module)
    const_name: Optional[str]  # constant first arg, when present


def _is_obs_call(node: ast.Call) -> Optional[str]:
    """The primitive name when this call is an obs span/metric
    primitive, else None."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    base = dotted_name(f.value)
    if base is None:
        return None
    last = base.rsplit(".", 1)[-1]
    if f.attr in TRACE_PRIMS and last in _TRACE_BASES:
        return f.attr
    if f.attr in METRIC_PRIMS and last in _METRIC_BASES:
        return f.attr
    return None


def _scan_calls(project: Project) -> List[_Call]:
    """Every obs primitive call in the package (obs/ itself exempt),
    attributed to its outermost enclosing def/method or the module."""
    out: List[_Call] = []
    for rel, sf in sorted(project.files.items()):
        if sf.tree is None or rel.split("/", 1)[0] == "obs":
            continue
        mod = _module_dotted(project, rel)

        def visit(node, site: str, depth: int, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                child_site, child_depth, child_cls = site, depth, cls
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    if depth == 0:
                        child_site = (
                            f"{mod}.{cls}.{child.name}"
                            if cls
                            else f"{mod}.{child.name}"
                        )
                    child_depth = depth + 1
                elif isinstance(child, ast.ClassDef) and depth == 0:
                    child_cls = child.name
                elif isinstance(child, ast.Call):
                    prim = _is_obs_call(child)
                    if prim is not None:
                        cname = (
                            const_str(child.args[0]) if child.args else None
                        )
                        out.append(
                            _Call(rel, child.lineno, prim, site, cname)
                        )
                visit(child, child_site, child_depth, child_cls)

        visit(sf.tree, mod, 0, None)
    return out


def _resolvable_paths(project: Project) -> Set[str]:
    """Every dotted path an OBS_SITES entry may legally name: modules,
    top-level functions, and class methods."""
    paths: Set[str] = set()
    for rel, sf in project.files.items():
        if sf.tree is None:
            continue
        mod = _module_dotted(project, rel)
        paths.add(mod)
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                paths.add(f"{mod}.{node.name}")
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        paths.add(f"{mod}.{node.name}.{sub.name}")
    return paths


# ---------------------------------------------------------------------------
# Checker
# ---------------------------------------------------------------------------


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    entries, stages, roots, reg_rel = parse_sites(project)
    if reg_rel is None:
        return findings
    reg_sf = project.file(reg_rel)
    reg_path = reg_sf.rel_path if reg_sf is not None else reg_rel
    declared: Dict[str, SiteEntry] = {e.path: e for e in entries}
    calls = _scan_calls(project)
    called_sites: Set[str] = {c.site for c in calls}

    # -- HS901: every primitive call site is declared ------------------------
    for c in calls:
        if c.site in declared:
            continue
        sf = project.file(c.rel)
        findings.append(
            Finding(
                "HS901",
                sf.rel_path if sf is not None else c.rel,
                c.line,
                f"obs primitive '{c.prim}' called at {c.site!r} but the "
                "site has no OBS_SITES entry (obs/sites.py) — declare "
                "the span/metric site with a one-line justification",
            )
        )

    # -- HS902: constant names stay inside the vocabulary --------------------
    for c in calls:
        if c.const_name is None:
            continue
        if c.prim in ("span", "stage") and stages and c.const_name not in stages:
            sf = project.file(c.rel)
            findings.append(
                Finding(
                    "HS902",
                    sf.rel_path if sf is not None else c.rel,
                    c.line,
                    f"stage-span name {c.const_name!r} is not in the "
                    "declared stage vocabulary (obs/sites.py *_STAGES) — "
                    "span names must mirror the breakdown keys they "
                    "measure",
                )
            )
        elif c.prim == "root" and roots and c.const_name not in roots:
            sf = project.file(c.rel)
            findings.append(
                Finding(
                    "HS902",
                    sf.rel_path if sf is not None else c.rel,
                    c.line,
                    f"root-span name {c.const_name!r} is not in "
                    "ROOT_NAMES (obs/sites.py) — root names are the "
                    "trace taxonomy's top level",
                )
            )

    # -- HS903: registry entries stay live ------------------------------------
    resolvable = _resolvable_paths(project)
    for e in entries:
        if e.kind not in KINDS:
            findings.append(
                Finding(
                    "HS903",
                    reg_path,
                    e.line,
                    f"OBS_SITES entry {e.path!r} has unknown kind "
                    f"{e.kind!r} (want one of {KINDS})",
                )
            )
            continue
        if not e.why.strip():
            findings.append(
                Finding(
                    "HS903",
                    reg_path,
                    e.line,
                    f"OBS_SITES entry {e.path!r} has no justification — "
                    "every instrumented site says why in one line",
                )
            )
            continue
        if e.path not in resolvable:
            findings.append(
                Finding(
                    "HS903",
                    reg_path,
                    e.line,
                    f"OBS_SITES entry {e.path!r} does not resolve to a "
                    "module, function or method in the package — stale "
                    "registry entry",
                )
            )
            continue
        if e.path not in called_sites:
            findings.append(
                Finding(
                    "HS903",
                    reg_path,
                    e.line,
                    f"OBS_SITES entry {e.path!r} resolves but its site "
                    "issues no obs primitive call — stale entry (remove "
                    "it or restore the instrumentation)",
                )
            )
    return findings
