"""HS7xx — config/doc/fault-matrix contract lints.

PRs 7–8 grew two operator-facing surfaces faster than anything checks
them: the flat ``hyperspace.*`` config keys (``constants.py`` +
``docs/CONFIG.md``) and the fault-injection points
(``testing/faults.py`` + the ``tests/test_faults.py`` matrix). Each is
a three-way contract — declaration, default, documentation (or test) —
that only stays consistent by diligence. This checker makes it
mechanical:

* HS701 — a ``hyperspace.*`` key that the package reads has no
  ``<NAME>_DEFAULT`` sibling in ``constants.py`` (or is read as a bare
  string literal with no constants entry at all): the one place
  defaults live is the constants module, not scattered call sites.
* HS702 — a key the package reads has no row in ``docs/CONFIG.md``:
  every operator-visible knob is documented or it does not ship.
* HS703 — a fault point armed in ``testing/faults.py`` (``POINTS``)
  never appears in ``tests/test_faults.py``, or a crash point
  (``CRASH_POINTS``) never appears in ``tests/test_crash_recovery.py``:
  the point × mode (and crash point × action) matrices are the tested
  contract, an unexercised point is an untested failure mode. The same
  rule covers the multi-host plane: a ``COLLECTIVE_SITES`` entry
  (``parallel/collectives.py``) that never appears in
  ``scripts/dryrun_multihost.py`` — by dotted path or trailing callable
  name, the prefix-family discipline — is a collective the dryrun's
  witness matrix can never exercise, so a newly added collective cannot
  ship unwitnessed. The port's dryrun is
  ``scripts/torch_dryrun_multihost.py`` (``spmd.dryrun_lines``).
* HS704 — a dead key: a ``hyperspace.*`` token documented in
  ``docs/CONFIG.md`` that no constants entry backs (or that nothing
  reads), or a key constant in ``constants.py`` that nothing reads —
  documentation drift in either direction.

Key *prefix families* (constants whose value ends with ``.``, e.g.
``hyperspace.faults.``) are matched by prefix: the doc row
``hyperspace.faults.<point>`` documents the family, and per-point keys
are read through ``Config.prefixed``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from hyperspace_tpu_torch.analysis.core import Finding, Project, const_str

RULES = {
    "HS701": "config key read without a constants default",
    "HS702": "config key read but undocumented in docs/CONFIG.md",
    "HS703": "fault point missing from the tests/test_faults.py matrix",
    "HS704": "dead config key (documented or declared but never read)",
}

CONSTANTS_FILE = "constants.py"
FAULTS_FILE = "testing/faults.py"
FAULT_TESTS = "test_faults.py"
CRASH_TESTS = "test_crash_recovery.py"
CONFIG_DOC = "CONFIG.md"

_GETTERS = frozenset(
    {"get", "get_bool", "get_int", "get_float", "get_str", "set", "unset"}
)

#: a documented key token: `hyperspace.` followed by dotted identifiers
_DOC_KEY_RE = re.compile(r"hyperspace\.[A-Za-z0-9_]+(?:\.[A-Za-z0-9_]+)*\.?")


def _constants_keys(
    project: Project,
) -> Tuple[Dict[str, Tuple[str, int]], Set[str], Set[str]]:
    """({key -> (NAME, line)}, default names, prefix-family values) from
    ``constants.py`` — every ``NAME = "hyperspace.…"`` string assign."""
    keys: Dict[str, Tuple[str, int]] = {}
    defaults: Set[str] = set()
    prefixes: Set[str] = set()
    sf = project.file(CONSTANTS_FILE)
    if sf is None or sf.tree is None:
        return keys, defaults, prefixes
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if t.id.endswith("_DEFAULT"):
                defaults.add(t.id)
                continue
            val = const_str(node.value)
            if val is None or not val.startswith("hyperspace."):
                continue
            if val.endswith("."):
                prefixes.add(val)
            keys[val] = (t.id, node.lineno)
    return keys, defaults, prefixes


def _reads(project: Project, names: Set[str]) -> Tuple[Set[str], List[Tuple[str, int, str]]]:
    """(constant NAMEs referenced outside constants.py, literal
    ``hyperspace.*`` keys passed straight to Config getters). A NAME
    reference is any ``C.NAME`` / imported-``NAME`` use — typed
    accessors in config.py all read through these."""
    used: Set[str] = set()
    literals: List[Tuple[str, int, str]] = []  # (display path, line, key)
    for rel, sf in project.files.items():
        if rel == CONSTANTS_FILE or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Attribute) and node.attr in names:
                used.add(node.attr)
            elif (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in names
            ):
                used.add(node.id)
            elif isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in _GETTERS
                    and node.args
                ):
                    lit = const_str(node.args[0])
                    if lit is not None and lit.startswith("hyperspace."):
                        literals.append((sf.rel_path, node.lineno, lit))
    return used, literals


def _doc_tokens(lines: List[str]) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for i, line in enumerate(lines, start=1):
        for m in _DOC_KEY_RE.finditer(line):
            out.append((m.group(0), i))
    return out


def _fault_points(
    project: Project, var_name: str = "POINTS"
) -> Tuple[List[str], int, Optional[str]]:
    """(``var_name`` tuple entries, line, display path) from
    testing/faults.py — POINTS for the injection registry, CRASH_POINTS
    for the crash registry."""
    sf = project.file(FAULTS_FILE)
    if sf is None or sf.tree is None:
        return [], 0, None
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if var_name not in targets:
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            pts = [const_str(e) for e in node.value.elts]
            return (
                [p for p in pts if p],
                node.lineno,
                sf.rel_path,
            )
    return [], 0, sf.rel_path


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    keys, defaults, prefixes = _constants_keys(project)
    const_sf = project.file(CONSTANTS_FILE)
    const_path = const_sf.rel_path if const_sf is not None else CONSTANTS_FILE
    names = {name for name, _line in keys.values()}
    used, literals = _reads(project, names)
    doc_lines = project.doc_lines(CONFIG_DOC)
    doc_text = "\n".join(doc_lines) if doc_lines is not None else None

    # -- HS701/HS702/HS704(b): per declared key ------------------------------
    for key, (name, line) in sorted(keys.items()):
        is_prefix = key in prefixes
        if name not in used:
            findings.append(
                Finding(
                    "HS704",
                    const_path,
                    line,
                    f"config key {key!r} ({name}) is declared but nothing "
                    "in the package reads it — wire it or delete it",
                )
            )
            continue
        if not is_prefix and f"{name}_DEFAULT" not in defaults:
            findings.append(
                Finding(
                    "HS701",
                    const_path,
                    line,
                    f"config key {key!r} ({name}) is read but has no "
                    f"{name}_DEFAULT in constants.py — defaults live in "
                    "ONE place or they drift",
                )
            )
        if doc_text is not None and key not in doc_text:
            findings.append(
                Finding(
                    "HS702",
                    const_path,
                    line,
                    f"config key {key!r} ({name}) is read but has no row "
                    "in docs/CONFIG.md — undocumented operator surface",
                )
            )

    # -- HS701 for literal-key reads (no constants entry at all) -------------
    for path, line, lit in literals:
        if lit in keys or any(lit.startswith(p) for p in prefixes):
            continue
        findings.append(
            Finding(
                "HS701",
                path,
                line,
                f"config key {lit!r} is read as a bare string literal — "
                "declare it in constants.py with a default",
            )
        )

    # -- HS704(a): documented keys nothing backs -----------------------------
    if doc_lines is not None and keys:
        for token, line in _doc_tokens(doc_lines):
            bare = token.rstrip(".")
            known = (
                token in keys
                or bare in keys
                or (token if token.endswith(".") else token + ".") in prefixes
                or any(token.startswith(p) for p in prefixes)
            )
            if known:
                continue
            if "hslint: disable=HS704" in doc_lines[line - 1]:
                continue
            findings.append(
                Finding(
                    "HS704",
                    f"docs/{CONFIG_DOC}",
                    line,
                    f"documented key {token!r} matches no constants.py "
                    "entry — dead documentation (delete the row or add "
                    "the key)",
                )
            )

    # -- HS703: the fault/crash matrices cover every point -------------------
    for var_name, tests_file, what in (
        ("POINTS", FAULT_TESTS, "point × mode"),
        ("CRASH_POINTS", CRASH_TESTS, "crash point × action"),
    ):
        points, pts_line, faults_path = _fault_points(project, var_name)
        if not points:
            continue
        matrix = None
        for rel, text in project.test_files():
            if rel.endswith(tests_file):
                matrix = text
                break
        if matrix is not None:
            for p in points:
                if p not in matrix:
                    findings.append(
                        Finding(
                            "HS703",
                            faults_path or FAULTS_FILE,
                            pts_line,
                            f"fault point {p!r} is armed in "
                            f"testing/faults.py but never appears in "
                            f"tests/{tests_file} — the {what} "
                            "matrix has a hole",
                        )
                    )

    # -- HS703 (collective plane): every COLLECTIVE_SITES entry must be
    # exercised by the multi-host dryrun's witness matrix — prefix-family
    # match: the full dotted site path or its trailing callable name
    from hyperspace_tpu_torch.analysis import spmd as _spmd

    site_entries, site_rel = _spmd.parse_sites(project)
    if site_entries:
        dryrun_name, dryrun = _spmd.dryrun_lines(project)
        if dryrun is not None:
            text = "\n".join(dryrun)
            site_sf = project.file(site_rel)
            site_path = (
                site_sf.rel_path if site_sf is not None else site_rel
            )
            for e in site_entries:
                token = e.path.rsplit(".", 1)[-1]
                if e.path in text or token in text:
                    continue
                findings.append(
                    Finding(
                        "HS703",
                        site_path,
                        e.line,
                        f"collective site {e.path!r} is registered in "
                        f"COLLECTIVE_SITES but never appears in "
                        f"scripts/{dryrun_name} — the dryrun's witness "
                        "matrix has a hole; add it to a WITNESS_* tuple "
                        "and drive (or explicitly exclude) it",
                    )
                )
    return findings
