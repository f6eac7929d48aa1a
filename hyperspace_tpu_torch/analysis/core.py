"""hslint core: findings, suppressions, and the analyzed-project model.

The analyzer is pure stdlib ``ast`` — it never imports the code it
checks (so it runs in any environment, including ones without torch or a
compiler) and never executes it (a broken tree still lints).

Suppression contract: a comment ``# hslint: disable=HS402`` (or a
comma-separated list, or ``all``) suppresses matching findings anchored
on the SAME line; a comment-only line suppresses the line directly
below it as well. Text after the rule list (an inline justification) is
ignored. Suppressed findings are still collected (with
``suppressed=True``) so the CLI can report them under
``--show-suppressed``, but they never fail the run.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: Schema-stable finding fields (tests/test_hslint.py golden-checks this).
FINDING_FIELDS = ("rule", "path", "line", "message", "suppressed")

# The rule list stops at the first token that is not a rule id or comma,
# so an inline justification after the ids does not break the match.
_SUPPRESS_RE = re.compile(
    r"#\s*hslint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


@dataclasses.dataclass
class Finding:
    """One rule violation: ``path:line: rule message``."""

    rule: str
    path: str  # relative to the analyzed package's parent
    line: int
    message: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tag}"

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in FINDING_FIELDS}


def _parse_suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    """1-based line -> set of suppressed rule ids ("all" wildcards)."""
    out: Dict[int, Set[str]] = {}
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if raw.lstrip().startswith("#"):
            # standalone comment: also covers the statement below it
            out.setdefault(i + 1, set()).update(rules)
    return out


class SourceFile:
    """One parsed python file: text, lines, AST, suppression map."""

    def __init__(self, abs_path: str, rel_path: str):
        self.abs_path = abs_path
        self.rel_path = rel_path
        with open(abs_path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.suppressions = _parse_suppressions(self.lines)
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.text, filename=abs_path)
        except SyntaxError as e:
            self.parse_error = f"{e.msg} (line {e.lineno})"

    def is_suppressed(self, rule: str, line: int) -> bool:
        rules = self.suppressions.get(line)
        return bool(rules) and (rule in rules or "all" in rules)


class Project:
    """The analyzed tree: every ``*.py`` under ``package_dir``, plus the
    sibling ``tests/`` directory (used by the kernel-parity checker) and
    the CUDA sources under ``csrc/`` when present.

    ``package_dir`` is the python package root (the directory holding
    ``constants.py``, ``actions/``, ``csrc/`` …). Checkers address
    files by path relative to it, so fixture mini-packages in tests
    exercise the same code paths as the real tree.
    """

    def __init__(self, package_dir: str, tests_dir: Optional[str] = None):
        self.package_dir = os.path.abspath(package_dir)
        parent = os.path.dirname(self.package_dir)
        if tests_dir is None:
            cand = os.path.join(parent, "tests")
            tests_dir = cand if os.path.isdir(cand) else None
        self.tests_dir = tests_dir
        self.files: Dict[str, SourceFile] = {}
        self.findings: List[Finding] = []
        for abs_path in self._walk_py(self.package_dir):
            rel = os.path.relpath(abs_path, self.package_dir)
            rel = rel.replace(os.sep, "/")
            sf = SourceFile(abs_path, self.display_path(rel))
            self.files[rel] = sf
            if sf.parse_error:
                self.findings.append(
                    Finding("HS001", sf.rel_path, 1, f"syntax error: {sf.parse_error}")
                )

    @staticmethod
    def _walk_py(root: str) -> Iterable[str]:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__" and not d.startswith(".")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)

    def display_path(self, rel: str) -> str:
        return f"{os.path.basename(self.package_dir)}/{rel}"

    # -- lookups used by checkers ------------------------------------------
    def file(self, rel: str) -> Optional[SourceFile]:
        return self.files.get(rel)

    def files_under(self, *subdirs: str) -> List[Tuple[str, SourceFile]]:
        out = []
        for rel, sf in self.files.items():
            top = rel.split("/", 1)[0]
            if top in subdirs:
                out.append((rel, sf))
        return out

    def cuda_sources(self) -> List[str]:
        """Package-relative paths of the ``csrc/*.cu`` kernel sources,
        sorted; empty when the tree has none."""
        d = os.path.join(self.package_dir, "csrc")
        if not os.path.isdir(d):
            return []
        return sorted(f"csrc/{n}" for n in os.listdir(d) if n.endswith(".cu"))

    def text(self, rel: str) -> str:
        """The text of a non-python file of the package (``csrc/…``)."""
        with open(os.path.join(self.package_dir, rel), "r", encoding="utf-8") as f:
            return f.read()

    def doc_lines(self, name: str) -> Optional[List[str]]:
        """Lines of ``docs/<name>`` next to the package (the contract
        checker reads ``CONFIG.md``), or None when absent — fixture
        trees without docs simply skip the doc-backed rules."""
        return self.aux_lines("docs", name)

    def aux_lines(self, *relpath: str) -> Optional[List[str]]:
        """Lines of any file next to the package (the contract checker
        reads ``scripts/dryrun_multihost.py`` for the collective-site
        witness matrix), or None when absent — fixture trees without it
        simply skip the file-backed rules."""
        p = os.path.join(os.path.dirname(self.package_dir), *relpath)
        if not os.path.isfile(p):
            return None
        with open(p, "r", encoding="utf-8") as f:
            return f.read().splitlines()

    def test_files(self) -> List[Tuple[str, str]]:
        """(relative display path, text) for every test file."""
        if not self.tests_dir or not os.path.isdir(self.tests_dir):
            return []
        out = []
        for abs_path in self._walk_py(self.tests_dir):
            rel = os.path.relpath(abs_path, os.path.dirname(self.tests_dir))
            with open(abs_path, "r", encoding="utf-8") as f:
                out.append((rel.replace(os.sep, "/"), f.read()))
        return out


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local alias -> fully-qualified module name, from every import
    statement in the file (including ones nested in functions — this
    codebase imports lazily inside hot functions)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
