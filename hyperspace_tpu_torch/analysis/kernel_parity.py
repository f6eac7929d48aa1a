"""HS1xx — hand-written CUDA kernel / plain torch twin parity.

Counterpart of ``hyperspace_tpu/analysis/kernel_parity.py``. The port's
kernels (``csrc/*.cu``, built by ``kernels.py`` and launched through
ctypes) are trusted only because each one has a plain PyTorch twin of the
same function and a test on the card holding the kernel to it. The
reference checks its native C++ exports against its ``KERNEL_TWINS``;
the port's registry (``ops/__init__.py``) names a kernel by its source
instead of by one export, because a kernel's launches go through several
``extern "C"`` entries of one file (a count and an emit pass, a plan
and a build). This checker turns that contract into lint:

* every ``extern "C"`` export (an ``hs_``-prefixed function) of a
  ``csrc/*.cu`` file must belong to a source that a ``KERNEL_TWINS``
  entry names (HS101), and every entry must name a source that exists
  and exports at least one entry (HS102);
* the entry's module must be a module of the package that defines the
  registered wrapper and the registered plain twin (HS103);
* ``tests/test_torch_cuda.py`` — the file that runs on the card — must
  reference the entry's wrapper, its name or one of its source's
  exports, so the parity claim is exercised where the kernel runs
  (HS104);
* a FUSED export (``hs_fused_*`` or ``hs_agg_*``: the one-pass
  filter→aggregate and its group passes) must register an in-package
  interpreted twin — a plain function defined in the package — never a
  ``torch.*`` single op: a single-op twin cannot witness whole-pipeline
  parity (HS105).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.analysis.core import Finding, Project, const_str

RULES = {
    "HS101": "CUDA export missing from the KERNEL_TWINS parity registry",
    "HS102": "KERNEL_TWINS entry names a source with no extern \"C\" export",
    "HS103": "KERNEL_TWINS wrapper or plain torch twin does not resolve",
    "HS104": "CUDA kernel has no test on the card referencing it",
    "HS105": "fused-pipeline export needs an in-package interpreted twin",
}

#: where the registry lives and the file that runs on the card
REGISTRY_FILE = "ops/__init__.py"
CARD_TESTS = "test_torch_cuda.py"

# A C export: an optional ``extern "C"`` (the export may open its own
# linkage or sit inside an ``extern "C" {`` block), one or more type
# tokens, then an hs_-prefixed identifier, then an argument list —
# anchored at line start so call sites inside kernel bodies don't match.
_EXPORT_RE = re.compile(
    r'^(?:extern\s+"C"\s+)?(?:[A-Za-z_][A-Za-z0-9_]*\s+)+\**(hs_[A-Za-z0-9_]+)\s*\(',
    re.MULTILINE,
)

_FUSED_PREFIXES = ("hs_fused_", "hs_agg_")


def cuda_exports(cu_text: str) -> List[str]:
    """Exported symbol names: line-anchored ``hs_``-prefixed function
    definitions (the export convention; device code and helpers are
    unprefixed or static), in order of appearance."""
    out: List[str] = []
    for m in _EXPORT_RE.finditer(cu_text):
        if m.group(1) not in out:
            out.append(m.group(1))
    return out


def _registry(
    tree: ast.AST,
) -> Optional[Tuple[int, Dict[str, Tuple[str, str, str, str]]]]:
    """(line, {name: (module, wrapper, plain twin, source)}) from the
    KERNEL_TWINS literal."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "KERNEL_TWINS" not in targets or not isinstance(node.value, ast.Dict):
            continue
        entries: Dict[str, Tuple[str, str, str, str]] = {}
        for k, v in zip(node.value.keys, node.value.values):
            key = const_str(k) if k is not None else None
            if key is None:
                continue
            fields = ["", "", "", ""]
            if isinstance(v, (ast.Tuple, ast.List)):
                for i, e in enumerate(v.elts[:4]):
                    fields[i] = const_str(e) or ""
            entries[key] = tuple(fields)
        return node.lineno, entries
    return None


def _module_functions(project: Project, module: str) -> Optional[set]:
    """Names of the functions defined in ``module`` (a dotted module of
    the analyzed package), or None when it is not one."""
    pkg = os.path.basename(project.package_dir)
    if not module.startswith(pkg + "."):
        return None
    tail = module[len(pkg) + 1 :].replace(".", "/")
    for rel in (f"{tail}.py", f"{tail}/__init__.py"):
        sf = project.file(rel)
        if sf is not None and sf.tree is not None:
            return {
                n.name
                for n in ast.walk(sf.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
    return None


def _source_rel(project: Project, source: str) -> str:
    """A registry source path (``<package>/csrc/x.cu``) relative to the
    package."""
    pkg = os.path.basename(project.package_dir)
    return source[len(pkg) + 1 :] if source.startswith(pkg + "/") else source


def check(project: Project) -> List[Finding]:
    sources = project.cuda_sources()
    reg_sf = project.file(REGISTRY_FILE)
    if not sources or reg_sf is None or reg_sf.tree is None:
        return []  # no CUDA layer in this tree: nothing to check
    exports = {rel: cuda_exports(project.text(rel)) for rel in sources}
    reg = _registry(reg_sf.tree)
    findings: List[Finding] = []
    if reg is None:
        findings.append(
            Finding(
                "HS101",
                reg_sf.rel_path,
                1,
                "no KERNEL_TWINS registry found; every CUDA export needs a "
                "registered wrapper and plain torch twin (exports: "
                + ", ".join(e for rel in sources for e in exports[rel])
                + ")",
            )
        )
        return findings
    reg_line, entries = reg
    registered = {_source_rel(project, src) for _m, _w, _p, src in entries.values()}
    for rel in sources:
        if rel in registered:
            continue
        for export in exports[rel]:
            findings.append(
                Finding(
                    "HS101",
                    reg_sf.rel_path,
                    reg_line,
                    f"CUDA export {export!r} ({rel}) belongs to no KERNEL_TWINS "
                    "entry (module, wrapper, plain twin, source)",
                )
            )
    card_tests = [
        text for rel, text in project.test_files() if rel.endswith("/" + CARD_TESTS)
    ]
    for name, (module, wrapper, plain, source) in sorted(entries.items()):
        rel = _source_rel(project, source)
        src_exports = exports.get(rel)
        if not src_exports:
            findings.append(
                Finding(
                    "HS102",
                    reg_sf.rel_path,
                    reg_line,
                    f"KERNEL_TWINS entry {name!r} names {source!r}, which is no "
                    "csrc/*.cu source with an extern \"C\" export (stale registry?)",
                )
            )
            src_exports = []
        defined = _module_functions(project, module)
        if defined is None:
            findings.append(
                Finding(
                    "HS103",
                    reg_sf.rel_path,
                    reg_line,
                    f"{name}: module {module!r} is no module of the package",
                )
            )
        else:
            for role, fn in (("wrapper", wrapper), ("plain twin", plain)):
                if not fn or fn not in defined:
                    findings.append(
                        Finding(
                            "HS103",
                            reg_sf.rel_path,
                            reg_line,
                            f"{name}: registered {role} {fn!r} is not defined in "
                            f"{module}",
                        )
                    )
        fused = [e for e in src_exports if e.startswith(_FUSED_PREFIXES)]
        if fused and (plain.startswith("torch.") or "." in plain or defined is None):
            findings.append(
                Finding(
                    "HS105",
                    reg_sf.rel_path,
                    reg_line,
                    f"{name}: fused-pipeline exports ({', '.join(fused)}) must "
                    f"register an in-package interpreted twin, got {plain!r} — "
                    "a torch single-op twin cannot witness whole-pipeline parity",
                )
            )
        tokens = [t for t in (wrapper, name, *src_exports) if t]
        if card_tests and not any(t in text for text in card_tests for t in tokens):
            findings.append(
                Finding(
                    "HS104",
                    reg_sf.rel_path,
                    reg_line,
                    f"{name}: tests/{CARD_TESTS} references neither {wrapper!r}, "
                    f"{name!r} nor an export of {source!r} — the parity contract "
                    "is unverified on the card",
                )
            )
    return findings
