"""HS3xx — hot-path purity inside compiled torch functions.

Counterpart of ``hyperspace_tpu/analysis/purity.py``, which holds the
reference's traced JAX functions (``jax.jit`` / ``shard_map`` /
``vmap``) to device-only code. The port traces nothing: its device work
is hand-written CUDA kernels launched through ctypes (``kernels.py``,
``ops/``) and eager torch ops, so the checker's scope is the functions
that ``torch.compile`` or ``torch.jit.script`` would compile — a
function is *compiled* when it is

* decorated with ``torch.compile`` / ``torch.jit.script`` (also
  ``functools.partial(torch.compile, ...)`` and ``torch.compile(...)``
  called with options), or
* passed by name to ``torch.compile(...)`` / ``torch.jit.script(...)``
  anywhere in the same file.

Inside such a function a numpy call (HS301) breaks the graph or fails
to script, and a host synchronization (HS302: ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``, ``np.asarray``, ``torch.cuda.synchronize``,
``float()``/``int()``/``bool()`` of a tensor) stalls the stream.

The port compiles no function today, so the checker finds nothing on it;
it is kept so that the first one added is held to the rule.

Scope: files under ``ops/``, ``execution/``, ``parallel/`` and
``rules/``. Analysis covers the compiled function's body including
nested ``def``s and lambdas; it does not follow calls into helpers.
Allowlist: ``np.<scalar-type>`` constructors and dtype/introspection
helpers (``np.iinfo``, ``np.dtype``, ``np.pi`` …).
"""

from __future__ import annotations

import ast
from typing import List, Set

from hyperspace_tpu_torch.analysis.core import Finding, Project, dotted_name

RULES = {
    "HS301": "numpy call inside a compiled (torch.compile/jit.script) function",
    "HS302": "host synchronization inside a compiled function",
}

HOT_DIRS = ("ops", "execution", "parallel", "rules")

#: np.<attr> uses that are pure host constants / introspection
NP_ALLOWED = {
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64", "intp",
    "float16", "float32", "float64", "bool_",
    "dtype", "iinfo", "finfo", "issubdtype",
    "pi", "e", "inf", "nan", "newaxis", "errstate",
}

#: method names whose call on a tensor forces a host sync
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: np.<attr> calls that are host syncs rather than plain numpy ops
NP_SYNC = {"asarray", "array", "save", "savez"}

#: dotted calls that synchronize the host with the device
SYNC_CALLS = {"torch.cuda.synchronize"}

#: the compiling entry points, by dotted name
_COMPILERS = ("torch.compile", "torch.jit.script", "jit.script")


def _is_compiler_expr(node: ast.AST) -> bool:
    """True for ``torch.compile``, ``torch.jit.script``,
    ``torch.compile(...)`` with options and ``(functools.)partial(
    torch.compile, ...)``."""
    name = dotted_name(node)
    if name:
        return name in _COMPILERS
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        if fn and fn.split(".")[-1] == "partial" and node.args:
            return _is_compiler_expr(node.args[0])
        return _is_compiler_expr(node.func)
    return False


def _compiled_names(tree: ast.AST) -> Set[str]:
    """Names of functions passed (by name) to a compiler call anywhere in
    the file: ``f2 = torch.compile(f)``, ``torch.jit.script(g)``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_compiler_expr(node.func):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Name):
                    out.add(arg.id)
    return out


def _compiled_functions(tree: ast.AST) -> List[ast.FunctionDef]:
    by_call = _compiled_names(tree)
    compiled = [
        node
        for node in ast.walk(tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and (
            node.name in by_call
            or any(_is_compiler_expr(d) for d in node.decorator_list)
        )
    ]
    # drop functions nested inside another compiled function — the
    # parent's body walk already covers them (no duplicate findings)
    nested = set()
    for fn in compiled:
        for sub in ast.walk(fn):
            if sub is not fn and isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested.add(id(sub))
    return [fn for fn in compiled if id(fn) not in nested]


def _annotation_nodes(fn: ast.FunctionDef) -> Set[int]:
    """ids of every node inside a type annotation under ``fn``:
    annotations never run inside the compiled graph."""
    roots: List[ast.AST] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
                + [args.vararg, args.kwarg]
            ):
                if a is not None and a.annotation is not None:
                    roots.append(a.annotation)
            if node.returns is not None:
                roots.append(node.returns)
        elif isinstance(node, ast.AnnAssign):
            roots.append(node.annotation)
    return {id(n) for root in roots for n in ast.walk(root)}


def _check_body(fn: ast.FunctionDef, sf_path: str) -> List[Finding]:
    findings: List[Finding] = []
    skip = _annotation_nodes(fn)
    for node in [n for stmt in fn.body for n in ast.walk(stmt) if id(n) not in skip]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("np", "numpy")
        ):
            if node.attr in NP_SYNC:
                findings.append(
                    Finding(
                        "HS302",
                        sf_path,
                        node.lineno,
                        f"np.{node.attr} in compiled function {fn.name!r} "
                        "forces a device-to-host copy",
                    )
                )
            elif node.attr not in NP_ALLOWED:
                findings.append(
                    Finding(
                        "HS301",
                        sf_path,
                        node.lineno,
                        f"np.{node.attr} in compiled function {fn.name!r} — "
                        "use torch (numpy breaks the graph or fails to script)",
                    )
                )
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and node.func.attr in SYNC_METHODS:
                findings.append(
                    Finding(
                        "HS302",
                        sf_path,
                        node.lineno,
                        f".{node.func.attr}() in compiled function {fn.name!r} "
                        "is a host sync",
                    )
                )
            fname = dotted_name(node.func)
            if fname in SYNC_CALLS:
                findings.append(
                    Finding(
                        "HS302",
                        sf_path,
                        node.lineno,
                        f"{fname} in compiled function {fn.name!r} is a host sync",
                    )
                )
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and node.args
                and not isinstance(node.args[0], ast.Constant)
            ):
                findings.append(
                    Finding(
                        "HS302",
                        sf_path,
                        node.lineno,
                        f"{node.func.id}() on a tensor in {fn.name!r} reads it "
                        "back to the host (host sync)",
                    )
                )
    return findings


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for _rel, sf in project.files_under(*HOT_DIRS):
        if sf.tree is None:
            continue
        for fn in _compiled_functions(sf.tree):
            findings.extend(_check_body(fn, sf.rel_path))
    return findings
