"""HS10xx — memory-residency lints.

ROADMAP item 1 (out-of-core serve: budgeted streaming, spill-aware
caching) needs what KERNEL_TWINS gave kernels and SHARED_STATE gave
concurrency: a complete, statically checked inventory of every site
whose resident bytes grow with relation size, each declaring the bound
that keeps it finite. ``ALLOC_SITES`` (``hyperspace_tpu_torch/memory.py``)
is that inventory; this checker keeps it honest.

* HS1001 — a row-proportional materialization (``read_table``,
  ``.to_numpy`` / ``.combine_chunks`` on a full table,
  ``np.concatenate`` of an unbounded accumulation, ``np.empty(n, …)``
  with a relation-derived size) inside a serve/build hot-path function
  (``execution/`` / ``indexes/`` / ``io/`` / ``serve/``, restricted to
  the cross-module reach closure from the public surface) whose
  enclosing function has no ``ALLOC_SITES`` entry. Per-function size
  taint decides "row-proportional": a value derived from a full
  relation's file list (``.files``, a ``files``/``paths`` parameter, a
  ``read_table`` result) is unbounded; a per-row-group or per-chunk
  slice (subscripts, loop targets, ``read_table_row_groups``) is not;
  an accumulator appended to across an unbounded loop is.
* HS1002 — a registered site whose declared bound class is not
  structurally enforced: ``cache-governed`` but the value never flows
  through a ``.put(...)`` (in the site or a direct caller);
  ``chunk-bounded`` but the site has no chunk loop;
  ``row-group-bounded`` but the site never touches the row-group read
  path; ``wave-budget`` but the site references no wave/budget/pool
  machinery.
* HS1003 — a stale ``ALLOC_SITES`` entry: unknown plane or bound
  class, missing justification, unresolved path, or a site whose
  function no longer contains any allocation primitive.
* HS1004 — residency-witness model gap (``hslint --witness``): the
  runtime witness (``testing/residency_witness.py``) observed an
  allocation site absent from the registry, or a site's recorded peak
  bytes exceed its declared bound class's ceiling
  (``memory.BOUND_CLASS_CEILINGS``). Registered sites never witnessed
  print as staleness warnings.

Trees without an ``ALLOC_SITES`` registry skip the checker entirely
(fixture mini-packages opt in by shipping a ``memory.py``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, List, Optional, Set, Tuple

from hyperspace_tpu_torch.analysis.core import (
    Finding,
    Project,
    const_str,
    dotted_name,
    import_aliases,
)

RULES = {
    "HS1001": "row-proportional hot-path materialization absent from "
    "ALLOC_SITES",
    "HS1002": "declared allocation bound class is not structurally enforced",
    "HS1003": "stale ALLOC_SITES registry entry",
    "HS1004": "residency witness model gap",
}

#: candidate homes of the ALLOC_SITES literal, first hit wins
REGISTRY_FILES = ("memory.py",)

PLANES = ("build", "serve", "maintenance")
BOUND_CLASSES = (
    "cache-governed",
    "wave-budget",
    "chunk-bounded",
    "row-group-bounded",
    "const-bounded",
    "spill-bounded",
)

#: top-level package dirs whose functions are the serve/build hot path
HOT_DIRS = ("execution", "indexes", "io", "serve")

#: full-relation read primitives (always unbounded) vs the per-selection
#: row-group read path (bounded by construction)
READ_PRIMS = frozenset({"read_table"})
SLICE_READ_PRIMS = frozenset(
    {"read_table_row_groups", "read_file_row_groups"}
)
#: arrow materializers — unbounded iff their base value is tainted
ARROW_PRIMS = frozenset(
    {"to_numpy", "combine_chunks", "to_pandas", "to_pylist",
     "dictionary_encode"}
)
#: numpy allocators keyed on a relation-derived shape argument
NP_SHAPE_PRIMS = frozenset({"empty", "zeros", "ones", "full"})
#: mmap materializers — bounded by construction (the bytes are
#: file-backed views; resident charge is the page cache's problem), but
#: still allocation sites the registry must be able to declare
MMAP_PRIMS = frozenset({"frombuffer", "read_buffer", "memory_map"})
#: concatenators — unbounded iff the concatenated value is tainted
CONCAT_PRIMS = frozenset(
    {"concatenate", "vstack", "hstack", "stack", "concat_tables"}
)
_NP_BASES = frozenset({"np", "numpy"})
#: parameter names that carry a relation's file list into a function
FILE_LIST_PARAMS = frozenset(
    {"files", "paths", "file_paths", "filepaths", "file_list"}
)
_GROW_BUILTINS = frozenset({"list", "tuple", "sorted", "set"})


@dataclasses.dataclass
class SiteEntry:
    path: str
    plane: str
    bound: str
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
            if "ALLOC_SITES" in targets:
                return rel
    return None


def parse_sites(
    project: Project,
) -> Tuple[List[SiteEntry], Optional[str]]:
    """(entries, registry rel) from the ALLOC_SITES literal;
    ([], None) when absent — trees without a residency contract skip
    the checker."""
    rel = registry_file(project)
    if rel is None:
        return [], None
    sf = project.file(rel)
    entries: List[SiteEntry] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            targets = [node.target.id]
        else:
            continue
        if "ALLOC_SITES" not in targets or not isinstance(
            node.value, ast.Dict
        ):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            key = const_str(k) if k is not None else None
            if key is None:
                continue
            plane = bound = why = ""
            if isinstance(v, (ast.Tuple, ast.List)) and len(v.elts) >= 3:
                plane = const_str(v.elts[0]) or ""
                bound = const_str(v.elts[1]) or ""
                why = const_str(v.elts[2]) or ""
            entries.append(SiteEntry(key, plane, bound, why, v.lineno))
    return entries, rel


# ---------------------------------------------------------------------------
# Per-function size taint
# ---------------------------------------------------------------------------


class _Taint:
    """Names in one function whose values are relation-proportional.

    Seeds: file-list parameters, ``.files`` attribute loads,
    ``read_table`` results. Propagates through assignments, growing
    builtins and accumulators appended to across an unbounded loop;
    stops at subscripts and loop targets (the per-chunk slice
    doctrine)."""

    def __init__(self, body: List[ast.stmt], arg_names: Set[str]):
        self.body = body
        self.tainted: Set[str] = {
            a for a in arg_names if a in FILE_LIST_PARAMS
        }

    def run(self) -> Set[str]:
        changed = True
        while changed:
            changed = False
            for stmt in self.body:
                for node in ast.walk(stmt):
                    changed |= self._stmt(node)
        return self.tainted

    def _add(self, name: str) -> bool:
        if name in self.tainted:
            return False
        self.tainted.add(name)
        return True

    def _stmt(self, node: ast.AST) -> bool:
        changed = False
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = getattr(node, "value", None)
            if value is not None and self.expr(value):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            changed |= self._add(sub.id)
        elif isinstance(node, ast.AugAssign):
            if self.expr(node.value) and isinstance(node.target, ast.Name):
                changed |= self._add(node.target.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            if self.expr(node.iter):
                # accumulation doctrine: a value grown once per element
                # of an unbounded iterable is itself unbounded — the
                # loop target stays bounded (one slice), the
                # accumulator does not
                for sub in ast.walk(node):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("append", "extend", "add")
                        and isinstance(sub.func.value, ast.Name)
                    ):
                        changed |= self._add(sub.func.value.id)
                    elif isinstance(sub, ast.AugAssign) and isinstance(
                        sub.target, ast.Name
                    ):
                        changed |= self._add(sub.target.id)
        return changed

    def expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr == "files":
                return True
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            return False  # a slice of anything is bounded by doctrine
        if isinstance(node, ast.Call):
            f = node.func
            last = (
                f.attr
                if isinstance(f, ast.Attribute)
                else f.id
                if isinstance(f, ast.Name)
                else ""
            )
            if last in SLICE_READ_PRIMS:
                return False
            if last in READ_PRIMS:
                return True
            if isinstance(f, ast.Name) and f.id in _GROW_BUILTINS:
                return any(self.expr(a) for a in node.args)
            if isinstance(f, ast.Attribute) and f.attr in ARROW_PRIMS:
                return self.expr(f.value)
            return any(self.expr(a) for a in node.args) or any(
                self.expr(k.value) for k in node.keywords
            )
        if isinstance(
            node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
        ):
            return any(self.expr(g.iter) for g in node.generators)
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        return False


# ---------------------------------------------------------------------------
# Function index + allocation-primitive scan
# ---------------------------------------------------------------------------


def _module_dotted(project: Project, rel: str) -> str:
    pkg = os.path.basename(project.package_dir)
    mod = rel[: -len(".py")] if rel.endswith(".py") else rel
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    mod = mod.replace("/", ".")
    return pkg if mod in ("__init__", "") else f"{pkg}.{mod}"


FnKey = Tuple[str, Optional[str], str]  # (rel, class, name) — "" = module


@dataclasses.dataclass
class _Alloc:
    line: int
    prim: str
    unbounded: bool


@dataclasses.dataclass
class _Fn:
    key: FnKey
    rel: str
    site: str  # dotted path
    public: bool
    body: List[ast.stmt]
    arg_names: Set[str]
    allocs: List[_Alloc] = dataclasses.field(default_factory=list)
    calls: Set[FnKey] = dataclasses.field(default_factory=set)
    has_put: bool = False
    has_loop: bool = False
    idents: Set[str] = dataclasses.field(default_factory=set)


def _np_base(node: ast.AST, aliases: Dict[str, str]) -> bool:
    base = dotted_name(node)
    if base is None:
        return False
    root = base.split(".", 1)[0]
    return root in _NP_BASES or aliases.get(root) == "numpy"


def _resolve_module_rel(
    project: Project, fq: str, pkg: str
) -> Optional[str]:
    if not fq.startswith(pkg + ".") and fq != pkg:
        return None
    rest = "" if fq == pkg else fq[len(pkg) + 1 :].replace(".", "/")
    cands = (
        ("__init__.py",)
        if not rest
        else (f"{rest}.py", f"{rest}/__init__.py")
    )
    for cand in cands:
        if cand in project.files:
            return cand
    return None


def build_index(project: Project) -> Dict[FnKey, _Fn]:
    """Every outermost function/method (plus each module's top-level
    statements) with its allocation primitives, size taint, and
    resolved same-package calls — the structure HS1001/HS1002/HS1003
    and the engagement tests share."""
    pkg = os.path.basename(project.package_dir)
    index: Dict[FnKey, _Fn] = {}
    class_names: Dict[str, Set[str]] = {}
    for rel, sf in sorted(project.files.items()):
        if sf.tree is None:
            continue
        mod = _module_dotted(project, rel)
        class_names[rel] = {
            n.name for n in sf.tree.body if isinstance(n, ast.ClassDef)
        }
        mod_body = [
            s
            for s in sf.tree.body
            if not isinstance(
                s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            )
        ]
        index[(rel, None, "")] = _Fn(
            (rel, None, ""), rel, mod, True, mod_body, set()
        )
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                index[(rel, None, node.name)] = _Fn(
                    (rel, None, node.name),
                    rel,
                    f"{mod}.{node.name}",
                    not node.name.startswith("_"),
                    node.body,
                    {a.arg for a in node.args.args + node.args.kwonlyargs},
                )
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        index[(rel, node.name, m.name)] = _Fn(
                            (rel, node.name, m.name),
                            rel,
                            f"{mod}.{node.name}.{m.name}",
                            not node.name.startswith("_")
                            and not m.name.startswith("_"),
                            m.body,
                            {
                                a.arg
                                for a in m.args.args + m.args.kwonlyargs
                            },
                        )
    for key, fn in index.items():
        sf = project.file(fn.rel)
        aliases = import_aliases(sf.tree)
        taint = _Taint(fn.body, fn.arg_names).run()
        tt = _Taint(fn.body, fn.arg_names)
        tt.tainted = taint
        for stmt in fn.body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                    fn.has_loop = True
                if isinstance(node, ast.Name):
                    fn.idents.add(node.id)
                elif isinstance(node, ast.Attribute):
                    fn.idents.add(node.attr)
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "put":
                    fn.has_put = True
                # -- allocation primitives ------------------------------
                last = (
                    f.attr
                    if isinstance(f, ast.Attribute)
                    else f.id
                    if isinstance(f, ast.Name)
                    else ""
                )
                if last in READ_PRIMS:
                    fn.allocs.append(_Alloc(node.lineno, last, True))
                elif last in SLICE_READ_PRIMS or last in MMAP_PRIMS:
                    fn.allocs.append(_Alloc(node.lineno, last, False))
                elif isinstance(f, ast.Attribute) and f.attr in ARROW_PRIMS:
                    fn.allocs.append(
                        _Alloc(node.lineno, f.attr, tt.expr(f.value))
                    )
                elif (
                    isinstance(f, ast.Attribute)
                    and f.attr in CONCAT_PRIMS
                    and (
                        f.attr == "concat_tables"
                        or _np_base(f.value, aliases)
                    )
                ):
                    fn.allocs.append(
                        _Alloc(
                            node.lineno,
                            f.attr,
                            any(tt.expr(a) for a in node.args),
                        )
                    )
                elif (
                    isinstance(f, ast.Attribute)
                    and f.attr in NP_SHAPE_PRIMS
                    and _np_base(f.value, aliases)
                    and node.args
                ):
                    fn.allocs.append(
                        _Alloc(node.lineno, f.attr, tt.expr(node.args[0]))
                    )
                # -- call graph (reach closure + HS1002 put-flow) -------
                callee = _resolve_call(
                    project, pkg, fn, f, aliases, class_names
                )
                if callee is not None and callee in index:
                    fn.calls.add(callee)
    return index


def _resolve_call(
    project: Project,
    pkg: str,
    fn: _Fn,
    f: ast.AST,
    aliases: Dict[str, str],
    class_names: Dict[str, Set[str]],
) -> Optional[FnKey]:
    if isinstance(f, ast.Name):
        fq = aliases.get(f.id)
        if fq is not None and "." in fq:
            mod_fq, name = fq.rsplit(".", 1)
            rel = _resolve_module_rel(project, mod_fq, pkg)
            if rel is not None:
                return (rel, None, name)
        return (fn.rel, None, f.id)
    if isinstance(f, ast.Attribute):
        base = dotted_name(f.value)
        if base is None:
            return None
        if base == "self" and fn.key[1] is not None:
            return (fn.rel, fn.key[1], f.attr)
        if base in class_names.get(fn.rel, ()):
            return (fn.rel, base, f.attr)
        fq = aliases.get(base.split(".", 1)[0])
        if fq is not None:
            tail = base.split(".", 1)[1] if "." in base else ""
            full = f"{fq}.{tail}" if tail else fq
            rel = _resolve_module_rel(project, full, pkg)
            if rel is not None:
                return (rel, None, f.attr)
            # imported CLASS: pkg.mod.Cls.method — strip the class
            # component and address the method key
            if "." in full:
                mod_fq, cls = full.rsplit(".", 1)
                rel = _resolve_module_rel(project, mod_fq, pkg)
                if rel is not None:
                    return (rel, cls, f.attr)
    return None


def reach_closure(index: Dict[FnKey, _Fn]) -> Set[FnKey]:
    """Functions transitively reachable from the public serve/build
    surface (public hot-dir functions/methods + module bodies) — the
    set HS1001 audits; orphaned private helpers stay out."""
    roots = [
        k
        for k, fn in index.items()
        if fn.public and fn.rel.split("/", 1)[0] in HOT_DIRS
    ]
    seen: Set[FnKey] = set()
    frontier = list(roots)
    while frontier:
        k = frontier.pop()
        if k in seen:
            continue
        seen.add(k)
        for callee in index[k].calls:
            if callee in index and callee not in seen:
                frontier.append(callee)
    return seen


# ---------------------------------------------------------------------------
# Checker
# ---------------------------------------------------------------------------

_HS1002_HINTS = {
    "cache-governed": "the value never flows through a ServeCache "
    ".put(...) in the site or a direct caller",
    "chunk-bounded": "the site contains no chunk loop bounding the "
    "allocation",
    "row-group-bounded": "the site never touches the row-group read "
    "path (read_table_row_groups / row_groups selection)",
    "wave-budget": "the site references no wave/budget/pool machinery",
    "spill-bounded": "the site references no spill/mmap machinery",
}


def _put_flow_closure(index: Dict[FnKey, _Fn]) -> Set[FnKey]:
    """Functions whose result can flow through a ``.put(...)``: the
    putters themselves plus everything they transitively call (the
    value returns up the same chain the calls went down). Method calls
    through variables are resolved by method name — the registry-style
    name matching the locks checker uses."""
    attr_callers: Dict[str, Set[FnKey]] = {}
    for fn in index.values():
        for stmt in fn.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    attr_callers.setdefault(node.func.attr, set()).add(
                        fn.key
                    )
    closure: Set[FnKey] = set()
    frontier = [k for k, fn in index.items() if fn.has_put]
    while frontier:
        k = frontier.pop()
        if k in closure:
            continue
        closure.add(k)
        fn = index[k]
        for callee in fn.calls:
            if callee in index and callee not in closure:
                frontier.append(callee)
        # name-matched method edges (obj.method() on an unresolvable
        # receiver): a putter mentioning .m() reaches every method m
        for name, meth_key in [
            (mk[2], mk) for mk in index if mk[1] is not None
        ]:
            if (
                meth_key not in closure
                and k in attr_callers.get(name, ())
            ):
                frontier.append(meth_key)
    return closure


def _bound_enforced(
    fn: _Fn, bound: str, put_closure: Set[FnKey]
) -> bool:
    if bound == "const-bounded":
        return True
    if bound == "cache-governed":
        return fn.has_put or fn.key in put_closure
    if bound == "chunk-bounded":
        return fn.has_loop
    if bound == "row-group-bounded":
        return any("row_group" in i for i in fn.idents)
    if bound == "wave-budget":
        return any(
            any(s in i for s in ("wave", "budget", "pool"))
            for i in fn.idents
        )
    if bound == "spill-bounded":
        return any(
            any(s in i for s in ("spill", "mmap", "mapped", "memory_map"))
            for i in fn.idents
        )
    return True


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    entries, reg_rel = parse_sites(project)
    if reg_rel is None:
        return findings
    reg_sf = project.file(reg_rel)
    reg_path = reg_sf.rel_path if reg_sf is not None else reg_rel
    declared: Dict[str, SiteEntry] = {e.path: e for e in entries}
    index = build_index(project)
    closure = reach_closure(index)
    put_closure = _put_flow_closure(index)
    by_site: Dict[str, _Fn] = {fn.site: fn for fn in index.values()}

    # -- HS1001: every unbounded hot-path materialization is declared --------
    for key in sorted(closure, key=str):
        fn = index[key]
        if fn.rel.split("/", 1)[0] not in HOT_DIRS:
            continue
        if fn.site in declared:
            continue
        sf = project.file(fn.rel)
        for alloc in fn.allocs:
            if not alloc.unbounded:
                continue
            findings.append(
                Finding(
                    "HS1001",
                    sf.rel_path if sf is not None else fn.rel,
                    alloc.line,
                    f"row-proportional materialization ({alloc.prim}) in "
                    f"{fn.site!r} but the site has no ALLOC_SITES entry "
                    "(memory.py) — declare its plane and bound class, or "
                    "bound the allocation to a per-chunk/per-row-group "
                    "slice",
                )
            )

    # -- HS1002/HS1003: the registry stays sound -----------------------------
    for e in entries:
        if e.plane not in PLANES:
            findings.append(
                Finding(
                    "HS1003",
                    reg_path,
                    e.line,
                    f"ALLOC_SITES entry {e.path!r} has unknown plane "
                    f"{e.plane!r} (want one of {PLANES})",
                )
            )
            continue
        if e.bound not in BOUND_CLASSES:
            findings.append(
                Finding(
                    "HS1003",
                    reg_path,
                    e.line,
                    f"ALLOC_SITES entry {e.path!r} has unknown bound "
                    f"class {e.bound!r} (want one of {BOUND_CLASSES})",
                )
            )
            continue
        if not e.why.strip():
            findings.append(
                Finding(
                    "HS1003",
                    reg_path,
                    e.line,
                    f"ALLOC_SITES entry {e.path!r} has no justification — "
                    "every declared bound says why it holds in one line",
                )
            )
            continue
        fn = by_site.get(e.path)
        if fn is None:
            findings.append(
                Finding(
                    "HS1003",
                    reg_path,
                    e.line,
                    f"ALLOC_SITES entry {e.path!r} does not resolve to a "
                    "module, function or method in the package — stale "
                    "registry entry",
                )
            )
            continue
        live = (
            bool(fn.allocs)
            or fn.has_put
            or any(
                index[c].allocs for c in fn.calls if c in index
            )
        )
        if not live:
            findings.append(
                Finding(
                    "HS1003",
                    reg_path,
                    e.line,
                    f"ALLOC_SITES entry {e.path!r} resolves but its site "
                    "neither allocates, charges the governor, nor calls "
                    "an allocating function — stale entry (remove it or "
                    "restore the allocation)",
                )
            )
            continue
        if not _bound_enforced(fn, e.bound, put_closure):
            findings.append(
                Finding(
                    "HS1002",
                    reg_path,
                    e.line,
                    f"ALLOC_SITES entry {e.path!r} declares "
                    f"{e.bound!r} but {_HS1002_HINTS[e.bound]}",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# Residency-witness cross-check (``hslint --witness``)
# ---------------------------------------------------------------------------


def load_witness(path: str, doc: Optional[dict] = None) -> dict:
    """Parse a residency witness artifact; raises ValueError on a
    malformed one (the CLI maps that to a usage error — a corrupt
    artifact must never pass as 'zero model gaps'). Pass a pre-parsed
    ``doc`` to validate without re-reading the file."""
    if doc is None:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    if not isinstance(doc, dict) or "sites" not in doc:
        raise ValueError(f"not a residency-witness artifact: {path}")
    sites = doc["sites"]
    if not isinstance(sites, dict) or not all(
        isinstance(k, str)
        and isinstance(v, dict)
        and isinstance(v.get("peak_bytes"), int)
        and isinstance(v.get("calls"), int)
        for k, v in sites.items()
    ):
        raise ValueError(f"malformed witness 'sites' map: {path}")
    budgets = doc.get("budgets", {})
    if not isinstance(budgets, dict) or not all(
        isinstance(k, str) and isinstance(v, int)
        for k, v in budgets.items()
    ):
        raise ValueError(f"malformed witness 'budgets' map: {path}")
    return doc


def witness_cross_check(
    projects: List[Project], doc: dict, artifact: str
) -> Tuple[List[Finding], List[str]]:
    """(model-gap findings, staleness warnings) of a residency witness
    against the static registry — the UNION over ``projects``, since
    one artifact records every wrapped site in its process.

    A WITNESSED allocation site absent from ``ALLOC_SITES`` is a hard
    HS1004 error (the runtime materialized something the model cannot
    see), as is a site whose observed peak bytes exceed its declared
    bound class's ceiling (the declared bound does not hold). A
    registered site never witnessed is only a staleness warning — the
    run may simply not have driven that path."""
    declared: Dict[str, SiteEntry] = {}
    for project in projects:
        entries, reg_rel = parse_sites(project)
        if reg_rel is not None:
            for e in entries:
                declared.setdefault(e.path, e)
    findings: List[Finding] = []
    warnings: List[str] = []
    budgets: Dict[str, int] = dict(doc.get("budgets", {}))
    sites: Dict[str, dict] = doc.get("sites", {})
    for site in sorted(sites):
        rec = sites[site]
        entry = declared.get(site)
        if entry is None:
            findings.append(
                Finding(
                    "HS1004",
                    artifact,
                    1,
                    f"witnessed allocation site {site!r} "
                    f"({rec.get('peak_bytes', 0)} peak bytes) is absent "
                    "from ALLOC_SITES — memory materialized at runtime "
                    "that the residency model cannot see",
                )
            )
            continue
        ceiling = budgets.get(entry.bound)
        if ceiling is not None and rec.get("peak_bytes", 0) > ceiling:
            findings.append(
                Finding(
                    "HS1004",
                    artifact,
                    1,
                    f"site {site!r} peaked at {rec['peak_bytes']} bytes, "
                    f"past its declared {entry.bound!r} ceiling of "
                    f"{ceiling} — the declared bound does not hold",
                )
            )
    for path in sorted(declared):
        rec = sites.get(path)
        if rec is None or rec.get("calls", 0) == 0:
            warnings.append(
                f"ALLOC_SITES entry {path} was never witnessed during "
                "the recorded run — stale model or an unexercised path"
            )
    return findings, warnings
