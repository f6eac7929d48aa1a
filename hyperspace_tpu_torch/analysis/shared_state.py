"""HS6xx — shared-state race detector + lock-witness cross-check.

The serve plane runs in-process: a thread-pool frontend, the
shared ServeCache, the scan read-ahead pool and per-bucket/per-shard
pools all run under real contention. The HS5xx lint reasons about lock
*ordering*; nothing proved that shared mutable state is guarded at all.
This checker does, against the ``SHARED_STATE`` registry in
``hyperspace_tpu_torch/concurrency.py`` (the KERNEL_TWINS doctrine applied to
concurrency — every cross-thread mutable object declares its lock and
guarding policy).

Statically, the checker:

* finds every thread-pool boundary — ``<pool>.submit(fn, …)`` /
  ``<pool>.map(fn, …)`` call sites (the shared ``scan_pool``, the
  ServeFrontend executor, the per-bucket/per-shard worker pools) — and
  resolves the submitted callables, including closures defined inside
  the submitting function;
* computes the set of functions transitively reachable from those
  callables (the same resolution discipline as the may-acquire walk in
  :mod:`analysis.locks`, extended to nested defs and one-level
  re-exports);
* records every access to a module-level global or registered instance
  attribute together with the locks held at the access site.

Rules:

* HS601 — a module-level mutable global that some function writes is
  read or written from a pool-reachable function but has no
  ``SHARED_STATE`` entry: undeclared cross-thread state.
* HS602 — registered state is accessed in violation of its declared
  policy (``guarded``: any access outside the lock; ``guarded-writes``:
  a write outside the lock; ``rebind-only``: an in-place mutation;
  ``frozen``: a write from a pool-reachable function). ``__init__``
  bodies are exempt for instance attributes — construction
  happens-before sharing.
* HS603 — a registry entry that no longer resolves (stale state path,
  unknown lock, unknown policy, or a missing justification).
* HS604 — only in ``--witness`` mode: the runtime lock witness
  (``testing/lock_witness.py``) observed an acquisition edge or a lock
  the static model does not contain — the model has a gap and every
  HS5xx/HS6xx verdict built on it is suspect. The reverse direction
  (static edge never witnessed) is a staleness *warning*, not an error.

Like every checker here this is an approximation (no aliasing, no
dynamic dispatch); it is tuned to be quiet on correct code and loud on
unguarded telemetry dicts, caches and registries — the bugs Sparkle
(PAPERS.md) shows dominate at large-box scale.
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
)
from hyperspace_tpu_torch.analysis import locks as _locks
from hyperspace_tpu_torch.analysis.locks import (
    LockId,
    _ModuleIndex,
    _resolve_lock,
    canonical_lock_name,
)

RULES = {
    "HS601": "shared mutable global reachable from a thread pool is not "
    "registered in SHARED_STATE",
    "HS602": "registered shared state accessed outside its declared "
    "lock/policy",
    "HS603": "SHARED_STATE registry entry does not resolve",
    "HS604": "lock witness observed an edge absent from the static model",
}

REGISTRY_FILE = "concurrency.py"
POLICIES = ("guarded", "guarded-writes", "rebind-only", "frozen")

#: in-place mutators of the stdlib containers shared state is made of
_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "extendleft",
        "insert",
        "add",
        "update",
        "clear",
        "pop",
        "popitem",
        "setdefault",
        "remove",
        "discard",
        "move_to_end",
        "sort",
        "reverse",
    }
)

#: constructors whose result is NOT cross-thread-hazardous state
_NONSHARED_CTORS = frozenset(
    {
        "Lock",
        "RLock",
        "Condition",
        "Event",
        "Semaphore",
        "BoundedSemaphore",
        "local",
        "Barrier",
    }
)

_MUTABLE_CTORS = frozenset(
    {"dict", "list", "set", "OrderedDict", "defaultdict", "deque", "Counter"}
)

FuncKey = Tuple[str, Optional[str], str]  # (rel, class or None, qualname)
StateId = Tuple[str, ...]  # ("mod", rel, name) | ("cls", rel, Class, attr)


@dataclasses.dataclass
class Access:
    state: StateId
    line: int
    kind: str  # "read" | "rebind" | "mutate"
    held: frozenset  # of LockId


@dataclasses.dataclass
class FnInfo:
    key: FuncKey
    rel: str
    rel_path: str  # display path
    calls: Set[FuncKey] = dataclasses.field(default_factory=set)
    submits: Set[FuncKey] = dataclasses.field(default_factory=set)
    accesses: List[Access] = dataclasses.field(default_factory=list)
    # (callee, locks held at the call site) — feeds the ``*_locked``
    # caller-held credit (one entry per call expression, so the
    # intersection over edges is over ALL call sites)
    call_held: List[Tuple[FuncKey, frozenset]] = dataclasses.field(
        default_factory=list
    )


# ---------------------------------------------------------------------------
# Registry parsing + resolution (HS603)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Entry:
    path: str
    lock_spec: str
    policy: str
    why: str
    line: int
    state: Optional[StateId] = None  # resolved
    lock: Optional[LockId] = None  # resolved (None for lock-free policies)


def parse_registry(project: Project) -> Tuple[List[Entry], int]:
    """(entries, registry line) from the SHARED_STATE literal in
    ``concurrency.py``; ([], 0) when the module or literal is absent."""
    sf = project.file(REGISTRY_FILE)
    if sf is None or sf.tree is None:
        return [], 0
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            targets = [node.target.id]
        else:
            continue
        if "SHARED_STATE" not in targets or not isinstance(node.value, ast.Dict):
            continue
        entries: List[Entry] = []
        for k, v in zip(node.value.keys, node.value.values):
            key = const_str(k) if k is not None else None
            if key is None:
                continue
            lock = policy = why = ""
            if isinstance(v, (ast.Tuple, ast.List)) and len(v.elts) >= 3:
                lock = const_str(v.elts[0]) or ""
                policy = const_str(v.elts[1]) or ""
                why = const_str(v.elts[2]) or ""
            entries.append(Entry(key, lock, policy, why, v.lineno))
        return entries, node.lineno
    return [], 0


class _PkgIndex:
    """Per-module facts the checker needs beyond locks._ModuleIndex:
    module-level assigned globals (with mutability), class attribute
    assigns, and nested-def-aware function records."""

    def __init__(self, project: Project):
        self.project = project
        self.pkg = os.path.basename(project.package_dir)
        # share the memoized lock model with the HS5xx pass
        self.locks_idx, self.all_locks = _locks._model(project)[:2]
        # rel -> {global name -> (line, is_mutable_literal)}
        self.module_globals: Dict[str, Dict[str, Tuple[int, bool]]] = {}
        # rel -> {class -> set of self-assigned attrs}
        self.class_attrs: Dict[str, Dict[str, Set[str]]] = {}
        for rel, sf in project.files.items():
            g: Dict[str, Tuple[int, bool]] = {}
            cattrs: Dict[str, Set[str]] = {}
            if sf.tree is not None:
                for node in sf.tree.body:
                    tgts: List[ast.expr] = []
                    val: Optional[ast.AST] = None
                    if isinstance(node, ast.Assign):
                        tgts, val = node.targets, node.value
                    elif isinstance(node, ast.AnnAssign) and node.value is not None:
                        tgts, val = [node.target], node.value
                    for t in tgts:
                        if isinstance(t, ast.Name) and not _is_nonshared(val):
                            g.setdefault(
                                t.id, (node.lineno, _is_mutable_literal(val))
                            )
                    if isinstance(node, ast.ClassDef):
                        attrs: Set[str] = set()
                        for sub in ast.walk(node):
                            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                                sub_t = (
                                    sub.targets
                                    if isinstance(sub, ast.Assign)
                                    else [sub.target]
                                )
                                for t in sub_t:
                                    if (
                                        isinstance(t, ast.Attribute)
                                        and isinstance(t.value, ast.Name)
                                        and t.value.id == "self"
                                    ):
                                        attrs.add(t.attr)
                        cattrs[node.name] = attrs
            self.module_globals[rel] = g
            self.class_attrs[rel] = cattrs

    def rel_for(self, qualified_mod: str) -> Optional[str]:
        if qualified_mod == self.pkg:
            return "__init__.py" if "__init__.py" in self.project.files else None
        if not qualified_mod.startswith(self.pkg + "."):
            return None
        tail = qualified_mod[len(self.pkg) + 1 :].replace(".", "/")
        for cand in (f"{tail}.py", f"{tail}/__init__.py"):
            if cand in self.project.files:
                return cand
        return None

    def resolve_state_path(self, path: str) -> Optional[StateId]:
        parts = path.split(".")
        if len(parts) < 2 or parts[0] != self.pkg:
            return None
        # longest module prefix first: "a.b.c.d" tries module a.b.c
        # (global d), then a.b (Class c, attr d)
        for i in range(len(parts) - 1, 0, -1):
            rel = self.rel_for(".".join(parts[:i]))
            if rel is None:
                continue
            rest = parts[i:]
            if len(rest) == 1:
                if rest[0] in self.module_globals.get(rel, {}):
                    return ("mod", rel, rest[0])
            elif len(rest) == 2:
                if rest[0] in self.class_attrs.get(rel, {}) and rest[1] in (
                    self.class_attrs[rel][rest[0]]
                ):
                    return ("cls", rel, rest[0], rest[1])
            return None
        return None

    def resolve_lock_spec(
        self, spec: str, state: Optional[StateId]
    ) -> Optional[LockId]:
        if spec.startswith("self."):
            if state is None or state[0] != "cls":
                return None
            _, rel, cls, _attr = state
            attr = spec[len("self.") :]
            if attr in self.locks_idx[rel].class_locks.get(cls, ()):
                return (f"cls:{rel}:{cls}", attr)
            # a lock the class INHERITS resolves to the base's identity
            # (locks._link_inherited_locks), so `self._lock` entries on
            # a subclass audit against the one real lock object
            return self.locks_idx[rel].inherited_locks.get(cls, {}).get(attr)
        parts = spec.split(".")
        for i in range(len(parts) - 1, 0, -1):
            rel = self.rel_for(".".join(parts[:i]))
            if rel is None:
                continue
            rest = parts[i:]
            if len(rest) == 1 and rest[0] in self.locks_idx[rel].module_locks:
                return (f"mod:{rel}", rest[0])
            return None
        return None


def _is_mutable_literal(node: Optional[ast.AST]) -> bool:
    if isinstance(
        node,
        (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp),
    ):
        return True
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return name.split(".")[-1] in _MUTABLE_CTORS
    return False


def _is_nonshared(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return name.split(".")[-1] in _NONSHARED_CTORS
    return False


# ---------------------------------------------------------------------------
# Function analysis: accesses, calls, submit targets, held locks
# ---------------------------------------------------------------------------


def _scope_stmts(body: List[ast.stmt]):
    """Every statement of one function scope, stopping at nested
    def/class boundaries (those are their own scopes)."""
    for node in body:
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                yield from _scope_stmts([child])
            elif isinstance(child, ast.ExceptHandler):
                yield from _scope_stmts(child.body)


def _local_names(fn: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(locals, global-declared) of one function body — locals are
    params plus every name bound in THIS scope (assignments, for/with
    targets, imports, nested def/class names, except aliases), minus
    ``global``-declared ones. Nested scopes do not leak in."""
    locals_: Set[str] = set()
    globals_: Set[str] = set()
    args = fn.args
    for a in (
        list(args.posonlyargs)
        + list(args.args)
        + list(args.kwonlyargs)
        + ([args.vararg] if args.vararg else [])
        + ([args.kwarg] if args.kwarg else [])
    ):
        locals_.add(a.arg)
    for node in _scope_stmts(fn.body):
        if isinstance(node, ast.Global):
            globals_.update(node.names)
        elif isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            locals_.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                locals_.add((a.asname or a.name).split(".")[0])
        else:
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.expr):
                    for n in ast.walk(sub):
                        if isinstance(n, ast.Name) and isinstance(
                            n.ctx, (ast.Store, ast.Del)
                        ):
                            locals_.add(n.id)
            if isinstance(node, ast.ExceptHandler) and node.name:
                locals_.add(node.name)
    return locals_ - globals_, globals_


def _direct_nested_defs(fn: ast.AST) -> List[ast.AST]:
    """Nested defs of THIS scope, wherever they sit in the body (inside
    ``if``/``with``/``try`` blocks included), excluding deeper nesting."""
    return [
        n
        for n in _scope_stmts(fn.body)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


class _FnWalker:
    """One function (or nested def / lambda) walked statement by
    statement, maintaining the held-lock stack exactly like
    ``locks._FuncAnalyzer`` and recording shared-state accesses, call
    edges and pool-submit targets."""

    def __init__(
        self,
        checker: "_Checker",
        info: FnInfo,
        idx: _ModuleIndex,
        cls: Optional[str],
        scope_chain: List[Set[str]],
        globals_decl: Set[str],
        nested_defs: Dict[str, FuncKey],
    ):
        self.checker = checker
        self.info = info
        self.idx = idx
        self.cls = cls
        self.scope_chain = scope_chain
        self.globals_decl = globals_decl
        self.nested_defs = nested_defs
        self.held: List[LockId] = []

    # -- resolution ---------------------------------------------------------
    def _is_local(self, name: str) -> bool:
        if name in self.globals_decl:
            return False
        return any(name in scope for scope in self.scope_chain)

    def _global_target(self, name: str) -> Optional[StateId]:
        """The module-global StateId ``name`` refers to at this site, or
        None (local/builtin/untracked)."""
        if self._is_local(name):
            return None
        if name in self.checker.pkg_idx.module_globals.get(self.info.rel, {}):
            return ("mod", self.info.rel, name)
        return None

    def _ref_target(self, node: ast.AST) -> Optional[StateId]:
        """StateId of an expression that names shared state: a bare
        global, ``self.attr``, or ``<module alias>.global``."""
        if isinstance(node, ast.Name):
            return self._global_target(node.id)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            base = node.value.id
            if base == "self" and self.cls is not None:
                if node.attr in self.checker.pkg_idx.class_attrs.get(
                    self.info.rel, {}
                ).get(self.cls, ()):
                    return ("cls", self.info.rel, self.cls, node.attr)
                return None
            if not self._is_local(base) or base in self.idx.aliases:
                target = self.idx.aliases.get(base)
                if target:
                    rel2 = self.checker.pkg_idx.rel_for(target)
                    if rel2 is not None and node.attr in (
                        self.checker.pkg_idx.module_globals.get(rel2, {})
                    ):
                        return ("mod", rel2, node.attr)
        return None

    def _resolve_callable(self, node: ast.AST, depth: int = 0) -> Optional[FuncKey]:
        """FuncKey of a function-valued expression: nested def, module
        function, imported function (one re-export level followed), or
        ``self.method``."""
        if depth > 2:
            return None
        if isinstance(node, ast.Name):
            if node.id in self.nested_defs:
                return self.nested_defs[node.id]
            if not self._is_local(node.id):
                if node.id in self.idx.functions:
                    return (self.info.rel, None, node.id)
                target = self.idx.aliases.get(node.id)
                if target:
                    return self._resolve_qualified(target, depth)
            return None
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            base = node.value.id
            if base == "self" and self.cls is not None:
                if node.attr in self.idx.classes.get(self.cls, ()):
                    return (self.info.rel, self.cls, node.attr)
                return None
            target = self.idx.aliases.get(base)
            if target:
                return self._resolve_qualified(f"{target}.{node.attr}", depth)
        return None

    def _resolve_qualified(self, qualified: str, depth: int) -> Optional[FuncKey]:
        mod, _, leaf = qualified.rpartition(".")
        if not mod:
            return None
        rel2 = self.checker.pkg_idx.rel_for(mod)
        if rel2 is None:
            return None
        idx2 = self.checker.pkg_idx.locks_idx[rel2]
        if leaf in idx2.functions:
            return (rel2, None, leaf)
        if leaf in idx2.classes:
            return (rel2, leaf, "__init__")
        # one re-export hop: ``from .executor import execute`` in an
        # __init__ — the call graph must cross package facades
        reexport = idx2.aliases.get(leaf)
        if reexport and depth < 2:
            return self._resolve_qualified(reexport, depth + 1)
        return None

    # -- recording ----------------------------------------------------------
    def _record(self, state: StateId, line: int, kind: str) -> None:
        self.info.accesses.append(
            Access(state, line, kind, frozenset(self.held))
        )

    # -- statements ---------------------------------------------------------
    def run_body(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in stmt.items:
                lock = _resolve_lock(self.idx, self.cls, item.context_expr)
                if lock is not None:
                    self.held.append(lock)
                    acquired.append(lock)
                else:
                    self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._expr(item.optional_vars)
            for s in stmt.body:
                self._stmt(s)
            for lock in acquired:
                if lock in self.held:
                    self.held.remove(lock)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, not here — analyze it as its own
            # function with an EMPTY held set (a lock held at def time
            # is not held at call time)
            self.checker.analyze_function(
                stmt,
                self.info.rel,
                self.cls,
                f"{self.info.key[2]}.{stmt.name}",
                self.scope_chain,
                self.nested_defs,
            )
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._assign(stmt)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.stmt):
                self._stmt(node)
            elif isinstance(node, ast.expr):
                self._expr(node)
            elif isinstance(node, ast.ExceptHandler):
                for s in node.body:
                    self._stmt(s)

    def _assign(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.AnnAssign) and stmt.value is None:
            return  # annotation only: binds nothing
        aug = isinstance(stmt, ast.AugAssign)
        targets = (
            stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        )
        if getattr(stmt, "value", None) is not None:
            self._expr(stmt.value)
        for t in targets:
            self._target(t, "mutate" if aug else "rebind")

    def _target(self, t: ast.expr, rebind_kind: str) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._target(el, rebind_kind)
            return
        if isinstance(t, ast.Starred):
            self._target(t.value, rebind_kind)
            return
        if isinstance(t, ast.Name):
            state = self._global_target(t.id)
            if state is not None:
                self._record(state, t.lineno, rebind_kind)
            return
        if isinstance(t, ast.Subscript):
            state = self._ref_target(t.value)
            if state is not None:
                self._record(state, t.lineno, "mutate")
            else:
                self._expr(t.value)
            self._expr(t.slice)
            return
        if isinstance(t, ast.Attribute):
            state = self._ref_target(t)
            if state is not None:
                self._record(state, t.lineno, rebind_kind)
            else:
                self._expr(t.value)

    # -- expressions --------------------------------------------------------
    def _expr(self, node: ast.AST) -> None:
        if isinstance(node, ast.Lambda):
            # runs later: empty held set, params shadow
            saved, self.held = self.held, []
            self.scope_chain.append(
                {a.arg for a in node.args.args + node.args.kwonlyargs}
            )
            self._expr(node.body)
            self.scope_chain.pop()
            self.held = saved
            return
        if isinstance(
            node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
        ):
            comp_locals: Set[str] = set()
            for gen in node.generators:
                for sub in ast.walk(gen.target):
                    if isinstance(sub, ast.Name):
                        comp_locals.add(sub.id)
            self.scope_chain.append(comp_locals)
            for gen in node.generators:
                self._expr(gen.iter)
                for cond in gen.ifs:
                    self._expr(cond)
            if isinstance(node, ast.DictComp):
                self._expr(node.key)
                self._expr(node.value)
            else:
                self._expr(node.elt)
            self.scope_chain.pop()
            return
        if isinstance(node, ast.Call):
            self._call(node)
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                state = self._global_target(node.id)
                if state is not None:
                    self._record(state, node.lineno, "read")
            return
        if isinstance(node, ast.Attribute):
            state = self._ref_target(node)
            if state is not None:
                kind = (
                    "read" if isinstance(node.ctx, ast.Load) else "rebind"
                )
                self._record(state, node.lineno, kind)
                return
            self._expr(node.value)
            return
        if isinstance(node, ast.Subscript):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                state = self._ref_target(node.value)
                if state is not None:
                    self._record(state, node.lineno, "mutate")
                else:
                    self._expr(node.value)
            else:
                self._expr(node.value)
            self._expr(node.slice)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _call(self, call: ast.Call) -> None:
        f = call.func
        if isinstance(f, ast.Attribute):
            # lock protocol
            if f.attr in ("acquire", "release"):
                lock = _resolve_lock(self.idx, self.cls, f.value)
                if lock is not None:
                    if f.attr == "acquire":
                        self.held.append(lock)
                    elif lock in self.held:
                        self.held.remove(lock)
                    for a in list(call.args) + [k.value for k in call.keywords]:
                        self._expr(a)
                    return
            # pool boundary: <pool>.submit(fn, …) / <pool>.map(fn, …)
            if f.attr in ("submit", "map") and call.args:
                target = self._resolve_callable(call.args[0])
                if target is not None:
                    self.info.submits.add(target)
            # in-place mutation of shared state
            if f.attr in _MUTATORS:
                state = self._ref_target(f.value)
                if state is not None:
                    self._record(state, call.lineno, "mutate")
        callee = self._resolve_callable(f)
        if callee is not None:
            self.info.calls.add(callee)
            self.info.call_held.append((callee, frozenset(self.held)))
        self._expr(f)
        for a in call.args:
            self._expr(a)
        for k in call.keywords:
            self._expr(k.value)


class _Checker:
    def __init__(self, project: Project):
        self.project = project
        self.pkg_idx = _PkgIndex(project)
        self.infos: Dict[FuncKey, FnInfo] = {}

    def analyze(self) -> None:
        for rel, sf in self.project.files.items():
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.analyze_function(node, rel, None, node.name, [], {})
                elif isinstance(node, ast.ClassDef):
                    for m in node.body:
                        if isinstance(
                            m, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            self.analyze_function(
                                m, rel, node.name, m.name, [], {}
                            )

    def analyze_function(
        self,
        fn: ast.AST,
        rel: str,
        cls: Optional[str],
        qualname: str,
        outer_scopes: List[Set[str]],
        outer_nested: Dict[str, FuncKey],
    ) -> None:
        key: FuncKey = (rel, cls, qualname)
        sf = self.project.files[rel]
        info = FnInfo(key, rel, sf.rel_path)
        self.infos[key] = info
        locals_, globals_decl = _local_names(fn)
        nested = dict(outer_nested)
        for sub in _direct_nested_defs(fn):
            nested[sub.name] = (rel, cls, f"{qualname}.{sub.name}")
        scope_chain = outer_scopes + [locals_]
        walker = _FnWalker(
            self,
            info,
            self.pkg_idx.locks_idx[rel],
            cls,
            scope_chain,
            globals_decl,
            nested,
        )
        walker.run_body(fn.body)

    # -- reachability -------------------------------------------------------
    def pool_reachable(self) -> Set[FuncKey]:
        roots: Set[FuncKey] = set()
        for info in self.infos.values():
            roots |= info.submits
        seen: Set[FuncKey] = set()
        frontier = [k for k in roots if k in self.infos]
        while frontier:
            k = frontier.pop()
            if k in seen:
                continue
            seen.add(k)
            for callee in self.infos[k].calls:
                if callee in self.infos and callee not in seen:
                    frontier.append(callee)
        return seen

    # -- candidates ---------------------------------------------------------
    def candidate_globals(self) -> Set[StateId]:
        """Module globals that are real cross-thread hazards: assigned at
        module level (non-lock, non-threadlocal) AND written by at least
        one function anywhere in the package. Never-written module dicts
        (KERNEL_TWINS, allowlists, …) are config, not state."""
        written: Set[StateId] = set()
        for info in self.infos.values():
            for a in info.accesses:
                if a.state[0] == "mod" and a.kind in ("rebind", "mutate"):
                    written.add(a.state)
        return written


def _state_name(state: StateId) -> str:
    if state[0] == "mod":
        return f"{state[1]}::{state[2]}"
    return f"{state[1]}::{state[2]}.{state[3]}"


def _locked_credits(checker: "_Checker") -> Dict[FuncKey, frozenset]:
    """Caller-held lock credit for ``*_locked`` functions.

    The codebase convention (``_dispatch_pending_locked``,
    ``_fast_cache_get_locked``, …): a ``_locked`` suffix promises "my
    caller holds the lock". This VERIFIES the promise instead of
    trusting it — the credit is the INTERSECTION of the locks held at
    every resolved call site (inheritance-aware: a call through a
    base-class method key may dispatch to a subclass override), so one
    lock-free call site voids the credit and HS602 fires at the access.
    Pool-submitted ``_locked`` callables get no credit (they run with
    an empty held set by definition), and a ``_locked`` function with
    no resolved call sites gets none either. Fixpoint: a ``_locked``
    caller's own credit counts at its call sites, so helper chains
    (``a_locked`` -> ``b_locked``) resolve; credits only grow, so the
    iteration terminates."""
    submitted: Set[FuncKey] = set()
    for info in checker.infos.values():
        submitted |= info.submits
    locked_keys = [
        k
        for k in checker.infos
        if k[2].endswith("_locked") and k not in submitted
    ]
    if not locked_keys:
        return {}
    # callee key -> every *_locked key it may dispatch to: itself, plus
    # any subclass override of the same method name
    dispatch: Dict[FuncKey, List[FuncKey]] = {}
    for k in locked_keys:
        rel, cls, name = k
        dispatch.setdefault(k, []).append(k)
        if cls is None:
            continue
        ancestors = checker.pkg_idx.locks_idx[rel].resolved_bases.get(
            cls, set()
        )
        for arel, acls in ancestors:
            dispatch.setdefault((arel, acls, name), []).append(k)
    # k -> [(caller, held at call site)]
    edges: Dict[FuncKey, List[Tuple[FuncKey, frozenset]]] = {}
    for caller, info in checker.infos.items():
        for callee, held in info.call_held:
            for k in dispatch.get(callee, ()):
                edges.setdefault(k, []).append((caller, held))
    credits: Dict[FuncKey, frozenset] = {}
    changed = True
    while changed:
        changed = False
        for k in locked_keys:
            sites = edges.get(k)
            if not sites:
                continue
            inter: Optional[frozenset] = None
            for caller, held in sites:
                eff = held | credits.get(caller, frozenset())
                inter = eff if inter is None else inter & eff
            if inter and inter != credits.get(k, frozenset()):
                credits[k] = inter
                changed = True
    return credits


def check(project: Project) -> List[Finding]:
    entries, reg_line = parse_registry(project)
    checker = _Checker(project)
    checker.analyze()
    pkg_idx = checker.pkg_idx
    reg_sf = project.file(REGISTRY_FILE)
    reg_path = reg_sf.rel_path if reg_sf is not None else REGISTRY_FILE
    findings: List[Finding] = []

    # -- HS603: the registry must resolve -----------------------------------
    registered: Dict[StateId, Entry] = {}
    for e in entries:
        ok = True
        e.state = pkg_idx.resolve_state_path(e.path)
        if e.state is None:
            findings.append(
                Finding(
                    "HS603",
                    reg_path,
                    e.line,
                    f"SHARED_STATE entry {e.path!r} names no module global "
                    "or class attribute in the package (stale registry?)",
                )
            )
            ok = False
        policy_ok = e.policy in POLICIES
        if not policy_ok:
            findings.append(
                Finding(
                    "HS603",
                    reg_path,
                    e.line,
                    f"{e.path}: unknown policy {e.policy!r} "
                    f"(have {', '.join(POLICIES)})",
                )
            )
            ok = False
        if not e.why.strip():
            findings.append(
                Finding(
                    "HS603",
                    reg_path,
                    e.line,
                    f"{e.path}: missing justification — every registry "
                    "entry must say why its policy is sound",
                )
            )
            ok = False
        needs_lock = policy_ok and e.policy in ("guarded", "guarded-writes")
        if needs_lock:
            e.lock = pkg_idx.resolve_lock_spec(e.lock_spec, e.state)
            if e.lock is None:
                findings.append(
                    Finding(
                        "HS603",
                        reg_path,
                        e.line,
                        f"{e.path}: declared lock {e.lock_spec!r} does not "
                        "resolve to a threading.Lock/RLock in the package",
                    )
                )
                ok = False
        elif policy_ok and e.lock_spec:
            findings.append(
                Finding(
                    "HS603",
                    reg_path,
                    e.line,
                    f"{e.path}: policy {e.policy!r} takes no lock, got "
                    f"{e.lock_spec!r}",
                )
            )
            ok = False
        if ok and e.state is not None:
            registered[e.state] = e

    # -- HS601: unregistered shared state reachable from a pool -------------
    reachable = checker.pool_reachable()
    candidates = checker.candidate_globals()
    seen_601: Set[Tuple[StateId, str]] = set()
    for key in sorted(reachable, key=str):
        info = checker.infos[key]
        for a in info.accesses:
            if a.state[0] != "mod" or a.state not in candidates:
                continue
            if a.state in registered:
                continue
            dedup = (a.state, info.rel_path)
            if dedup in seen_601:
                continue
            seen_601.add(dedup)
            findings.append(
                Finding(
                    "HS601",
                    info.rel_path,
                    a.line,
                    f"module global {a.state[2]!r} ({a.state[1]}) is "
                    f"{'written' if a.kind != 'read' else 'read'} from "
                    f"thread-pool-reachable {key[2]}() but has no "
                    "SHARED_STATE entry — declare its lock and policy in "
                    f"{REGISTRY_FILE}",
                )
            )

    # -- HS602: registered state must honor its policy ----------------------
    credits = _locked_credits(checker)
    seen_602: Set[Tuple[StateId, str, int]] = set()
    for key, info in sorted(checker.infos.items(), key=lambda kv: str(kv[0])):
        if key[1] is not None and key[2].split(".")[0] == "__init__":
            continue  # construction happens-before sharing
        credit = credits.get(key, frozenset())
        for a in info.accesses:
            e = registered.get(a.state)
            if e is None:
                continue
            held = a.held | credit
            bad: Optional[str] = None
            if e.policy == "guarded":
                if e.lock not in held:
                    bad = (
                        f"accessed without {e.lock_spec} held "
                        "(policy: guarded)"
                    )
            elif e.policy == "guarded-writes":
                if a.kind != "read" and e.lock not in held:
                    bad = (
                        f"written without {e.lock_spec} held "
                        "(policy: guarded-writes)"
                    )
            elif e.policy == "rebind-only":
                if a.kind == "mutate":
                    bad = (
                        "mutated in place (policy: rebind-only — build a "
                        "new object and publish it with one rebind)"
                    )
            elif e.policy == "frozen":
                if a.kind != "read" and key in reachable:
                    bad = (
                        "written from a thread-pool-reachable function "
                        "(policy: frozen — import-time registration only)"
                    )
            if bad is None:
                continue
            dedup = (a.state, info.rel_path, a.line)
            if dedup in seen_602:
                continue
            seen_602.add(dedup)
            findings.append(
                Finding(
                    "HS602",
                    info.rel_path,
                    a.line,
                    f"{_state_name(a.state)} {bad} in {key[2]}()",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# Lock-witness cross-check (``hslint --witness``)
# ---------------------------------------------------------------------------


def load_witness(path: str, doc: Optional[dict] = None) -> dict:
    """Parse a witness artifact; raises ValueError on a malformed one
    (the CLI maps that to a usage error — a corrupt artifact must never
    pass as 'zero model gaps', nor crash with a traceback). Pass a
    pre-parsed ``doc`` to validate it without re-reading the file (the
    CLI already parsed it to sniff the artifact kind)."""
    if doc is None:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    if not isinstance(doc, dict) or "locks" not in doc or "edges" not in doc:
        raise ValueError(f"not a lock-witness artifact: {path}")
    locks = doc["locks"]
    if not isinstance(locks, dict) or not all(
        isinstance(k, str) and isinstance(v, int) for k, v in locks.items()
    ):
        raise ValueError(f"malformed witness 'locks' map: {path}")
    edges = doc["edges"]
    if not isinstance(edges, list) or not all(
        isinstance(e, list)
        and len(e) >= 2
        and isinstance(e[0], str)
        and isinstance(e[1], str)
        for e in edges
    ):
        raise ValueError(f"malformed witness 'edges' list: {path}")
    return doc


def witness_cross_check(
    projects: List[Project], doc: dict, artifact: str
) -> Tuple[List[Finding], List[str]]:
    """(model-gap findings, staleness warnings) of a witness artifact
    against the static lock model — the UNION over ``projects`` when
    several package dirs are analyzed, since one artifact records every
    wrapped lock in the process.

    A WITNESSED acquisition edge (or lock) the static graph does not
    contain is a hard HS604 error: the runtime did something the model
    cannot see, so every ordering/guard verdict is suspect. A STATIC
    edge between two witnessed locks that was never observed is only a
    staleness warning — the stress suite may simply not have driven that
    path this run."""
    static_names: Set[str] = set()
    static_edges: Set[Tuple[str, str]] = set()
    for project in projects:
        all_locks, edges, _sites = _locks.build_lock_graph(project)
        static_names |= {canonical_lock_name(l) for l in all_locks}
        static_edges |= {
            (canonical_lock_name(a), canonical_lock_name(b))
            for a, targets in edges.items()
            for b in targets
        }
    findings: List[Finding] = []
    warnings: List[str] = []

    wit_locks: Dict[str, int] = dict(doc.get("locks", {}))
    for name in sorted(wit_locks):
        if name not in static_names:
            findings.append(
                Finding(
                    "HS604",
                    artifact,
                    1,
                    f"witnessed lock {name!r} is unknown to the static "
                    "model — a lock exists at runtime that the analyzer "
                    "cannot see",
                )
            )
    witnessed_edges: Set[Tuple[str, str]] = set()
    for edge in doc.get("edges", []):
        a, b = edge[0], edge[1]
        witnessed_edges.add((a, b))
        if (a, b) not in static_edges:
            findings.append(
                Finding(
                    "HS604",
                    artifact,
                    1,
                    f"witnessed acquisition edge {a} -> {b} is absent from "
                    "the static lock graph — the model has a gap; HS501's "
                    "cycle verdict cannot be trusted until it is closed",
                )
            )
    for a, b in sorted(static_edges):
        if a in wit_locks and b in wit_locks and (a, b) not in witnessed_edges:
            warnings.append(
                f"static lock edge never witnessed: {a} -> {b} — stale "
                "model or an unexercised path"
            )
    for entry, meta in sorted(doc.get("entries", {}).items()):
        lock = meta.get("lock")
        if lock and wit_locks.get(lock, 0) == 0:
            warnings.append(
                f"SHARED_STATE entry {entry}: declared lock {lock} was "
                "never acquired during the witnessed run — guard coverage "
                "gap"
            )
    return findings, warnings
