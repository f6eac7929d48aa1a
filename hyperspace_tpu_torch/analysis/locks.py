"""HS5xx — lock-order and lock-held-I/O lint.

The concurrency seams of this codebase are few but sharp: the kernel
loader's one-time nvcc build lock (``kernels.py``), the calibration
probe lock (``calibrate.py``), the serve-cache LRU
lock (``execution/serve_cache.py``) and the session's cache-construction
lock (``session.py``). The concurrent first-compile race fixed in
history shows these bite in practice.

The checker builds, statically:

* the set of lock objects — module-level ``X = threading.Lock()`` /
  ``RLock()`` and instance ``self.x = threading.Lock()`` assignments;
* per function/method: which locks it acquires (``with X:`` /
  ``X.acquire()``), which calls happen while each lock is held, and
  whether its body performs I/O (``open``, ``os.*``, ``subprocess.*``,
  ``shutil.*``, ``socket.*``, ``tempfile.*``, ``ctypes.CDLL``);
* a cross-module call graph (imports resolved within the package, one
  pass, no execution) and from it the transitive *may-acquire* set of
  every function.

Rules:

* HS501 — the lock-acquisition graph (edge A→B when B is acquired, or a
  function that may acquire B is called, while A is held) contains a
  cycle: two threads taking the locks in opposite orders deadlock.
* HS502 — I/O performed while a lock is held (directly in the held
  region, or by a directly-called function): the canonical slow-lock
  anti-pattern. One finding per held region, anchored at the acquire
  site, so a single suppression covers a deliberately-serialized region
  (e.g. the one-time nvcc build under ``_lock``).

Both rules are approximations (no aliasing, attribute-chain resolution
one level deep); they are tuned to be quiet on correct code and loud on
the two failure modes named above.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from hyperspace_tpu_torch.analysis.core import (
    Finding,
    Project,
    dotted_name,
    import_aliases,
)

RULES = {
    "HS501": "lock-acquisition cycle (potential deadlock)",
    "HS502": "I/O while holding a lock",
}

#: dotted-prefix roots treated as I/O
IO_ROOTS = ("os", "subprocess", "shutil", "socket", "tempfile")
#: os.* members that are pure/cheap (string manipulation, process
#: introspection, config reads) — not I/O
IO_EXCLUDED_PREFIXES = (
    "os.environ",
    "os.path.join",
    "os.path.basename",
    "os.path.dirname",
    "os.path.split",
    "os.path.splitext",
    "os.path.expanduser",
    "os.path.normpath",
    "os.getpid",
    "os.cpu_count",
    "os.sched_getaffinity",
    "os.fspath",
    "os.sep",
    "os.name",
)

LockId = Tuple[str, str]  # ("mod:<rel>" | "cls:<rel>:<Class>", attr)
FuncKey = Tuple[str, Optional[str], str]  # (rel, class or None, name)


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name is not None and name.split(".")[-1] in ("Lock", "RLock")


def _is_io_call(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    if name is None:
        return False
    if name == "open" or name == "ctypes.CDLL":
        return True
    if any(name.startswith(p) for p in IO_EXCLUDED_PREFIXES):
        return False
    root = name.split(".")[0]
    return root in IO_ROOTS and "." in name


@dataclasses.dataclass
class FuncInfo:
    key: FuncKey
    rel_path: str  # display path of the defining file
    direct_locks: Set[LockId] = dataclasses.field(default_factory=set)
    direct_io: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    calls: Set[FuncKey] = dataclasses.field(default_factory=set)
    # (held lock, acquired lock, line) — both held and acquired directly
    direct_edges: List[Tuple[LockId, LockId, int]] = dataclasses.field(
        default_factory=list
    )
    # (held lock, acquire line, callee key) — call made under the lock
    held_calls: List[Tuple[LockId, int, FuncKey]] = dataclasses.field(
        default_factory=list
    )
    # (held lock, acquire line, description, io line) — direct I/O under it
    held_io: List[Tuple[LockId, int, str, int]] = dataclasses.field(
        default_factory=list
    )


class _ModuleIndex:
    """Resolution context for one file."""

    def __init__(self, project: Project, rel: str):
        self.project = project
        self.rel = rel
        self.sf = project.files[rel]
        self.aliases = import_aliases(self.sf.tree) if self.sf.tree else {}
        self.pkg = os.path.basename(project.package_dir)
        self.module_locks: Set[str] = set()
        self.functions: Set[str] = set()
        self.classes: Dict[str, Set[str]] = {}  # class -> method names
        self.class_locks: Dict[str, Set[str]] = {}  # class -> lock attrs
        # class -> base-class exprs, as written (resolved after all
        # modules are indexed — a base usually lives in another file)
        self.class_bases: Dict[str, List[ast.expr]] = {}
        # class -> {lock attr -> base-class LockId} for locks the class
        # INHERITS rather than assigns: ``self._lock`` in a subclass
        # method is the base's lock object (attribute lookup is
        # dynamic), so it must resolve to the base's identity or the
        # ordering graph would fork one lock into two
        self.inherited_locks: Dict[str, Dict[str, LockId]] = {}
        # class -> {(rel, class)} of every in-package ancestor,
        # transitively (dynamic dispatch: a call through a base-class
        # method key may execute a subclass override)
        self.resolved_bases: Dict[str, Set[Tuple[str, str]]] = {}

    def qualified_to_rel(self, qualified: str) -> Optional[str]:
        """'hyperspace_tpu_torch.ops' -> 'ops/__init__.py' (or .py file)."""
        if not qualified.startswith(self.pkg + "."):
            return None
        tail = qualified[len(self.pkg) + 1 :].replace(".", "/")
        for cand in (f"{tail}.py", f"{tail}/__init__.py"):
            if cand in self.project.files:
                return cand
        return None


def _collect_defs(project: Project) -> Tuple[Dict[str, _ModuleIndex], Set[LockId]]:
    indexes: Dict[str, _ModuleIndex] = {}
    locks: Set[LockId] = set()
    for rel, sf in project.files.items():
        idx = _ModuleIndex(project, rel)
        indexes[rel] = idx
        if sf.tree is None:
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        idx.module_locks.add(t.id)
                        locks.add((f"mod:{rel}", t.id))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                idx.functions.add(node.name)
            elif isinstance(node, ast.ClassDef):
                methods = {
                    m.name
                    for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
                idx.classes[node.name] = methods
                lock_attrs: Set[str] = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                        for t in sub.targets:
                            if (
                                isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                            ):
                                lock_attrs.add(t.attr)
                                locks.add((f"cls:{rel}:{node.name}", t.attr))
                idx.class_locks[node.name] = lock_attrs
                if node.bases:
                    idx.class_bases[node.name] = list(node.bases)
    _link_inherited_locks(indexes)
    return indexes, locks


def _resolve_base_class(
    idx: _ModuleIndex, indexes: Dict[str, _ModuleIndex], base: ast.expr
) -> Optional[Tuple[str, str]]:
    """``(rel, class)`` a base-class expression names, or None for
    anything outside the package (stdlib/third-party bases hold no locks
    we model)."""
    name = dotted_name(base)
    if not name:
        return None
    head, _, rest = name.partition(".")
    full = idx.aliases.get(head, head) + (f".{rest}" if rest else "")
    mod, _, cls = full.rpartition(".")
    if not mod:  # same-module base, unqualified
        return (idx.rel, cls) if cls in idx.classes else None
    brel = idx.qualified_to_rel(mod)
    if brel is None or cls not in indexes[brel].classes:
        return None
    return brel, cls


def _link_inherited_locks(indexes: Dict[str, _ModuleIndex]) -> None:
    """Propagate lock attributes down single-inheritance chains: a
    subclass that does NOT assign ``self.<attr>`` itself sees the base's
    lock under the base's LockId. Fixpoint handles multi-level chains
    regardless of file iteration order; a subclass re-assigning the
    attr shadows the base (its own class_locks entry wins)."""
    changed = True
    while changed:
        changed = False
        for idx in indexes.values():
            for cls, bases in idx.class_bases.items():
                own = idx.inherited_locks.setdefault(cls, {})
                ancestors = idx.resolved_bases.setdefault(cls, set())
                for base in bases:
                    target = _resolve_base_class(idx, indexes, base)
                    if target is None:
                        continue
                    brel, bcls = target
                    bidx = indexes[brel]
                    lineage = {target} | bidx.resolved_bases.get(bcls, set())
                    if not lineage <= ancestors:
                        ancestors |= lineage
                        changed = True
                    merged: Dict[str, LockId] = dict(
                        bidx.inherited_locks.get(bcls, {})
                    )
                    for attr in bidx.class_locks.get(bcls, ()):
                        merged[attr] = (f"cls:{brel}:{bcls}", attr)
                    for attr, lock_id in merged.items():
                        if attr in idx.class_locks.get(cls, ()):
                            continue  # shadowed by the subclass's own lock
                        if own.get(attr) != lock_id:
                            own[attr] = lock_id
                            changed = True


def _resolve_lock(
    idx: _ModuleIndex, cls: Optional[str], node: ast.AST
) -> Optional[LockId]:
    if isinstance(node, ast.Name) and node.id in idx.module_locks:
        return (f"mod:{idx.rel}", node.id)
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and cls is not None
    ):
        if node.attr in idx.class_locks.get(cls, ()):
            return (f"cls:{idx.rel}:{cls}", node.attr)
        return idx.inherited_locks.get(cls, {}).get(node.attr)
    return None


def _resolve_call(
    idx: _ModuleIndex,
    indexes: Dict[str, _ModuleIndex],
    cls: Optional[str],
    node: ast.Call,
) -> Optional[FuncKey]:
    f = node.func
    if isinstance(f, ast.Name):
        if f.id in idx.functions:
            return (idx.rel, None, f.id)
        if f.id in idx.classes:
            return (idx.rel, f.id, "__init__")
        target = idx.aliases.get(f.id)
        if target:  # from pkg.mod import fn / Class
            mod, _, leaf = target.rpartition(".")
            rel2 = idx.qualified_to_rel(mod) if mod else None
            if rel2 and rel2 in indexes:
                if leaf in indexes[rel2].functions:
                    return (rel2, None, leaf)
                if leaf in indexes[rel2].classes:
                    return (rel2, leaf, "__init__")
        return None
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name):
            base = f.value.id
            if base == "self" and cls is not None:
                if f.attr in idx.classes.get(cls, ()):
                    return (idx.rel, cls, f.attr)
                return None
            target = idx.aliases.get(base)
            if target:
                rel2 = idx.qualified_to_rel(target)
                if rel2 and rel2 in indexes:
                    if f.attr in indexes[rel2].functions:
                        return (rel2, None, f.attr)
                    if f.attr in indexes[rel2].classes:
                        return (rel2, f.attr, "__init__")
    return None


class _FuncAnalyzer:
    """Sequential statement walk of one function maintaining the held-lock
    set; ``with lock:`` holds for the block, ``lock.acquire()`` holds for
    the rest of the function (``release()`` drops it)."""

    def __init__(
        self,
        info: FuncInfo,
        idx: _ModuleIndex,
        indexes: Dict[str, _ModuleIndex],
        cls: Optional[str],
    ):
        self.info = info
        self.idx = idx
        self.indexes = indexes
        self.cls = cls
        self.held: List[Tuple[LockId, int]] = []  # (lock, acquire line)

    def run(self, fn: ast.FunctionDef) -> None:
        self._stmts(fn.body)

    # -- statements ---------------------------------------------------------
    def _stmts(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in stmt.items:
                lock = _resolve_lock(self.idx, self.cls, item.context_expr)
                if lock is not None:
                    self._acquire(lock, item.context_expr.lineno)
                    acquired.append(lock)
                else:
                    self._expr(item.context_expr)
            self._stmts(stmt.body)
            for lock in acquired:
                self._release(lock)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs analyzed when (if) they run, not here
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.stmt):
                self._stmt(node)
            elif isinstance(node, ast.expr):
                self._expr(node)
            elif isinstance(node, (ast.ExceptHandler,)):
                self._stmts(node.body)

    # -- expressions --------------------------------------------------------
    def _expr(self, node: ast.AST) -> None:
        for call in [
            n for n in ast.walk(node) if isinstance(n, ast.Call)
        ]:
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in ("acquire", "release"):
                lock = _resolve_lock(self.idx, self.cls, f.value)
                if lock is not None:
                    if f.attr == "acquire":
                        self._acquire(lock, call.lineno)
                    else:
                        self._release(lock)
                    continue
            self._record_call(call)

    # -- events -------------------------------------------------------------
    def _acquire(self, lock: LockId, line: int) -> None:
        self.info.direct_locks.add(lock)
        for held, _hline in self.held:
            if held != lock:
                self.info.direct_edges.append((held, lock, line))
        self.held.append((lock, line))

    def _release(self, lock: LockId) -> None:
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i][0] == lock:
                del self.held[i]
                return

    def _record_call(self, call: ast.Call) -> None:
        if _is_io_call(call):
            desc = dotted_name(call.func) or "open"
            self.info.direct_io.append((desc, call.lineno))
            for held, hline in self.held:
                self.info.held_io.append((held, hline, desc, call.lineno))
        callee = _resolve_call(self.idx, self.indexes, self.cls, call)
        if callee is not None:
            self.info.calls.add(callee)
            for held, hline in self.held:
                self.info.held_calls.append((held, hline, callee))


def _analyze_functions(
    project: Project, indexes: Dict[str, _ModuleIndex]
) -> Dict[FuncKey, FuncInfo]:
    infos: Dict[FuncKey, FuncInfo] = {}
    for rel, sf in project.files.items():
        if sf.tree is None:
            continue
        idx = indexes[rel]

        def handle(fn: ast.FunctionDef, cls: Optional[str]) -> None:
            key: FuncKey = (rel, cls, fn.name)
            info = FuncInfo(key, sf.rel_path)
            _FuncAnalyzer(info, idx, indexes, cls).run(fn)
            infos[key] = info

        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                handle(node, None)
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        handle(m, node.name)
    return infos


def _may_acquire(infos: Dict[FuncKey, FuncInfo]) -> Dict[FuncKey, Set[LockId]]:
    """Transitive closure of lock acquisition over the call graph."""
    may: Dict[FuncKey, Set[LockId]] = {
        k: set(v.direct_locks) for k, v in infos.items()
    }
    changed = True
    while changed:
        changed = False
        for key, info in infos.items():
            for callee in info.calls:
                extra = may.get(callee)
                if extra and not extra <= may[key]:
                    may[key] |= extra
                    changed = True
    return may


def _find_cycle(
    edges: Dict[LockId, Set[LockId]]
) -> Optional[List[LockId]]:
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[LockId, int] = {}
    stack: List[LockId] = []

    def dfs(u: LockId) -> Optional[List[LockId]]:
        color[u] = GRAY
        stack.append(u)
        for v in sorted(edges.get(u, ())):
            c = color.get(v, WHITE)
            if c == GRAY:
                return stack[stack.index(v) :] + [v]
            if c == WHITE:
                got = dfs(v)
                if got:
                    return got
        stack.pop()
        color[u] = BLACK
        return None

    for u in sorted(edges):
        if color.get(u, WHITE) == WHITE:
            got = dfs(u)
            if got:
                return got
    return None


def _lock_name(lock: LockId) -> str:
    scope, attr = lock
    if scope.startswith("cls:"):
        return f"{scope.rsplit(':', 1)[1]}.{attr}"
    return attr


def canonical_lock_name(lock: LockId) -> str:
    """Stable cross-artifact name for a lock: ``<rel>::<attr>`` for a
    module lock, ``<rel>::<Class>.<attr>`` for an instance lock. The
    runtime lock witness (``testing/lock_witness.py``) emits the same
    names, so witness artifacts and the static model compare directly."""
    scope, attr = lock
    if scope.startswith("cls:"):
        _, rel, cls = scope.split(":", 2)
        return f"{rel}::{cls}.{attr}"
    return f"{scope.split(':', 1)[1]}::{attr}"


def _model(project: Project):
    """The full lock model of a tree — (indexes, all locks, per-function
    infos, may-acquire sets, edges, edge anchor sites) — computed ONCE
    per Project and memoized on it: the HS501/HS502 pass and the
    lock-witness cross-check share one analysis."""
    cached = getattr(project, "_locks_model_cache", None)
    if cached is None:
        indexes, all_locks = _collect_defs(project)
        infos = _analyze_functions(project, indexes)
        may = _may_acquire(infos)
        edges, edge_sites = _edges_from(infos, may)
        cached = (indexes, all_locks, infos, may, edges, edge_sites)
        project._locks_model_cache = cached
    return cached


def build_lock_graph(
    project: Project,
) -> Tuple[
    Set[LockId],
    Dict[LockId, Set[LockId]],
    Dict[Tuple[LockId, LockId], Tuple[str, int]],
]:
    """(all locks, edges, edge anchor sites) of the static lock model:
    edge A→B when B is acquired — directly or via any callee's
    may-acquire set — while A is held. Shared by the HS501 cycle check
    and the lock-witness cross-check (``analysis/shared_state.py``);
    memoized per Project."""
    _indexes, all_locks, _infos, _may, edges, edge_sites = _model(project)
    return all_locks, edges, edge_sites


def _edges_from(
    infos: Dict[FuncKey, FuncInfo], may: Dict[FuncKey, Set[LockId]]
) -> Tuple[
    Dict[LockId, Set[LockId]], Dict[Tuple[LockId, LockId], Tuple[str, int]]
]:
    """Edges: direct nested acquires + acquires via calls made while
    holding (through the transitive may-acquire set)."""
    edges: Dict[LockId, Set[LockId]] = {}
    edge_sites: Dict[Tuple[LockId, LockId], Tuple[str, int]] = {}
    for info in infos.values():
        for held, acquired, line in info.direct_edges:
            edges.setdefault(held, set()).add(acquired)
            edge_sites.setdefault((held, acquired), (info.rel_path, line))
        for held, hline, callee in info.held_calls:
            for acquired in may.get(callee, ()):
                if acquired == held:
                    continue
                edges.setdefault(held, set()).add(acquired)
                edge_sites.setdefault((held, acquired), (info.rel_path, hline))
    return edges, edge_sites


def check(project: Project) -> List[Finding]:
    _indexes, _locks_, infos, _may, edges, edge_sites = _model(project)
    findings: List[Finding] = []

    cycle = _find_cycle(edges)
    if cycle:
        pairs = list(zip(cycle, cycle[1:]))
        path = " -> ".join(_lock_name(l) for l in cycle)
        rel_path, line = edge_sites.get(pairs[0], ("", 1))
        findings.append(
            Finding(
                "HS501",
                rel_path,
                line,
                f"lock-acquisition cycle: {path} — threads taking these in "
                "opposite orders deadlock",
            )
        )

    # -- lock-held I/O, one finding per held region -------------------------
    grouped: Dict[Tuple[FuncKey, LockId, int], List[str]] = {}
    for info in infos.values():
        for held, hline, desc, io_line in info.held_io:
            grouped.setdefault((info.key, held, hline), []).append(
                f"{desc} (line {io_line})"
            )
        for held, hline, callee in info.held_calls:
            callee_info = infos.get(callee)
            if callee_info and callee_info.direct_io:
                desc, io_line = callee_info.direct_io[0]
                grouped.setdefault((info.key, held, hline), []).append(
                    f"{callee[2]}() -> {desc} ({callee_info.rel_path}:{io_line})"
                )
    for (key, held, hline), sites in sorted(
        grouped.items(), key=lambda kv: (str(kv[0][0]), kv[0][1], kv[0][2])
    ):
        info = infos[key]
        shown = ", ".join(dict.fromkeys(sites))
        if len(shown) > 200:
            shown = shown[:200] + "…"
        findings.append(
            Finding(
                "HS502",
                info.rel_path,
                hline,
                f"I/O while holding {_lock_name(held)!r} in {key[2]}(): "
                f"{shown} — blocks every other thread on this lock for the "
                "I/O's duration",
            )
        )
    return findings
