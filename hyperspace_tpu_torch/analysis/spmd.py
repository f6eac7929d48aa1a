"""HS8xx — SPMD collective-symmetry sanitizer + collective witness.

Counterpart of ``hyperspace_tpu/analysis/spmd.py`` in the port's
vocabulary. A job of several processes lives or dies by every
participant issuing the same collective program: a zero-row process
skipping the ``all_to_all_single``, waves planned over per-process file
lists, a barrier reachable from only some processes all hang it. This
checker holds the ``COLLECTIVE_SITES`` registry in
``parallel/collectives.py`` (every collective or barrier call site
declares its symmetry contract — ``symmetric-all``, ``per-host-lane``,
``coordinator-gated`` — with a one-line justification) against the code.

Statically, the checker:

* finds every call to a collective primitive — the ``torch.distributed``
  calls the port makes (``all_to_all_single``, ``all_gather``,
  ``all_gather_object``, ``all_reduce``, ``broadcast``, ``barrier``,
  ``send``, ``recv`` and their kin, through a ``dist`` /
  ``torch.distributed`` receiver), the bootstrap
  ``init_process_group``, and the in-process exchange between the shards
  of one mesh (``_exchange_blocks``, the port's translation of the
  reference's ``lax.all_to_all`` inside ``shard_map``) — and attributes it
  to its enclosing module-level function or method;
* builds the transitive *may-reach-collective* set of every function
  over the same cross-module call resolution as :mod:`analysis.locks`;
* tracks, per function, which local names are *process-identity
  tainted* (assigned from ``process_index()`` / ``mesh.process_index``
  / ``dist.get_rank()`` / ``is_coordinator`` / ``.process_local()``,
  transitively through local assignments; the world size is
  deliberately NOT tainted — every process agrees on it). A gather's
  result is global, and ``torch.distributed`` hands it back through an
  output list that no identity value is assigned to, so it stays
  untainted by construction.

Rules:

* HS801 — an ``if`` that branches on process identity can reach a
  collective on only some of its paths: the processes that take the
  other path never issue the collective and the job deadlocks. Sites
  whose registered contract is ``coordinator-gated`` are exempt.
* HS802 — a function issues a collective primitive but has no
  ``COLLECTIVE_SITES`` entry, or a registry entry is stale (unresolved
  path, unknown contract, missing justification, or a non-gated entry
  whose function neither issues nor reaches a collective: a one-process
  strategy that hands a job of several processes to its multi-process
  form reaches that form's collectives).
* HS803 — a loop that encloses a collective iterates over
  process-local data (a ``.process_local()`` subset, a
  ``[process_index()::n]`` stripe): different processes run different
  iteration counts and issue different numbers of collectives.
* HS804 — only in ``--witness`` mode: the runtime collective witness
  (``testing/collective_witness.py``, armed via
  ``HS_COLLECTIVE_WITNESS=<prefix>`` in ``scripts/torch_dryrun_multihost.py``)
  recorded per-process collective sequences that diverge, a witnessed
  site the registry lacks, or a coordinator-gated site witnessed off
  process 0. Registered-but-never-witnessed is a staleness *warning*.

:func:`dryrun_lines` names the multi-process dryrun whose witness matrix
``contracts`` (HS703) holds every registered site to: the port's scripts
carry the prefix ``torch_`` (``scripts/torch_dryrun_multihost.py``),
the reference's do not.

Like every checker here this is an approximation (no aliasing, local
taint only); it is tuned to be quiet on correct code and loud on the
divergence shapes a review would otherwise catch by hand.
"""

from __future__ import annotations

import ast
import dataclasses
import glob as _glob
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

RULES = {
    "HS801": "process-identity branch can reach a collective on only "
    "some paths",
    "HS802": "collective call site absent from COLLECTIVE_SITES (or "
    "stale registry entry)",
    "HS803": "loop enclosing a collective iterates over process-local "
    "data",
    "HS804": "collective witness diverges from the registry or contract",
}

#: candidate homes of the COLLECTIVE_SITES literal, first hit wins
REGISTRY_FILES = ("parallel/collectives.py", "collectives.py", "parallel/__init__.py")

CONTRACTS = ("symmetric-all", "per-host-lane", "coordinator-gated")

#: last path component of a ``torch.distributed`` collective call (made
#: through a receiver in DIST_BASES)
COLLECTIVE_PRIMITIVES = frozenset(
    {
        "all_to_all",
        "all_to_all_single",
        "all_gather",
        "all_gather_into_tensor",
        "all_gather_object",
        "all_reduce",
        "reduce",
        "reduce_scatter",
        "reduce_scatter_tensor",
        "broadcast",
        "broadcast_object_list",
        "gather",
        "gather_object",
        "scatter",
        "scatter_object_list",
        "barrier",
        "monitored_barrier",
        "send",
        "recv",
        "isend",
        "irecv",
        "batch_isend_irecv",
    }
)

#: receivers of the calls above: ``import torch.distributed as dist``
DIST_BASES = ("dist", "torch.distributed", "distributed", "_dist")

#: the bootstrap every process issues once (``distributed.initialize`` in
#: the reference)
BOOTSTRAP = "init_process_group"

#: in-process collectives between the shards of one mesh, by callable
#: name: ``parallel/shuffle._exchange_blocks`` moves ``blocks[s][t]`` to
#: shard t for every (s, t), the reference's ``lax.all_to_all``
IN_PROCESS_PRIMITIVES = frozenset({"_exchange_blocks"})

#: the multi-process dryrun that drives every registered site
DRYRUN_FILE = "dryrun_multihost.py"

FuncKey = Tuple[str, Optional[str], str]  # (rel, class or None, name)


# ---------------------------------------------------------------------------
# Registry parsing + resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SiteEntry:
    path: str
    op: str
    contract: str
    why: str
    line: int
    key: Optional[FuncKey] = None  # resolved


def registry_file(project: Project) -> Optional[str]:
    for rel in REGISTRY_FILES:
        sf = project.file(rel)
        if sf is None or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            targets: List[str] = []
            if isinstance(node, ast.Assign):
                targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name
            ):
                targets = [node.target.id]
            if "COLLECTIVE_SITES" in targets:
                return rel
    return None


def parse_sites(project: Project) -> Tuple[List[SiteEntry], Optional[str]]:
    """(entries, registry rel) from the COLLECTIVE_SITES literal;
    ([], None) when absent — trees without a multi-host plane simply
    skip the registry-backed rules."""
    rel = registry_file(project)
    if rel is None:
        return [], None
    sf = project.file(rel)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            targets = [node.target.id]
        else:
            continue
        if "COLLECTIVE_SITES" not in targets or not isinstance(
            node.value, ast.Dict
        ):
            continue
        entries: List[SiteEntry] = []
        for k, v in zip(node.value.keys, node.value.values):
            key = const_str(k) if k is not None else None
            if key is None:
                continue
            op = contract = why = ""
            if isinstance(v, (ast.Tuple, ast.List)) and len(v.elts) >= 3:
                op = const_str(v.elts[0]) or ""
                contract = const_str(v.elts[1]) or ""
                why = const_str(v.elts[2]) or ""
            entries.append(SiteEntry(key, op, contract, why, v.lineno))
        return entries, rel
    return [], None


class _Resolver:
    """Dotted paths <-> FuncKeys over the package tree."""

    def __init__(self, project: Project):
        self.project = project
        self.pkg = os.path.basename(project.package_dir)
        self.indexes = _locks._model(project)[0]

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

    def resolve_site_path(self, path: str) -> Optional[FuncKey]:
        parts = path.split(".")
        if len(parts) < 2 or parts[0] != self.pkg:
            return None
        for i in range(len(parts) - 1, 0, -1):
            rel = self.rel_for(".".join(parts[:i]))
            if rel is None:
                continue
            rest = parts[i:]
            idx = self.indexes[rel]
            if len(rest) == 1 and rest[0] in idx.functions:
                return (rel, None, rest[0])
            if (
                len(rest) == 2
                and rest[0] in idx.classes
                and rest[1] in idx.classes[rest[0]]
            ):
                return (rel, rest[0], rest[1])
            return None
        return None

    def dotted_path(self, key: FuncKey) -> str:
        rel, cls, name = key
        mod = rel[: -len(".py")] if rel.endswith(".py") else rel
        if mod.endswith("/__init__"):
            mod = mod[: -len("/__init__")]
        mod = mod.replace("/", ".")
        base = self.pkg if mod == "__init__" else f"{self.pkg}.{mod}"
        return f"{base}.{cls}.{name}" if cls else f"{base}.{name}"


# ---------------------------------------------------------------------------
# Per-function facts
# ---------------------------------------------------------------------------


def _primitive_op(call: ast.Call) -> Optional[str]:
    name = dotted_name(call.func)
    if name is None:
        return None
    base, _, leaf = name.rpartition(".")
    if leaf in IN_PROCESS_PRIMITIVES:
        return leaf
    if base not in DIST_BASES:
        return None
    if leaf == BOOTSTRAP or leaf in COLLECTIVE_PRIMITIVES:
        return leaf
    return None


def dryrun_lines(project: Project) -> Tuple[str, Optional[List[str]]]:
    """(script name, lines) of the multi-process dryrun beside the package:
    ``scripts/torch_dryrun_multihost.py`` for a package named ``*_torch``,
    else ``scripts/dryrun_multihost.py``; lines None when it is absent
    (fixture trees simply skip the file-backed rule)."""
    pkg = os.path.basename(project.package_dir)
    name = ("torch_" if pkg.endswith("_torch") else "") + DRYRUN_FILE
    return name, project.aux_lines("scripts", name)


@dataclasses.dataclass
class _FnFacts:
    key: FuncKey
    rel_path: str
    node: ast.AST
    primitives: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    calls: Set[FuncKey] = dataclasses.field(default_factory=set)


class _Analysis:
    def __init__(self, project: Project):
        self.project = project
        self.resolver = _Resolver(project)
        self.indexes = self.resolver.indexes
        self.facts: Dict[FuncKey, _FnFacts] = {}
        for rel, sf in project.files.items():
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._collect(rel, sf.rel_path, None, node)
                elif isinstance(node, ast.ClassDef):
                    for m in node.body:
                        if isinstance(
                            m, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            self._collect(rel, sf.rel_path, node.name, m)
        self.reach = self._reach_closure()

    def _collect(
        self, rel: str, rel_path: str, cls: Optional[str], fn: ast.AST
    ) -> None:
        """Full-subtree facts: collectives inside nested defs/lambdas
        (closures handed to a pool) attribute to the OUTERMOST def — the
        granularity the registry names."""
        key: FuncKey = (rel, cls, fn.name)
        facts = _FnFacts(key, rel_path, fn)
        idx = self.indexes[rel]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            op = _primitive_op(node)
            if op is not None:
                facts.primitives.append((op, node.lineno))
                continue
            callee = _locks._resolve_call(idx, self.indexes, cls, node)
            if callee is not None and callee != key:
                facts.calls.add(callee)
        self.facts[key] = facts

    def _reach_closure(self) -> Dict[FuncKey, Set[FuncKey]]:
        """FuncKey -> set of collective-BEARING functions transitively
        reachable from it (a function with a direct primitive counts as
        reaching itself)."""
        bearing = {k for k, f in self.facts.items() if f.primitives}
        reach: Dict[FuncKey, Set[FuncKey]] = {
            k: ({k} if k in bearing else set()) for k in self.facts
        }
        changed = True
        while changed:
            changed = False
            for key, facts in self.facts.items():
                for callee in facts.calls:
                    extra = reach.get(callee)
                    if extra and not extra <= reach[key]:
                        reach[key] |= extra
                        changed = True
        return reach

    # -- site naming --------------------------------------------------------
    def site_name(self, key: FuncKey) -> str:
        return self.resolver.dotted_path(key)

    def reach_of_stmts(
        self, facts: _FnFacts, stmts: List[ast.stmt]
    ) -> Set[str]:
        """Collective sites reachable from a statement list: direct
        primitives (named ``<op>@<rel>``) plus the transitive reach of
        every resolvable call, as registry-comparable dotted names."""
        out: Set[str] = set()
        idx = self.indexes[facts.key[0]]
        for stmt in stmts:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                op = _primitive_op(node)
                if op is not None:
                    out.add(f"{op}@{facts.key[0]}")
                    continue
                callee = _locks._resolve_call(
                    idx, self.indexes, facts.key[1], node
                )
                if callee is None:
                    continue
                for reached in self.reach.get(callee, ()):
                    out.add(self.site_name(reached))
        return out


# ---------------------------------------------------------------------------
# Identity taint (per function, local)
# ---------------------------------------------------------------------------


def _expr_has_identity_source(node: ast.AST, tainted: Set[str]) -> bool:
    """True when the expression derives from process identity: a
    ``process_index()`` / ``get_rank()`` call, a ``.process_index`` or
    ``is_coordinator`` reference, a ``.process_local()`` call, or a name
    already tainted."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        leaf = name.split(".")[-1]
        if leaf in ("process_index", "process_local", "get_rank"):
            return True
    if isinstance(node, ast.Attribute) and node.attr in (
        "is_coordinator",
        "process_index",
    ):
        return True
    if isinstance(node, ast.Name) and (
        node.id == "is_coordinator" or node.id in tainted
    ):
        return True
    return any(
        _expr_has_identity_source(child, tainted)
        for child in ast.iter_child_nodes(node)
    )


def _identity_tainted_names(fn: ast.AST) -> Set[str]:
    """Local names assigned (anywhere in the function subtree) from a
    process-identity expression, to a local fixpoint."""
    assigns: List[Tuple[List[str], ast.AST]] = []
    for node in ast.walk(fn):
        targets: List[ast.expr] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets, value = [node.target], node.value
        if value is None:
            continue
        names = [
            t.id
            for tt in targets
            for t in ast.walk(tt)
            if isinstance(t, ast.Name)
        ]
        if names:
            assigns.append((names, value))
    tainted: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if any(n in tainted for n in names):
                continue
            if _expr_has_identity_source(value, tainted):
                tainted.update(names)
                changed = True
    return tainted


def _terminates(stmts: List[ast.stmt]) -> bool:
    """The arm never falls through to the code after the branch."""
    return any(
        isinstance(s, (ast.Return, ast.Raise, ast.Break, ast.Continue))
        for s in stmts
    )


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    analysis = _Analysis(project)
    entries, reg_rel = parse_sites(project)
    reg_sf = project.file(reg_rel) if reg_rel else None
    reg_path = reg_sf.rel_path if reg_sf is not None else "parallel/collectives.py"

    # -- HS802 (registry side): every entry must resolve --------------------
    contracts: Dict[str, str] = {}
    for e in entries:
        ok = True
        e.key = analysis.resolver.resolve_site_path(e.path)
        if e.key is None:
            findings.append(
                Finding(
                    "HS802",
                    reg_path,
                    e.line,
                    f"COLLECTIVE_SITES entry {e.path!r} names no "
                    "module-level callable in the package (stale "
                    "registry?)",
                )
            )
            ok = False
        if e.contract not in CONTRACTS:
            findings.append(
                Finding(
                    "HS802",
                    reg_path,
                    e.line,
                    f"{e.path}: unknown contract {e.contract!r} "
                    f"(have {', '.join(CONTRACTS)})",
                )
            )
            ok = False
        if not e.why.strip():
            findings.append(
                Finding(
                    "HS802",
                    reg_path,
                    e.line,
                    f"{e.path}: missing justification — every registry "
                    "entry must say why its symmetry contract holds",
                )
            )
            ok = False
        if (
            ok
            and e.contract != "coordinator-gated"
            and not analysis.reach.get(e.key)
        ):
            findings.append(
                Finding(
                    "HS802",
                    reg_path,
                    e.line,
                    f"{e.path}: registered as a {e.contract} collective "
                    "site but its body neither issues nor reaches a "
                    "collective primitive (stale registry?)",
                )
            )
            ok = False
        if ok:
            contracts[e.path] = e.contract

    def effective(sites: Set[str]) -> Set[str]:
        """Drop coordinator-gated sites — asymmetric reach of those is
        the contract, not a divergence."""
        return {
            s for s in sites if contracts.get(s) != "coordinator-gated"
        }

    # -- HS802 (call side): every collective-bearing function registered ----
    declared = {e.path for e in entries}  # broken entries already flagged
    for key in sorted(analysis.facts, key=str):
        facts = analysis.facts[key]
        if not facts.primitives:
            continue
        path = analysis.site_name(key)
        if path in contracts or path in declared:
            continue
        op, line = facts.primitives[0]
        findings.append(
            Finding(
                "HS802",
                facts.rel_path,
                line,
                f"{key[2]}() issues {op} but has no COLLECTIVE_SITES "
                f"entry — declare {path!r} with its symmetry contract in "
                "parallel/collectives.py",
            )
        )

    # -- HS801 + HS803: per-function control-flow sweep ---------------------
    for key in sorted(analysis.facts, key=str):
        facts = analysis.facts[key]
        fn = facts.node
        tainted = _identity_tainted_names(fn)

        for node in ast.walk(fn):
            if isinstance(node, ast.If):
                if not _expr_has_identity_source(node.test, tainted):
                    continue
                body_sites = effective(
                    analysis.reach_of_stmts(facts, node.body)
                )
                else_sites = effective(
                    analysis.reach_of_stmts(facts, node.orelse)
                )
                after = [
                    s
                    for s in ast.walk(fn)
                    if isinstance(s, ast.stmt)
                    and s.lineno > (node.end_lineno or node.lineno)
                ]
                after_sites = effective(analysis.reach_of_stmts(facts, after))
                path_body = body_sites | (
                    set() if _terminates(node.body) else after_sites
                )
                path_else = else_sites | (
                    set() if _terminates(node.orelse) else after_sites
                )
                if path_body == path_else or not (path_body | path_else):
                    continue
                only = sorted(path_body.symmetric_difference(path_else))
                findings.append(
                    Finding(
                        "HS801",
                        facts.rel_path,
                        node.lineno,
                        f"branch on process identity in {key[2]}() "
                        "reaches a collective on only some paths "
                        f"({', '.join(only[:3])}) — processes taking the "
                        "other path never issue it and the job deadlocks",
                    )
                )
            elif isinstance(node, ast.For):
                if not _expr_has_identity_source(node.iter, tainted):
                    continue
                body_sites = effective(
                    analysis.reach_of_stmts(facts, node.body)
                )
                if not body_sites:
                    continue
                findings.append(
                    Finding(
                        "HS803",
                        facts.rel_path,
                        node.lineno,
                        f"loop in {key[2]}() encloses a collective "
                        f"({', '.join(sorted(body_sites)[:3])}) but "
                        "iterates over process-local data — iteration "
                        "counts diverge across processes; derive the "
                        "bound from an allgathered/global value",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# Collective-witness cross-check (``hslint --witness``)
# ---------------------------------------------------------------------------


def load_collective_witness(path: str) -> List[dict]:
    """Per-process witness documents for a prefix (``<path>.p<i>.json``
    as written by ``testing/collective_witness.dump``) or a single
    artifact file; ValueError on a malformed or absent artifact (the
    CLI maps that to a usage error — a corrupt artifact must never pass
    as 'zero divergence')."""
    if os.path.isfile(path):
        paths = [path]
    else:
        paths = sorted(_glob.glob(f"{path}.p*.json"))
        if not paths:
            raise ValueError(
                f"no collective witness artifacts at {path} "
                f"(expected {path}.p<i>.json)"
            )
    docs = []
    for p in paths:
        with open(p, "r", encoding="utf-8") as f:
            doc = json.load(f)
        _validate_witness(doc, p)
        docs.append(doc)
    docs.sort(key=lambda d: d["process"])
    if len({d["process"] for d in docs}) != len(docs):
        raise ValueError(f"duplicate process indexes in artifacts at {path}")
    return docs


def _validate_witness(doc, path: str) -> None:
    if (
        not isinstance(doc, dict)
        or not isinstance(doc.get("process"), int)
        or not isinstance(doc.get("sequence"), list)
    ):
        raise ValueError(f"not a collective-witness artifact: {path}")
    for r in doc["sequence"]:
        if (
            not isinstance(r, dict)
            or not isinstance(r.get("site"), str)
            or not isinstance(r.get("op"), str)
            or not isinstance(r.get("wave"), int)
        ):
            raise ValueError(f"malformed witness 'sequence' record: {path}")
    if not isinstance(doc.get("registered", {}), dict):
        raise ValueError(f"malformed witness 'registered' map: {path}")


def collective_cross_check(
    projects: List[Project], docs: List[dict], artifact: str
) -> Tuple[List[Finding], List[str]]:
    """(divergence findings, staleness warnings) of per-process witness
    artifacts against the COLLECTIVE_SITES registry — the UNION over
    ``projects`` when several package dirs are analyzed.

    Hard HS804 errors: a witnessed site the registry lacks; a
    coordinator-gated site witnessed on a non-coordinator process; any
    cross-process divergence of the (coordinator-gated-filtered)
    collective sequences — length, site/op/wave order, or payload
    signature where the contract is ``symmetric-all``. A registered site
    never witnessed by any process is a staleness warning only — the
    dryrun may simply not have driven that path this run."""
    registry: Dict[str, str] = {}
    for project in projects:
        entries, _rel = parse_sites(project)
        for e in entries:
            if e.contract in CONTRACTS:
                registry[e.path] = e.contract
    findings: List[Finding] = []
    warnings: List[str] = []

    seen_unregistered: Set[str] = set()
    seen_gated: Set[Tuple[str, int]] = set()
    seen_drift: Set[str] = set()
    witnessed: Set[str] = set()
    for doc in docs:
        pid = doc["process"]
        for r in doc["sequence"]:
            site = r["site"]
            witnessed.add(site)
            contract = registry.get(site)
            if contract is None:
                if site not in seen_unregistered:
                    seen_unregistered.add(site)
                    findings.append(
                        Finding(
                            "HS804",
                            artifact,
                            1,
                            f"witnessed collective site {site!r} is not "
                            "in COLLECTIVE_SITES — a collective ran that "
                            "the registry (and every HS80x verdict) "
                            "cannot see",
                        )
                    )
            elif contract != r.get("contract", contract):
                if site not in seen_drift:
                    seen_drift.add(site)
                    warnings.append(
                        f"contract drift for {site}: registry says "
                        f"{contract!r}, artifact recorded "
                        f"{r.get('contract')!r} — re-record the witness"
                    )
            if contract == "coordinator-gated" and pid != 0:
                if (site, pid) not in seen_gated:
                    seen_gated.add((site, pid))
                    findings.append(
                        Finding(
                            "HS804",
                            artifact,
                            1,
                            f"coordinator-gated site {site!r} was "
                            f"witnessed on process {pid} — the "
                            "single-writer contract is violated",
                        )
                    )

    def filtered(doc: dict) -> List[dict]:
        return [
            r
            for r in doc["sequence"]
            if registry.get(r["site"]) != "coordinator-gated"
        ]

    if len(docs) > 1:
        base = filtered(docs[0])
        base_pid = docs[0]["process"]
        for doc in docs[1:]:
            seq = filtered(doc)
            pid = doc["process"]
            n = min(len(base), len(seq))
            divergence = None
            for i in range(n):
                a, b = base[i], seq[i]
                if (a["site"], a["op"], a["wave"]) != (
                    b["site"],
                    b["op"],
                    b["wave"],
                ):
                    divergence = (
                        i,
                        f"process {base_pid} issued {a['site']} "
                        f"(wave {a['wave']}) where process {pid} issued "
                        f"{b['site']} (wave {b['wave']})",
                    )
                    break
                if registry.get(a["site"]) == "symmetric-all" and a.get(
                    "sig"
                ) != b.get("sig"):
                    divergence = (
                        i,
                        f"payload signatures differ at symmetric-all "
                        f"site {a['site']}: {a.get('sig')} vs "
                        f"{b.get('sig')}",
                    )
                    break
            if divergence is None and len(base) != len(seq):
                divergence = (
                    n,
                    f"process {base_pid} recorded {len(base)} "
                    f"collectives, process {pid} recorded {len(seq)} — "
                    "some processes issued collectives others never "
                    "reached",
                )
            if divergence is not None:
                idx, detail = divergence
                findings.append(
                    Finding(
                        "HS804",
                        artifact,
                        1,
                        f"cross-process collective sequence divergence "
                        f"at position {idx}: {detail}",
                    )
                )
    for site in sorted(registry):
        if site not in witnessed:
            warnings.append(
                f"registered collective site never witnessed: {site} — "
                "stale registry or an unexercised dryrun path"
            )
    return findings, warnings
