"""HS2xx — operation-log state-machine conformance.

The index lifecycle is a state machine defined once, in
``constants.States`` (the states, the stable subset, and the ROLLBACK
map from each transient state to the stable state it recovers to — the
machine ``metadata/entry.py``'s ``LogEntry.state`` field ranges over).
Every Action in ``actions/*`` declares its edges as class attributes:
``begin()`` writes ``transient_state``, commit writes ``final_state``,
and ``required_state`` (where present) is the stable state the action
validates against before beginning.

Legal edges, derived statically from the States class:

* begin:   ROLLBACK[T] -> T   — so T must be a ROLLBACK key, or a crash
  mid-action leaves the index in a state ``cancel()`` cannot recover
  (HS201: unguarded transient);
* commit:  T -> F with F in STABLE_STATES (HS202);
* every state name referenced in actions/ or metadata/ must be a
  member of States (HS203 — catches typos that would otherwise become
  permanently wedged log entries);
* where an action declares ``required_state``, it must equal
  ROLLBACK[transient_state]: validating against any other state makes
  the begin edge illegal (HS204);
* a ROLLBACK key no action uses as its transient state is dead machine
  surface (HS205) — either a missing action or a stale state;
* every ROLLBACK edge must LAND on a stable state (HS206): the rollback
  edges are exactly what crash recovery (``metadata/recovery.py``) and
  ``cancel()`` traverse, and an edge into another transient state would
  make "recover" mean "strand differently".
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from hyperspace_tpu_torch.analysis.core import Finding, Project, const_str

RULES = {
    "HS201": "action transient state has no ROLLBACK edge (cancel cannot recover)",
    "HS202": "action final state is not a stable state",
    "HS203": "unknown state name referenced in a transition site",
    "HS204": "required_state does not match the transient state's ROLLBACK source",
    "HS205": "transient state defined in ROLLBACK but used by no action",
    "HS206": "ROLLBACK edge lands on a non-stable state (recovery would strand)",
}


class StateMachine:
    def __init__(self):
        self.states: Dict[str, str] = {}  # attr name -> string value
        self.stable: Set[str] = set()  # attr names
        self.rollback: Dict[str, str] = {}  # transient attr -> stable attr


def _extract_machine(project: Project) -> Optional[Tuple[StateMachine, str]]:
    sf = project.file("constants.py")
    if sf is None or sf.tree is None:
        return None
    cls = next(
        (
            n
            for n in ast.walk(sf.tree)
            if isinstance(n, ast.ClassDef) and n.name == "States"
        ),
        None,
    )
    if cls is None:
        return None
    m = StateMachine()
    for node in cls.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        if (val := const_str(node.value)) is not None:
            m.states[target.id] = val
        elif target.id == "STABLE_STATES":
            for n in ast.walk(node.value):
                if isinstance(n, ast.Name) and n.id in m.states:
                    m.stable.add(n.id)
        elif target.id == "ROLLBACK" and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Name) and isinstance(v, ast.Name):
                    m.rollback[k.id] = v.id
    return m, sf.rel_path


def _state_attr(node: ast.AST) -> Optional[Tuple[str, int]]:
    """('CREATING', line) for a ``States.CREATING`` attribute node."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "States"
    ):
        return node.attr, node.lineno
    return None


def check(project: Project) -> List[Finding]:
    got = _extract_machine(project)
    action_files = project.files_under("actions")
    if got is None or not action_files:
        return []
    machine, constants_path = got
    findings: List[Finding] = []
    used_transients: Set[str] = set()

    for _rel, sf in action_files + project.files_under("metadata"):
        if sf.tree is None:
            continue
        # HS203 over every States.X reference in the file
        for node in ast.walk(sf.tree):
            ref = _state_attr(node)
            if ref is None:
                continue
            name, line = ref
            if name not in machine.states and name not in (
                "STABLE_STATES",
                "ROLLBACK",
            ):
                findings.append(
                    Finding(
                        "HS203",
                        sf.rel_path,
                        line,
                        f"States.{name} is not a defined lifecycle state",
                    )
                )
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs: Dict[str, Tuple[Optional[str], int]] = {}
            for node in cls.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    t = node.targets[0]
                    if isinstance(t, ast.Name) and t.id in (
                        "transient_state",
                        "final_state",
                        "required_state",
                    ):
                        ref = _state_attr(node.value)
                        if ref is not None:
                            attrs[t.id] = (ref[0], ref[1])
                        elif const_str(node.value) == "":
                            attrs[t.id] = (None, node.lineno)
            transient = attrs.get("transient_state")
            final = attrs.get("final_state")
            required = attrs.get("required_state")
            if transient and transient[0] is not None:
                used_transients.add(transient[0])
                if transient[0] not in machine.rollback:
                    findings.append(
                        Finding(
                            "HS201",
                            sf.rel_path,
                            transient[1],
                            f"{cls.name}: transient state "
                            f"States.{transient[0]} has no ROLLBACK edge — a "
                            "crash mid-action cannot be cancel()ed",
                        )
                    )
            if final and final[0] is not None and final[0] not in machine.stable:
                findings.append(
                    Finding(
                        "HS202",
                        sf.rel_path,
                        final[1],
                        f"{cls.name}: final state States.{final[0]} is not in "
                        "STABLE_STATES — the commit edge leaves the log "
                        "unstable",
                    )
                )
            if (
                required
                and required[0] is not None
                and transient
                and transient[0] is not None
                and machine.rollback.get(transient[0]) is not None
                and machine.rollback[transient[0]] != required[0]
            ):
                findings.append(
                    Finding(
                        "HS204",
                        sf.rel_path,
                        required[1],
                        f"{cls.name}: requires States.{required[0]} but "
                        f"States.{transient[0]} rolls back to "
                        f"States.{machine.rollback[transient[0]]} — begin "
                        "edge and rollback edge disagree",
                    )
                )
    for t in sorted(machine.rollback):
        if t not in used_transients:
            findings.append(
                Finding(
                    "HS205",
                    constants_path,
                    1,
                    f"ROLLBACK defines transient state {t} but no Action "
                    "uses it (unreachable state)",
                )
            )
        if machine.rollback[t] not in machine.stable:
            findings.append(
                Finding(
                    "HS206",
                    constants_path,
                    1,
                    f"ROLLBACK edge {t} -> {machine.rollback[t]} lands on "
                    "a non-stable state — crash recovery and cancel() "
                    "walk these edges and must terminate on a stable "
                    "state",
                )
            )
    return findings
