"""HS4xx — exception-handling policy.

The kernel wrappers speak in typed faults (``kernels.KERNEL_FAULTS``:
a refused build, a CUDA error code), and the operation-log commit path
speaks in typed exceptions (``ConcurrentWriteException``,
``NoChangesException``). A bare ``except:`` (HS401) or an ``except
Exception`` that swallows instead of re-raising (HS402) can mask both
contracts: a kernel's fault becomes a silently unrewritten plan (ROADMAP
C.7), a lost OCC race looks like success, and
``KeyboardInterrupt``/``SystemExit`` get eaten mid-commit.

The rules, package-wide:

* HS401: ``except:`` with no exception type — always flagged;
* HS402: ``except Exception`` / ``except BaseException`` whose handler
  does not re-raise (a bare ``raise`` anywhere in the handler makes it
  a log-and-propagate pattern, which is fine).

Deliberate catch-alls (a plan-rewrite fallback that must never break a
query, version-dependent library probing) stay — suppressed with
``# hslint: disable=HS402`` and a one-line justification.
"""

from __future__ import annotations

import ast
from typing import List

from hyperspace_tpu_torch.analysis.core import Finding, Project, dotted_name

RULES = {
    "HS401": "bare except: masks rc-code and OCC contracts",
    "HS402": "except Exception without re-raise swallows unrelated failures",
}

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names = []
    if t is None:
        return False  # bare except, handled as HS401
    if isinstance(t, ast.Tuple):
        names = [dotted_name(e) for e in t.elts]
    else:
        names = [dotted_name(t)]
    return any(n and n.split(".")[-1] in _BROAD for n in names)


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for _rel, sf in sorted(project.files.items()):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(
                    Finding(
                        "HS401",
                        sf.rel_path,
                        node.lineno,
                        "bare except: catches SystemExit/KeyboardInterrupt "
                        "and masks typed contracts — name the exceptions",
                    )
                )
            elif _is_broad(node) and not _reraises(node):
                findings.append(
                    Finding(
                        "HS402",
                        sf.rel_path,
                        node.lineno,
                        "except Exception without re-raise — type the "
                        "handler, or suppress with a justification if the "
                        "catch-all is the contract",
                    )
                )
    return findings
