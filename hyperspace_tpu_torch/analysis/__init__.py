"""hslint — repo-native static analysis for hyperspace_tpu_torch.

Counterpart of ``hyperspace_tpu/analysis/``: the same ten checkers and
rule ids (``docs/static-analysis.md``), pure stdlib ``ast``. Seven carry
over unchanged; three speak the port's vocabulary:

* :mod:`kernel_parity` (HS1xx) — every ``extern "C"`` export of
  ``csrc/*.cu`` belongs to a kernel of the ``KERNEL_TWINS`` registry
  (``ops/__init__.py``) whose wrapper and plain torch twin resolve, and
  ``tests/test_torch_cuda.py`` holds it on the card;
* :mod:`log_state` (HS2xx) — every Action's begin/commit edges are
  legal transitions of the operation-log state machine;
* :mod:`purity` (HS3xx) — no numpy and no host syncs inside functions
  compiled by ``torch.compile`` / ``torch.jit.script`` (the port compiles
  none today, so it finds nothing);
* :mod:`except_policy` (HS4xx) — no bare/overbroad excepts that can
  mask a kernel's fault (C.7) or the OCC contracts;
* :mod:`locks` (HS5xx) — no lock-order cycles, no I/O under a lock;
* :mod:`shared_state` (HS6xx) — every mutable global a thread pool can
  reach is registered in ``SHARED_STATE`` (``concurrency.py``) and
  accessed per its declared lock/policy; ``--witness`` cross-checks the
  static lock model against a runtime witness artifact;
* :mod:`contracts` (HS7xx) — config keys have constants defaults and
  ``docs/CONFIG.md`` rows, fault points are matrix-tested, dead keys
  are flagged, collective sites are driven by the multi-process dryrun
  (``scripts/torch_dryrun_multihost.py`` for the port);
* :mod:`spmd` (HS8xx) — every ``torch.distributed`` collective (and the
  in-process block exchange between the shards of one mesh) declares
  its symmetry contract in ``COLLECTIVE_SITES``
  (``parallel/collectives.py``), process-identity branches and
  process-local loop bounds cannot make processes issue diverging
  collective programs, and ``--witness`` cross-checks the per-process
  runtime collective sequences recorded by
  ``testing/collective_witness.py``;
* :mod:`obs` (HS9xx) — every span/metric instrumentation site is
  declared in ``OBS_SITES`` (``obs/sites.py``) with a justification,
  constant span/stage names stay inside the declared breakdown-key
  vocabulary, and stale registry entries are flagged;
* :mod:`residency` (HS10xx) — every row-proportional hot-path
  materialization is declared in ``ALLOC_SITES`` (``memory.py``) with
  a plane and a structurally-enforced bound class, and ``--witness``
  cross-checks the per-site peak bytes recorded by
  ``testing/residency_witness.py`` against the declared bounds.

Run it: ``python -m hyperspace_tpu_torch.analysis [package_dir]`` (the
port by default) — exits nonzero when any unsuppressed finding remains.
Suppress a finding with ``# hslint: disable=<RULE>`` on (or directly
above) the flagged line, with a justification comment.

The analyzer is pure stdlib ``ast`` — importing this package imports
neither torch nor numpy, and the checked code is never executed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from hyperspace_tpu_torch.analysis import (
    contracts,
    except_policy,
    kernel_parity,
    locks,
    log_state,
    obs,
    purity,
    residency,
    shared_state,
    spmd,
)
from hyperspace_tpu_torch.analysis.core import FINDING_FIELDS, Finding, Project

__all__ = [
    "Finding",
    "Project",
    "ALL_RULES",
    "CHECKERS",
    "FINDING_FIELDS",
    "run_analysis",
]

CHECKERS = (
    kernel_parity,
    log_state,
    purity,
    except_policy,
    locks,
    shared_state,
    contracts,
    spmd,
    obs,
    residency,
)

#: rule id -> one-line description; HS001 is the analyzer's own
#: parse-failure rule.
ALL_RULES: Dict[str, str] = {"HS001": "file does not parse"}
for _mod in CHECKERS:
    ALL_RULES.update(_mod.RULES)


def run_analysis(
    package_dir: str,
    tests_dir: Optional[str] = None,
    project: Optional[Project] = None,
) -> List[Finding]:
    """All findings (suppressed ones included, marked) for the package at
    ``package_dir``, sorted by (path, line, rule). Pass a prebuilt
    ``project`` to share the parsed tree with other passes (the CLI's
    ``--witness`` cross-check reuses it)."""
    if project is None:
        project = Project(package_dir, tests_dir=tests_dir)
    findings: List[Finding] = list(project.findings)
    for checker in CHECKERS:
        findings.extend(checker.check(project))
    by_display = {sf.rel_path: sf for sf in project.files.values()}
    for f in findings:
        sf = by_display.get(f.path)
        if sf is not None and sf.is_suppressed(f.rule, f.line):
            f.suppressed = True
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings
