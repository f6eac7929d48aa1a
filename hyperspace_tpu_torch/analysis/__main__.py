"""CLI entry point: ``python -m hyperspace_tpu_torch.analysis [package_dir ...]``.

Exit status: 0 when every finding is suppressed (or there are none),
1 when unsuppressed findings remain, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from hyperspace_tpu_torch.analysis import ALL_RULES, run_analysis


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.analysis",
        description="hslint: repo-native static analysis for hyperspace_tpu_torch",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=None,
        help="package directories to analyze (default: hyperspace_tpu_torch "
        "next to the installed package)",
    )
    parser.add_argument(
        "--tests-dir",
        default=None,
        help="tests directory for the kernel-parity checker "
        "(default: sibling tests/ of the package)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format",
    )
    parser.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print suppressed findings",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the ruleset and exit"
    )
    parser.add_argument(
        "--witness",
        metavar="ARTIFACT",
        action="append",
        default=None,
        help="cross-check a runtime witness artifact against the static "
        "model (repeatable). A lock-witness JSON "
        "(testing/lock_witness.py) checks the lock model: witnessed "
        "edges/locks absent from it are hard HS604 errors. A "
        "residency-witness JSON (testing/residency_witness.py) checks "
        "the allocation-bound model: a witnessed site absent from "
        "ALLOC_SITES, or a per-site peak past its declared bound-class "
        "ceiling, is a hard HS1004 error. A "
        "collective-witness prefix (testing/collective_witness.py; "
        "per-process <prefix>.p<i>.json files) merges the per-process "
        "collective sequences: any cross-process divergence or "
        "unregistered witnessed site is a hard HS804 error. Static "
        "edges / registered sites never witnessed print as warnings",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(ALL_RULES):
            print(f"{rule}  {ALL_RULES[rule]}")
        return 0

    paths = args.paths or [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ]
    for p in paths:
        if not os.path.isdir(p):
            print(f"error: not a directory: {p}", file=sys.stderr)
            return 2

    from hyperspace_tpu_torch.analysis.core import Project

    projects = [Project(p, tests_dir=args.tests_dir) for p in paths]
    all_findings = []
    for p, project in zip(paths, projects):
        all_findings.extend(
            run_analysis(p, tests_dir=args.tests_dir, project=project)
        )

    for witness in args.witness or ():
        # ONE cross-check per artifact against the union of the analyzed
        # packages' models: an artifact records every wrapped lock /
        # registered site in its process, so a per-package comparison
        # would call each package's surface "unknown" to the other.
        # Artifact kind is sniffed from its content: a lock witness is a
        # single JSON file with a "locks" map; a residency witness one
        # with a "sites" map; a collective witness is a per-process
        # <prefix>.p<i>.json family (or one such file).
        from hyperspace_tpu_torch.analysis import residency, shared_state, spmd

        try:
            doc = None
            if os.path.isfile(witness):
                import json as _json

                with open(witness, "r", encoding="utf-8") as f:
                    doc = _json.load(f)
            if isinstance(doc, dict) and "locks" in doc:
                lock_doc = shared_state.load_witness(witness, doc=doc)
                gaps, warnings = shared_state.witness_cross_check(
                    projects, lock_doc, os.path.basename(witness)
                )
            elif isinstance(doc, dict) and "sites" in doc:
                res_doc = residency.load_witness(witness, doc=doc)
                gaps, warnings = residency.witness_cross_check(
                    projects, res_doc, os.path.basename(witness)
                )
            else:
                docs = spmd.load_collective_witness(witness)
                gaps, warnings = spmd.collective_cross_check(
                    projects, docs, os.path.basename(witness)
                )
        except (OSError, ValueError) as exc:
            print(f"error: bad witness artifact: {exc}", file=sys.stderr)
            return 2
        all_findings.extend(gaps)
        for w in warnings:
            print(f"hslint: warning: {w}", file=sys.stderr)

    active = [f for f in all_findings if not f.suppressed]
    suppressed = [f for f in all_findings if f.suppressed]
    if args.format == "json":
        shown = all_findings if args.show_suppressed else active
        print(json.dumps([f.to_dict() for f in shown], indent=2))
    else:
        for f in active:
            print(f.render())
        if args.show_suppressed:
            for f in suppressed:
                print(f.render())
        print(
            f"hslint: {len(active)} finding(s), "
            f"{len(suppressed)} suppressed, "
            f"{len(ALL_RULES)} rules, {len(paths)} package(s)"
        )
    return 1 if active else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # Downstream pager/head closed the pipe mid-print. The gate's
        # verdict is unknown at this point, so exit with the conventional
        # SIGPIPE status (128+13) — never 0, or `hslint.sh | head` under
        # pipefail could wave a failing tree through.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(141)
