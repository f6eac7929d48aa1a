"""Advisor CLI — ``python -m hyperspace_tpu_torch.advisor <subcommand>``.

Subcommands:

``report``      profile a query-log directory (no session needed) and
                print the hot-shape table or JSON.
``recommend``   build a session, mine the log, run the what-if scorer,
                print ranked recommendations; ``--apply`` executes them
                under the byte/time budget (typing ``--apply`` IS the
                opt-in — it forces past ``advisor.apply.enabled``).
``replay``      re-run a recorded workload through the serve frontend
                and print the latency/QPS summary.

Counterpart of ``hyperspace_tpu/advisor/cli.py``. Sessions are built
fresh per invocation, on ``--device`` (default: the card; without a CUDA
device the session subcommands raise unless given ``--device cpu``, the
rule of ``session.resolve_device``): ``--system-path`` sets
``hyperspace.system.path``; repeated ``--conf key=value`` pairs set
anything else (values parsed as JSON when possible, else kept as
strings — so ``--conf hyperspace.serve.maxWorkers=8`` is an int).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from hyperspace_tpu_torch import constants as C


def _build_session(args):
    from hyperspace_tpu_torch.session import HyperspaceSession

    session = HyperspaceSession(device=getattr(args, "device", None))
    if getattr(args, "system_path", None):
        session.conf.set(C.INDEX_SYSTEM_PATH, args.system_path)
    for pair in getattr(args, "conf", None) or []:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise SystemExit(f"--conf expects key=value, got {pair!r}")
        try:
            value = json.loads(raw)
        except ValueError:
            value = raw
        session.conf.set(key, value)
    return session


def _log_dir(args, session=None) -> str:
    if getattr(args, "log_dir", None):
        return args.log_dir
    if session is not None:
        from hyperspace_tpu_torch.obs import querylog as _querylog

        return _querylog.obs_root(session.conf)
    raise SystemExit("--log-dir is required (no session to derive it from)")


def _cmd_report(args) -> int:
    from hyperspace_tpu_torch.advisor import profile as _profile

    prof = _profile.profile_directory(
        _log_dir(args), max_shapes=args.max_shapes
    )
    if args.json:
        print(json.dumps(prof.to_dict(top=args.top), indent=2))
        return 0
    print(
        f"records={prof.records} failed={prof.failed} "
        f"shapes={len(prof.shapes)} total_s={prof.total_s:.3f} "
        f"overflow={prof.overflow_records}"
    )
    for s in prof.hot_shapes(args.top):
        print(
            f"  {s.count:6d}x  total={s.total_s:8.3f}s  p50={s.p50_s:.4f}s "
            f"fail={s.failed} degrade={s.degrades} retry={s.retries} "
            f"replay={'y' if s.replay else 'n'}  {s.shape[:100]}"
        )
    return 0


def _cmd_recommend(args) -> int:
    from hyperspace_tpu_torch.advisor import recommend as _recommend

    session = _build_session(args)
    report = _recommend.advise(
        session,
        directory=_log_dir(args, session),
        max_candidates=args.max_candidates,
    )
    if args.json and not args.apply:
        print(json.dumps(report.to_dict(top=args.top), indent=2))
        return 0
    recs = report.recommendations
    print(
        f"scored {report.candidates_scored} candidates "
        f"({report.candidates_skipped} skipped) over "
        f"{report.shapes_with_plans} replayable shapes -> "
        f"{len(recs)} recommendations"
    )
    for r in recs[: args.top]:
        cols = ",".join(r.indexed_columns)
        print(
            f"  [{r.kind:8s}] {r.index_name:16s} {r.index_kind:20s} "
            f"on ({cols})  benefit~{r.estimated_benefit_s:.3f}s "
            f"build~{r.estimated_build_bytes >> 20}MiB  {r.reason}"
        )
    if args.apply and recs:
        from hyperspace_tpu_torch.advisor import apply as _apply

        summary = _apply.apply_recommendations(
            session,
            recs,
            max_bytes=args.max_bytes,
            max_seconds=args.max_seconds,
            force=True,
        )
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print(
                f"applied={summary['applied']} failed={summary['failed']} "
                f"skipped={summary['skipped']} "
                f"spent={summary['spent_bytes'] >> 20}MiB "
                f"elapsed={summary['elapsed_s']:.1f}s"
            )
    return 0


def _cmd_replay(args) -> int:
    from hyperspace_tpu_torch.obs import querylog as _querylog
    from hyperspace_tpu_torch.testing import replay as _replay

    session = _build_session(args)
    records = _querylog.read_valid_records(_log_dir(args, session))
    result = _replay.replay_records(
        session,
        records,
        preserve_timing=args.preserve_timing,
        speedup=args.speedup,
        use_slo_classes=not args.no_slo,
        max_inflight=args.max_inflight,
    )
    print(json.dumps(result.to_dict(), indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.advisor",
        description="Hyperspace workload advisor (docs/advisor.md)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, session: bool) -> None:
        p.add_argument("--log-dir", help="query-log directory (default: "
                       "<system.path>/_hyperspace_obs)")
        p.add_argument("--top", type=int, default=10)
        p.add_argument("--json", action="store_true")
        if session:
            p.add_argument("--system-path", help="hyperspace.system.path")
            p.add_argument("--device", default=None,
                           help="the session's device (default: cuda; "
                           "'cpu' runs on the CPU)")
            p.add_argument("--conf", action="append", metavar="KEY=VALUE",
                           help="extra session config (repeatable)")

    p = sub.add_parser("report", help="profile a query-log directory")
    common(p, session=False)
    p.add_argument("--max-shapes", type=int,
                   default=C.ADVISOR_PROFILE_MAX_SHAPES_DEFAULT)
    p.set_defaults(func=_cmd_report)

    p = sub.add_parser("recommend", help="what-if index recommendations")
    common(p, session=True)
    p.add_argument("--max-candidates", type=int, default=None)
    p.add_argument("--apply", action="store_true",
                   help="execute recommendations under the budget")
    p.add_argument("--max-bytes", type=int, default=None,
                   help="apply byte budget (default: conf)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="apply time budget (default: conf)")
    p.set_defaults(func=_cmd_recommend)

    p = sub.add_parser("replay", help="replay a recorded workload")
    common(p, session=True)
    p.add_argument("--preserve-timing", action="store_true",
                   help="honor recorded inter-arrival gaps")
    p.add_argument("--speedup", type=float, default=1.0)
    p.add_argument("--max-inflight", type=int, default=1)
    p.add_argument("--no-slo", action="store_true",
                   help="ignore recorded slo_class on submit")
    p.set_defaults(func=_cmd_replay)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
