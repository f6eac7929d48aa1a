"""OBS_SITES — the registry of observability instrumentation sites.

The SHARED_STATE / KERNEL_TWINS / COLLECTIVE_SITES doctrine applied to
the observability plane: every call site that CREATES spans
(``trace.root`` / ``trace.span`` / ``trace.stage``) or REGISTERS
metrics (``registry.counter`` / ``gauge`` / ``labeled_counter`` /
``stage_timer`` / ``register_view`` / ``register_weak_view``) declares
itself HERE with a
one-line justification — so "what is instrumented, and why?" is a
mechanical question (``hslint`` HS9xx, ``analysis/obs.py``), not an
archaeology project, and a hot loop cannot silently grow a span per
row. Propagation shims (``trace.carry``/``activate``) and point events
(``trace.event``) are deliberately exempt: they create no spans.

Entry shape::

    "<dotted path of the function, method, or module>": (
        "<kind: span | metric | view>",
        "<one-line justification — why this site is instrumented>",
    )

Paths name a module-level function
(``hyperspace_tpu_torch.execution.join_exec._stage_add``), a method
(``hyperspace_tpu_torch.actions.base.Action.run``), or a whole module
(``hyperspace_tpu_torch.testing.replay`` — module-level instrument
registration). The serve tier's and the advisor's sites come with those
modules (ROADMAP A.10b, A.10c); their stage names are in the vocabulary
already. Calls in nested defs/lambdas attribute to
their outermost enclosing def, like the collective registry.

Stage-span VOCABULARY: HS902 rejects any constant stage/span name that
is not listed below — stage spans exist to mirror the legacy breakdown
keys, and a misspelled span name would silently fork the taxonomy the
querylog, the bench gates and docs/observability.md all key on.

Keep this module stdlib-only and import-cheap: the analyzer only ever
parses it, and the obs plane imports it for the vocabulary.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: site kinds (HS903 rejects anything else)
KINDS = ("span", "metric", "view")

#: serve-side stage spans — the last_serve_breakdown keys plus the
#: frontend's admission stages (docs/observability.md "Span taxonomy")
SERVE_STAGES = (
    "queue_wait",
    "pin",
    "rewrite",
    "prune",
    "scan",
    "prepare",
    "match",
    "expand",
    "verify",
    "assemble",
    "delta",
    "agg",
    "finalize",
    "execute",
    # out-of-core serve (docs/out-of-core.md): one span per streaming
    # join wave, and the spill tier's demote/restore I/O
    "stream_wave",
    "spill_write",
    "spill_restore",
    # the port's join stage of the pairs' copy to the host
    # (execution/join_exec._pairs_to_host)
    "to_host",
)

#: build/lifecycle stage spans — the last_build_breakdown keys plus the
#: shuffle stage seconds and the metadata-plane seams
BUILD_STAGES = (
    "scan",
    "hash_shuffle",
    "pack",
    "exchange",
    "unpack",
    "sort",
    "write",
    "sidecar_capture",
    "log_commit",
    # the port's build breakdown keys beyond the reference's vocabulary:
    # the zone-map capture, the z-order build, the out-of-core waves and
    # the data-skipping sketches (session.build_stats)
    "zonemap_capture",
    "z_address",
    "stats",
    "spill",
    "merge",
    "sketch_read",
    "sketch",
)

#: advisor-side stage spans (advisor/: query-log mining and what-if
#: scoring under one "advisor.run" root — docs/advisor.md)
ADVISOR_STAGES = (
    "advisor.scan",
    "advisor.score",
)

#: root span names (constant ones; action roots are "action.<Class>")
ROOT_NAMES = ("serve.query", "advisor.run")

#: the full constant-name vocabulary HS902 checks against
STAGE_NAMES = tuple(
    sorted(set(SERVE_STAGES) | set(BUILD_STAGES) | set(ADVISOR_STAGES))
)

OBS_SITES: Dict[str, Tuple[str, str]] = {
    # -- serve plane ---------------------------------------------------------
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache.__init__": (
        "view",
        "the memory governor's stats() export live through the registry "
        "(one owner, one lock)",
    ),
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache._spill_demote": (
        "span",
        "spill_write is pickle + fsync'd publish outside every breakdown "
        "stage; serve time under memory pressure must be attributable to "
        "the spill tier",
    ),
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache._restore_from_spill": (
        "span",
        "spill_restore shows the cost of serving from the disk tier next "
        "to the scan/prepare stages it displaces",
    ),
    "hyperspace_tpu_torch.session.HyperspaceSession.__init__": (
        "metric",
        "hs_serve_stage_seconds / hs_build_stage_seconds read the newest "
        "session's join_stats / build_stats: the breakdowns live on the "
        "session, so the instruments read them and keep no copy",
    ),
    "hyperspace_tpu_torch.execution.join_exec._stage_add": (
        "span",
        "the ONE serve stage hook: the stage span and the breakdown "
        "increment are the same measurement, so they cannot disagree",
    ),
    "hyperspace_tpu_torch.execution.executor._exec": (
        "span",
        "the agg stage (metadata plane, fused pass, interpreted chain) is "
        "invisible to the join breakdown; its span closes the taxonomy",
    ),
    # -- build / lifecycle plane ---------------------------------------------
    "hyperspace_tpu_torch.indexes.covering_build._stage_add": (
        "span",
        "the ONE build stage hook, mirroring the serve-side discipline",
    ),
    "hyperspace_tpu_torch.parallel.shuffle._publish_stats": (
        "span",
        "pack/exchange/unpack stage spans from the exchange's own measured "
        "seconds",
    ),
    "hyperspace_tpu_torch.actions.create.capture_sidecars": (
        "span",
        "zonemap and sidecar captures are build-tail I/O and kernel work "
        "outside the data stages; their spans carry build_stats' seconds",
    ),
    "hyperspace_tpu_torch.actions.base.Action.run": (
        "span",
        "the lifecycle-action ROOT span: every action is explainable after "
        "the fact, whatever the outcome",
    ),
    "hyperspace_tpu_torch.actions.base.Action._run_protocol": (
        "span",
        "log_commit stage: metadata-plane publish time separable from the "
        "data-plane op() time",
    ),
    "hyperspace_tpu_torch.actions.base.Action._run_coordinated": (
        "span",
        "the coordinator-side log_commit stage on multi-process jobs",
    ),
    # -- harnesses -----------------------------------------------------------
    "hyperspace_tpu_torch.testing.replay": (
        "metric",
        "replay harness instruments (queries replayed/skipped/failed) in "
        "the same plane as the querylog counters",
    ),
}
