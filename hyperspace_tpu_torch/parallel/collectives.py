"""COLLECTIVE_SITES — the registry of cross-process collective call sites.

Counterpart of ``hyperspace_tpu/parallel/collectives.py``, naming the
port's own sites. Every collective or cross-process barrier of the port
declares its symmetry contract here, so "does every process issue the
same collectives?" can be asked of one table.

Entry shape::

    "<dotted path of the module-level callable>": (
        "<collective it issues (all_to_all_single, all_gather, ...)>",
        "<contract>",
        "<one-line justification: why the contract holds>",
    )

Contracts:

``symmetric-all``
    Every process issues the call at the same position in its collective
    sequence with the same payload signature.
``per-host-lane``
    Every process issues the call at the same position, but the payload
    is that process's own data (its rows, its count matrix, its verdict),
    so signatures may differ across processes.
``coordinator-gated``
    Only the coordinator (rank 0) issues the call: the metadata plane's
    single-writer seams.

Stdlib only and cheap to import.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: the known symmetry contracts
CONTRACTS = ("symmetric-all", "per-host-lane", "coordinator-gated")

COLLECTIVE_SITES: Dict[str, Tuple[str, str, str]] = {
    # -- bootstrap ------------------------------------------------------------
    "hyperspace_tpu_torch.parallel.mesh.initialize_distributed": (
        "init_process_group",
        "per-host-lane",
        "every process joins the one torch.distributed group at the same "
        "step with its own rank; the init method, world size and backend "
        "agree, and a second call is a no-op everywhere",
    ),
    # -- exchange strategies (parallel/shuffle.py) ----------------------------
    "hyperspace_tpu_torch.parallel.shuffle._flat_exchange": (
        "block copy",
        "symmetric-all",
        "one process drives every shard: cap and the payload structure come "
        "from global inputs (never reached on a multi-process job: "
        "resolve_strategy takes twostage there)",
    ),
    "hyperspace_tpu_torch.parallel.shuffle._compact_exchange": (
        "block copy",
        "symmetric-all",
        "one process drives every shard over host-packed exact extents "
        "(never reached on a multi-process job)",
    ),
    "hyperspace_tpu_torch.parallel.shuffle._twostage_exchange": (
        "block copy",
        "symmetric-all",
        "one process carves its mesh into simulated hosts; per-round caps "
        "come from the global count matrix (a multi-process job takes "
        "_twostage_exchange_mp)",
    ),
    "hyperspace_tpu_torch.parallel.shuffle._twostage_exchange_mp": (
        "all_gather + all_to_all_single",
        "per-host-lane",
        "each process contributes its own [P, L] send-count matrix to the "
        "all_gather at the same position, whose result sizes every split "
        "of the all_to_all_singles that follow, one a payload, on every "
        "process, zero-row stripes included",
    ),
    # -- build metadata plane (indexes/covering_build.py) ---------------------
    "hyperspace_tpu_torch.indexes.covering_build._global_written": (
        "barrier",
        "per-host-lane",
        "every process reaches the post-write barrier with its own written "
        "files and returns the same listing of the data directory; reached "
        "from every write_bucketed exit, zero-row stripes included",
    ),
    # -- action protocol (actions/base.py) ------------------------------------
    "hyperspace_tpu_torch.actions.base._action_rendezvous": (
        "all_gather",
        "per-host-lane",
        "every process gathers its own step verdict at the same protocol "
        "step, so a one-sided failure aborts the job everywhere instead of "
        "leaving peers blocked",
    ),
    "hyperspace_tpu_torch.actions.base._publish_log": (
        "log_write",
        "coordinator-gated",
        "the operation log has one writer: only the coordinator publishes "
        "begin and commit entries; workers hold the file list through "
        "_global_written",
    ),
    "hyperspace_tpu_torch.actions.base._publish_latest_stable": (
        "log_write",
        "coordinator-gated",
        "the latestStable pointer rides the same single-writer seam as "
        "the log entries",
    ),
}
