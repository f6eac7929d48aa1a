"""Chaos schedule harness: randomized lifecycles under injected crashes.

Counterpart of ``hyperspace_tpu/testing/chaos.py``, driving port
sessions. The crash matrix kills ONE action at ONE point from a known
state; this is the composition test: a seeded randomized schedule of
create / refresh / optimize / delete / restore / vacuum / append / serve
steps, with a crash injected at a chosen (step, point), then recovery,
then the rest of the schedule. After every crash the harness checks the
recovery plane's whole contract:

* **state machine**: the log tip is back in a stable state;
* **serve equivalence**: every serve step answers identically with and
  without index rewriting, and identically to the same schedule run
  crash-free;
* **zero orphans**: after GC (grace 0) no data file under the index dir
  is unreferenced by a stable entry.

The schedule is a pure function of the seed (the JAX package's
``build_schedule`` gives the same list), so a crash run and its crash-free
replica run the same ops over byte-identical source data. After recovery
the crashed step is retried once (an op that had committed before the
crash point surfaces as a no-op or an illegal-state rejection, both
tolerated).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException, NoChangesException
from hyperspace_tpu_torch.metadata import recovery
from hyperspace_tpu_torch.testing import faults
from hyperspace_tpu_torch.testing.faults import SimulatedCrash

INDEX_NAME = "chaosidx"

#: lifecycle steps a crash point can be injected into
LIFECYCLE_OPS = (
    "create",
    "refresh_full",
    "refresh_incremental",
    "optimize",
    "delete",
    "restore",
    "vacuum",
)


@dataclasses.dataclass
class ChaosReport:
    schedule: List[Tuple]
    serve_results: List[pa.Table] = dataclasses.field(default_factory=list)
    crashes_fired: int = 0
    crashes_skipped: int = 0  # armed step no-op'ed, the point never ran
    recoveries: int = 0
    rolled_back: int = 0
    healed_pointers: int = 0
    stranded_after: int = 0
    orphans_after_gc: int = 0
    gc_quarantined: int = 0
    final_state: Optional[str] = None


def build_schedule(seed: int, n_steps: int) -> List[Tuple]:
    """A legal op sequence from a seeded walk of the lifecycle machine.

    Pure in the seed: both the crash run and its crash-free replica
    derive the same list. Every refresh is preceded by an append (so it
    cannot no-op) and the walk keeps serves sprinkled throughout."""
    rng = random.Random(seed)
    steps: List[Tuple] = [("create",), ("serve",)]
    state = "active"
    appended = 0
    while len(steps) < n_steps:
        if state == "none":
            steps.append(("create",))
            state = "active"
        elif state == "deleted":
            op = rng.choice(["restore", "vacuum", "serve"])
            steps.append((op,))
            if op == "restore":
                state = "active"
            elif op == "vacuum":
                state = "none"
        else:  # active
            op = rng.choice(
                [
                    "refresh_full",
                    "refresh_incremental",
                    "optimize",
                    "vacuum",  # ACTIVE -> vacuum-outdated sweep
                    "delete",
                    "serve",
                    "serve",
                ]
            )
            if op in ("refresh_full", "refresh_incremental"):
                appended += 1
                steps.append(("append", appended))
            steps.append((op,))
            if op == "delete":
                state = "deleted"
        if rng.random() < 0.3:
            steps.append(("serve",))
    return steps


class ChaosHarness:
    """One seeded schedule, executable crash-free or with a crash at a
    chosen (lifecycle-step index, crash point)."""

    def __init__(
        self,
        root: str,
        seed: int = 0,
        n_steps: int = 12,
        rows_per_file: int = 120,
        lease_ms: int = 50,
        device=None,
    ):
        """``device`` is the sessions' (None: CUDA, raising without a card;
        the tests pass "cpu")."""
        self.root = root
        self.device = device
        self.seed = seed
        self.rows_per_file = rows_per_file
        self.lease_ms = lease_ms
        self.schedule = build_schedule(seed, n_steps)

    # -- deterministic source data ------------------------------------------
    def _file_table(self, ordinal: int) -> pa.Table:
        rng = np.random.default_rng(self.seed * 1000 + ordinal)
        n = self.rows_per_file
        return pa.table(
            {
                "k": pa.array(rng.integers(0, 40, n), pa.int64()),
                "v": pa.array(rng.integers(-500, 500, n), pa.int64()),
                "q": pa.array(
                    [f"s{int(x)}" for x in rng.integers(0, 6, n)]
                ),
            }
        )

    def _write_source_file(self, src_dir: str, ordinal: int) -> None:
        pq.write_table(
            self._file_table(ordinal),
            os.path.join(src_dir, f"part-{ordinal:03d}.parquet"),
        )

    def _make_session(self, run_dir: str):
        from hyperspace_tpu_torch.session import HyperspaceSession

        index_root = os.path.join(run_dir, "indexes")
        os.makedirs(index_root, exist_ok=True)
        s = HyperspaceSession(device=self.device)
        s.conf.set(C.INDEX_SYSTEM_PATH, index_root)
        s.conf.set(C.INDEX_NUM_BUCKETS, 4)
        s.conf.set(C.INDEX_LINEAGE_ENABLED, True)
        s.conf.set(C.RECOVERY_LEASE_MS, self.lease_ms)
        s.conf.set(C.RECOVERY_ORPHAN_GRACE_MS, 0)
        return s, index_root

    # -- execution -----------------------------------------------------------
    def run(
        self,
        crash_step: Optional[int] = None,
        crash_point: Optional[str] = None,
        run_name: Optional[str] = None,
    ) -> ChaosReport:
        """Execute the schedule; when ``crash_step`` names the Nth
        LIFECYCLE step (0-based, ``lifecycle_steps()`` order), arm
        ``crash_point`` just before it, recover after the simulated
        death, assert the recovery contract, retry, continue."""
        if run_name is None:
            run_name = (
                "clean"
                if crash_step is None
                else f"crash_{crash_step}_{crash_point}"
            )
        run_dir = os.path.join(self.root, run_name)
        src_dir = os.path.join(run_dir, "source")
        os.makedirs(src_dir, exist_ok=True)
        self._write_source_file(src_dir, 0)
        session, index_root = self._make_session(run_dir)
        from hyperspace_tpu_torch.hyperspace import Hyperspace

        hs = Hyperspace(session)
        report = ChaosReport(schedule=list(self.schedule))
        index_path = os.path.join(index_root, INDEX_NAME)
        lifecycle_i = -1
        for step in self.schedule:
            op = step[0]
            if op == "append":
                self._write_source_file(src_dir, step[1])
                continue
            if op == "serve":
                report.serve_results.append(self._serve(session, src_dir))
                continue
            lifecycle_i += 1
            armed = (
                crash_step is not None
                and lifecycle_i == crash_step
                and crash_point is not None
            )
            if armed:
                faults.set_crash(crash_point, "raise")
            try:
                self._lifecycle(hs, session, src_dir, op)
                if armed:
                    # the armed point never executed (the op no-op'ed or
                    # took a path without that seam): not a failure of
                    # recovery, but the matrix records it
                    faults.set_crash(crash_point, "off")
                    report.crashes_skipped += 1
            except SimulatedCrash:
                report.crashes_fired += 1
                faults.set_crash(crash_point, "off")
                self._recover_and_assert(session, hs, index_path, report)
                # retry once: a crash BEFORE commit redoes the op, a
                # crash AFTER commit surfaces as no-op/illegal-state
                try:
                    self._lifecycle(hs, session, src_dir, op)
                except (HyperspaceException, NoChangesException):
                    pass
        # end-of-schedule sweep
        self._recover_and_assert(session, hs, index_path, report, final=True)
        return report

    def lifecycle_steps(self) -> List[Tuple]:
        return [s for s in self.schedule if s[0] in LIFECYCLE_OPS]

    # -- pieces --------------------------------------------------------------
    def _serve(self, session, src_dir: str) -> pa.Table:
        """One serve step, differentially checked: the index-rewritten
        answer must equal the source-only answer (sorted — bucketed
        serves interleave row order)."""
        df = session.read.parquet(src_dir)
        q = df.filter(df["k"] >= 20).select("k", "v", "q")
        session.index_manager.clear_cache()
        session.enable_hyperspace()
        got = q.collect()
        session.disable_hyperspace()
        want = q.collect()
        got_s = _sorted(got)
        want_s = _sorted(want)
        if not got_s.equals(want_s):
            raise AssertionError(
                f"serve diverged from source truth: {got_s.num_rows} vs "
                f"{want_s.num_rows} rows"
            )
        return got_s

    def _lifecycle(self, hs, session, src_dir: str, op: str) -> None:
        session.index_manager.clear_cache()
        if op == "create":
            from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig

            df = session.read.parquet(src_dir)
            hs.create_index(
                df, CoveringIndexConfig(INDEX_NAME, ["k"], ["v", "q"])
            )
        elif op == "refresh_full":
            hs.refresh_index(INDEX_NAME, "full")
        elif op == "refresh_incremental":
            hs.refresh_index(INDEX_NAME, "incremental")
        elif op == "optimize":
            try:
                hs.optimize_index(INDEX_NAME, "full")
            except NoChangesException:  # pragma: no cover - swallowed in run()
                pass
        elif op == "delete":
            hs.delete_index(INDEX_NAME)
        elif op == "restore":
            hs.restore_index(INDEX_NAME)
        elif op == "vacuum":
            hs.vacuum_index(INDEX_NAME)
        else:  # pragma: no cover
            raise ValueError(f"unknown op {op!r}")

    def _recover_and_assert(
        self, session, hs, index_path: str, report: ChaosReport, final=False
    ) -> None:
        """Recovery + the full invariant sweep the chaos contract names."""
        if not os.path.isdir(os.path.join(index_path, C.HYPERSPACE_LOG_DIR)):
            report.final_state = States.DOESNOTEXIST if final else None
            return
        # the dead writer's lease must age out (heartbeat died with it)
        time.sleep(self.lease_ms * 2.5 / 1000.0)
        rep = hs.recover(INDEX_NAME, gc=True)
        report.recoveries += 1
        report.rolled_back += bool(rep.get("rolled_back"))
        report.healed_pointers += bool(rep.get("healed_pointer"))
        gc_rep = rep.get("gc") or {}
        report.gc_quarantined += int(
            gc_rep.get("quarantined_files", 0)
        ) + int(gc_rep.get("quarantined_dirs", 0))
        # the state machine's invariant at runtime: the tip is stable
        log_mgr, _ = session.index_manager._managers(INDEX_NAME)
        tip = log_mgr.get_latest_log()
        state = tip.state if tip is not None else States.DOESNOTEXIST
        if state not in States.STABLE_STATES:
            report.stranded_after += 1
        # GC convergence: a second pass finds nothing left to take
        leftovers = recovery.find_orphans(index_path)
        report.orphans_after_gc += len(leftovers)
        if final:
            report.final_state = state


def _sorted(t: pa.Table) -> pa.Table:
    return t.sort_by([(c, "ascending") for c in t.column_names])


def run_crash_matrix(
    root: str,
    seed: int = 0,
    n_steps: int = 12,
    points: Tuple[str, ...] = faults.CRASH_POINTS,
    max_cells: Optional[int] = None,
    device=None,
) -> Dict[str, object]:
    """Crash the seeded schedule at every (lifecycle step × crash point)
    cell in turn and aggregate the invariant counters.

    Every run's serve results must match the crash-free replica's
    step-for-step; the aggregate must show zero stranded entries and
    zero orphans after GC. Returns the summary dict."""
    harness = ChaosHarness(root, seed=seed, n_steps=n_steps, device=device)
    clean = harness.run(run_name="clean")
    cells = [
        (i, p)
        for i in range(len(harness.lifecycle_steps()))
        for p in points
    ]
    if max_cells is not None:
        cells = cells[:max_cells]
    summary: Dict[str, object] = {
        "seed": seed,
        "schedule_steps": len(harness.schedule),
        "lifecycle_steps": len(harness.lifecycle_steps()),
        "cells": len(cells),
        "crashes_fired": 0,
        "crashes_skipped": 0,
        "rolled_back": 0,
        "healed_pointers": 0,
        "stranded_after_recovery": 0,
        "orphans_after_gc": 0,
        "serve_mismatches": 0,
        "serves_verified": 0,
    }
    for i, point in cells:
        rep = harness.run(crash_step=i, crash_point=point)
        summary["crashes_fired"] += rep.crashes_fired
        summary["crashes_skipped"] += rep.crashes_skipped
        summary["rolled_back"] += rep.rolled_back
        summary["healed_pointers"] += rep.healed_pointers
        summary["stranded_after_recovery"] += rep.stranded_after
        summary["orphans_after_gc"] += rep.orphans_after_gc
        for got, want in zip(rep.serve_results, clean.serve_results):
            summary["serves_verified"] += 1
            if not got.equals(want):
                summary["serve_mismatches"] += 1
    return summary
