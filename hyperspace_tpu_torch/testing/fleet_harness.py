"""Multi-process fleet harness: N frontend processes over one lake.

Counterpart of ``hyperspace_tpu/testing/fleet_harness.py``. It spawns N
real OS processes, each running a ``FleetFrontend`` over the SAME index
lake on the device its spec names (the card by default: every worker then
opens its own CUDA context on the one card, and a worker that finds no card
raises; ``"cpu"`` where the caller asks for it), drives an identical query schedule through all of them from a
file barrier, and (on the chaos rung) ``kill -9``\\ s one frontend
mid-serve. The contract it asserts is the fleet's whole promise at once:

* **zero wrong answers**: every surviving worker's per-query digest equals
  the parent's single-process ground truth (computed with and without
  index rewriting);
* **cross-process dedup**: identical plans submitted to N processes elect
  one executor (``spool_hits`` summed across workers is positive);
* **zero leaked pins**: after the killed worker's pin lease expires, one GC
  pass reaps its durable pin files and the lake's file set converges.

On ``cuda`` the parent builds every kernel (``kernels.build_all``) before
it spawns a worker, so no worker compiles. Workers re-enter this module via
``python -m hyperspace_tpu_torch.testing.fleet_harness --worker
<spec.json>``.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from hyperspace_tpu_torch import constants as C

INDEX_NAME = "fleetidx"

#: worker-side defaults; the parent overrides via the spec's conf map
WORKER_CONF = {
    C.INDEX_NUM_BUCKETS: 4,
    C.FLEET_ENABLED: True,
    C.SERVE_CACHE_ENABLED: True,
    C.FLEET_BUS_POLL_MS: 50,
    C.FLEET_PIN_LEASE_MS: 2_000,
    C.FLEET_SINGLEFLIGHT_WAIT_MS: 3_000,
    C.FLEET_SINGLEFLIGHT_CLAIM_MS: 4_000,
    # a GENEROUS member lease: in-rung reaping is lease-only, so a
    # kill -9 victim's member file survives the rung and the survivors'
    # probes deterministically exercise the dead-owner fallback (the
    # parent's convergence check reaps by pid liveness afterwards)
    C.FLEET_FAST_MEMBER_LEASE_MS: 60_000,
    C.FLEET_FAST_GOSSIP_MS: 50,
}


def _digest(table: pa.Table) -> str:
    """Stable cross-process content digest: sort by every column, then
    hash the plain-python rendering (int/string payloads only by
    harness construction, so repr is deterministic)."""
    t = table.sort_by([(c, "ascending") for c in table.column_names])
    return hashlib.sha256(repr(t.to_pydict()).encode("utf-8")).hexdigest()


def build_lake(
    root: str, rows: int = 20_000, n_files: int = 4, seed: int = 0, device=None
) -> Tuple[str, str]:
    """Write the shared source data + build the covering index once
    (parent-side) on ``device`` (``None``: the session's default, the
    card). Returns (src_dir, index_system_path)."""
    src = os.path.join(root, "source")
    index_root = os.path.join(root, "indexes")
    os.makedirs(src, exist_ok=True)
    os.makedirs(index_root, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = max(1, rows // n_files)
    for i in range(n_files):
        pq.write_table(
            pa.table(
                {
                    "k": pa.array(rng.integers(0, 200, per), pa.int64()),
                    "v": pa.array(rng.integers(-1000, 1000, per), pa.int64()),
                }
            ),
            os.path.join(src, f"part-{i:03d}.parquet"),
        )
    session = _make_session(src, index_root, fleet=False, device=device)
    from hyperspace_tpu_torch.hyperspace import Hyperspace
    from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig

    hs = Hyperspace(session)
    df = session.read.parquet(src)
    hs.create_index(df, CoveringIndexConfig(INDEX_NAME, ["k"], ["v"]))
    return src, index_root


def _make_session(src: str, index_root: str, fleet: bool, conf=None, device=None):
    from hyperspace_tpu_torch.session import HyperspaceSession

    s = HyperspaceSession(device=device)
    s.conf.set(C.INDEX_SYSTEM_PATH, index_root)
    for k, v in WORKER_CONF.items():
        s.conf.set(k, v)
    s.conf.set(C.FLEET_ENABLED, fleet)
    for k, v in (conf or {}).items():
        s.conf.set(k, v)
    s.enable_hyperspace()
    return s


def build_queries(session, src: str, n_queries: int = 6) -> List:
    """The shared schedule: every worker runs the SAME DataFrames in the
    same order, so identical submissions meet at the claim plane. Int
    aggregates only — exact under any row order, keeping the digests
    bitwise across processes and degrade paths."""
    from hyperspace_tpu_torch import functions as F

    out = []
    for i in range(n_queries):
        df = session.read.parquet(src)
        if i % 3 == 0:
            out.append(df.filter(df["k"] == (17 * i + 5) % 200))
        elif i % 3 == 1:
            lo = (i * 23) % 150
            out.append(
                df.filter((df["k"] >= lo) & (df["k"] < lo + 40)).agg(
                    F.count().alias("n"), F.sum("v").alias("sv")
                )
            )
        else:
            out.append(
                df.filter(df["k"] < 120 + i).group_by("k").agg(
                    F.count().alias("n")
                )
            )
    return out


def expected_digests(
    root: str, src: str, index_root: str, n_queries: int, device=None
):
    """Parent-side ground truth, differentially checked: the indexed
    answer must equal the unindexed answer before it may serve as the
    workers' reference."""
    session = _make_session(src, index_root, fleet=False, device=device)
    queries = build_queries(session, src, n_queries)
    out = {}
    for qid, df in enumerate(queries):
        session.enable_hyperspace()
        got = df.collect()
        session.disable_hyperspace()
        want = df.collect()
        d_got, d_want = _digest(got), _digest(want)
        if d_got != d_want:
            raise AssertionError(
                f"parent ground truth diverged on query {qid}: indexed "
                f"{got.num_rows} rows vs source {want.num_rows}"
            )
        out[str(qid)] = d_got
    return out


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def worker_main(spec_path: str) -> int:
    with open(spec_path, "r", encoding="utf-8") as fh:
        spec = json.load(fh)
    if not spec.get("device"):
        raise ValueError(f"fleet worker spec {spec_path} names no device")
    from hyperspace_tpu_torch import ops

    session = _make_session(
        spec["src"],
        spec["index_root"],
        fleet=True,
        conf=spec.get("conf"),
        device=spec["device"],
    )
    fe = session.serve_frontend
    queries = build_queries(session, spec["src"], spec["n_queries"])
    # warm the engine BEFORE the barrier (trace/compile, scan pools,
    # calibration) on per-worker-distinct predicates — distinct digests,
    # so no warmup single-flights onto a peer and skips its own warm.
    # The measured window then times serving, not first-touch setup.
    if spec.get("warmup", True):
        from hyperspace_tpu_torch import functions as F

        wid = int(spec["worker_id"])
        df = session.read.parquet(spec["src"])
        for wq in (
            df.filter(df["k"] == -(wid + 1)),
            df.filter(df["k"] >= -(wid + 2)).agg(F.count().alias("n")),
            df.filter(df["k"] < -(wid + 3)).group_by("k").agg(
                F.count().alias("n")
            ),
        ):
            fe.serve(wq)
    # the kernel launches from the barrier to the end of the run: the
    # schedule and, on a fast-path rung, the probes (0 on the CPU, where
    # every wrapper runs its plain version)
    ops.reset_launch_counts()
    with open(spec["ready"], "w", encoding="utf-8") as fh:
        fh.write(str(os.getpid()))
    deadline = time.monotonic() + 60.0
    while not os.path.exists(spec["go"]):
        if time.monotonic() >= deadline:
            return 3
        time.sleep(0.01)
    digests: Dict[str, str] = {}
    latencies: List[float] = []
    t_start = time.perf_counter()
    served = 0
    slo_class = spec.get("slo_class")
    for _ in range(spec["iters"]):
        for qid, df in enumerate(queries):
            t0 = time.perf_counter()
            table = fe.serve(df, slo_class=slo_class)
            latencies.append(time.perf_counter() - t0)
            digests[str(qid)] = _digest(table)
            served += 1
            if served == 1 and spec.get("serving_marker"):
                with open(spec["serving_marker"], "w", encoding="utf-8") as fh:
                    fh.write("1")
    wall = time.perf_counter() - t_start
    probes = probe_mismatches = 0
    if spec.get("fastpath_phase"):
        # phase 2 (after the measured window — wall_s/qps are phase-1
        # numbers): the parent refreshes the index between done1 and
        # go2, so every live worker witnesses >=1 pushed fanout event;
        # then each worker serves one probe per OTHER member, chosen so
        # its digest rendezvous-routes to that member — a live target is
        # a deterministic spool-free handoff, a kill -9'd target is a
        # deterministic dead-owner fallback, and every probe answer is
        # differentially checked against the unindexed truth
        with open(spec["done1"], "w", encoding="utf-8") as fh:
            fh.write("1")
        deadline2 = time.monotonic() + 60.0
        while not os.path.exists(spec["go2"]):
            if time.monotonic() >= deadline2:
                return 4
            time.sleep(0.01)
        probes, probe_mismatches = _run_probes(session, fe, spec["src"])
    launches = ops.launch_counts()
    stats = fe.stats()
    fe.close()
    obs_report = None
    if session.conf.obs_enabled:
        # the parent asserts cross-process trace linkage: this worker's
        # root trace ids plus every winner id its spool hits linked to
        from hyperspace_tpu_torch.obs import trace as obs_trace

        roots = obs_trace.finished("serve.query")
        obs_report = {
            "root_trace_ids": [r.trace_id for r in roots],
            "spool_hit_links": [
                e.get("winner_trace_id")
                for r in roots
                for e in r.events
                if e.get("name") == "spool_hit"
            ],
        }
    lat_ms = sorted(x * 1000 for x in latencies)
    out = {
        "worker": spec["worker_id"],
        "pid": os.getpid(),
        "digests": digests,
        "served": served,
        "obs": obs_report,
        "wall_s": wall,
        "p50_ms": lat_ms[len(lat_ms) // 2] if lat_ms else 0.0,
        "p99_ms": lat_ms[min(len(lat_ms) - 1, (len(lat_ms) * 99) // 100)]
        if lat_ms
        else 0.0,
        "probes": probes,
        "probe_mismatches": probe_mismatches,
        "launches": launches,
        "stats": stats,
    }
    tmp = spec["out"] + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(out, fh)
    os.replace(tmp, spec["out"])
    return 0


def _run_probes(session, fe, src: str) -> Tuple[int, int]:
    """Serve one digest-targeted probe per OTHER fast-plane member.

    For each peer in the member directory this worker searches candidate
    predicates until it finds one whose (plan, snapshot) digest
    rendezvous-routes to that peer, then serves it and differentially
    checks the answer against the unindexed truth. Returns
    ``(probes, mismatches)``; a worker without a live router (fast plane
    disabled or degraded) probes nothing."""
    from hyperspace_tpu_torch.serve import router as fleet_router

    router = getattr(fe, "_router", None)
    if router is None:
        return 0, 0
    members = fleet_router.read_members(fleet_router.members_dir(session.conf))
    targets = [o for o in members if o != router.owner]
    if not targets:
        return 0, 0
    pin = fe._pin()
    if not pin:
        return 0, 0
    df0 = session.read.parquet(src)
    probes = mismatches = 0
    for target in targets:
        probe = None
        # the probe predicate space is disjoint from the phase-1
        # schedule by shape (the extra always-true v bound), so probe
        # digests never collide with already-cached phase-1 results
        for kk in range(200):
            df = df0.filter((df0["k"] == kk) & (df0["v"] > -2000))
            digest = fe._plan_digest(df.logical_plan, pin)
            if (
                digest is not None
                and fleet_router.rendezvous_owner(members.keys(), digest)
                == target
            ):
                probe = df
                break
        if probe is None:
            continue
        got = fe.serve(probe)
        session.disable_hyperspace()
        want = probe.collect()
        session.enable_hyperspace()
        probes += 1
        if _digest(got) != _digest(want):
            mismatches += 1
    return probes, mismatches


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


def _spawn_worker(spec: dict, spec_path: str) -> subprocess.Popen:
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh)
    env = dict(os.environ)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "hyperspace_tpu_torch.testing.fleet_harness",
            "--worker",
            spec_path,
        ],
        env=env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT,
    )


def run_fleet(
    root: str,
    n_procs: int,
    iters: int = 4,
    rows: int = 20_000,
    n_queries: int = 6,
    kill_one: bool = False,
    conf: Optional[dict] = None,
    timeout_s: float = 180.0,
    reuse_lake: Optional[Tuple[str, str]] = None,
    fastpath_phase: bool = False,
    device=None,
) -> Dict[str, object]:
    """Run one fleet rung: N worker processes serving the same schedule
    against one lake from a barrier start (optionally ``kill -9`` one
    mid-serve). Returns the aggregate the callers report and the
    smoke asserts on — wrong answers, cross-process dedup, leaked pin
    files, aggregate QPS, and the workers' kernel launches from the
    barrier on, summed. Every process (the parent's ground truth and each
    worker) runs on ``device``, the card unless the caller asks for the
    CPU; on the card the parent builds every kernel first."""
    from hyperspace_tpu_torch.session import resolve_device

    device = str(resolve_device(device))
    os.makedirs(root, exist_ok=True)
    if device.startswith("cuda"):
        from hyperspace_tpu_torch import kernels

        kernels.build_all()
    if reuse_lake is not None:
        src, index_root = reuse_lake
    else:
        src, index_root = build_lake(root, rows=rows, device=device)
    # cold coordination plane per rung: a reused lake must not hand this
    # rung the previous rung's spooled results (the ladder measures each
    # process count in the same regime, not a progressively warmer spool)
    from hyperspace_tpu_torch.utils import files as file_utils

    file_utils.delete(os.path.join(index_root, C.HYPERSPACE_FLEET_DIR))
    expected = expected_digests(root, src, index_root, n_queries, device=device)
    procs: List[subprocess.Popen] = []
    specs: List[dict] = []
    for i in range(n_procs):
        spec = {
            "worker_id": i,
            "src": src,
            "index_root": index_root,
            "iters": iters,
            "n_queries": n_queries,
            "ready": os.path.join(root, f"ready.{i}"),
            "go": os.path.join(root, "go"),
            "out": os.path.join(root, f"out.{i}.json"),
            "conf": conf or {},
            "device": device,
        }
        if fastpath_phase:
            spec["fastpath_phase"] = True
            spec["done1"] = os.path.join(root, f"done1.{i}")
            spec["go2"] = os.path.join(root, "go2")
        if kill_one and i == 0:
            # the victim serves an effectively-endless schedule; the
            # parent SIGKILLs it as soon as its first serve lands
            spec["iters"] = max(iters * 1000, 100_000)
            spec["serving_marker"] = os.path.join(root, "serving.0")
        specs.append(spec)
        procs.append(_spawn_worker(spec, os.path.join(root, f"spec.{i}.json")))
    deadline = time.monotonic() + timeout_s
    try:
        for spec in specs:
            while not os.path.exists(spec["ready"]):
                if time.monotonic() >= deadline:
                    raise TimeoutError("fleet worker never became ready")
                _reap_early_exit(procs)
                time.sleep(0.02)
        with open(os.path.join(root, "go"), "w", encoding="utf-8") as fh:
            fh.write("1")
        killed_pid = None
        if kill_one:
            marker = specs[0]["serving_marker"]
            while not os.path.exists(marker):
                if time.monotonic() >= deadline:
                    raise TimeoutError("chaos victim never started serving")
                time.sleep(0.005)
            killed_pid = procs[0].pid
            os.kill(killed_pid, signal.SIGKILL)
        if fastpath_phase:
            # the survivors are parked at the phase-2 barrier; refresh
            # the index NOW (its fanout push is every live worker's
            # pushed-event witness), then release them into the probes
            for i, spec in enumerate(specs):
                if kill_one and i == 0:
                    continue
                while not os.path.exists(spec["done1"]):
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            "fleet worker never finished phase 1"
                        )
                    _reap_early_exit(
                        [p for j, p in enumerate(procs) if not (kill_one and j == 0)]
                    )
                    time.sleep(0.02)
            from hyperspace_tpu_torch.hyperspace import Hyperspace

            # the refresh needs actual changes (an unchanged source is a
            # no-op action, which publishes nothing): append one small
            # delta file, then fan the incremental refresh out
            delta_id = uuid.uuid4().hex[:8]
            rng = np.random.default_rng(int(delta_id, 16) % (1 << 31))
            pq.write_table(
                pa.table(
                    {
                        "k": pa.array(rng.integers(0, 200, 200), pa.int64()),
                        "v": pa.array(
                            rng.integers(-1000, 1000, 200), pa.int64()
                        ),
                    }
                ),
                # unique per rung: a reused lake must present the NEXT
                # rung's refresh with fresh changes too (an unchanged
                # source is a no-op, and no-ops publish nothing)
                os.path.join(src, f"part-phase2-{delta_id}.parquet"),
            )
            refresher = _make_session(
                src, index_root, fleet=True, conf=conf, device=device
            )
            Hyperspace(refresher).refresh_index(INDEX_NAME, "incremental")
            with open(os.path.join(root, "go2"), "w", encoding="utf-8") as fh:
                fh.write("1")
        for i, p in enumerate(procs):
            if kill_one and i == 0:
                p.wait()
                continue
            remain = max(1.0, deadline - time.monotonic())
            rc = p.wait(timeout=remain)
            if rc != 0:
                raise AssertionError(f"fleet worker {i} exited rc={rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for i, spec in enumerate(specs):
        if kill_one and i == 0:
            continue
        with open(spec["out"], "r", encoding="utf-8") as fh:
            results.append(json.load(fh))
    wrong = 0
    for r in results:
        for qid, want in expected.items():
            if r["digests"].get(qid) != want:
                wrong += 1
    total_served = sum(r["served"] for r in results)
    max_wall = max((r["wall_s"] for r in results), default=0.0)
    lease_ms = int(
        (conf or {}).get(
            C.FLEET_PIN_LEASE_MS, WORKER_CONF[C.FLEET_PIN_LEASE_MS]
        )
    )
    # the one way to combine per-worker counter snapshots
    # (obs.merge_snapshots: counters sum, watermarks max, percentiles drop)
    from hyperspace_tpu_torch.obs import merge_snapshots

    fleet_merged = merge_snapshots(
        *(r["stats"].get("fleet", {}) for r in results)
    )
    spool_hits = fleet_merged.get("spool_hits", 0)
    claims_won = fleet_merged.get("claims_won", 0)
    bus_events = fleet_merged.get("bus_events", 0)
    probes = sum(r.get("probes", 0) for r in results)
    probe_mismatches = sum(r.get("probe_mismatches", 0) for r in results)
    launches: Dict[str, int] = {}
    for r in results:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    leaked = _converge_pins(index_root, lease_ms=lease_ms)
    leaked_fast = _converge_fast_members(index_root)
    return {
        "processes": n_procs,
        "workers_reporting": len(results),
        "killed": bool(kill_one),
        "queries": total_served,
        "wrong_answers": wrong + probe_mismatches,
        "qps": round(total_served / max_wall, 1) if max_wall > 0 else 0.0,
        "p50_ms": round(
            float(np.median([r["p50_ms"] for r in results])), 2
        )
        if results
        else 0.0,
        "p99_ms": round(max(r["p99_ms"] for r in results), 2)
        if results
        else 0.0,
        "cross_process_dedup": spool_hits,
        "claims_won": claims_won,
        "bus_events": bus_events,
        # fast data plane (merged across workers; fast_frontends is the
        # count of workers whose fast plane came up)
        "fast_frontends": fleet_merged.get("fast_frontends", 0),
        "fast_push_received": fleet_merged.get("fast_push_received", 0),
        "fast_handoffs": fleet_merged.get("fast_handoffs", 0),
        "fast_fallbacks": fleet_merged.get("fast_fallbacks", 0),
        "fast_result_hits": fleet_merged.get("fast_result_hits", 0),
        "fast_dedup_joins": fleet_merged.get("fast_dedup_joins", 0),
        "fast_wait_ms_total": fleet_merged.get("fast_wait_ms_total", 0.0),
        "fast_waits": fleet_merged.get("fast_waits", 0),
        "poll_wait_ms_total": fleet_merged.get("poll_wait_ms_total", 0.0),
        "poll_waits": fleet_merged.get("poll_waits", 0),
        "probes": probes,
        "probe_mismatches": probe_mismatches,
        "leaked_pin_files": leaked,
        "leaked_fast_members": leaked_fast,
        "device": device,
        "launches": launches,
        "worker_obs": [r.get("obs") for r in results if r.get("obs")],
    }


def _reap_early_exit(procs: List[subprocess.Popen]) -> None:
    for i, p in enumerate(procs):
        rc = p.poll()
        if rc is not None and rc != 0:
            raise AssertionError(
                f"fleet worker {i} died before the barrier (rc={rc})"
            )


def _converge_pins(index_root: str, lease_ms: Optional[int] = None) -> int:
    """Wait out the pin lease, run one GC pass per index (which reaps
    expired pin files), and count any pin file that SURVIVES — the
    killed frontend's leavings must converge to zero."""
    from hyperspace_tpu_torch.metadata import recovery

    lease = lease_ms or WORKER_CONF[C.FLEET_PIN_LEASE_MS]
    time.sleep(lease * 1.5 / 1000.0)
    leaked = 0
    try:
        index_dirs = sorted(os.listdir(index_root))
    except OSError:
        return 0
    for name in index_dirs:
        index_path = os.path.join(index_root, name)
        if not os.path.isdir(index_path) or name.startswith("_"):
            continue
        recovery.gc_orphans(index_path, grace_ms=0)
        pins_dir = os.path.join(index_path, C.HYPERSPACE_PINS_DIR)
        if os.path.isdir(pins_dir):
            leaked += sum(
                1 for f in os.listdir(pins_dir) if f.endswith(".json")
            )
    return leaked


def _converge_fast_members(index_root: str) -> int:
    """After the rung, reap every member whose PROCESS is gone (kill -9
    victims leave lease-valid member files — the generous harness lease
    is deliberate, see ``WORKER_CONF``) and count member or socket files
    that survive the reap: the fast plane's leak witness."""
    from hyperspace_tpu_torch.serve import router as fleet_router

    mdir = os.path.join(index_root, C.HYPERSPACE_FLEET_DIR, "members")
    _reaped, leftovers = fleet_router.reap_members(mdir, force_dead=True)
    leaked = len(leftovers)
    try:
        leaked += sum(1 for f in os.listdir(mdir) if f.endswith(".json"))
    except OSError:
        pass
    return leaked


def main(argv: List[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        return worker_main(argv[1])
    print(
        "usage: python -m hyperspace_tpu_torch.testing.fleet_harness "
        "--worker <spec.json>",
        file=sys.stderr,
    )
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
