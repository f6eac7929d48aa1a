"""SHARED_STATE — the registry of cross-thread mutable state.

Counterpart of ``hyperspace_tpu/concurrency.py``, naming the port's own
state and locks: the session's breakdowns (``build_stats`` under
``covering_build._stats_lock``, ``join_stats`` rebind-only) take the place
of the reference's module breakdown dicts, the serve cache's and the serve
tier's instance state is declared (the frontend's single-flight map, the
fleet's fast-plane maps, the bus's event sequence), and the kernel loader's
map replaces the reference's native library.

The KERNEL_TWINS doctrine applied to concurrency: every module-level
(and registered class-level) mutable object that a thread-pool-submitted
callable can reach is declared HERE, together with the lock that guards
it and the guarding *policy* — so "is this shared state guarded?" is a
mechanical question (``hslint`` HS6xx, ``analysis/shared_state.py``),
not an archaeology project. The runtime lock witness
(``testing/lock_witness.py``) wraps the locks named here during the
stress suites and cross-checks what actually happened against this
model (``hslint --witness``).

Entry shape::

    "<dotted path of the state object>": (
        "<dotted module lock | self.<attr> | ''>",
        "<policy>",
        "<one-line justification — why this policy is sound>",
    )

State paths name a module-level global
(``hyperspace_tpu_torch.io.scan._scan_pool``) or a class instance attribute
(``hyperspace_tpu_torch.execution.serve_cache.ServeCache._entries``; guarded
by an instance lock spelled ``self.<attr>``). Policies:

``guarded``
    Every access (read or write) holds the declared lock. The strictest
    contract; HS602 flags any access outside it.
``guarded-writes``
    Writes hold the lock; unguarded reads are a documented benign race
    (double-checked publication fast paths, monotonic flags, telemetry
    probes). HS602 flags unguarded writes only.
``rebind-only``
    No lock: the object is never mutated in place — writers build a new
    object and publish it with one atomic name rebind, readers grab the
    reference once. HS602 flags any in-place mutation (``.update()``,
    ``x[k] = v``, ``+=``); plain rebinds and reads pass.
``frozen``
    Populated at import time (decorator registration), read-only once
    threads exist. HS602 flags writes from any thread-pool-reachable
    function.

Class-level state is registered opt-in (HS602 then audits every method
of the class, ``__init__`` excluded — construction happens-before
sharing); module-level globals are the default blast radius and HS601
flags any unregistered one a pool-submitted callable can reach.

Keep this module stdlib-only and import-cheap: the lock witness imports
it inside test processes before any session exists.
"""

from __future__ import annotations

from typing import Dict, Tuple

SHARED_STATE: Dict[str, Tuple[str, str, str]] = {
    # -- thread pools and loaders (publish-once, read forever) ---------------
    "hyperspace_tpu_torch.io.scan._scan_pool": (
        "hyperspace_tpu_torch.io.scan._scan_pool_lock",
        "guarded-writes",
        "double-checked create under the lock; the published executor is "
        "a stable reference, post-publish reads need no lock",
    ),
    # -- serve-plane caches --------------------------------------------------
    "hyperspace_tpu_torch.indexes.zonemaps._local_cache": (
        "hyperspace_tpu_torch.indexes.zonemaps._local_lock",
        "guarded",
        "bounded LRU shared by every serve thread when serve-cache mode "
        "is off; get/put/evict/clear all run under the one lock",
    ),
    "hyperspace_tpu_torch.indexes.zonemaps._local_bytes": (
        "hyperspace_tpu_torch.indexes.zonemaps._local_lock",
        "guarded",
        "byte ledger of the zonemap module LRU (residency bound, "
        "ALLOC_SITES doctrine); every read-modify-write runs under the "
        "same lock as the cache it accounts for",
    ),
    "hyperspace_tpu_torch.indexes.aggindex._local_cache": (
        "hyperspace_tpu_torch.indexes.aggindex._local_lock",
        "guarded",
        "bounded LRU of assembled aggregate-plane state shared by every "
        "serve thread when serve-cache mode is off; get/put/evict/clear "
        "all run under the one lock",
    ),
    "hyperspace_tpu_torch.indexes.aggindex._local_bytes": (
        "hyperspace_tpu_torch.indexes.aggindex._local_lock",
        "guarded",
        "byte ledger of the aggregate-plane module LRU (residency "
        "bound, ALLOC_SITES doctrine); every read-modify-write runs "
        "under the same lock as the cache it accounts for",
    ),
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache._entries": (
        "self._lock",
        "guarded",
        "the memory governor's entry map: every public method takes the "
        "lock for its whole critical section (docs in serve_cache.py)",
    ),
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache._bytes": (
        "self._lock",
        "guarded-writes",
        "byte ledger mutated only under the cache lock; resident_bytes "
        "is a documented unsynchronized telemetry probe",
    ),
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache._spill": (
        "self._lock",
        "guarded",
        "the spill-tier index (key -> (path, nbytes)): get/put/demote/"
        "evict/clear mutate it only inside the cache lock; file I/O "
        "(encode, fsync'd publish, restore) runs outside with the key "
        "already removed, so a racing get just misses and re-derives",
    ),
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache._spill_bytes": (
        "self._lock",
        "guarded",
        "byte ledger of the spill tier, mutated in the same critical "
        "sections as _spill so the hyperspace.serve.spill.maxBytes cap "
        "can never be overshot by a torn read-modify-write",
    ),
    "hyperspace_tpu_torch.execution.serve_cache._mmap_regions": (
        "hyperspace_tpu_torch.execution.serve_cache._mmap_lock",
        "guarded-writes",
        "the file-backed address-range registry estimate_nbytes "
        "consults: register (spill restore / open_mmap_table), "
        "finalizer-driven unregister and range iteration hold the one "
        "lock; the sizing hot path's `if _mmap_regions` emptiness probe "
        "is a deliberate lock-free read — a stale answer only mis-sizes "
        "one estimate by the mmap token",
    ),
    "hyperspace_tpu_torch.execution.serve_cache._LIVE_CACHES": (
        "",
        "rebind-only",
        "WeakSet of live caches consulted by the spill orphan reaper; "
        "membership changes are single add() at construction (before "
        "the cache is shared) plus GC-driven removal — CPython WeakSet "
        "discard is atomic at that granularity, readers snapshot via "
        "list() before iterating",
    ),
    "hyperspace_tpu_torch.execution.executor.last_stream_stats": (
        "hyperspace_tpu_torch.execution.executor._stream_stats_lock",
        "guarded",
        "per-query streaming-join wave/bucket counters accumulated from "
        "the wave worker threads; reset and add both hold the stream "
        "stats lock (last-writer-wins by contract, like the breakdown)",
    ),
    "hyperspace_tpu_torch.serve.frontend.ServeFrontend._inflight": (
        "self._lock",
        "guarded",
        "single-flight dedup map: lookup+insert must be atomic or two "
        "identical plans both execute; all accesses hold the frontend lock",
    ),
    # -- fleet fanout bus (serve/bus.py) -------------------------------------
    "hyperspace_tpu_torch.serve.bus._seq": (
        "hyperspace_tpu_torch.serve.bus._seq_lock",
        "guarded",
        "process-wide bus event sequence: every publisher increments under "
        "the one lock so same-millisecond publishes cannot collide on a "
        "file name",
    ),
    # -- fleet fast plane (serve/fleet.py) -----------------------------------
    "hyperspace_tpu_torch.serve.fleet.FleetFrontend._fast_results": (
        "self._lock",
        "guarded",
        "the digest->Arrow-result LRU served to routed peers; get/put/evict "
        "from serve workers and fast-bus handler threads all hold the "
        "frontend lock",
    ),
    "hyperspace_tpu_torch.serve.fleet.FleetFrontend._fast_results_bytes": (
        "self._lock",
        "guarded",
        "byte ledger of the fast result cache, mutated in the same critical "
        "sections as the cache it accounts for",
    ),
    "hyperspace_tpu_torch.serve.fleet.FleetFrontend._fast_inflight": (
        "self._lock",
        "guarded",
        "owner-side single-flight map (digest -> Future): lookup+insert must "
        "be atomic or two identical routed requests both execute",
    ),
    "hyperspace_tpu_torch.serve.fleet.FleetFrontend._wake_events": (
        "self._lock",
        "guarded",
        "digest -> (Event, waiters) parking lot for spool waiters woken by "
        "result-ready pushes; register/unregister/wake hold the frontend lock",
    ),
    "hyperspace_tpu_torch.serve.fleet.FleetFrontend._fast_applied": (
        "self._lock",
        "guarded",
        "bus-event names applied via fast push, consulted by the durable "
        "poll to dedup push-vs-poll delivery",
    ),
    "hyperspace_tpu_torch.serve.fleet.FleetFrontend._fast_applied_order": (
        "self._lock",
        "guarded",
        "FIFO eviction order of the applied-name dedup set, mutated in the "
        "same critical sections as the set it bounds",
    ),
    "hyperspace_tpu_torch.serve.fleet.FleetFrontend._peer_slo": (
        "self._lock",
        "guarded",
        "gossiped per-peer SLO class depths read by the admission check and "
        "written by the gossip handler; both hold the frontend lock",
    ),
    # -- telemetry (process-global, last-writer-wins by contract) ------------
    "hyperspace_tpu_torch.session.HyperspaceSession.build_stats": (
        "hyperspace_tpu_torch.indexes.covering_build._stats_lock",
        "guarded-writes",
        "the session's build breakdown (the reference's module "
        "last_build_breakdown): the shard tails add from several threads "
        "and reset clears, all under the stats lock; readers take it "
        "after the build returns",
    ),
    "hyperspace_tpu_torch.session.HyperspaceSession.join_stats": (
        "",
        "rebind-only",
        "the session's join breakdown (the reference's module "
        "last_serve_breakdown): each join fills a dict of its own (a side "
        "thread its own, merged after the pool joins) and publishes it "
        "with one rebind",
    ),
    "hyperspace_tpu_torch.session.HyperspaceSession._serve_cache": (
        "self._serve_cache_lock",
        "guarded-writes",
        "the session's serve cache is rebuilt under the session's lock "
        "when a cap changes; clear_serve_cache reads the reference once",
    ),
    "hyperspace_tpu_torch.session.HyperspaceSession._trace_seq": (
        "",
        "rebind-only",
        "the profiler trace files' sequence numbers: an itertools.count "
        "bound once at construction, whose next() is atomic under the GIL",
    ),
    "hyperspace_tpu_torch.parallel.shuffle.last_shuffle_stats": (
        "",
        "rebind-only",
        "diagnostic snapshot of the most recent exchange: the writer "
        "builds a fresh dict and publishes it with one atomic rebind, "
        "readers copy the reference they grabbed",
    ),
    "hyperspace_tpu_torch.parallel.shuffle._skew_warned": (
        "",
        "rebind-only",
        "once-per-build skew-warning latch: plain bool rebinds "
        "(False at data-op entry, True at first warn); a racy "
        "check-then-warn can only duplicate one log line",
    ),
    "hyperspace_tpu_torch.indexes.zonemaps.last_prune_stats": (
        "",
        "rebind-only",
        "per-serve prune telemetry published as a whole new dict in one "
        "rebind; concurrent serves interleave whole snapshots, never "
        "torn ones",
    ),
    "hyperspace_tpu_torch.execution.pipeline_compiler.last_fused_stats": (
        "",
        "rebind-only",
        "fused-pass telemetry of the most recent execution, published as "
        "one rebind of a freshly-built dict",
    ),
    "hyperspace_tpu_torch.execution.pipeline_compiler.last_aggplane_stats": (
        "",
        "rebind-only",
        "metadata-plane telemetry of the most recent execution, "
        "published as one rebind of a freshly-built dict",
    ),
    "hyperspace_tpu_torch.execution.approx_exec.last_approx_stats": (
        "",
        "rebind-only",
        "approximate-serve telemetry of the most recent estimate, "
        "published as one rebind of a freshly-built dict",
    ),
    "hyperspace_tpu_torch.testing.replay.last_replay_stats": (
        "",
        "rebind-only",
        "last completed replay's summary dict published whole in one "
        "rebind; concurrent replays interleave snapshots, never torn "
        "ones",
    ),
    # -- observability plane (hyperspace_tpu_torch/obs/) ---------------------
    "hyperspace_tpu_torch.obs.trace._enabled": (
        "",
        "rebind-only",
        "the process-global tracing switch: plain bool rebinds; a racy "
        "read costs one span (recorded or skipped), never a torn value",
    ),
    "hyperspace_tpu_torch.obs.trace._max_spans": (
        "",
        "rebind-only",
        "per-trace span cap republished whole by configure(); a stale "
        "read caps one trace at the previous bound",
    ),
    "hyperspace_tpu_torch.obs.trace._finished": (
        "hyperspace_tpu_torch.obs.trace._rec_lock",
        "guarded",
        "the finished-trace ring: root finish/append, drain and reset "
        "all hold the record lock (configure() swaps the deque under "
        "it too)",
    ),
    # -- recovery plane (metadata/recovery.py) -------------------------------
    "hyperspace_tpu_torch.metadata.recovery._active_pins": (
        "hyperspace_tpu_torch.metadata.recovery._pins_lock",
        "guarded",
        "serve snapshot pin registry consulted by orphan GC; register/"
        "release/union all hold the pins lock (the frozensets handed out "
        "are immutable)",
    ),
    "hyperspace_tpu_torch.metadata.recovery._pin_seq": (
        "hyperspace_tpu_torch.metadata.recovery._pins_lock",
        "guarded",
        "monotonic pin-token counter incremented only under the pins "
        "lock",
    ),
    "hyperspace_tpu_torch.metadata.recovery._durable_pins": (
        "hyperspace_tpu_torch.metadata.recovery._pins_lock",
        "guarded",
        "durable-pin renewal map (token -> pin files) consulted by the "
        "heartbeat sweep; record/release/snapshot all hold the pins "
        "lock, pin-file I/O happens outside it",
    ),
    "hyperspace_tpu_torch.metadata.recovery._pin_heartbeat": (
        "hyperspace_tpu_torch.metadata.recovery._pins_lock",
        "guarded-writes",
        "singleton renewal thread published by one rebind under the "
        "pins lock; the unguarded read sees None or the started "
        "heartbeat, never a torn value",
    ),
    # -- fault injection (testing/faults.py) ---------------------------------
    "hyperspace_tpu_torch.testing.faults._crash_active": (
        "hyperspace_tpu_torch.testing.faults._lock",
        "guarded-writes",
        "crash-point arm/disarm mutate under the registry lock; the "
        "disarmed-path read is the same deliberate lock-free truthiness "
        "check the fault registry documents",
    ),
    "hyperspace_tpu_torch.testing.faults._active": (
        "hyperspace_tpu_torch.testing.faults._lock",
        "guarded-writes",
        "arm/disarm mutate under the registry lock; the disarmed-path "
        "read is a deliberate lock-free truthiness check (module doc)",
    ),
    "hyperspace_tpu_torch.testing.faults._fired_totals": (
        "hyperspace_tpu_torch.testing.faults._lock",
        "guarded",
        "fired counters updated inside fire() and snapshotted by stats() "
        "under the one registry lock",
    ),
    # -- residency witness (testing/residency_witness.py) --------------------
    "hyperspace_tpu_torch.testing.residency_witness._sites": (
        "hyperspace_tpu_torch.testing.residency_witness._rec_lock",
        "guarded",
        "per-site peak-bytes/call counters updated by the recording "
        "wrappers on every thread that calls a registered allocation "
        "site; record/snapshot/reset all hold the recorder lock "
        "(install/uninstall are single-threaded test setup by contract)",
    ),
    # -- collective witness (testing/collective_witness.py) ------------------
    "hyperspace_tpu_torch.testing.collective_witness._records": (
        "hyperspace_tpu_torch.testing.collective_witness._rec_lock",
        "guarded",
        "the per-process ordered collective sequence: record/snapshot/"
        "reset all hold the recorder lock (install/uninstall are "
        "single-threaded test setup by contract)",
    ),
    "hyperspace_tpu_torch.testing.collective_witness._wave_counts": (
        "hyperspace_tpu_torch.testing.collective_witness._rec_lock",
        "guarded",
        "per-site wave counters incremented with the matching sequence "
        "append under the same recorder lock",
    ),
    # -- kernel loader (kernels.py) -------------------------------------------
    "hyperspace_tpu_torch.kernels._libs": (
        "hyperspace_tpu_torch.kernels._lock",
        "guarded-writes",
        "double-checked load: the build and the CDLL publish run under the "
        "loader lock; the lock-free fast-path read sees None or a loaded "
        "library",
    ),
    # -- import-time registries ----------------------------------------------
    "hyperspace_tpu_torch.indexes.registry._REGISTRY": (
        "",
        "frozen",
        "index classes register at import time via decorator; serve/build "
        "threads only read it",
    ),
    "hyperspace_tpu_torch.indexes.sketches._SKETCH_REGISTRY": (
        "",
        "frozen",
        "sketch classes register at import time via decorator; query "
        "threads only read it",
    ),
}
