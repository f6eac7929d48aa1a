"""Config keys, index states and reserved property names.

Reference: ``index/IndexConstants.scala:21-170`` and
``actions/Constants.scala:20-34``. Counterpart of
``hyperspace_tpu/constants.py`` trimmed to the keys this slice reads; the
key strings, names that reach disk and defaults are unchanged, so both
packages read one system path the same way.
"""

import os

# ---------------------------------------------------------------------------
# Index lifecycle states (actions/Constants.scala:20-34)
# ---------------------------------------------------------------------------


class States:
    DOESNOTEXIST = "DOESNOTEXIST"
    CREATING = "CREATING"
    ACTIVE = "ACTIVE"
    REFRESHING = "REFRESHING"
    OPTIMIZING = "OPTIMIZING"
    DELETING = "DELETING"
    DELETED = "DELETED"
    RESTORING = "RESTORING"
    VACUUMING = "VACUUMING"
    VACUUMINGOUTDATED = "VACUUMINGOUTDATED"

    STABLE_STATES = frozenset({ACTIVE, DELETED, DOESNOTEXIST})

    # transient state -> stable state it rolls back to on cancel()
    ROLLBACK = {
        CREATING: DOESNOTEXIST,
        REFRESHING: ACTIVE,
        OPTIMIZING: ACTIVE,
        VACUUMINGOUTDATED: ACTIVE,
        DELETING: ACTIVE,
        RESTORING: DELETED,
        VACUUMING: DELETED,
    }


# ---------------------------------------------------------------------------
# Config keys (index/IndexConstants.scala) — flat string keys
# ---------------------------------------------------------------------------

HYPERSPACE_APPLY_ENABLED = "hyperspace.apply.enabled"
HYPERSPACE_APPLY_ENABLED_DEFAULT = True

INDEX_SYSTEM_PATH = "hyperspace.system.path"
# PathResolver.scala's <warehouse>/indexes, anchored at the user's home
INDEX_SYSTEM_PATH_DEFAULT = os.path.join(
    os.path.expanduser("~"), "hyperspace", "indexes"
)

INDEX_NUM_BUCKETS = "hyperspace.index.num_buckets"
INDEX_NUM_BUCKETS_DEFAULT = 200  # IndexConstants.scala:33-36 (= shuffle partitions)

INDEX_LINEAGE_ENABLED = "hyperspace.index.lineage.enabled"
INDEX_LINEAGE_ENABLED_DEFAULT = False  # IndexConstants.scala:105-106

# Hybrid Scan (rules/hybrid.py): serve an index whose source has taken
# appends or deletes since the build, the appended files read from the
# source and unioned with the index scan, the deleted files' rows
# excluded through the lineage column. Off by default, as upstream.
INDEX_HYBRID_SCAN_ENABLED = "hyperspace.index.hybridscan.enabled"
INDEX_HYBRID_SCAN_ENABLED_DEFAULT = False
INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO = "hyperspace.index.hybridscan.maxAppendedRatio"
INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO_DEFAULT = 0.3  # IndexConstants.scala:44-52
INDEX_HYBRID_SCAN_MAX_DELETED_RATIO = "hyperspace.index.hybridscan.maxDeletedRatio"
INDEX_HYBRID_SCAN_MAX_DELETED_RATIO_DEFAULT = 0.2

INDEX_FILTER_RULE_USE_BUCKET_SPEC = "hyperspace.index.filterRule.useBucketSpec"
INDEX_FILTER_RULE_USE_BUCKET_SPEC_DEFAULT = False  # IndexConstants.scala:56-57

# Partition-first, pipelined build tail (indexes/covering_build.
# _write_bucketed_pipelined): the per-bucket runs of the card's sort go
# to one writer thread bucket by bucket, so the writes start before the
# whole sorted batch exists. The same bytes as the legacy route
# (bucketize, then write_bucket_files), which False restores.
INDEX_BUILD_PARTITION_FIRST = "hyperspace.index.build.partitionFirst"
INDEX_BUILD_PARTITION_FIRST_DEFAULT = True

# Out-of-core build (indexes/covering_build._write_bucketed_streaming, the
# z-order index's two-pass write): a source whose estimated materialized
# size exceeds this many bytes is read in waves within it, each bucket's
# (or z-range's) rows spilled to disk and merged at the end (0 = unbounded,
# one in-memory pass). The reference gets disk-backed spill from Spark's
# shuffle (covering/CoveringIndex.scala:58-61 repartition).
INDEX_BUILD_MEMORY_BUDGET = "hyperspace.index.build.memoryBudgetBytes"
INDEX_BUILD_MEMORY_BUDGET_DEFAULT = 0

# Sharded build and serve tail (reference constants.py:130-140): on a
# mesh of more than one shard each shard's bucket range runs its own sort
# and bucket-file writes (build) and its own prepare and match (serve),
# with a per-bucket union at the edge. The files and rows are the same
# either way; False restores the single tail. No effect on one shard.
BUILD_SHARDED_TAIL_ENABLED = "hyperspace.build.shardedTail.enabled"
BUILD_SHARDED_TAIL_ENABLED_DEFAULT = True

# Exchange strategy of the build's bucket shuffle (parallel/shuffle.py):
# auto | flat | compact | host | twostage, all with the same output;
# "auto" resolves per topology (shuffle.resolve_strategy).
BUILD_EXCHANGE_STRATEGY = "hyperspace.build.exchange.strategy"
BUILD_EXCHANGE_STRATEGY_DEFAULT = "auto"

# Simulated host count of the twostage exchange in one process (the flat
# mesh carved into this many groups of contiguous shards); 0 = the
# process count. A multi-process job always uses the process count.
BUILD_EXCHANGE_TWOSTAGE_HOSTS = "hyperspace.build.exchange.twostageHosts"
BUILD_EXCHANGE_TWOSTAGE_HOSTS_DEFAULT = 0

# Warn (once a build) when the exchange's per-(shard, peer) send-count
# skew (max/mean) exceeds this ratio on a slot of at least the row floor.
BUILD_SHUFFLE_SKEW_WARN_RATIO = 4.0
BUILD_SHUFFLE_SKEW_WARN_MIN_ROWS = 1 << 12

# Shards of the build plane; 0 = every shard of the session mesh, a
# positive value caps the build mesh to the first N.
BUILD_NUM_SHARDS = "hyperspace.build.numShards"
BUILD_NUM_SHARDS_DEFAULT = 0

# Explain rendering (DisplayMode.scala: plaintext / console / html)
EXPLAIN_DISPLAY_MODE = "hyperspace.explain.displayMode"
EXPLAIN_DISPLAY_MODE_DEFAULT = "plaintext"

# Lifecycle modes (Hyperspace.refreshIndex / optimizeIndex): optimize
# compacts the files of a bucket below the size threshold (quick) or all
# of them (full); refresh rebuilds (full), indexes the source's changes
# (incremental) or records them in the log alone (quick).
OPTIMIZE_FILE_SIZE_THRESHOLD = "hyperspace.index.optimize.fileSizeThreshold"
OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT = 256 * 1024 * 1024  # 256MB, :116-117
OPTIMIZE_MODE_QUICK = "quick"
OPTIMIZE_MODE_FULL = "full"
OPTIMIZE_MODES = (OPTIMIZE_MODE_QUICK, OPTIMIZE_MODE_FULL)

REFRESH_MODE_FULL = "full"
REFRESH_MODE_INCREMENTAL = "incremental"
REFRESH_MODE_QUICK = "quick"
REFRESH_MODES = (REFRESH_MODE_FULL, REFRESH_MODE_INCREMENTAL, REFRESH_MODE_QUICK)

INDEX_CACHE_EXPIRY_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
INDEX_CACHE_EXPIRY_SECONDS_DEFAULT = 300  # CachingIndexCollectionManager.scala

# Source providers, loaded from this list by sources/manager.py (reference
# FileBasedSourceProviderManager.scala:38-174); the port's own builders
INDEX_SOURCES_PROVIDERS = "hyperspace.index.sources.fileBasedBuilders"
INDEX_SOURCES_PROVIDERS_DEFAULT = (
    "hyperspace_tpu_torch.sources.default.DefaultFileBasedSourceBuilder,"
    "hyperspace_tpu_torch.sources.delta.DeltaLakeSourceBuilder,"
    "hyperspace_tpu_torch.sources.iceberg.IcebergSourceBuilder"
)

DEFAULT_SUPPORTED_FORMATS = "hyperspace.index.sources.defaultSupportedFormats"
# reference default: DefaultFileBasedSource.scala:76-85
DEFAULT_SUPPORTED_FORMATS_DEFAULT = "avro,csv,json,orc,parquet,text"

# Nested (struct) field indexing is opt-in, as in the reference
# (conf.supportNestedFields gate, actions/CreateAction.scala:69-71;
# flattened-name machinery in util/ResolverUtils.scala:130-234).
INDEX_SUPPORT_NESTED_FIELDS = "hyperspace.index.supportNestedFields"
INDEX_SUPPORT_NESTED_FIELDS_DEFAULT = False

# Range serve plane (executor._range_pruned_scan + indexes/zonemaps.py):
# zone-map pruning of index files and row groups under range/Eq/In
# conjuncts, and the fused range mask (kernel B3a). Superset-safe by
# construction (pruned scan == full scan + mask); the flag restores the
# unpruned path bit-identically.
SERVE_RANGEPRUNE_ENABLED = "hyperspace.serve.rangeprune.enabled"
SERVE_RANGEPRUNE_ENABLED_DEFAULT = True

# Pipelined join serve (executor._prepared_join_side +
# join_exec.prepare_join_side_pipelined): on a co-bucketed join over
# clean index-scan shapes the two sides prepare on two threads and each
# side's per-bucket reads overlap its per-bucket prepare. Bit-identical to
# the sequential route. The reference defaults it on; here it is off,
# because on the H100 host it measured slower than the sequential route
# (PERF.md section 5, scripts/torch_join_pipeline_turns.py).
SERVE_PIPELINE_ENABLED = "hyperspace.serve.pipeline.enabled"
SERVE_PIPELINE_ENABLED_DEFAULT = False

# Aggregate index plane (indexes/aggindex.py): the master switch for the
# ``_aggstate.json`` / ``_aggsample.parquet`` sidecars written at create,
# the metadata aggregate (execution/pipeline_compiler.
# try_metadata_aggregate) and the AggregateIndexRule rewrite of bare
# Aggregate∘Scan plans onto a covering index. Off: no capture, no
# metadata route, no rewrite.
INDEX_AGG_ENABLED = "hyperspace.index.agg.enabled"
INDEX_AGG_ENABLED_DEFAULT = True

# Grouped-partial capture cap: per row group, single-column grouped
# partials are captured only for fusable columns with at most this many
# distinct values there. A cap, never a correctness knob: a row group
# without a grouped entry is scanned at serve time.
INDEX_AGG_MAX_GROUPS = "hyperspace.index.agg.maxGroupsPerRowGroup"
INDEX_AGG_MAX_GROUPS_DEFAULT = 256

# Rows sampled per row group (seeded by file and row group) into the
# ``_aggsample.parquet`` sidecar of the approximate plane; 0 disables it.
INDEX_AGG_SAMPLE_ROWS = "hyperspace.index.agg.sampleRowsPerGroup"
INDEX_AGG_SAMPLE_ROWS_DEFAULT = 128

# Approximate serving (execution/approx_exec.py): sample-based COUNT/SUM
# estimates with 95% confidence intervals through the explicit
# ``DataFrame.collect_approx()``; never substituted for an exact answer.
# With the flag off ``collect_approx`` raises. The budget is the widest
# 95%-CI half-width relative to the estimate; wider raises
# ApproximationError (``collect_approx(max_rel_error=...)`` overrides).
SERVE_APPROX_ENABLED = "hyperspace.serve.approx.enabled"
SERVE_APPROX_ENABLED_DEFAULT = False
SERVE_APPROX_MAX_REL_ERROR = "hyperspace.serve.approx.maxRelativeError"
SERVE_APPROX_MAX_REL_ERROR_DEFAULT = 0.05

# Fused serve pipeline (execution/pipeline_compiler.py): a
# Filter(→Project)→Aggregate over a pruned index scan runs as one fused
# pass per row-group chunk (kernel B5f on the card), and a Filter over a
# scan compacts its passing rows in one pass (kernel B3b). Rows equal the
# interpreted chain's; False restores it.
SERVE_FUSEDPIPELINE_ENABLED = "hyperspace.serve.fusedpipeline.enabled"
SERVE_FUSEDPIPELINE_ENABLED_DEFAULT = True

# Serve-server mode (execution/serve_cache.py): an opt-in cache of
# decoded index data (scans, prepared join sides, zone maps, fused plans,
# aggregate state) in host RAM between queries, keyed by the immutable
# index file set, LRU-evicted by bytes.
SERVE_CACHE_ENABLED = "hyperspace.serve.cache.enabled"
SERVE_CACHE_ENABLED_DEFAULT = False
SERVE_CACHE_MAX_BYTES = "hyperspace.serve.cache.maxBytes"
SERVE_CACHE_MAX_BYTES_DEFAULT = 4 << 30  # 4 GiB

# Streaming per-bucket join serve (executor._exec_join_streaming): the
# co-bucketed join's prepared sides are read, prepared, matched (kernel B4)
# and released a wave of buckets at a time instead of held whole. Rows
# equal the materializing route's in order.
SERVE_STREAM_ENABLED = "hyperspace.serve.stream.enabled"
SERVE_STREAM_ENABLED_DEFAULT = False

# Wave budget of the streaming join: the estimated decoded bytes of the
# buckets of both sides in flight at once (footer row counts x projected
# columns x 8). A bucket larger than the budget runs as a wave of its own.
SERVE_STREAM_MAX_BYTES = "hyperspace.serve.stream.maxBytes"
SERVE_STREAM_MAX_BYTES_DEFAULT = 256 << 20  # 256 MiB

# Spill tier of the serve cache: evicted scans, bucketed batches, prepared
# join sides and hybrid deltas are written to fsync'd files under
# <system.path>/_hyperspace_spill/ and restored through mmap on the next
# miss instead of being re-read from parquet. 0 = off. The byte cap bounds
# the on-disk tier; the oldest files go first.
SERVE_SPILL_MAX_BYTES = "hyperspace.serve.spill.maxBytes"
SERVE_SPILL_MAX_BYTES_DEFAULT = 0

# Memory-mapped parquet reads (io/parquet.read_table): pyarrow maps the
# files instead of reading them onto the heap. Rows are the same either
# way.
IO_MMAP_ENABLED = "hyperspace.io.mmap.enabled"
IO_MMAP_ENABLED_DEFAULT = False

# Scanned rows at or above which the fused routes dispatch. The reference
# calibrates this per machine and keeps this value as the fallback; the
# port has no calibration probe (ROADMAP queue A item 10) and uses it as
# it is (pipeline_compiler._NATIVE_FUSED_PIPELINE_MIN_ROWS).
NATIVE_FUSED_PIPELINE_MIN_ROWS_DEFAULT = 1 << 15

# Z-order covering index (IndexConstants.scala:59-74): the build splits
# the z-sorted rows into ceil(bytes / target) files; quantile scaling
# replaces min/max scaling of the z-address words.
ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION = (
    "hyperspace.index.zorder.targetSourceBytesPerPartition"
)
ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION_DEFAULT = 1024 * 1024 * 1024
ZORDER_QUANTILE_ENABLED = "hyperspace.index.zorder.quantile.enabled"
ZORDER_QUANTILE_ENABLED_DEFAULT = False
ZORDER_QUANTILE_RELATIVE_ERROR = "hyperspace.index.zorder.quantile.relativeError"
ZORDER_QUANTILE_RELATIVE_ERROR_DEFAULT = 0.01

# ---------------------------------------------------------------------------
# Reserved column / property names
# ---------------------------------------------------------------------------

# File names written by the index data plane start with this prefix.
INDEX_FILE_PREFIX = "part"

# Lineage column (IndexConstants: DATA_FILE_NAME_ID = "_data_file_id")
DATA_FILE_NAME_ID = "_data_file_id"

# Index log directory + data-version prefix (IndexDataManager.scala:24-37)
HYPERSPACE_LOG_DIR = "_hyperspace_log"
# durable cross-process pins (metadata/recovery.register_pins): one
# lease-stamped file a pinning process and index root; a vacuum keeps it
HYPERSPACE_PINS_DIR = "_hyperspace_pins"
# orphan GC's quarantine, underscore-prefixed like the log dir so data
# scans never see it
HYPERSPACE_QUARANTINE_DIR = "_hyperspace_quarantine"
# the serve cache's spill tier under the system path; the recovery plane
# reaps expired spill files no live cache indexes, and GC skips the directory
HYPERSPACE_SPILL_DIR = "_hyperspace_spill"
INDEX_VERSION_DIR_PREFIX = "v__"
LATEST_STABLE_LOG_NAME = "latestStable"

# IndexLogEntry property keys
LINEAGE_PROPERTY = "lineage"
HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY = "hasParquetAsSourceFormat"
DELTA_VERSION_HISTORY_PROPERTY = "deltaVersions"

# Nested-column prefix (util/ResolverUtils.scala `__hs_nested.`)
NESTED_FIELD_PREFIX = "__hs_nested."


# ---------------------------------------------------------------------------
# Fault and crash injection (testing/faults.py) and crash recovery
# (metadata/recovery.py); keys and defaults as in the reference
# (hyperspace_tpu/constants.py:411-470)
# ---------------------------------------------------------------------------

# ``hyperspace.faults.<point>`` names an injection point with a spec such as
# "transient", "transient:3", "persistent" or "persistent;match=v__=". The
# keys arm nothing until ``faults.configure(session.conf)`` reads them.
FAULTS_KEY_PREFIX = "hyperspace.faults."

# ``hyperspace.faults.crash.<point>`` with "raise[;at=N][;match=substr]" (an
# in-process SimulatedCrash) or "exit[...]" (os._exit mid-protocol).
CRASH_KEY_PREFIX = "hyperspace.faults.crash."

# Master switch for the recovery plane: writer leases stamped into the
# transient log entries, stranded-entry rollback at action start and at
# session attach, latestStable healing and the OCC retry loop of
# Action.run. Off: a crashed writer strands the index until cancel().
RECOVERY_ENABLED = "hyperspace.recovery.enabled"
RECOVERY_ENABLED_DEFAULT = True

# Writer lease: a live action re-stamps its transient entry every
# leaseMs/3; an entry whose lease has expired belongs to a dead writer.
# Entries without lease properties fall back to timestamp + leaseMs.
RECOVERY_LEASE_MS = "hyperspace.recovery.leaseMs"
RECOVERY_LEASE_MS_DEFAULT = 60_000

# Orphan GC: unreferenced index data files move into
# <index>/_hyperspace_quarantine/<stamp>/ and are deleted once the stamp is
# older than this grace period.
RECOVERY_ORPHAN_GRACE_MS = "hyperspace.recovery.orphanGraceMs"
RECOVERY_ORPHAN_GRACE_MS_DEFAULT = 10 * 60_000

# An action that loses the write_log OCC race re-snapshots the log tip and
# retries, with exponential backoff from backoffMs, up to maxAttempts tries.
RECOVERY_RETRY_MAX_ATTEMPTS = "hyperspace.recovery.retry.maxAttempts"
RECOVERY_RETRY_MAX_ATTEMPTS_DEFAULT = 3
RECOVERY_RETRY_BACKOFF_MS = "hyperspace.recovery.retry.backoffMs"
RECOVERY_RETRY_BACKOFF_MS_DEFAULT = 10


# Age after which recovery's spill reaper deletes a spill file (or a torn
# .tmp_spool_ temp) that no live serve cache in this process indexes.
SERVE_SPILL_ORPHAN_TTL_MS = "hyperspace.serve.spill.orphanTtlMs"
SERVE_SPILL_ORPHAN_TTL_MS_DEFAULT = 10 * 60 * 1000

# -- concurrent serve frontend (serve/frontend.py) ----------------------------
# Worker threads answering queries concurrently. 0 = auto: min(32,
# 4 x cores); serve work is read-dominated, so oversubscribing cores keeps
# the scan pool fed while masks and merges run.
SERVE_MAX_CONCURRENCY = "hyperspace.serve.maxConcurrency"
SERVE_MAX_CONCURRENCY_DEFAULT = 0

# Admission control: queries queued (admitted but not yet running) beyond
# this bound are shed with a typed ServeOverloadedError. 0 = unbounded.
SERVE_MAX_QUEUE_DEPTH = "hyperspace.serve.maxQueueDepth"
SERVE_MAX_QUEUE_DEPTH_DEFAULT = 128

# Retry with backoff for transient failures at the serve operation
# boundary: maxAttempts tries in all, exponential backoff from backoffMs.
# Each retry re-pins the index snapshot, so a vacuum that removed the
# pinned version's files mid-query recovers onto the current version.
SERVE_RETRY_MAX_ATTEMPTS = "hyperspace.serve.retry.maxAttempts"
SERVE_RETRY_MAX_ATTEMPTS_DEFAULT = 3
SERVE_RETRY_BACKOFF_MS = "hyperspace.serve.retry.backoffMs"
SERVE_RETRY_BACKOFF_MS_DEFAULT = 10

# -- replicated serve fleet (serve/fleet.py, serve/bus.py) --------------------
# Master switch for fleet mode: N serve frontend processes over one index
# lake. Turns on durable query pins (lease-expiring files under
# <index>/_hyperspace_pins/), the index-version fanout bus under
# <system.path>/_hyperspace_fleet/, and cross-process single-flight (a
# fingerprint-keyed claim file and a bounded result spool).
FLEET_ENABLED = "hyperspace.fleet.enabled"
FLEET_ENABLED_DEFAULT = False

# Durable pin lease (register_pins(durable=True)): renewed every leaseMs/3;
# an expired pin file belongs to a dead reader and is reaped by GC/vacuum.
FLEET_PIN_LEASE_MS = "hyperspace.fleet.pin.leaseMs"
FLEET_PIN_LEASE_MS_DEFAULT = 30_000

# How often each subscribed frontend lists the bus directory, and how long
# event files live before the next publisher prunes them.
FLEET_BUS_POLL_MS = "hyperspace.fleet.bus.pollMs"
FLEET_BUS_POLL_MS_DEFAULT = 100
FLEET_BUS_RETAIN_MS = "hyperspace.fleet.bus.retainMs"
FLEET_BUS_RETAIN_MS_DEFAULT = 60_000

# Cross-process single-flight: identical plans elect one executor through an
# atomic claim file; losers wait up to waitMs for the spooled result before
# executing locally. claimMs bounds how long a dead winner's claim blocks.
FLEET_SINGLEFLIGHT_ENABLED = "hyperspace.fleet.singleflight.enabled"
FLEET_SINGLEFLIGHT_ENABLED_DEFAULT = True
FLEET_SINGLEFLIGHT_WAIT_MS = "hyperspace.fleet.singleflight.waitMs"
FLEET_SINGLEFLIGHT_WAIT_MS_DEFAULT = 5_000
FLEET_SINGLEFLIGHT_CLAIM_MS = "hyperspace.fleet.singleflight.claimMs"
FLEET_SINGLEFLIGHT_CLAIM_MS_DEFAULT = 10_000

# Result spool byte budget under <system.path>/_hyperspace_fleet/spool/;
# writers prune the oldest results past it.
FLEET_SPOOL_MAX_BYTES = "hyperspace.fleet.spool.maxBytes"
FLEET_SPOOL_MAX_BYTES_DEFAULT = 256 << 20  # 256 MiB

# Per-tenant SLO classes (a prefix family, like hyperspace.faults.):
# hyperspace.fleet.class.<name>.maxConcurrency caps the class's queries
# running at once (0 = unlimited; the rest wait without a worker thread),
# .maxQueueDepth sheds the class's admissions past that backlog, under the
# global hyperspace.serve.maxQueueDepth bound.
FLEET_CLASS_KEY_PREFIX = "hyperspace.fleet.class."

# -- fleet fast data plane (serve/fastbus.py, serve/router.py) ----------------
# A per-host push bus over Unix sockets announced through lease-stamped
# member files, and owner routing (rendezvous-hash the plan digest to one
# member, ship the plan spec, stream the Arrow result back). Every fast
# message is replayable from the durable planes: a dropped push costs a poll
# interval, a dead owner a fallback to the claim/spool path.
FLEET_FAST_ENABLED = "hyperspace.fleet.fast.enabled"
FLEET_FAST_ENABLED_DEFAULT = True
# Owner routing alone; off keeps the pushes but single-flight on the claims.
FLEET_FAST_ROUTING_ENABLED = "hyperspace.fleet.fast.routing.enabled"
FLEET_FAST_ROUTING_ENABLED_DEFAULT = True
# Round-trip budget of one owner-routed request; past it the durable plane.
FLEET_FAST_REQUEST_TIMEOUT_MS = "hyperspace.fleet.fast.requestTimeoutMs"
FLEET_FAST_REQUEST_TIMEOUT_MS_DEFAULT = 2_000
# Member lease, renewed every leaseMs/3; an expired member is reaped.
FLEET_FAST_MEMBER_LEASE_MS = "hyperspace.fleet.fast.memberLeaseMs"
FLEET_FAST_MEMBER_LEASE_MS_DEFAULT = 10_000
# Byte budget of each member's in-memory digest->result LRU (0 = off).
FLEET_FAST_RESULT_CACHE_BYTES = "hyperspace.fleet.fast.resultCacheBytes"
FLEET_FAST_RESULT_CACHE_BYTES_DEFAULT = 64 << 20  # 64 MiB
# Cadence of the per-class queue-depth gossip to live peers.
FLEET_FAST_GOSSIP_MS = "hyperspace.fleet.fast.gossipMs"
FLEET_FAST_GOSSIP_MS_DEFAULT = 50
# The class queue-depth bound counts live peers' gossiped depths too.
FLEET_FAST_SLO_FLEET_WIDE = "hyperspace.fleet.fast.sloFleetWide"
FLEET_FAST_SLO_FLEET_WIDE_DEFAULT = True

# Fleet coordination directory under the system path: bus/ events, spool/
# single-flight claims and results, members/ fast-plane member files.
HYPERSPACE_FLEET_DIR = "_hyperspace_fleet"

# -- execution tuning keys the port reads nowhere ------------------------------
# The reference evaluates a filter on its host path below this row count and
# on the device at or above it (its measured host-device round trip). The
# port always evaluates the mask on the session's device
# (execution/executor._filter_mask): setting the key changes neither rows
# nor route. Left out on purpose, beside deviceJoinMinRows (ROADMAP A.11).
EXECUTION_DEVICE_FILTER_MIN_ROWS = "hyperspace.execution.deviceFilterMinRows"
EXECUTION_DEVICE_FILTER_MIN_ROWS_DEFAULT = 8_000_000

# -- profiling and telemetry events -------------------------------------------
# When set, session.execute runs each query under torch.profiler and writes a
# Chrome trace into this directory (CPU activity, plus CUDA activity on a
# CUDA session). Empty = off.
PROFILE_TRACE_DIR = "hyperspace.profile.traceDir"
PROFILE_TRACE_DIR_DEFAULT = ""

# Pluggable telemetry event logger (telemetry.EventLogging), a dotted class
# path; empty = the no-op EventLogger.
EVENT_LOGGER_CLASS = "hyperspace.eventLoggerClass"
EVENT_LOGGER_CLASS_DEFAULT = ""

# -- observability plane (obs/) -----------------------------------------------
# Master switch for structured tracing: every lifecycle action gets one root
# span with child stage spans mirroring the breakdown keys
# (session.build_stats / session.join_stats). Off (the default): every obs
# call site is one module-bool check.
OBS_ENABLED = "hyperspace.obs.enabled"
OBS_ENABLED_DEFAULT = False

# Durable query log (obs/querylog.py): per-process JSONL files under
# <system.path>/_hyperspace_obs/, rotated past maxBytes (fsync before the
# rename; the mid_querylog_rotate crash point), at most maxFiles sealed
# segments a process.
OBS_QUERYLOG_ENABLED = "hyperspace.obs.querylog.enabled"
OBS_QUERYLOG_ENABLED_DEFAULT = True
OBS_QUERYLOG_MAX_BYTES = "hyperspace.obs.querylog.maxBytes"
OBS_QUERYLOG_MAX_BYTES_DEFAULT = 4 << 20
OBS_QUERYLOG_MAX_FILES = "hyperspace.obs.querylog.maxFiles"
OBS_QUERYLOG_MAX_FILES_DEFAULT = 8

# Trace bounds (obs/trace.py): child spans kept a trace (the rest counted in
# the root's spans_dropped) and finished traces kept in memory.
OBS_TRACE_MAX_SPANS = "hyperspace.obs.trace.maxSpans"
OBS_TRACE_MAX_SPANS_DEFAULT = 512
OBS_TRACE_RETAIN = "hyperspace.obs.trace.retain"
OBS_TRACE_RETAIN_DEFAULT = 256

# JSONL path of telemetry.JsonlEventLogger; empty =
# <system.path>/_hyperspace_obs/events.<pid>.jsonl.
OBS_EVENTLOG_PATH = "hyperspace.obs.eventlog.path"
OBS_EVENTLOG_PATH_DEFAULT = ""

# Replayable plan specs in query-log records (obs/planspec.py). Specs carry
# literals, unlike the scrubbed predicate shape, so this is opt-in.
OBS_QUERYLOG_RECORD_PLANS = "hyperspace.obs.querylog.recordPlans"
OBS_QUERYLOG_RECORD_PLANS_DEFAULT = False

# Observability sidecar directory under the system path.
HYPERSPACE_OBS_DIR = "_hyperspace_obs"
