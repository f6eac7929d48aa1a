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

INDEX_FILTER_RULE_USE_BUCKET_SPEC = "hyperspace.index.filterRule.useBucketSpec"
INDEX_FILTER_RULE_USE_BUCKET_SPEC_DEFAULT = False  # IndexConstants.scala:56-57

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

# Fused serve pipeline (execution/pipeline_compiler.py): a
# Filter(→Project)→Aggregate over a pruned index scan runs as one fused
# pass per row-group chunk (kernel B5f on the card), and a Filter over a
# scan compacts its passing rows in one pass (kernel B3b). Rows equal the
# interpreted chain's; False restores it.
SERVE_FUSEDPIPELINE_ENABLED = "hyperspace.serve.fusedpipeline.enabled"
SERVE_FUSEDPIPELINE_ENABLED_DEFAULT = True

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
# the serve cache's spill tier under the system path (ROADMAP A.8); the
# recovery plane reaps expired spill files and GC skips the directory
HYPERSPACE_SPILL_DIR = "_hyperspace_spill"
INDEX_VERSION_DIR_PREFIX = "v__"
LATEST_STABLE_LOG_NAME = "latestStable"

# IndexLogEntry property keys
LINEAGE_PROPERTY = "lineage"
HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY = "hasParquetAsSourceFormat"

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

# Durable pin lease (register_pins(durable=True)): renewed every leaseMs/3;
# an expired pin file belongs to a dead reader and is reaped by GC/vacuum.
# Its key, hyperspace.fleet.pin.leaseMs, comes with the serve tier that sets
# it (ROADMAP A.10).
FLEET_PIN_LEASE_MS_DEFAULT = 30_000

# Age after which recovery's spill reaper deletes a spill file no live
# cache indexes.
SERVE_SPILL_ORPHAN_TTL_MS = "hyperspace.serve.spill.orphanTtlMs"
SERVE_SPILL_ORPHAN_TTL_MS_DEFAULT = 10 * 60 * 1000
