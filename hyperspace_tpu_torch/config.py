"""Typed config system.

Reference: ``util/HyperspaceConf.scala:27-238`` — typed accessors over flat
string-keyed Spark SQL confs. Counterpart of ``hyperspace_tpu/config.py``
trimmed to the accessors this slice reads; defaults come from
:mod:`hyperspace_tpu_torch.constants`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from hyperspace_tpu_torch import constants as C


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


class Config:
    """Flat key→value config with typed accessors and change tracking.

    ``version`` increments on every mutation; caches keyed on config state
    (``CacheWithTransform``, reference ``util/CacheWithTransform.scala``)
    compare it to decide invalidation.
    """

    def __init__(self, initial: Optional[dict] = None):
        self._values: dict = dict(initial or {})
        self.version = 0

    # -- raw access ---------------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        self._values[key] = value
        self.version += 1

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def get_bool(self, key: str, default: bool = False) -> bool:
        return _to_bool(self._values.get(key, default))

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self._values.get(key, default))

    def get_str(self, key: str, default: str = "") -> str:
        return str(self._values.get(key, default))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self._values.get(key, default))

    def prefixed(self, prefix: str) -> dict:
        """All ``{key: value}`` pairs whose key starts with ``prefix`` (the
        fault registry, ``testing/faults.configure``, scans
        ``hyperspace.faults.*`` through this), over a snapshot of the
        values."""
        return {k: v for k, v in list(self._values.items()) if k.startswith(prefix)}

    # -- typed accessors (HyperspaceConf.scala) -----------------------------
    @property
    def apply_enabled(self) -> bool:
        return self.get_bool(
            C.HYPERSPACE_APPLY_ENABLED, C.HYPERSPACE_APPLY_ENABLED_DEFAULT
        )

    @property
    def system_path(self) -> str:
        return self.get_str(C.INDEX_SYSTEM_PATH, C.INDEX_SYSTEM_PATH_DEFAULT)

    @property
    def num_buckets(self) -> int:
        return self.get_int(C.INDEX_NUM_BUCKETS, C.INDEX_NUM_BUCKETS_DEFAULT)

    @property
    def lineage_enabled(self) -> bool:
        return self.get_bool(
            C.INDEX_LINEAGE_ENABLED, C.INDEX_LINEAGE_ENABLED_DEFAULT
        )

    @property
    def optimize_file_size_threshold(self) -> int:
        return self.get_int(
            C.OPTIMIZE_FILE_SIZE_THRESHOLD, C.OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT
        )

    @property
    def filter_rule_use_bucket_spec(self) -> bool:
        return self.get_bool(
            C.INDEX_FILTER_RULE_USE_BUCKET_SPEC,
            C.INDEX_FILTER_RULE_USE_BUCKET_SPEC_DEFAULT,
        )

    @property
    def cache_expiry_seconds(self) -> int:
        return self.get_int(
            C.INDEX_CACHE_EXPIRY_SECONDS, C.INDEX_CACHE_EXPIRY_SECONDS_DEFAULT
        )

    @property
    def source_provider_builders(self) -> list:
        raw = self.get_str(
            C.INDEX_SOURCES_PROVIDERS, C.INDEX_SOURCES_PROVIDERS_DEFAULT
        )
        return [s.strip() for s in raw.split(",") if s.strip()]

    @property
    def default_supported_formats(self) -> set:
        raw = self.get_str(
            C.DEFAULT_SUPPORTED_FORMATS, C.DEFAULT_SUPPORTED_FORMATS_DEFAULT
        )
        return {s.strip().lower() for s in raw.split(",") if s.strip()}

    @property
    def support_nested_fields(self) -> bool:
        return self.get_bool(
            C.INDEX_SUPPORT_NESTED_FIELDS,
            C.INDEX_SUPPORT_NESTED_FIELDS_DEFAULT,
        )

    @property
    def hybrid_scan_enabled(self) -> bool:
        return self.get_bool(
            C.INDEX_HYBRID_SCAN_ENABLED, C.INDEX_HYBRID_SCAN_ENABLED_DEFAULT
        )

    @property
    def hybrid_scan_max_appended_ratio(self) -> float:
        return self.get_float(
            C.INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO,
            C.INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO_DEFAULT,
        )

    @property
    def hybrid_scan_max_deleted_ratio(self) -> float:
        return self.get_float(
            C.INDEX_HYBRID_SCAN_MAX_DELETED_RATIO,
            C.INDEX_HYBRID_SCAN_MAX_DELETED_RATIO_DEFAULT,
        )

    @property
    def build_memory_budget(self) -> int:
        """Max bytes materialized per build wave (0 = unbounded)."""
        return self.get_int(
            C.INDEX_BUILD_MEMORY_BUDGET, C.INDEX_BUILD_MEMORY_BUDGET_DEFAULT
        )

    @property
    def build_num_shards(self) -> int:
        """Shards of the build plane (0 = the whole session mesh); a
        positive value caps the build mesh to the first N shards."""
        return self.get_int(C.BUILD_NUM_SHARDS, C.BUILD_NUM_SHARDS_DEFAULT)

    @property
    def build_exchange_strategy(self) -> str:
        """Exchange strategy of the build's bucket shuffle
        (``parallel/shuffle.py``): ``auto`` | ``flat`` | ``compact`` |
        ``host`` | ``twostage``, all with the same output; ``auto``
        resolves per topology (``shuffle.resolve_strategy``)."""
        return self.get_str(C.BUILD_EXCHANGE_STRATEGY, C.BUILD_EXCHANGE_STRATEGY_DEFAULT)

    @property
    def build_exchange_twostage_hosts(self) -> int:
        """Simulated host count of the twostage exchange in one process
        (0 = the process count)."""
        return self.get_int(
            C.BUILD_EXCHANGE_TWOSTAGE_HOSTS, C.BUILD_EXCHANGE_TWOSTAGE_HOSTS_DEFAULT
        )

    @property
    def build_sharded_tail(self) -> bool:
        """The sharded build and serve tail on a mesh of more than one
        shard (the same files and rows as the single tail, which False
        restores)."""
        return self.get_bool(
            C.BUILD_SHARDED_TAIL_ENABLED, C.BUILD_SHARDED_TAIL_ENABLED_DEFAULT
        )

    @property
    def explain_display_mode(self) -> str:
        return self.get_str(C.EXPLAIN_DISPLAY_MODE, C.EXPLAIN_DISPLAY_MODE_DEFAULT)

    @property
    def build_partition_first(self) -> bool:
        """The pipelined partition-first build tail (the same bytes as the
        legacy route; False takes the legacy route)."""
        return self.get_bool(
            C.INDEX_BUILD_PARTITION_FIRST, C.INDEX_BUILD_PARTITION_FIRST_DEFAULT
        )

    @property
    def serve_approx_enabled(self) -> bool:
        """Explicit opt-in for sample-based approximate aggregates
        (``DataFrame.collect_approx``); never substituted for exact."""
        return self.get_bool(C.SERVE_APPROX_ENABLED, C.SERVE_APPROX_ENABLED_DEFAULT)

    @property
    def serve_approx_max_rel_error(self) -> float:
        """Widest acceptable 95%-CI half-width relative to the estimate."""
        return max(
            0.0,
            self.get_float(
                C.SERVE_APPROX_MAX_REL_ERROR, C.SERVE_APPROX_MAX_REL_ERROR_DEFAULT
            ),
        )

    @property
    def serve_rangeprune_enabled(self) -> bool:
        return self.get_bool(
            C.SERVE_RANGEPRUNE_ENABLED, C.SERVE_RANGEPRUNE_ENABLED_DEFAULT
        )

    @property
    def serve_pipeline_enabled(self) -> bool:
        return self.get_bool(
            C.SERVE_PIPELINE_ENABLED, C.SERVE_PIPELINE_ENABLED_DEFAULT
        )

    @property
    def index_agg_enabled(self) -> bool:
        """The aggregate index plane: sidecar capture at create, the
        metadata aggregate and the AggregateIndexRule rewrite."""
        return self.get_bool(C.INDEX_AGG_ENABLED, C.INDEX_AGG_ENABLED_DEFAULT)

    @property
    def index_agg_max_groups(self) -> int:
        """Per-row-group distinct-value cap for grouped-partial capture."""
        return max(
            0, self.get_int(C.INDEX_AGG_MAX_GROUPS, C.INDEX_AGG_MAX_GROUPS_DEFAULT)
        )

    @property
    def index_agg_sample_rows(self) -> int:
        """Stratified-sample rows captured per row group (0 = none)."""
        return max(
            0, self.get_int(C.INDEX_AGG_SAMPLE_ROWS, C.INDEX_AGG_SAMPLE_ROWS_DEFAULT)
        )

    @property
    def serve_fusedpipeline_enabled(self) -> bool:
        """The fused filter→aggregate and filter→select routes."""
        return self.get_bool(
            C.SERVE_FUSEDPIPELINE_ENABLED, C.SERVE_FUSEDPIPELINE_ENABLED_DEFAULT
        )

    @property
    def serve_cache_enabled(self) -> bool:
        return self.get_bool(C.SERVE_CACHE_ENABLED, C.SERVE_CACHE_ENABLED_DEFAULT)

    @property
    def serve_cache_max_bytes(self) -> int:
        return self.get_int(C.SERVE_CACHE_MAX_BYTES, C.SERVE_CACHE_MAX_BYTES_DEFAULT)

    @property
    def serve_stream_enabled(self) -> bool:
        """The streaming per-bucket join serve: prepared sides a wave of
        buckets at a time; rows equal the materializing route's."""
        return self.get_bool(C.SERVE_STREAM_ENABLED, C.SERVE_STREAM_ENABLED_DEFAULT)

    @property
    def serve_stream_max_bytes(self) -> int:
        """Wave budget: estimated decoded bytes of the buckets in flight."""
        return max(
            1, self.get_int(C.SERVE_STREAM_MAX_BYTES, C.SERVE_STREAM_MAX_BYTES_DEFAULT)
        )

    @property
    def serve_spill_max_bytes(self) -> int:
        """The serve cache's on-disk spill tier byte cap (0 = spill off)."""
        return max(
            0, self.get_int(C.SERVE_SPILL_MAX_BYTES, C.SERVE_SPILL_MAX_BYTES_DEFAULT)
        )

    @property
    def io_mmap_enabled(self) -> bool:
        """Memory-mapped parquet reads (io/parquet.read_table)."""
        return self.get_bool(C.IO_MMAP_ENABLED, C.IO_MMAP_ENABLED_DEFAULT)

    @property
    def zorder_target_source_bytes_per_partition(self) -> int:
        return self.get_int(
            C.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION,
            C.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION_DEFAULT,
        )

    @property
    def zorder_quantile_enabled(self) -> bool:
        return self.get_bool(
            C.ZORDER_QUANTILE_ENABLED, C.ZORDER_QUANTILE_ENABLED_DEFAULT
        )

    @property
    def zorder_quantile_relative_error(self) -> float:
        return self.get_float(
            C.ZORDER_QUANTILE_RELATIVE_ERROR,
            C.ZORDER_QUANTILE_RELATIVE_ERROR_DEFAULT,
        )

    # -- crash recovery (metadata/recovery.py) ------------------------------
    @property
    def recovery_enabled(self) -> bool:
        """Writer leases, stranded-entry rollback, stale-pointer healing
        and the OCC retry loop of Action.run."""
        return self.get_bool(C.RECOVERY_ENABLED, C.RECOVERY_ENABLED_DEFAULT)

    @property
    def recovery_lease_ms(self) -> int:
        return max(1, self.get_int(C.RECOVERY_LEASE_MS, C.RECOVERY_LEASE_MS_DEFAULT))

    @property
    def recovery_orphan_grace_ms(self) -> int:
        return max(
            0,
            self.get_int(C.RECOVERY_ORPHAN_GRACE_MS, C.RECOVERY_ORPHAN_GRACE_MS_DEFAULT),
        )

    @property
    def recovery_retry_max_attempts(self) -> int:
        return max(
            1,
            self.get_int(
                C.RECOVERY_RETRY_MAX_ATTEMPTS, C.RECOVERY_RETRY_MAX_ATTEMPTS_DEFAULT
            ),
        )

    @property
    def recovery_retry_backoff_ms(self) -> int:
        return max(
            0,
            self.get_int(C.RECOVERY_RETRY_BACKOFF_MS, C.RECOVERY_RETRY_BACKOFF_MS_DEFAULT),
        )

    @property
    def serve_spill_orphan_ttl_ms(self) -> int:
        """Age after which an orphaned spill file is reaped."""
        return max(
            1,
            self.get_int(C.SERVE_SPILL_ORPHAN_TTL_MS, C.SERVE_SPILL_ORPHAN_TTL_MS_DEFAULT),
        )

    # -- concurrent serve frontend (serve/frontend.py) -------------------------
    @property
    def serve_max_concurrency(self) -> int:
        """Serve-frontend worker threads (0 = auto-size)."""
        n = self.get_int(C.SERVE_MAX_CONCURRENCY, C.SERVE_MAX_CONCURRENCY_DEFAULT)
        if n > 0:
            return n
        import os

        return min(32, 4 * (os.cpu_count() or 1))

    @property
    def serve_max_queue_depth(self) -> int:
        return self.get_int(C.SERVE_MAX_QUEUE_DEPTH, C.SERVE_MAX_QUEUE_DEPTH_DEFAULT)

    @property
    def serve_retry_max_attempts(self) -> int:
        return max(
            1, self.get_int(C.SERVE_RETRY_MAX_ATTEMPTS, C.SERVE_RETRY_MAX_ATTEMPTS_DEFAULT)
        )

    @property
    def serve_retry_backoff_ms(self) -> int:
        return max(0, self.get_int(C.SERVE_RETRY_BACKOFF_MS, C.SERVE_RETRY_BACKOFF_MS_DEFAULT))

    # -- replicated serve fleet (serve/fleet.py, serve/bus.py) ----------------
    @property
    def fleet_enabled(self) -> bool:
        """Fleet mode: durable cross-process pins, the index-version fanout
        bus, cross-process single-flight."""
        return self.get_bool(C.FLEET_ENABLED, C.FLEET_ENABLED_DEFAULT)

    @property
    def fleet_pin_lease_ms(self) -> int:
        return max(1, self.get_int(C.FLEET_PIN_LEASE_MS, C.FLEET_PIN_LEASE_MS_DEFAULT))

    @property
    def fleet_bus_poll_ms(self) -> int:
        return max(1, self.get_int(C.FLEET_BUS_POLL_MS, C.FLEET_BUS_POLL_MS_DEFAULT))

    @property
    def fleet_bus_retain_ms(self) -> int:
        return max(0, self.get_int(C.FLEET_BUS_RETAIN_MS, C.FLEET_BUS_RETAIN_MS_DEFAULT))

    @property
    def fleet_singleflight_enabled(self) -> bool:
        return self.get_bool(
            C.FLEET_SINGLEFLIGHT_ENABLED, C.FLEET_SINGLEFLIGHT_ENABLED_DEFAULT
        )

    @property
    def fleet_singleflight_wait_ms(self) -> int:
        return max(
            0, self.get_int(C.FLEET_SINGLEFLIGHT_WAIT_MS, C.FLEET_SINGLEFLIGHT_WAIT_MS_DEFAULT)
        )

    @property
    def fleet_singleflight_claim_ms(self) -> int:
        return max(
            1,
            self.get_int(C.FLEET_SINGLEFLIGHT_CLAIM_MS, C.FLEET_SINGLEFLIGHT_CLAIM_MS_DEFAULT),
        )

    @property
    def fleet_spool_max_bytes(self) -> int:
        return max(0, self.get_int(C.FLEET_SPOOL_MAX_BYTES, C.FLEET_SPOOL_MAX_BYTES_DEFAULT))

    # -- fleet fast data plane (serve/fastbus.py, serve/router.py) ------------
    @property
    def fleet_fast_enabled(self) -> bool:
        """The push bus and owner routing over the durable fleet planes."""
        return self.get_bool(C.FLEET_FAST_ENABLED, C.FLEET_FAST_ENABLED_DEFAULT)

    @property
    def fleet_fast_routing_enabled(self) -> bool:
        return self.get_bool(
            C.FLEET_FAST_ROUTING_ENABLED, C.FLEET_FAST_ROUTING_ENABLED_DEFAULT
        )

    @property
    def fleet_fast_request_timeout_ms(self) -> int:
        return max(
            1,
            self.get_int(
                C.FLEET_FAST_REQUEST_TIMEOUT_MS, C.FLEET_FAST_REQUEST_TIMEOUT_MS_DEFAULT
            ),
        )

    @property
    def fleet_fast_member_lease_ms(self) -> int:
        return max(
            1,
            self.get_int(C.FLEET_FAST_MEMBER_LEASE_MS, C.FLEET_FAST_MEMBER_LEASE_MS_DEFAULT),
        )

    @property
    def fleet_fast_result_cache_bytes(self) -> int:
        return max(
            0,
            self.get_int(
                C.FLEET_FAST_RESULT_CACHE_BYTES, C.FLEET_FAST_RESULT_CACHE_BYTES_DEFAULT
            ),
        )

    @property
    def fleet_fast_gossip_ms(self) -> int:
        return max(1, self.get_int(C.FLEET_FAST_GOSSIP_MS, C.FLEET_FAST_GOSSIP_MS_DEFAULT))

    @property
    def fleet_fast_slo_fleet_wide(self) -> bool:
        return self.get_bool(C.FLEET_FAST_SLO_FLEET_WIDE, C.FLEET_FAST_SLO_FLEET_WIDE_DEFAULT)

    @property
    def fleet_slo_classes(self) -> dict:
        """``{class name: (max_concurrency, max_queue_depth)}`` from the
        ``hyperspace.fleet.class.<name>.{maxConcurrency,maxQueueDepth}``
        prefix family (0 = unlimited for either bound)."""
        out: dict = {}
        prefix = C.FLEET_CLASS_KEY_PREFIX
        for key, value in self.prefixed(prefix).items():
            name, _, attr = key[len(prefix):].rpartition(".")
            if not name:
                continue
            caps = out.setdefault(name, [0, 0])
            try:
                if attr == "maxConcurrency":
                    caps[0] = max(0, int(value))
                elif attr == "maxQueueDepth":
                    caps[1] = max(0, int(value))
            except (TypeError, ValueError):
                continue
        return {name: (c[0], c[1]) for name, c in out.items()}

    @property
    def profile_trace_dir(self) -> str:
        return self.get_str(C.PROFILE_TRACE_DIR, C.PROFILE_TRACE_DIR_DEFAULT)

    # -- observability plane (obs/) -------------------------------------------
    @property
    def obs_enabled(self) -> bool:
        """Structured tracing and the query log; off is the one-bool-check
        path with bit-identical serve behaviour."""
        return self.get_bool(C.OBS_ENABLED, C.OBS_ENABLED_DEFAULT)

    @property
    def obs_querylog_enabled(self) -> bool:
        return self.get_bool(C.OBS_QUERYLOG_ENABLED, C.OBS_QUERYLOG_ENABLED_DEFAULT)

    @property
    def obs_querylog_max_bytes(self) -> int:
        return max(1, self.get_int(C.OBS_QUERYLOG_MAX_BYTES, C.OBS_QUERYLOG_MAX_BYTES_DEFAULT))

    @property
    def obs_querylog_max_files(self) -> int:
        return max(1, self.get_int(C.OBS_QUERYLOG_MAX_FILES, C.OBS_QUERYLOG_MAX_FILES_DEFAULT))

    @property
    def obs_trace_max_spans(self) -> int:
        return max(1, self.get_int(C.OBS_TRACE_MAX_SPANS, C.OBS_TRACE_MAX_SPANS_DEFAULT))

    @property
    def obs_trace_retain(self) -> int:
        return max(1, self.get_int(C.OBS_TRACE_RETAIN, C.OBS_TRACE_RETAIN_DEFAULT))

    @property
    def obs_eventlog_path(self) -> str:
        return self.get_str(C.OBS_EVENTLOG_PATH, C.OBS_EVENTLOG_PATH_DEFAULT)

    @property
    def obs_querylog_record_plans(self) -> bool:
        """Replayable plan specs in query-log records (they carry literals)."""
        return self.get_bool(C.OBS_QUERYLOG_RECORD_PLANS, C.OBS_QUERYLOG_RECORD_PLANS_DEFAULT)


class CacheWithTransform:
    """Caches ``transform(conf)`` until the config is mutated.

    Reference: ``util/CacheWithTransform.scala:45`` — the source-provider
    list is rebuilt only when the backing conf changes.
    """

    def __init__(self, conf: Config, transform: Callable[[Config], Any]):
        self._conf = conf
        self._transform = transform
        self._cached = None
        self._cached_version = -1

    def load(self) -> Any:
        if self._cached_version != self._conf.version:
            self._cached = self._transform(self._conf)
            self._cached_version = self._conf.version
        return self._cached
