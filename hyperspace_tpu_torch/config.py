"""Typed config system.

Reference: ``util/HyperspaceConf.scala:27-238`` — typed accessors over flat
string-keyed Spark SQL confs. Counterpart of ``hyperspace_tpu/config.py``
trimmed to the accessors this slice reads; defaults come from
:mod:`hyperspace_tpu_torch.constants`.
"""

from __future__ import annotations

from typing import Any, Optional

from hyperspace_tpu_torch import constants as C


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


class Config:
    """Flat key→value config with typed accessors."""

    def __init__(self, initial: Optional[dict] = None):
        self._values: dict = dict(initial or {})

    # -- raw access ---------------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        self._values[key] = value

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
    def support_nested_fields(self) -> bool:
        return self.get_bool(
            C.INDEX_SUPPORT_NESTED_FIELDS,
            C.INDEX_SUPPORT_NESTED_FIELDS_DEFAULT,
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
