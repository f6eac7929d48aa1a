"""ALLOC_SITES — the registry of row-proportional allocation sites.

Counterpart of ``hyperspace_tpu/memory.py``, naming the port's
allocating functions (the reference's ``_exec_bucketed`` and
``_bucket_stream`` are one function in the port, ``_bucket_fetches``; the
advisor's entry comes with it, ROADMAP A.10c). A torch tensor weighs
``numel() * element_size()`` bytes in the residency witness.

The KERNEL_TWINS / SHARED_STATE doctrine applied to resident bytes:
every hot-path function that materializes memory proportional to
relation size (a full parquet read, an arrow->numpy decode, a
concatenated prepared side, an ``np.empty(n_rows, ...)``) is declared
HERE, together with the *plane* it runs on and the *bound class* that
keeps its resident set finite — so "what stops this allocation from
growing past RAM?" is a mechanical question (``hslint`` HS10xx,
``analysis/residency.py``), not an archaeology project. The runtime
residency witness (``testing/residency_witness.py``) wraps the sites
named here, records per-site peak bytes + process RSS high-water, and
``hslint --witness`` cross-checks what actually happened against this
model. The out-of-core arc (ROADMAP item 1: budgeted streaming, spill)
changes DECLARED bounds in this file instead of hunting for hidden
materializations.

Entry shape::

    "<dotted path of the allocating function/method>": (
        "<plane: build | serve | maintenance>",
        "<bound class>",
        "<one-line justification — why this bound holds>",
    )

Site paths name a module-level function
(``hyperspace_tpu_torch.io.parquet.read_table``), a class method
(``hyperspace_tpu_torch.execution.join_exec.PreparedJoinSide.subset``) or a
module (import-time allocation). Bound classes:

``cache-governed``
    The materialized value flows into the ``ServeCache`` byte governor
    (``execution/serve_cache.py``): residency is bounded by the cache
    budget, eviction frees it. HS1002 flags a declared site whose value
    never flows through a ``.put(...)`` (in the site or a direct
    caller).
``wave-budget``
    Bounded by the in-flight wave of a pooled fan-out (the scan pool's
    bounded worker count times per-unit size). HS1002 requires the
    site to reference the wave/budget/pool machinery.
``chunk-bounded``
    Allocated per chunk inside an explicit chunk loop; peak residency
    is one chunk plus the reduced accumulator. HS1002 flags a declared
    site with no loop.
``row-group-bounded``
    Proportional to one parquet row group (``io/parquet.py``
    INDEX_ROW_GROUP_SIZE rows), not the relation. HS1002 requires the
    site to touch the row-group read path.
``const-bounded``
    O(1) or O(schema) — statistics, offsets, per-file footers summary;
    grows with column/file *count* ceilings that config caps, never
    with row count. No structural check; the justification carries it.
``spill-bounded``
    Bounded by the on-disk spill tier budget
    (``hyperspace.serve.spill.maxBytes``): the materialized value is a
    zero-copy view of a memory-mapped spill file whose resident charge
    is the O(1) mmap token, with real residency governed by the page
    cache. HS1002 requires the site to reference the spill machinery.

The witness gates each class against ``BOUND_CLASS_CEILINGS`` below:
an observed per-site peak past its class ceiling is a hard HS1004
error, the same doctrine as a witnessed lock edge the static model
lacks.

Keep this module stdlib-only and import-cheap: the analyzer parses it
(never imports it) and the residency witness imports it inside test
processes before any session exists.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: planes an allocation site may run on
PLANES = ("build", "serve", "maintenance")

#: the six declared bound classes (see module doc)
BOUND_CLASSES = (
    "cache-governed",
    "wave-budget",
    "chunk-bounded",
    "row-group-bounded",
    "const-bounded",
    "spill-bounded",
)

#: per-class byte ceilings the runtime witness gates on (HS1004): an
#: observed per-site peak past its declared class ceiling hard-errors.
#: cache-governed mirrors the serve-cache default budget
#: (constants.SERVE_CACHE_MAX_BYTES_DEFAULT); the rest are the
#: engineering envelopes the out-of-core arc will tighten.
BOUND_CLASS_CEILINGS: Dict[str, int] = {
    "cache-governed": 4 << 30,
    "wave-budget": 1 << 30,
    "chunk-bounded": 512 << 20,
    "row-group-bounded": 256 << 20,
    "const-bounded": 64 << 20,
    "spill-bounded": 512 << 20,
}

ALLOC_SITES: Dict[str, Tuple[str, str, str]] = {
    # -- io: the read primitives ---------------------------------------------
    "hyperspace_tpu_torch.io.parquet.read_table": (
        "serve",
        "cache-governed",
        "materializes exactly the pruned file selection the planner "
        "chose; every serve-path caller publishes the decoded result "
        "into the ServeCache byte governor or holds a per-chunk slice",
    ),
    "hyperspace_tpu_torch.io.parquet.read_table_row_groups": (
        "serve",
        "row-group-bounded",
        "reads only the selected row groups, fanned per file through "
        "the bounded scan pool; residency is selection-, not "
        "relation-proportional",
    ),
    "hyperspace_tpu_torch.io.columnar.Column.from_arrow": (
        "serve",
        "cache-governed",
        "arrow->numpy decode of one column of whatever table the "
        "caller read; decoded columns live in ServeCache entries "
        "(ScanCacheEntry) whose budget_nbytes pre-charges them",
    ),
    "hyperspace_tpu_torch.io.columnar.Column.concat": (
        "serve",
        "cache-governed",
        "concatenates per-file column pieces into the one decoded copy "
        "the scan/joinside cache entries charge against the governor",
    ),
    "hyperspace_tpu_torch.io.columnar.ColumnarBatch.from_arrow": (
        "serve",
        "cache-governed",
        "per-column decode of a read table; the batch is what the "
        "serve cache charges (batch_nbytes/estimate_nbytes)",
    ),
    # -- serve-plane prepared state ------------------------------------------
    "hyperspace_tpu_torch.execution.join_exec.prepare_join_side": (
        "serve",
        "cache-governed",
        "the prepared side (concat batch, combined keys, offsets, "
        "memoized sort permutations) is pre-charged via "
        "PreparedJoinSide.nbytes and put into ServeCache",
    ),
    "hyperspace_tpu_torch.execution.join_exec.prepare_join_side_pipelined": (
        "serve",
        "cache-governed",
        "streaming twin of prepare_join_side (bit-identical output): "
        "the concatenated prepared side flows into the joinside "
        "ServeCache entry via the caller's put "
        "(executor._joinside_for_child), pre-charged with .nbytes",
    ),
    "hyperspace_tpu_torch.execution.join_exec.PreparedJoinSide.subset": (
        "serve",
        "cache-governed",
        "column-subset view rebuilt from a cached side; the subset is "
        "re-put with its own nbytes charge",
    ),
    # -- zonemap / aggregate metadata planes ---------------------------------
    "hyperspace_tpu_torch.indexes.zonemaps.assemble_zone_data": (
        "serve",
        "chunk-bounded",
        "footers are decoded in fixed-size file chunks; only the "
        "per-row-group stat cells survive a chunk, so transient "
        "residency is one chunk of footers + the O(row-group) zones",
    ),
    "hyperspace_tpu_torch.indexes.zonemaps.zone_data_for": (
        "serve",
        "cache-governed",
        "assembled ZoneData is put into ServeCache with zd.nbytes (and "
        "mirrored in the byte-bounded module LRU fallback)",
    ),
    "hyperspace_tpu_torch.indexes.aggindex.agg_data_for": (
        "serve",
        "cache-governed",
        "assembled AggData is put into ServeCache with its decoded "
        "nbytes (and mirrored in the byte-bounded module LRU fallback)",
    ),
    "hyperspace_tpu_torch.indexes.aggindex.install_fanout_payload": (
        "serve",
        "cache-governed",
        "peer-pushed aggregate payload is decoded then put into "
        "ServeCache under the same key/charge as agg_data_for",
    ),
    # -- executor serve hot paths --------------------------------------------
    "hyperspace_tpu_torch.execution.executor._scan_cache_entry": (
        "serve",
        "cache-governed",
        "decodes the missing columns of the pruned selection and puts "
        "the ScanCacheEntry with budget_nbytes pre-charged against the "
        "governor",
    ),
    "hyperspace_tpu_torch.execution.executor._bucket_fetches": (
        "serve",
        "wave-budget",
        "the Hybrid Scan join's index-side buckets: a clean scan publishes "
        "its decoded buckets under a ('bucketed', fp, cols) cache key, a "
        "streamed one fans the per-bucket reads out on the bounded scan "
        "pool and the consumer drops each bucket after merging",
    ),
    "hyperspace_tpu_torch.execution.executor._exec_scan": (
        "serve",
        "cache-governed",
        "reads the planner's pruned selection (row-group-narrowed when "
        "zone maps supply file_row_groups); the decoded batch becomes "
        "the scan cache entry the governor charges",
    ),
    # -- out-of-core streaming serve (hyperspace.serve.stream.*) -------------
    "hyperspace_tpu_torch.execution.executor._stream_wave_side": (
        "serve",
        "wave-budget",
        "reads exactly one wave's bucket files — waves are packed by "
        "_exec_join_streaming so both sides' estimated decoded bytes "
        "fit hyperspace.serve.stream.maxBytes — and the prepared wave "
        "is released as soon as its join output is assembled",
    ),
    "hyperspace_tpu_torch.execution.join_exec.prepare_join_side_contiguous": (
        "serve",
        "wave-budget",
        "zero-concat prepared side over one already-contiguous wave "
        "batch: allocates only the O(wave) key/offset arrays beside "
        "the batch the wave reader materialized under the budget",
    ),
    # -- spill tier (hyperspace.serve.spill.*) -------------------------------
    "hyperspace_tpu_torch.execution.serve_cache.ServeCache._restore_from_spill": (
        "serve",
        "spill-bounded",
        "restored values are zero-copy read-only views of the mmap'd "
        "spill file (resident charge = the O(1) mmap token); real "
        "pages belong to the kernel page cache, and the tier's total "
        "bytes are capped by hyperspace.serve.spill.maxBytes",
    ),
    "hyperspace_tpu_torch.io.columnar.open_mmap_table": (
        "serve",
        "spill-bounded",
        "memory-maps an arrow IPC file and registers the region so "
        "estimate_nbytes charges views of it as file-backed tokens; "
        "residency is governed by the page cache, not the heap",
    ),
    # -- aggregate / sample plane (approximate answers) ----------------------
    "hyperspace_tpu_torch.indexes.aggindex.prune_missing": (
        "maintenance",
        "const-bounded",
        "vacuum reads one sample sidecar to re-point lineage; sidecars "
        "are capped at sample_rows per row group by construction",
    ),
    "hyperspace_tpu_torch.indexes.aggindex._sample_table_cached": (
        "serve",
        "const-bounded",
        "one directory's sample sidecar (sample_rows-capped per row "
        "group) behind a small lru_cache; bounded by maxsize x sidecar "
        "cap, never by relation rows",
    ),
    "hyperspace_tpu_torch.indexes.aggindex.sample_data_for": (
        "serve",
        "const-bounded",
        "assembles the per-file sample strata: sample_rows per row "
        "group, a 2**16x reduction of the relation — the approximate "
        "plane's contract, config-capped by INDEX_AGG_SAMPLE_ROWS",
    ),
    # -- build plane: wave loops and per-file passes -------------------------
    "hyperspace_tpu_torch.indexes.covering_build._scan_with_lineage": (
        "build",
        "chunk-bounded",
        "per-file read loop whose concat accumulator is exactly the "
        "file subset the caller passed — wave-planned stripes from the "
        "streaming writers, never the whole relation on the build path",
    ),
    "hyperspace_tpu_torch.indexes.covering_build._write_bucketed_streaming": (
        "build",
        "wave-budget",
        "materializes one planned wave within build_memory_budget plus "
        "one bucket at merge time; spill files carry the rest",
    ),
    "hyperspace_tpu_torch.indexes.zorder._write_zordered_streaming": (
        "build",
        "wave-budget",
        "wave-planned z-order rewrite: one build_memory_budget wave "
        "resident at a time, sorted runs spill to disk between waves",
    ),
    "hyperspace_tpu_torch.indexes.dataskipping.DataSkippingIndex.build_sketch_rows": (
        "build",
        "chunk-bounded",
        "reads one source file per iteration and keeps only its O(1) "
        "sketch row; peak residency is the largest single file",
    ),
    "hyperspace_tpu_torch.indexes.zonemaps._capture_zspans": (
        "build",
        "chunk-bounded",
        "two per-file passes that read one file at a time and retain "
        "only per-file span cells; bounded by the largest single file",
    ),
    # -- maintenance plane: optimize / refresh subsets -----------------------
    "hyperspace_tpu_torch.indexes.covering_build.rewrite_files": (
        "maintenance",
        "const-bounded",
        "optimize reads only this host's stripe of the operator-chosen "
        "small-file victim set (config-thresholded), not the relation",
    ),
    "hyperspace_tpu_torch.indexes.zorder.ZOrderCoveringIndex.optimize": (
        "maintenance",
        "const-bounded",
        "optimize rewrites the config-selected small-file subset in "
        "one pass; victim-set size is thresholded, not row-proportional",
    ),
    "hyperspace_tpu_torch.indexes.dataskipping.DataSkippingIndex.optimize": (
        "maintenance",
        "const-bounded",
        "re-sketches the operator-chosen optimize subset; the index "
        "itself stays one row per source file",
    ),
    "hyperspace_tpu_torch.indexes.dataskipping.DataSkippingIndex.refresh_incremental": (
        "maintenance",
        "const-bounded",
        "re-reads the previous sketch table — one O(1) row per source "
        "file, file-count- not row-proportional",
    ),
    # -- workload advisor (advisor/) -----------------------------------------
    # pure-Python dict/list growth, invisible to the checker's
    # numpy/pyarrow allocation model; declared anyway so the residency
    # witness measures it  # hslint: disable=HS1003
    "hyperspace_tpu_torch.advisor.profile.build_profile": (
        "maintenance",
        "const-bounded",
        "folds a query-log stream into at most advisor.profile."
        "maxShapes shape groups (overflow counted, not stored), each "
        "capped at _DURATION_SAMPLES duration samples — O(maxShapes), "
        "never O(records)",
    ),
    # -- port-only sites (no same-named function in the reference) -----------
    "hyperspace_tpu_torch.io.parquet.read_tables": (
        "serve",
        "cache-governed",
        "one table per file of the pruned bucket selection, read on the "
        "bounded scan pool; as read_table, every serve-path caller "
        "publishes the decoded result into the ServeCache byte governor "
        "or holds a per-chunk slice",
    ),
    "hyperspace_tpu_torch.execution.pipeline_compiler._run_chunked": (
        "serve",
        "chunk-bounded",
        "the fused pass joins consecutive files' tables up to "
        "_FUSED_FOLD_ROWS rows before one fold and drops them after it; "
        "peak residency is one fold's chunk plus the group accumulator",
    ),
    "hyperspace_tpu_torch.indexes.covering_build._merge_bucket": (
        "build",
        "wave-budget",
        "the out-of-core merge reads ONE bucket's spilled runs (a run a "
        "wave, each written under build_memory_budget) — the reference's "
        "_write_bucketed_streaming 'plus one bucket at merge time'",
    ),
    # -- io: generic scan plumbing -------------------------------------------
    "hyperspace_tpu_torch.io.scan.read_relation_files": (
        "serve",
        "chunk-bounded",
        "decodes one file per iteration on the partition-value branch; "
        "the accumulator is the caller's pruned selection, and every "
        "in-package caller passes planner-bounded subsets",
    ),
}
