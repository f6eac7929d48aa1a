"""Chip smoke test of hyperspace_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-src PATH] [--only-b4 | --only-b5 | --only-b5f | --only-serve]

Drives the port's main path once at real scale and holds every kernel
against its plain PyTorch version on the card:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every CUDA kernel under hyperspace_tpu_torch/csrc with nvcc
   for sm_90a, one nvcc per source, all started together;
3. kernels:
   * murmur3 bucket ids (kernel B1) bit-equal to the plain version over
     136 cases (``b1_cases``: n from 0 to 6,001,215 with ragged tails, k
     in {1, 2, 3, 4}, odd n and views 8 bytes off a 16-byte boundary,
     num_buckets in {1, 200, 2^31 - 1, 2^31}, seeds {42, 7}); timed with
     CUDA events on a busy device at 6,001,215 rows: cold (L2 flushed
     before each run) for k = 1, 2, 3 beside each byte bound and the
     plain version, warm (back to back) for k = 1, and at a query's n = 1
     and 8 as latency. With ``--baseline-src`` an earlier B1 source is
     built too, held against the plain version and timed cold in turns
     with the current kernel (baseline, current, current, baseline);
   * the per-bucket join match (kernel B4) with pair lists equal in
     order to the plain version over ``b4_cases`` (presorted and unsorted
     segments, B in {1, 7, 200}, empty segments on either side, n or
     m = 0, INT64_MIN / INT64_MAX keys, null sentinels, many-to-many
     duplicates, one skewed 2,000 x 2,000 segment, and for B4's two
     search branches a group across three one-row segments, windows of
     512 and 513 right keys, an all-equal segment wider than 512, a
     window of 512 keys all below a left key, n in {1, 31, 33, 1185}),
     each with int32 and with int64 lo / cnt;
   * the fused range mask (kernel B3a) equal to the plain version and to
     the host evaluator over ``tests/torch_b3a_cases.py`` (NaN and +-0.0,
     INT64_MIN / INT64_MAX bounds, strict and non-strict bounds, float
     bounds on int columns, nulls, 16 terms, n of 1, 31, 33 and ragged
     tails), with aligned columns and with views off the vector
     alignment; NEVER_MATCH cases launch nothing and the +-2^53 float
     bounds on int columns take the general device mask;
   * the segment reductions (kernel B5): integer sum and count, the
     ordered float fold, MIN, MAX and the count of valid rows, each
     bit-equal to its plain version on a CPU copy over
     ``tests/torch_b5_cases.py`` (every value type, NaN with payloads,
     -0.0 / 0.0 ties, +-inf, nulls, wrap-around, one group of 100,000
     rows, 10,000 groups, and group layouts across, on and beside the
     kernel's 2,048-row ranges, Q18's groups of 1-7 rows, groups of 31,
     32 and 33 rows on and across range edges, a long group amid short
     ones, empty groups, no rows, and fold groups around its 256-row tile
     with a NaN first met in a late tile), and the fold from a carried
     start (``B5_START_CASES``); the
     latency of one dependent float add (``scripts/torch_chain_probe.cu``,
     built beside the kernels), the float fold's chain bound;
   * the fused select (kernel B3b) and the fused filter→aggregate
     (kernel B5f) over ``tests/torch_b5f_cases.py`` (an empty chunk, no
     row passing, NEVER_MATCH, one group and no groups, 1,025 and 100,000
     groups in a chunk, NaN, -0.0 and null keys, int64 wrap, groups of
     only NaN or only nulls, -0.0 / 0.0 ties across two chunks, three
     chunks whose float sum depends on the carry; the ``int_`` cases take
     B5f's one-pass route, including blocks that overflow their tables,
     the others its ordered route): B3b's indices equal the plain
     version's and ``np.nonzero``, B5f's carried state equal bit for bit
     to the plain version's on the CPU after every chunk, each case timed
     cold;
   * the z-order interleave (kernel B6) bit-equal to the plain version on
     the same card tensor over ``tests/torch_b6_cases.py`` (n from 0 to 6,001,215,
     k in {1, 2, 3, 4}, bits in {1, 8, 11, 16, 31, 32}, words at 0, at
     2^bits - 1 and random, views 4 bytes past a 16-byte boundary); timed
     cold at 6,001,215 rows of 16-bit words for k = 1, 2, 3 beside each
     byte bound and the plain version on the card;
   * the Bloom filter bit indices (kernel B7), both C entries (the
     indices, and the build's packed words) bit-equal to the plain
     version on a CPU copy over ``tests/torch_b7_cases.py`` (n from 0 to
     65,537, INT64_MIN / INT64_MAX, uint64 bit-views, string reps and
     duplicates, m from 64 to 2^31 - 64 where h1 + j*h2 wraps at 2^32, k in
     {1, 7, 16}) and the build's route boundaries (m at the last word the
     block and the binned routes take, and one word past each), the build
     by the route m gives (one block's shared memory up to 2^20 bits,
     8 KiB slices of binned indices up to 2^24, global atomics beyond), counted
     by route, its plan on the card equal to ``ops/bloom.build_plan``;
     each timed cold at a source file's 750,152
     rows and at 6,001,215 in one launch (the indices at phase 11's
     m = 5,751,040, the build at m = 95,872, 5,751,040 and 2^31 - 64;
     k = 7), beside its byte and int32-operation bounds and the plain
     version on the card; the indices also at the probe's 1 and 8 reps;
4. filter path: a lineitem-shaped table of 6,001,215 rows (TPC-H SF1
   lineitem's row count, l_orderkey over SF1's 1,500,000 orders), a
   covering index with the default 200 buckets through the pipelined
   partition-first writer (built once more with
   ``hyperspace.index.build.partitionFirst`` off: its 200 bucket files
   byte-equal, both builds' stages logged side by side), then 32 point and 4
   IN-list filters served from the index with bucket pruning, each
   checked against the unindexed plan row for row (point filters take
   the fused range mask, B3a; IN lists the general device mask);
5. join path: an orders table in the bench.py shape (1,500,000 rows,
   8 files), its covering index on o_orderkey, then ``orders ⋈
   lineitem`` on the order key served shuffle-free from both indexes
   (phase 4's li_idx covers the lineitem columns the join uses)
   (one warm-up, then 4 interleaved rounds with the pipelined serve,
   ``hyperspace.serve.pipeline.enabled``, on and off, rows equal in order,
   each stage's seconds; B1 and B3a launch nothing across them), its rows
   equal as a multiset to the unindexed plan's (also timed); then a two-key
   join with about 1 % null keys on 200,000 rows a side, equal to its
   unindexed plan;
6. B4 on phase 5's own inputs: the first B4 call of each of phase 5's
   four plans is recorded (``B4Inputs``) and held equal in order to the
   plain version: the indexed join (1,500,000 x 6,001,215 keys, 200
   presorted buckets), the unindexed one (one segment, both row maps),
   and the two-key join both ways (per-bucket sorts, row maps). The
   indexed and unindexed inputs are timed there cold and warm, count
   pass, range-total scan and emit pass apart, with int64 lo / cnt too,
   beside the bound and the plain version; so are the unindexed inputs
   with the left side shuffled and phase 3's "row order" case (random
   left keys, which send every row to the search in global memory); a
   batched ``torch.searchsorted`` over the indexed buckets padded to
   [B, W] (ranges only, no pairs) is timed as a yardstick;
7. range path: ``l_orderkey >= a AND l_orderkey < b AND l_quantity < 24``
   over about 0.1 %, 1 % and 10 % of the orderkeys, first over li_idx
   (200 buckets, one row group a file; pyarrow's pushdown filters thin
   the read) with a date cut-off whose residual is the whole index, then
   over li_rg_idx (8 buckets, about 12 row groups a file, built here):
   each query index-served, its residual mask through B3a, equal to the
   unindexed plan as a multiset and to the plan without range pruning in
   order; p50 over 5 runs, files and row groups kept, zone-map sources.
   B3a is then held against the plain version on every query's recorded
   residual and timed on the whole-index one, the largest range one and
   the li_idx 1 % one (cold, warm, plain, the general device mask on the
   same device columns, and the host-to-device copy).

8. aggregate path: over phase 4's lineitem with li_idx, li_rg_idx and
   o_idx active, the queries of ``aggregate_queries``: (a) an index-served
   ``l_orderkey`` window (bench.py's agg_lo / agg_hi at SF1) with count,
   sum, avg, min and max; (b) bench.py's q_gagg, the same window grouped
   by l_quantity with a float64 sum (50 groups, from the source); (c)
   sum, min and max of l_extendedprice over all 6,001,215 rows (the
   float fold's one long chain); (d) TPC-H Q18's shape, a sum per
   l_orderkey (1,500,000 groups) sorted descending and limited to 100,
   rewritten by AggregateIndexRule onto the smallest covering index; (e)
   a top-10 (Limit over Sort) and a streaming limit. Each: one warm-up,
   p50 over 5 runs with stage seconds, rows equal bit for bit in order to
   a ``device="cpu"`` session's, equal to the plan without Hyperspace
   (d in order), integer columns equal to pyarrow's group_by. B5 is then
   held against its plain version on every call the warm-ups made
   (``B5Inputs``) and timed on b, c and d's calls, cold and warm, beside
   the byte bound, the chain bound, the plain version, ``index_add_`` /
   ``scatter_reduce_`` on the card and the values' host-to-device copy;
   so are MIN, MAX and the count of valid rows on d's layout (the count
   over a seeded validity), and each pass's own time (range pass, fix-up
   pass) on c's MIN and d's SUM from torch.profiler's kernel records.

   Phase 7 runs each query with ``hyperspace.serve.fusedpipeline.enabled``
   off, so its residuals take the mask route (B3a) it measures, then 5
   times on the default route (the fused select, B3b, for residuals of
   32,768 rows or more), rows equal in order.

9. aggregate index plane: every create above captured ``_aggstate.json``
   and ``_aggsample.parquet`` on the card (their ``sidecar_capture``
   seconds are logged beside each build's stages). Over phase 4's
   lineitem: (m1) ``l_orderkey >= 0`` grouped by l_quantity with count,
   min, max and sum of l_orderkey over li_rg_idx, answered from the
   sidecar with 0 row groups read (96 of 96 from metadata); (m2) the agg
   window's count, sum, min and max of l_quantity over li_rg_idx, its
   boundary row groups through B5f; (f1) phase 8's query a and (f2) the
   window grouped by l_quantity over li_idx on the fused aggregate
   (B5f); (s1) the window and ``l_quantity < 24`` selecting l_shipdate
   on the fused select (B3b). Each: the explain names its index, one
   warm-up, 5 rounds with its route on and off in turns, rows equal bit
   for bit in order to the route off, to a ``device="cpu"`` session and
   to the plan without Hyperspace (s1 as a multiset). The
   ``_aggstate.json`` of li_rg_idx, li_idx (whose l_orderkey pass
   overflows to the ordered route) and o_idx (a float SUM on the ordered
   route) each equals the doc a cpu session computes over its files,
   file and row-group counts logged. Each create's ``sidecar_capture`` seconds are logged split
   into its row-group reads and its folds, with the folds' fused passes
   and their chunks that overflowed B5f's one pass. li_idx's and o_idx's
   captures are then computed again under torch.profiler: the fold's
   device time by part (B5f's kernels, B3b, B5, copies, the rest)
   beside its host clock. B5f is then held against its
   plain version on f1's and f2's inputs (li_idx's three columns as one
   chunk of 6,001,215 rows) on its route (one pass for both) and on the
   ordered route, and timed: the whole call (CUDA events and host clock),
   its synchronisations (torch's sync debug mode), every kernel of one
   call by torch.profiler (cold), the ordered route and the group pass
   alone, beside its byte bound (the bytes the inputs need: term columns
   whole, the 32-byte sectors of passing rows of the others) and the
   whole-column one, the plain version and the interpreted chain on the
   same device columns; B3b (one launch) on f1's terms and s1's recorded
   batch, 21 calls each equal to the plain version, timed cold beside
   its bound, the plain version and B3a + ``torch.nonzero``.

10. z-order path: in a session of its own over phase 4's lineitem files,
   bench.py's two z-order covering indexes, agg_idx on l_orderkey
   (including l_quantity, l_extendedprice) and z_idx on (l_shipdate,
   l_quantity) (including l_orderkey), each create's stage seconds
   (scan, z_address, sort, write, zonemap_capture, sidecar_capture) and
   rows/s, B6 launched by its build and its z-span capture; then (m1)
   bench.py's q_meta over agg_idx, answered from its ``_aggstate.json``,
   and bench.py's q_zrange (``l_shipdate`` in [1995-06-01, 1995-06-30],
   ``l_quantity <= 5``) over z_idx with its files' and row groups' z-spans
   pruning the read. Each: the explain names its index (``ZOCI``); one
   warm-up; 5 rounds with its route (metadata plane, range pruning) on and
   off in turns; rows equal in order to the route off and to a
   ``device="cpu"`` session's, and to the plan without Hyperspace (m1 bit
   for bit, q_zrange as a multiset). Each index's ``_zonemaps.json`` (with
   ``rg_zspans`` and the ``zorder`` spec) and ``_aggstate.json`` equal the
   docs a cpu session computes over its files apart from ``mtime_ns``.
   Every B6 and B5f call of the creates is recorded (``KernelCalls``,
   the one recorder of phases 10-13) and held bit-equal to the plain
   version; the z-order lexsort is timed cold on each build's planes.

11. data-skipping path: in a session of its own over phase 4's lineitem
   files (in ship-date order), ds_idx with a min/max sketch on
   l_shipdate and a Bloom filter sketch on l_orderkey (fpp 0.01, 600,000
   expected items a file: m = 5,751,040, k = 7); the create's seconds
   split into file reads and sketching, one B7 build a file, its sketch
   file byte-equal to the one a ``device="cpu"`` session writes. Then
   (d1) bench.py's q_zrange, pruned by the min/max sketch; (d2) phase
   4's 32 point keys and 4 keys no file holds, pruned by the Bloom
   filter sketch (B7 probes the literals); (d3) phase 4's 4 IN-lists.
   Each: the explain names ``Type: DS``; the files kept equal the cpu
   session's; one warm-up, 3 rounds with Hyperspace on and off in turns
   (p50 and p99, and the p50 of each query's on-off difference); then
   at least 20 more runs a side in turns (2 rounds of d2) split by stage
   (optimizer, range-pruning pass, file reads, filter, rest) with the
   routes each side took (``ds_stage_split``); rows equal as a multiset
   to the plan without Hyperspace and in order to the cpu session's.
   Every B7 call of the phase is recorded (``KernelCalls``) and held
   bit-equal to the plain version; the create's 8 builds
   take the binned route; the build is timed cold on the first file's
   own l_orderkey reps.

12. lifecycle path (``lifecycle_path``): over a copy of the first 4 of
   phase 4's 8 lineitem files (3,000,607 rows; a depth cut for the script's
   time), lineage on, lc_idx (li_idx's config, beside phase
   5's o_idx), lc_z (phase 10's z_idx) and lc_ds (phase 11's ds_idx, in a
   system path of its own), each step run on the card and then in a
   ``device="cpu"`` session. TPC-H's refresh functions at lake
   granularity: (1) RF1's batch (1,500 new orders of 1-7 lines) and an
   incremental refresh of all three; (2) a day's file of 750,152 rows,
   incremental; (3) RF2 as the delete of source file 0, incremental (the
   lineage rewrite of about 5.25 M rows through B1 and B2); (4) a second
   RF1 batch, incremental, lc_idx optimized full then quick (a no-op), a
   third batch recorded by a quick refresh, then an incremental one; (5)
   a fourth batch, full refreshes and vacuums of the outdated versions,
   delete, restore, delete, vacuum, and a cancel over a transient entry.
   After each step every index file (bucket, z-order and sketch files
   byte for byte, ``_zonemaps.json`` and ``_aggstate.json`` without
   mtime_ns) and log entry (without ids and timestamps) equals the cpu
   session's; before step 1, after steps 2, 3 and 5 phase 4's 36 filters
   with 4 new keys (lc_idx), 12 of d2's point keys (lc_ds: 8 of phase 4's
   and the 4 new ones) and q_zrange (lc_z), and in the quick-refresh state
   10 of the filters (lc_idx through a Union with the recorded batch),
   name their index in the explain, and their rows equal the plan without
   Hyperspace and, in order, the cpu session's; phase 5's join over o_idx
   and lc_idx is timed after step 2 (buckets of two files) and after step
   3 (one file a bucket) and held to the unindexed plan and the cpu
   session each time (for the script's time: no checkpoint after steps 1
   and 4 since phase 13; no join before step 1, fewer d2 keys and quick
   filters since phase 15). Each action's seconds, stages, rows written and
   launches, files a bucket around optimize and versions around vacuum
   are logged, and each checkpoint set's seconds with its checks. Every
   B1, B6, B7 and B5f call (B3b and B5 on its ordered route) is recorded
   (``KernelCalls``) and held bit-equal to the plain version after each
   action.

13. recovery path (``recovery_path``): over a fresh copy of phase 4's 8
   lineitem files, lineage on, a 2,000 ms writer lease and orphan grace 0,
   rc_idx (li_idx's config), rc_z (z_idx's) and rc_ds (ds_idx's), beside a
   crash-free run of every action in system paths of their own. In-process
   crashes (``raise``): rc_idx's create at after_begin_log, mid_data_write
   (at=101, in the pipelined writer's thread: the 199 bucket files other
   than the crashed one land, as in the reference), after_data_write,
   mid_sidecar_publish and after_end_log; a day's file refreshed
   incrementally at mid_data_write (at=101); optimize full at
   mid_data_write (at=101); RF2's rewrite at after_data_write; a vacuum of
   the outdated versions at mid_vacuum_delete (at=2); rc_z's create at
   mid_data_write; rc_ds's at after_data_write. Each: the crash fired once
   and left a transient tip (committed for after_end_log); after the lease
   ``hs.recover`` rolled back (healed the pointer); the data files equal
   the set before (a subset for the vacuum), no orphan, a second GC moves
   nothing; the index's queries (phase 4's 36 filters, q_zrange, d2) equal
   the unindexed plan; the retried action's files and entries equal the
   crash-free run's, and it launched each kernel it runs; a
   mid_data_write cell at=101 left every file of the retried version but
   one. A child
   interpreter creating rc_idx dies at its 101st bucket file (``exit``,
   code 86): before its lease ``recover`` reports a live writer and
   changes nothing, after it rolls back the child's 100 files, and the
   create runs here. A full refresh on a thread while a second session
   attaches and recovers: live writer, nothing touched; the heartbeat's
   renewals and longest gap (below the lease). Costs: recover's seconds
   after each lease, GC's ms, ``ensure_recovered`` on a clean tip, each
   retry's seconds, RF1's refresh with recovery on and off in turns. Every
   B1, B6, B7 and B5f call is held bit-equal to its plain version
   (``KernelCalls``).

14. hybrid path (``hybrid_path``): over a copy of phase 4's 8 lineitem
   files and phase 5's orders files, lineage on, hs_idx (li_idx's config)
   and ho_idx (o_idx's), served by a session on the card and a
   ``device="cpu"`` session over the same system path, with
   ``hyperspace.index.hybridscan.enabled`` on: (1) bench.py's hybrid file
   (n_items // 32 = 187,537 rows) appended: phase 4's filters and phase
   5's ``orders ⋈ lineitem`` (one warm-up, 2 interleaved rounds of the
   sequential and pipelined routes), each plan a ``Union`` with the
   ``hybridDelta`` scan and both join sides index-served, the appended
   rows hashed into the index's 200 buckets by B1; (2) source file 0
   deleted (the lineage NOT-IN), the same queries (phase 15 repeats this
   state over a Delta table); (3) appends past the 0.3 appended ratio: the
   index refused with TOO_MUCH_APPENDED, the query reads the source; (4)
   Hybrid Scan off, a quick refresh, the filters served in exact mode
   through the recorded delta, then an incremental refresh and no Union
   (all 36 filters). Rows equal the unindexed plan as a multiset and the
   cpu session's in order. Over a ``Union`` or the source each state runs
   4 point filters and 2 IN-lists (``HY_LEAN``), for the script's time. (5)
   The approximate plane over ha_idx (li_rg_idx's layout, l_extendedprice
   included, 8 buckets, 128 sample rows a row group): an ungrouped COUNT
   and SUM over a 10 % l_orderkey window, the same grouped by l_quantity,
   one at max_rel_error 0.001 and one over a hybrid state, which raise
   ApproximationError on both sessions; the card's tables equal the cpu
   session's bit for bit. Every B1 call is held bit-equal to its plain
   version (``KernelCalls``).

15. lake path (``lake_path``): phase 4's 8 lineitem files hard-linked (or
   copied) into a Delta table ``ld`` whose log the port's own code writes
   (``tests/torch_lake.py``: commit 0 with the protocol, a ``metaData``
   whose ``schemaString`` maps the files' Arrow schema, and 8 ``add``
   actions with the files' sizes and mtimes), a card session and a
   ``device="cpu"`` session over one system path, lineage on: (1) ld_idx
   (li_idx's config, 200 buckets) through ``read.delta``, its 200 bucket
   files byte-equal to phase 14's hs_idx (the same config with lineage,
   over the same files in the same order), and phase 4's 36 filters
   served bucket-pruned at LogVersion 2, point filters in order; (2)
   commit 1 appends phase 14's file (187,537 rows), commit 2 removes file
   0, a classic checkpoint at version 2 with ``_last_checkpoint``: 8 point
   and the 4 IN-list filters through Hybrid Scan's ``Union`` (the appended
   file, file 0's NOT-IN), then an incremental refresh (``deltaVersions``
   2:0,4:2) and the 36 filters bucket-pruned at LogVersion 4; (3) time
   travel: ``version_as_of=0`` served by LogVersion 2 (the 12 filters),
   ``version_as_of=1`` (a tie: ``closest_index`` picks log 4, whose
   signature is version 2's, so the source serves), a vacuum of the
   outdated versions (``deltaVersions`` reset to 4:2) and
   ``version_as_of=0`` again, read from the source; (4) ld_z, a z-order
   index on (l_orderkey, l_shipdate), and phase 10's q_zrange; (5) an
   Iceberg table li_ice over the same 8 files (format 2 metadata, a
   manifest list and a manifest through the port's Avro writer), ice_ds
   as phase 11's ds_idx (8 binned B7 builds) and d1-d3; a second snapshot
   appends one file: the current table is not served, a read pinned to
   snapshot 1 is; (6) file 1 (750,152 rows) as csv and orc, its first
   100,000 rows as json lines, avro and text (l_orderkey a line): a
   covering index over each and 4 point filters, bucket-pruned, equal to
   the plan without Hyperspace and to the parquet file's rows. Each
   filter's rows equal the plan without Hyperspace and, in order, the cpu
   session's. ``read_snapshot``'s ms (Delta from JSON and from the
   checkpoint, Iceberg), each create's seconds and stages, the filters'
   p50 and p99 by state and the rewrite's ms at the latest version and
   under time travel are logged, and a ``sources`` JSON line. Every B1,
   B3a, B5f, B6 and B7 call is held bit-equal to its plain version
   (``KernelCalls``).

16. out-of-core path (``outofcore_path``): a session of its own whose build
   memory budget (``hyperspace.index.build.memoryBudgetBytes``) is 2.5 times
   part0's estimated materialized bytes (its footers), so every build
   over phase 4's 8 files reads 4 waves of 2: (1) st_idx, li_idx's
   configuration, streamed (each wave hashed by B1 and sorted on the
   card, each bucket's run spilled, each bucket merged with a key sort on
   the card), its waves, spill files, stages and rows/s logged; each of
   its 200 bucket files holds li_idx's rows of the same name after sorting
   by every column, key-sorted (the files matching in order too are
   counted); the peak device bytes of its data write (from the create's
   start to its last bucket file, before the captures) below li_idx's in
   phase 4, measured the same way (``write_peak``); phase 4's 36 filters
   over st_idx, bucket-pruned, equal to the plan without Hyperspace; (2)
   sz_idx, phase 10's z_idx configuration with lineage on over a
   hard-linked copy of the 8 files, streamed in two passes (a stats pass
   freezing the min/max spec, a spill pass into 64 z-ranges by B6's
   planes, a merge a range), its rows in file order equal to z_idx's;
   q_zrange served by it, equal to the plan without Hyperspace; then file
   0 deleted and phase 14's file (187,537 rows) appended, an incremental
   refresh whose previous data streams with the appended file, and
   q_zrange again; (3) ``hs.why_not`` (plain and extended) and
   ``hs.explain(verbose=True)`` in the plaintext, console and html modes
   for a point filter and q_zrange, each naming the index applied and a
   reason for the other, and ``analyze_min_max_string`` of l_orderkey and
   l_shipdate over li_idx's and z_idx's files, printed. Every B1, B3a, B6
   and B5f call is recorded (``KernelCalls``, as CPU copies, so that no
   record holds device memory) and held bit-equal to its plain version.

17. out-of-core serve and caches (``ooserve_path``): a session of its own
   over phase 4's system path (li_idx and o_idx, built again with their
   configs if an earlier phase took them away): (1) phase 5's orders ⋈
   lineitem on the materializing route, then streamed
   (``hyperspace.serve.stream.enabled``) at a wave budget of an eighth of
   both sides' footer estimate (about 8 waves, at least 4 required), at
   the default 256 MiB (one wave), and at the small budget with
   ``hyperspace.io.mmap.enabled``: each run's rows equal the materializing
   route's in order, one B4 call a wave; waves, buckets, stage
   seconds and each run's peak device bytes logged; (2) with
   ``hyperspace.serve.cache.enabled``: phase 4's 36 filters cache off,
   cold and warm (rows equal in order to the cache-off route's, B3a on the
   warm residual masks), the join cache off (3 runs), cold and warm from
   its ``joinside`` entries (3 runs), f1 over the cached scan (B5f) the
   same way; p50s and ``cache.stats()`` logged; (3) the spill tier: the
   cache capped at the larger join side, a 4 GiB spill cap, the join
   twice (the first demotes, the second restores, rows equal); between
   the two, ``hs.recover`` with the cache alive keeps the live spill files
   (``kept_live``). Every B4, B3a and B5f call is recorded (as CPU copies)
   and held equal to its plain version: B4's pair lists in order, B3a's
   masks and B5f's states bit for bit. An ``ooserve`` JSON line.
18. sharded path (``sharded_path``): 4 shards on the one card
   (``devices=["cuda:0"] * 4``): (1) li_idx's configuration over phase
   4's lineitem built through the exchange strategies flat (kernels B1,
   B8a and B8b), compact, host and twostage (2 simulated hosts), and flat
   with ``hyperspace.build.shardedTail.enabled`` off: every build's 200
   bucket files byte-equal to phase 4's one-shard li_idx, its
   ``last_shuffle_stats`` (pack, exchange and unpack seconds, cap, skew)
   logged; (2) every B8a and B8b call of the main path held bit-equal to
   its plain version on the same card tensors, and one of each (the flat
   build's first shard) timed cold, 256 MiB read first, median of 30,
   whole with its error word's read (as PR 20 timed it) and its launches
   alone, with the digit route it took, beside its byte bound at 3.35
   TB/s, its plain version and ``torch.sort(keys, stable=True)`` of the
   same keys as the library yardstick; (3) phase 5's ``o_idx ⋈ li_idx`` served at 4 shards,
   sequential and streamed (``hyperspace.serve.stream.enabled``): rows
   equal to phase 5's plan in order, a block of buckets a shard matched
   by B4 (counted in ``bucket_match_pairs.shard``), every B4 call held to
   its plain version; (4) phase 16's budgeted st_idx build at 4 shards
   with the concurrent per-shard merges: its files byte-equal to phase
   16's; (5) the 4-shard build served at one shard and phase 4's li_idx
   at 4: phase 4's first 8 point filters and an IN list, rows equal to
   phase 4's session's; (6) ``scripts/torch_dryrun_multihost.py --device
   cuda``, 2 processes on the one card over gloo (NCCL refuses two ranks
   on one GPU), started at the phase's start and awaited at its end:
   exit 0, ``DRYRUN-OK`` twice, equal content hashes. A ``sharded`` JSON
   line.
19. SQL, tracing and the witnesses' plane (``obs_sql_path``) over phases 4
   and 5's session, lineitem and orders registered as views: (1) phase
   4's 36 filters, phase 5's join and phase 8's queries a-e as SQL strings
   (``sql_queries``), each equal to the DataFrame API's in logical and
   optimized plan and in rows (in order, floats bit for bit), the filters,
   the join, a and d index-served (b, c and e read a column no index
   covers, as in phase 8); every B1, B3a and B4 call under SQL recorded
   and held to its plain version, and every B5 call on a CPU copy; (2) 5
   rounds with ``hyperspace.obs.enabled`` off and 5 on, in turns, of the
   36 filters and the join: p50 and p99 of the filters, p50 of the join;
   every query is served by ``session.serve_frontend`` (one client), and
   with tracing on each runs under the frontend's root span, whose stage
   spans equal ``session.join_stats`` and whose record goes to the query
   log the frontend opens, with ``recordPlans`` on; the records read back
   with ``read_valid_records``, each valid, all replayed through
   ``testing/replay.replay_records`` (the frontend again) with the
   original rows; (3) a create
   of ``obs_idx`` (orders on o_custkey) under its root span, whose stage
   spans equal ``build_stats``, with ``log_commit``, and whose
   ``CreateActionEvent`` reaches a ``JsonlEventLogger`` file; (4) with
   ``hyperspace.profile.traceDir`` set, one filter and the join on the
   same session (``profile_check``): two Chrome traces whose CUDA kernel
   events name B1 (``murmur3_bucket_kernel``) and B4 (``count_kernel``,
   ``emit_kernel``), with no kernel launch missing its device event.
   An ``obs`` JSON line.
20. The serve tier (``serve_path``) over phases 4 and 5's session: phase
   4's 36 filters served directly and through ``session.serve_frontend``
   from 1, 8 and 64 client threads (p50, p99, queries a second, every
   answer equal in order to the direct one); 8 submits of phase 5's join
   from one barrier coalesced into one execution (``deduped`` 7); phase
   8's a-d from 8 clients; an SLO class ``batch`` (maxConcurrency 1,
   maxQueueDepth 2) admitting two joins and shedding two beside 8
   unclassed filter clients; an RF1-sized batch over phase 4's keys
   appended, li_idx refreshed and vacuumed while 8 clients serve, every
   answer the truth before or after; a transient and a persistent
   ``parquet_read`` fault and a B1 ``KernelLaunchError`` (failed, neither
   retried nor degraded); two ``FleetFrontend`` sessions sharing one
   claim and the bus; ``testing/fleet_harness`` with 2 processes on the
   card over 1,000,000 rows and its kill -9 rung. Every B1, B3a, B4, B5f
   and B5 call from the frontend's threads is held to its plain version.
   A ``serve`` JSON line.

``--only-b4`` is for iterating on B4: it runs phases 1-3, then the
timings of phase 6 on device tensors shaped like phase 5's indexed and
unindexed calls, built from the same keys with B1 and a device sort
instead of from the tables, and prints the card line and the records
under ``only_b4`` instead of ``kernels``, with null launches: the main
path does not run. ``--only-b5`` is the same for iterating on B5: phases
1-3, then phase 8's B5 timings on device tensors shaped like its calls
(``b5_replica``: d's permutation from l_orderkey in B1's 8 buckets,
key-sorted within each, then the stable group sort; b's 50 groups over
the agg window; c's identity), built on the card from phase 4's
generators and seeds without writing Parquet, each held bit-equal to the
plain version; records under ``only_b5``. ``--only-serve`` builds the
kernels and runs phases 4, 5 and 20 alone, records under ``only_serve``
(about 4 minutes). ``--only-b5f`` does the same
for B5f and B3b: phases 1-3, then phase 9's B5f/B3b timings on inputs
built on the card from phase 4's generators (``b5f_replica``: li_idx's
rows, l_orderkey in B1's 200 buckets and key-sorted within each, as one
chunk; f1's and f2's plans; s1's batch); records under ``only_b5f``. The
numbers that go into PERF.md come from the run without flags, which
drives every phase.

Kernel launch counts are set to 0 just before phases 4, 5, 7, 8, 9, 10,
11, 12, 13, 14, 15, 16, 17, 18, 19 and 20 and read just after each; each
kernel's count in the JSON line adds phases 12, 13, 14, 15, 16, 17, 18, 19
and 20's (phase 20's worker processes count their own); B8a
and B8b (``bucket_exchange_pack`` / ``_order``) run in phase 18 alone. The
kernel checks' launches are not counted as the main path's. Any failure raises and exits non-zero. The last two
lines of standard output are the kernels' JSON record and ``{"ok": true,
"device": ...}``. It needs one CUDA device and the repository checkout
it lives in; the tables are written under build/chip_smoke/ and removed
at the end.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 6_001_215  # TPC-H SF1 lineitem
N_ORDERS = 1_500_000  # TPC-H SF1 orders
N_FILES = 8
SEED = 7
# H100 SXM peaks (NVIDIA data sheet and Hopper white paper, 700 W part):
# HBM3 bandwidth, and 32-bit integer ALU operations (132 SMs x 64 INT32
# lanes x 1.98 GHz boost; outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
AGG_SWITCH = "hyperspace.index.agg.enabled"
FUSED_SWITCH = "hyperspace.serve.fusedpipeline.enabled"
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def hold_device(ms: float = 10.0) -> None:
    """Enqueue about ``ms`` of device busy-wait (at up to 2 GHz), so that
    the events and launches the host enqueues next queue behind it and
    time the device, not the host's path from Python to each launch."""
    import torch

    torch.cuda._sleep(int(ms * 2e6))


def time_cuda(fn, launches: int = 30, repeats: int = 5) -> float:
    """Milliseconds per launch of ``fn``, warm: ``launches`` back-to-back
    runs between two CUDA events behind :func:`hold_device`, the median
    over ``repeats`` such runs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        hold_device()
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def time_cold(fn, flush, warmup: int = 3, iters: int = 30) -> list:
    """Milliseconds of ``iters`` CUDA-event-timed runs of ``fn``, each
    after reading all of ``flush`` (five times the 50 MB L2) outside the
    timed window: every run finds its inputs in HBM and the L2 holding
    only clean lines, so no write-back of earlier work lands in the
    timed window. The flush keeps the card busy while the host enqueues
    the run, so the events time the device."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def murmur3_ops_per_row(k: int) -> int:
    """32-bit integer operations per row of kernel B1: 6 per word mix (two
    words per key); 9 for fmix (the length xor, three shift-xor pairs, two
    multiplies); 6 for the remainder by precomputed constants (two
    32x32 -> 64-bit products at 2 each, two 32-bit products at 1)."""
    return 12 * k + 15


def b1_bound(n: int, k: int) -> dict:
    """Least time of B1 on [k, n] reps: the larger of its bytes (k int64
    reads and one int32 write per row) over HBM bandwidth and its integer
    operations over the int32 peak."""
    nbytes = (8 * k + 4) * n
    ops = n * murmur3_ops_per_row(k)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes,
        "bytes_ms": bytes_ms,
        "int32_ops": ops,
        "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def b1_cases() -> dict:
    """Correctness cases of B1: (n, k, plane-0 offset in int64s) ->
    [(num_buckets, seed), ...]. Ragged tails around the 128-row warp
    tile, an exact multiple of it, odd n with k >= 2 (every other plane
    8 bytes off a 16-byte boundary), views whose plane 0 starts 8 bytes
    off, the extreme bucket counts, and k = 4 for the generic-k path."""
    cases: dict = {}

    def add(ns, ks, offsets, nbs, seeds):
        for n, k, off, nb, seed in itertools.product(ns, ks, offsets, nbs, seeds):
            cases.setdefault((n, k, off), []).append((nb, seed))

    add((0, 1, 255, 257, N_ROWS), (1, 2, 3), (0,), (200, 1 << 31), (42, 7))
    add((2, 3, 4, 5, 127, 128, 129, 1 << 20), (1, 2, 3), (0,), (200, 1 << 31), (42,))
    add((5, 129, 1 << 20, N_ROWS), (1, 2, 3), (1,), (200,), (7,))
    add((257, N_ROWS), (1, 2, 3), (0,), (1, (1 << 31) - 1), (42,))
    add((129, N_ROWS), (4,), (0, 1), (200,), (42,))
    return cases


def device_reps(reps_np: np.ndarray, dev, offset_rows: int):
    """The [k, n] reps on the card, as a contiguous view starting
    ``offset_rows`` int64s into a fresh allocation."""
    import torch

    k, n = reps_np.shape
    buf = torch.empty(k * n + offset_rows, dtype=torch.int64, device=dev)
    reps = buf[offset_rows:].view(k, n)
    reps.copy_(torch.from_numpy(reps_np))
    if n and reps.data_ptr() % 16 != (8 * offset_rows) % 16:
        raise AssertionError("allocation not 16-byte aligned; offset case is void")
    return reps


def check_b1(dev, kernel, label: str, cases: dict) -> tuple:
    """Hold ``kernel`` bit-equal to the plain version over ``cases``;
    returns (number of cases, max_abs_err)."""
    import torch

    from hyperspace_tpu_torch.ops import hash as H

    rng = np.random.default_rng(SEED)
    i64 = np.iinfo(np.int64)
    max_err, count = 0, 0
    for (n, k, off), params in cases.items():
        reps_np = rng.integers(i64.min, i64.max, size=(k, n), dtype=np.int64,
                               endpoint=True)
        extremes = np.array([i64.min, i64.max, -1, 0], dtype=np.int64)
        reps_np[0, : min(n, 4)] = extremes[: min(n, 4)]
        reps = device_reps(reps_np, dev, off)
        for nb, seed in params:
            got = kernel(reps, nb, seed)
            torch.cuda.synchronize()
            want = H.bucket_ids_torch(reps, nb, seed)
            if got.dtype != torch.int32 or got.shape != (n,):
                raise AssertionError(f"{label}: bad output {got.dtype} {got.shape}")
            err = (got.long() - want.long()).abs().max().item() if n else 0
            max_err = max(max_err, err)
            count += 1
            if err != 0:
                raise AssertionError(
                    f"{label} differs from plain: n={n} k={k} offset={off} "
                    f"nb={nb} seed={seed}"
                )
    return count, max_err


def build_baseline(src: str):
    """Start nvcc on an earlier B1 source (the C interface without the
    remainder constant and alignment bits) beside the package build;
    returns (process, library path)."""
    from hyperspace_tpu_torch import kernels

    out_dir = os.path.join(ROOT, "build", "baseline_b1")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libbaseline_b1.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-o", lib, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def load_baseline(proc, lib: str):
    """Wait for :func:`build_baseline`; returns a wrapper with the
    package kernel's signature (reps, num_buckets, seed) -> out."""
    import ctypes

    import torch

    log_text, _ = proc.communicate()
    log(f"build: baseline B1: {log_text.strip()}")
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the baseline B1 source")
    fn = ctypes.CDLL(lib).hs_murmur3_bucket_ids
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(reps, num_buckets: int, seed: int = 42):
        k, n = reps.shape
        out = torch.empty(n, dtype=torch.int32, device=reps.device)
        err = fn(reps.data_ptr(), out.data_ptr(), n, k, num_buckets,
                 seed & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline B1 launch failed: CUDA error {err}")
        return out

    return run


def check_kernels(dev, baseline=None) -> dict:
    import torch

    from hyperspace_tpu_torch.ops import hash as H

    count, max_err = check_b1(dev, H.bucket_ids_kernel, "B1", b1_cases())
    log(f"kernels: B1 bit-equal to plain over {count} cases (max_abs_err {max_err})")

    rng = np.random.default_rng(SEED + 2)
    i64 = np.iinfo(np.int64)
    # 256 MiB read before every cold run: five times the L2
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    cold = []
    for k in (1, 2, 3):
        reps = torch.from_numpy(
            rng.integers(i64.min, i64.max, size=(k, N_ROWS), dtype=np.int64)
        ).to(dev)
        ms = float(np.median(time_cold(lambda: H.bucket_ids_kernel(reps, 200), flush)))
        plain_ms = time_cuda(lambda: H.bucket_ids_torch(reps, 200))
        b = b1_bound(N_ROWS, k)
        cold.append({"k": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"], "share_of_bound": b["bound_ms"] / ms})
        log(
            f"kernels: B1 cold at {N_ROWS} rows, k={k}: ms {ms:.4f} bound_ms "
            f"{b['bound_ms']:.4f} ({b['bound_ms'] / ms:.1%}; bytes {b['bytes']} -> "
            f"{b['bytes_ms']:.4f} ms, int32 ops {b['int32_ops']} -> "
            f"{b['ops_ms']:.4f} ms); plain_ms {plain_ms:.4f}; library_ms n/a"
        )
        if k == 1:
            reps1 = reps
    warm_ms = time_cuda(lambda: H.bucket_ids_kernel(reps1, 200))
    log(f"kernels: B1 warm (back to back) at {N_ROWS} rows, k=1: ms {warm_ms:.4f}")

    query = {}
    for n in (1, 8):
        reps = reps1[:, :n].contiguous()
        device_ms = time_cuda(lambda: H.bucket_ids_kernel(reps, 200), launches=100)
        host = []
        for _ in range(100):
            t0 = time.perf_counter()
            H.bucket_ids_kernel(reps, 200)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        query[str(n)] = {"device_ms": device_ms, "host_ms": float(np.median(host))}
        log(f"kernels: B1 query launch n={n}: device_ms {device_ms:.4f} "
            f"host_ms (call + synchronize) {np.median(host):.4f}")

    turns = None
    if baseline is not None:
        _, err_b = check_b1(dev, baseline, "baseline B1", {(N_ROWS, 1, 0): [(200, 42)]})
        baseline_samples, turns = [], []
        for name in ("baseline", "new", "new", "baseline"):
            fn = baseline if name == "baseline" else H.bucket_ids_kernel
            t = time_cold(lambda: fn(reps1, 200), flush)
            if name == "baseline":
                baseline_samples += t
            turns.append([name, float(np.median(t))])
        log(f"kernels: B1 cold in turns at {N_ROWS} rows, k=1 (baseline bit-equal, "
            f"max_abs_err {err_b}): " + ", ".join(f"{a} {b:.4f}" for a, b in turns))
    k1 = cold[0]
    return {
        "name": "murmur3_bucket_ids",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/murmur3_bucket.cu",
        "replaces": "hyperspace_tpu/ops/hash.py:248",
        "launches": None,  # the main path's count, filled in by main
        "max_abs_err": max_err,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "cases": count,
        "timing": "cold: 256 MiB read before each run, median of 30",
        "cold_by_k": cold,
        "warm_ms": warm_ms,
        "query": query,
        "baseline_ms": float(np.median(baseline_samples)) if turns else None,
        "turns_ms": turns,
    }


I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
N_BUCKETS = 200


def b4_cases(rng) -> list:
    """Correctness cases of B4: (label, left keys, left offsets, right
    keys, right offsets, left mode, right mode), numpy. Mode "sorted": each
    segment is ascending already (a clean index bucket); "sort": the side
    is stably sorted per segment on the card first, as the main path does
    for unsorted buckets; "as is" (left only): the keys go to B4 in their
    own order, as the unindexed join's left does."""

    def case(label, l_sizes, r_sizes, lo, hi, l_mode, r_mode):
        l_sizes = np.asarray(l_sizes, dtype=np.int64)
        r_sizes = np.asarray(r_sizes, dtype=np.int64)
        l = rng.integers(lo, hi, int(l_sizes.sum()), dtype=np.int64, endpoint=True)
        r = rng.integers(lo, hi, int(r_sizes.sum()), dtype=np.int64, endpoint=True)
        l_offs = np.concatenate([[0], np.cumsum(l_sizes)])
        r_offs = np.concatenate([[0], np.cumsum(r_sizes)])
        for keys, offs, mode in ((l, l_offs, l_mode), (r, r_offs, r_mode)):
            if mode == "sorted":
                for a, b in zip(offs[:-1], offs[1:]):
                    keys[a:b].sort()
        return [label, l, l_offs, r, r_offs, l_mode, r_mode]

    out = []
    for nb in (1, 7, N_BUCKETS):
        ls = rng.integers(0, 3000, nb)
        rs = rng.integers(0, 3000, nb)
        out.append(case(f"presorted B={nb}", ls, rs, 0, 4000, "sorted", "sorted"))
        out.append(case(f"unsorted B={nb}", ls, rs, 0, 4000, "sort", "sort"))
        out.append(case(f"left unsorted B={nb}", ls, rs, -50, 50, "sort", "sorted"))
    sizes = np.array([0, 500, 0, 700, 300, 0, 900])
    out.append(case("empty left segments", sizes, sizes[::-1] + 1, 0, 300,
                    "sorted", "sorted"))
    out.append(case("empty right segments", sizes[::-1] + 1, sizes, 0, 300,
                    "sort", "sort"))
    out.append(case("n = 0", [0, 0, 0], [5, 0, 9], 0, 5, "sorted", "sorted"))
    out.append(case("m = 0", [5, 0, 9], [0, 0, 0], 0, 5, "sorted", "sorted"))
    out.append(case("n = m = 0", [0], [0], 0, 5, "sorted", "sorted"))
    out.append(case("row order", [40_000], [50_000], 0, 20_000, "as is", "sort"))
    ext = case("INT64_MIN / INT64_MAX", [1000, 1000], [1000, 1000], I64_MIN, I64_MAX,
               "sort", "sort")
    for arr in (ext[1], ext[3]):  # the extremes as real keys on both sides
        arr[::7] = I64_MAX
        arr[3::11] = I64_MIN
        arr[5::13] = -1
    out.append(ext)
    # the executor's null sentinels: left even offsets, right odd, and a
    # real key equal to one of them
    from hyperspace_tpu_torch.execution.join_exec import _SENTINEL_BASE

    sen = case("null sentinels", [800, 800], [800, 800], -10, 10, "sort", "sort")
    sen[1][::9] = _SENTINEL_BASE - 2 * np.arange(len(sen[1][::9]))
    sen[3][::9] = _SENTINEL_BASE - 2 * np.arange(len(sen[3][::9])) - 1
    sen[3][1] = _SENTINEL_BASE  # a real right key equal to a left sentinel
    out.append(sen)
    out.append(case("many-to-many", [3000, 3000], [3000, 3000], 0, 3, "sorted", "sorted"))
    skew = case("skewed segment", [100, 2000, 100], [100, 2000, 100], 0, 1000,
                "sort", "sort")
    skew[1][100:2100] = 42
    skew[3][100:2100] = 42
    out.append(skew)
    out.extend(b4_branch_cases())
    return out


def b4_branch_cases() -> list:
    """B4's edge cases, shared with the tests (``tests/torch_b4_cases.py``,
    numpy only): each search branch at its edges, presorted."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b4_cases import b4_edge_cases

    return [[label, l, l_offs, r, r_offs, "sorted", "sorted"]
            for label, (l, l_offs, r, r_offs) in b4_edge_cases().items()]


def b4_case_inputs(dev, l, l_offs, r, r_offs, l_mode, r_mode) -> tuple:
    """One case's B4 arguments on the card: (l_keys, l_offs, r_sorted,
    r_offs, l_row, r_row), a "sort" side sorted per segment first."""
    import torch

    from hyperspace_tpu_torch.ops import join as J

    lk = torch.from_numpy(l).to(dev)
    rk = torch.from_numpy(r).to(dev)
    l_row = r_row = None
    if l_mode == "sort":
        lk, l_row = J.segment_sort(lk, l_offs)
    if r_mode == "sort":
        rk, r_row = J.segment_sort(rk, r_offs)
    return lk, l_offs, rk, r_offs, l_row, r_row


def compare_b4(dev, lk, l_offs, rk, r_offs, l_row=None, r_row=None) -> int:
    """Hold B4 against its plain version on one set of inputs, with int32
    and with int64 lo / cnt; returns the max abs error (0, or it
    raises)."""
    import torch

    from hyperspace_tpu_torch.ops import join as J

    want = J.match_pairs_torch(lk, l_offs, rk, r_offs, l_row, r_row)
    err = 0
    for int64_index in (False, True):
        got = J.match_pairs_kernel(lk, l_offs, rk, r_offs, l_row, r_row, int64_index)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != torch.int64 or g.device != lk.device:
                raise AssertionError(f"B4: bad output {g.dtype} {tuple(g.shape)} "
                                     f"want {tuple(w.shape)}")
        err = max([err] + [int((g - w).abs().max()) if g.numel() else 0
                           for g, w in zip(got, want)])
        if err != 0:
            raise AssertionError(f"B4 pairs differ from the plain version "
                                 f"(int64 lo / cnt: {int64_index})")
    return err


def b4_bound(n: int, m: int, pairs: int, segments: int, probes: int,
             maps: int = 0) -> dict:
    """Least time of B4: the larger of its bytes (each left and right key
    read once, ``maps`` row maps of the left/right length read once, the
    offsets, 16 bytes written per pair) over HBM bandwidth and its
    integer operations over the int32 peak: 6 int32 operations (64-bit
    address, compare and bound update, two each) per binary-search probe
    and 4 per pair written (two 64-bit stores' addresses)."""
    nbytes = 8 * n + 8 * m + maps + 16 * (segments + 1) + 16 * pairs
    ops = 6 * probes + 4 * pairs
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes,
        "bytes_ms": bytes_ms,
        "int32_ops": ops,
        "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def b4_probes(l_offs: np.ndarray, r_offs: np.ndarray) -> int:
    """Binary-search probes of B4's count pass on these segments: per left
    row, the segment lookup over B + 1 offsets and the lower and upper
    bound over its right segment."""
    seg = np.ceil(np.log2(max(len(l_offs) - 1, 1))).astype(np.int64)
    r_len = np.diff(r_offs)
    per_row = seg + 2 * np.ceil(np.log2(r_len + 1)).astype(np.int64)
    return int(np.sum(np.diff(l_offs) * per_row))


def check_b4_cases(dev) -> tuple:
    """B4's cases against its plain version (phase 3): (count, max abs
    error)."""
    rng = np.random.default_rng(SEED + 3)
    count, max_err = 0, 0
    for _label, *case in b4_cases(rng):
        max_err = max(max_err, compare_b4(dev, *b4_case_inputs(dev, *case)))
        count += 1
    log(f"kernels: B4 pairs equal in order to plain over {count} cases, each with "
        f"int32 and with int64 lo / cnt (max_abs_err {max_err})")
    return count, max_err


class B4Inputs:
    """Keeps the inputs of the first B4 call that the join executor makes
    under each label: the very keys, offsets and row maps that phase 5
    hands the kernel, for the comparison with the plain version and the
    timing after the phase. The wrapper calls straight through, so its
    launches count as the main path's."""

    def __init__(self):
        from hyperspace_tpu_torch.execution import join_exec

        self.calls, self.label = {}, None
        inner = join_exec.match_pairs

        def recording(*args):
            if self.label is not None:
                self.calls.setdefault(self.label, args)
            return inner(*args)

        join_exec.match_pairs = recording


def time_b4(dev, args, flush) -> dict:
    """Cold and warm times of B4 on one set of inputs: count pass, the scan
    of its range totals, emit pass, and the three in sequence (B4's device
    work, int32 lo / cnt as the wrapper takes them here, and the int64
    instance), beside the bound; and the wrapper's whole call, its read of
    the total included."""
    import torch

    from hyperspace_tpu_torch.ops import join as J

    lk, l_offs, rk, r_offs, l_row, r_row = args
    l_offs, r_offs = np.asarray(l_offs, np.int64), np.asarray(r_offs, np.int64)
    stream = torch.cuda.current_stream().cuda_stream
    l_offs_t = torch.from_numpy(l_offs).to(dev)
    r_offs_t = torch.from_numpy(r_offs).to(dev)
    dtype = J.index_dtype(rk.shape[0])
    groups = {t: J._range_groups(lk.shape[0], t) for t in (torch.int32, torch.int64)}

    def count_pass(index=dtype):
        return J._count_pass(lk, l_offs_t, rk, r_offs_t, groups[index], index, stream)

    counts = count_pass()
    range_tot = counts.range_tot.clone()  # the totals, before the scan
    total = int(J._scan_pass(counts.range_tot, stream)[-1])
    li = torch.empty(total, dtype=torch.int64, device=dev)
    ri = torch.empty(total, dtype=torch.int64, device=dev)

    def sequence(index=dtype):  # count pass, scan, emit pass: B4's device work
        c = count_pass(index)
        J._scan_pass(c.range_tot, stream)
        J._emit_pass(c, l_row, r_row, li, ri, stream)

    med = lambda t: float(np.median(t))  # noqa: E731
    count_ms = med(time_cold(count_pass, flush))
    zeros = torch.zeros_like(range_tot)  # stays zero under repeated scans in place
    scan_ms = med(time_cold(lambda: J._scan_pass(zeros, stream), flush))
    torch_cumsum_ms = med(time_cold(lambda: torch.cumsum(range_tot, 0), flush))
    emit_ms = med(time_cold(lambda: J._emit_pass(counts, l_row, r_row, li, ri, stream),
                            flush))
    ms = med(time_cold(sequence, flush))
    int64_index_ms = med(time_cold(lambda: sequence(torch.int64), flush))
    call = []
    for _ in range(10):
        flush.sum()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J.match_pairs_kernel(lk, l_offs, rk, r_offs, l_row, r_row)
        torch.cuda.synchronize()
        call.append((time.perf_counter() - t0) * 1e3)
    maps = sum(8 * t.shape[0] for t in (l_row, r_row) if t is not None)
    b = b4_bound(lk.shape[0], rk.shape[0], total, len(l_offs) - 1,
                 b4_probes(l_offs, r_offs), maps)
    return {
        "n": lk.shape[0], "m": rk.shape[0], "segments": len(l_offs) - 1,
        "pairs": total, "row_maps": [l_row is not None, r_row is not None],
        "ms": ms, "count_ms": count_ms, "scan_ms": scan_ms, "emit_ms": emit_ms,
        "int64_index_ms": int64_index_ms, "torch_cumsum_ms": torch_cumsum_ms,
        "range_groups": groups[dtype],
        "warm_ms": time_cuda(sequence), "call_ms": med(call),
        "plain_ms": time_cuda(
            lambda: J.match_pairs_torch(lk, l_offs, rk, r_offs, l_row, r_row),
            launches=3, repeats=3),
        **b,
    }


def check_b4_main_path(dev, recorded: dict) -> int:
    """B4 on the inputs that phase 5 handed it: each recorded call held
    equal in order to the plain version; returns the max abs error."""
    labels = ("indexed", "unindexed", "two-key indexed", "two-key unindexed")
    missing = [k for k in labels if k not in recorded]
    if missing:
        raise AssertionError(f"phase 5 made no B4 call for {missing}")
    max_err = 0
    for label in labels:
        lk, l_offs, rk, r_offs, l_row, r_row = recorded[label]
        max_err = max(max_err, compare_b4(dev, lk, l_offs, rk, r_offs, l_row, r_row))
        log(f"kernels: B4 pairs equal in order to plain on phase 5's {label} join inputs "
            f"({lk.shape[0]} x {rk.shape[0]} keys, {len(l_offs) - 1} segments, row maps "
            f"{l_row is not None}/{r_row is not None}), int32 and int64 lo / cnt")
    if recorded["indexed"][4] is not None or recorded["indexed"][5] is not None:
        raise AssertionError("the indexed join did not take the presorted route")
    return max_err


def b4_replica(dev) -> dict:
    """B4's inputs in phase 5's two main calls, built on the card from the
    same keys without writing the tables: the indexed join's (orders'
    1,500,000 keys against lineitem's 6,001,215, each side in B1's 200
    buckets, key-sorted within each, identity row maps) and the unindexed
    join's (one segment: orders' keys in row order with their row map,
    lineitem's sorted with its sort permutation)."""
    import torch

    from hyperspace_tpu_torch.ops import hash as H
    from hyperspace_tpu_torch.ops.sort import sort_permutation

    items = torch.from_numpy(lineitem_columns()["l_orderkey"]).to(dev)
    orders = torch.arange(N_ORDERS, dtype=torch.int64, device=dev)

    def bucketed(keys):
        ids = H.bucket_ids_kernel(keys[None], N_BUCKETS).long()
        sizes = torch.bincount(ids, minlength=N_BUCKETS).cpu().numpy()
        perm = sort_permutation(keys[None], ids)
        return keys[perm], np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    order_r = sort_permutation(items[None])
    return {
        "indexed": (*bucketed(orders), *bucketed(items), None, None),
        "unindexed": (orders, np.array([0, N_ORDERS]), items[order_r],
                      np.array([0, N_ROWS]), torch.arange(N_ORDERS, device=dev), order_r),
    }


def b4_timed_inputs(dev, inputs: dict) -> dict:
    """The inputs B4 is timed on: the indexed and the unindexed join's
    (``inputs``), the unindexed ones with the left side shuffled (no window
    then serves any rows: every row searches global memory), and phase 3's
    "row order" case (random left keys)."""
    import torch

    lk, l_offs, rk, r_offs, l_row, r_row = inputs["unindexed"]
    perm = torch.from_numpy(np.random.default_rng(SEED + 8).permutation(
        lk.shape[0])).to(dev)
    row_order = next(c for c in b4_cases(np.random.default_rng(SEED + 3))
                     if c[0] == "row order")
    return {
        "indexed": inputs["indexed"],
        "unindexed": inputs["unindexed"],
        "unindexed, left shuffled": (lk[perm], l_offs, rk, r_offs, l_row[perm], r_row),
        "row order": b4_case_inputs(dev, *row_order[1:]),
    }


def b4_timings(dev, inputs: dict) -> dict:
    """Times B4 cold and warm on :func:`b4_timed_inputs`; logs each beside
    its bound; returns B4's record for the kernels line (launches and
    max_abs_err filled in by the caller)."""
    import torch

    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)  # 256 MiB
    timed = b4_timed_inputs(dev, inputs)
    t, u, shuffled, small = (time_b4(dev, timed[k], flush) for k in (
        "indexed", "unindexed", "unindexed, left shuffled", "row order"))

    # yardstick: both sides padded to [B, W] with INT64_MAX, one batched
    # torch.searchsorted per bound (the count pass's ranges, no pairs)
    lk, l_offs, rk, r_offs = inputs["indexed"][:4]

    def padded(keys, offs):
        sizes = torch.from_numpy(np.diff(offs)).to(dev)
        seg = torch.repeat_interleave(torch.arange(len(offs) - 1, device=dev), sizes)
        pos = torch.arange(keys.shape[0], device=dev) - torch.from_numpy(
            offs[:-1]).to(dev)[seg]
        out = torch.full((len(offs) - 1, int(sizes.max())), I64_MAX, dtype=torch.int64,
                         device=dev)
        out[seg, pos] = keys
        return out

    lp, rp = padded(lk, l_offs), padded(rk, r_offs)
    yard_ms = float(np.median(time_cold(
        lambda: (torch.searchsorted(rp, lp), torch.searchsorted(rp, lp, right=True)),
        flush)))
    for label, r in (("indexed join's", t), ("unindexed join's", u),
                     ("unindexed join's, left shuffled,", shuffled),
                     ('"row order" case\'s', small)):
        log(
            f"kernels: B4 cold on the {label} inputs, {r['n']} x {r['m']} keys, "
            f"{r['segments']} segments, row maps {r['row_maps']}, {r['pairs']} pairs: "
            f"ms {r['ms']:.4f} (count pass {r['count_ms']:.4f}, scan {r['scan_ms']:.4f}, "
            f"emit pass {r['emit_ms']:.4f}; int64 lo / cnt {r['int64_index_ms']:.4f}; "
            f"torch.cumsum over the range totals {r['torch_cumsum_ms']:.4f}; "
            f"{r['range_groups']} groups of 32 rows a warp) "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%}; bytes "
            f"{r['bytes']} -> {r['bytes_ms']:.4f} ms, int32 ops {r['int32_ops']} -> "
            f"{r['ops_ms']:.4f} ms); warm ms {r['warm_ms']:.4f}; wrapper call with its "
            f"total read ms {r['call_ms']:.4f}; plain_ms {r['plain_ms']:.4f}"
        )
    log(f"kernels: batched torch.searchsorted over the indexed join's [{len(l_offs) - 1}, "
        f"W] buckets (yardstick, ranges only) cold ms {yard_ms:.4f}; library_ms n/a")
    keys = ("n", "m", "pairs", "ms", "count_ms", "scan_ms", "emit_ms", "int64_index_ms",
            "torch_cumsum_ms",
            "warm_ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "bytes")
    return {
        "name": "bucket_match_pairs",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/bucket_match.cu",
        "replaces": "hyperspace_tpu/ops/join.py:142",
        "launches": None,  # the main path's count, filled in by main
        "max_abs_err": 0,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "timing": "cold: 256 MiB read before each run, median of 30; count pass, "
                  "scan of the range totals and emit pass, on the indexed join's "
                  "inputs",
        "pairs": t["pairs"],
        "bytes": t["bytes"],
        "count_ms": t["count_ms"],
        "scan_ms": t["scan_ms"],
        "emit_ms": t["emit_ms"],
        "int64_index_ms": t["int64_index_ms"],
        "torch_cumsum_ms": t["torch_cumsum_ms"],
        "warm_ms": t["warm_ms"],
        "call_ms": t["call_ms"],
        "searchsorted_yardstick_ms": yard_ms,
        "unindexed": {k: u[k] for k in keys},
        "unindexed_left_shuffled": {k: shuffled[k] for k in keys},
        "row_order_case": {k: small[k] for k in keys},
    }


def lineitem_columns() -> dict:
    """The bench.py lineitem shape at SF1 scale, columns in file order."""
    rng = np.random.default_rng(SEED)
    l_orderkey = rng.integers(0, N_ORDERS, N_ROWS, dtype=np.int64)
    l_shipdate = np.datetime64("1994-01-01") + rng.integers(
        0, 2400, N_ROWS
    ).astype("timedelta64[D]")
    l_quantity = rng.integers(1, 51, N_ROWS, dtype=np.int64)
    l_extendedprice = rng.normal(30000, 8000, N_ROWS)
    order = np.argsort(l_shipdate, kind="stable")
    return {
        "l_orderkey": l_orderkey[order],
        "l_shipdate": l_shipdate[order].astype("datetime64[D]"),
        "l_quantity": l_quantity[order],
        "l_extendedprice": l_extendedprice[order],
    }


def gen_lineitem(out_dir: str) -> str:
    """:func:`lineitem_columns` as 8 Parquet files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols = lineitem_columns()
    cols["l_shipdate"] = pa.array(cols["l_shipdate"])
    items = pa.table(cols)
    src = os.path.join(out_dir, "lineitem")
    os.makedirs(src)
    for i in range(N_FILES):
        lo, hi = i * N_ROWS // N_FILES, (i + 1) * N_ROWS // N_FILES
        pq.write_table(items.slice(lo, hi - lo), os.path.join(src, f"part{i}.parquet"))
    return src


def phase4_keys() -> tuple:
    """Phase 4's 32 point keys and 4 IN-lists of 8 keys (phase 11 filters
    on them too)."""
    rng = np.random.default_rng(SEED + 1)
    point_keys = [int(k) for k in rng.integers(0, N_ORDERS, 32)]
    in_lists = [[int(k) for k in rng.integers(0, N_ORDERS, 8)] for _ in range(4)]
    return point_keys, in_lists


def filter_path(work: str, device) -> dict:
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import ops

    t0 = time.perf_counter()
    src = gen_lineitem(work)
    log(f"main path: generated {N_ROWS} rows in {N_FILES} files in "
        f"{time.perf_counter() - t0:.2f}s")

    sess = HyperspaceSession(device=device)
    sess.conf.set("hyperspace.system.path", os.path.join(work, "indexes"))
    hs = Hyperspace(sess)
    df = sess.read.parquet(src)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, write_peak_bytes = write_peak(lambda: hs.create_index(
        df, CoveringIndexConfig("li_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"])))
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()["murmur3_bucket_ids"]
    entry = hs.get_index("li_idx")
    files = entry.content.files
    rows = sum(pq.ParquetFile(f).metadata.num_rows for f in files)
    log(
        f"main path: build {build_s:.3f}s, {N_ROWS / build_s:,.0f} rows/s, "
        f"{len(files)} bucket files, {rows} rows, stages "
        f"{ {k: round(v, 4) for k, v in sess.build_stats.items()} }, "
        f"B1 launches {build_launches}, data write's peak device bytes {write_peak_bytes:,}"
    )
    if rows != N_ROWS or len(files) != 200 or build_launches <= 0:
        raise AssertionError("build did not index every row through B1")
    legacy = legacy_build(work, device, src, files, build_s, dict(sess.build_stats))
    build_launches = ops.launch_counts()["murmur3_bucket_ids"]

    point_keys, in_lists = phase4_keys()
    queries = [df["l_orderkey"] == k for k in point_keys] + [
        df["l_orderkey"].isin(keys) for keys in in_lists
    ]

    def plan(cond):
        return df.filter(cond).select("l_orderkey", "l_shipdate", "l_quantity")

    sess.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    sess.enable_hyperspace()
    for cond in queries:
        text = hs.explain(plan(cond))
        used = text.split("Indexes used:")[1]
        if "Name: li_idx" not in text or "li_idx" not in used:
            raise AssertionError(f"index not used for {cond!r}:\n{text}")
    plan(queries[0]).collect()  # first query pays one-time set-up
    sess.exec_stats.reset()
    served, times = [], []
    for cond in queries:
        t0 = time.perf_counter()
        served.append(plan(cond).collect())
        times.append((time.perf_counter() - t0) * 1e3)
    total_launches = ops.launch_counts()["murmur3_bucket_ids"]
    query_launches = total_launches - build_launches
    stats = sess.exec_stats.as_dict()
    p50, p99 = np.percentile(times, [50, 99])
    n_point = len(point_keys)
    log(
        f"main path: {len(queries)} index-served queries p50_ms {p50:.3f} "
        f"p99_ms {p99:.3f} (point p50_ms {np.median(times[:n_point]):.3f}, "
        f"IN-list p50_ms {np.median(times[n_point:]):.3f}); "
        f"B1 launches {query_launches}; fused range masks (B3a) "
        f"{stats['fused_range_masks']}; general device masks "
        f"{stats['device_filter_evals']}; host Unsupported masks "
        f"{stats['host_filter_evals']}; bucket-pruned scans "
        f"{stats['bucket_pruned_scans']}"
    )
    if query_launches <= 0 or stats["host_filter_evals"] != 0:
        raise AssertionError("queries did not run through B1 and the device mask")
    if stats["bucket_pruned_scans"] != len(queries):
        raise AssertionError("not every query was bucket-pruned")

    # A point filter reads one bucket, whose rows keep source order among
    # equal keys, so it must match the unindexed plan row for row. An IN
    # list spans buckets and comes out bucket by bucket, so it must match
    # as a multiset (both sides sorted by every column).
    sess.disable_hyperspace()
    base_times, n_rows = [], 0
    for i, (cond, got) in enumerate(zip(queries, served)):
        t0 = time.perf_counter()
        want = plan(cond).collect()
        base_times.append((time.perf_counter() - t0) * 1e3)
        if i >= len(point_keys):
            keys = [(c, "ascending") for c in want.column_names]
            got, want = got.sort_by(keys), want.sort_by(keys)
        if not got.equals(want):
            raise AssertionError(f"index-served rows differ for {cond!r}")
        n_rows += got.num_rows
    if n_rows == 0:
        raise AssertionError("no query matched a row")
    log(
        f"main path: all {len(queries)} queries equal the unindexed plan "
        f"({n_rows} rows); unindexed p50_ms "
        f"{np.percentile(base_times, 50):.3f}"
    )
    return {"launches": total_launches, "all_launches": ops.launch_counts(),
            "session": sess, "hs": hs, "items": df, "src": src, "legacy_build": legacy,
            "li_write_peak": write_peak_bytes,
            "p50_ms": float(p50), "p99_ms": float(p99)}


def file_sha(path: str) -> str:
    import hashlib

    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def legacy_build(work: str, device, src: str, files, build_s: float, stages: dict) -> dict:
    """li_idx built once more, in a session of its own, with
    ``hyperspace.index.build.partitionFirst`` off (the legacy route: the
    whole sorted batch gathered, then written): its 200 bucket files must
    equal the pipelined build's byte for byte. Both builds' seconds and
    stages are logged side by side; the copy is removed after."""
    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession

    root = os.path.join(work, "indexes_legacy")
    sess = HyperspaceSession(device=device)
    sess.conf.set("hyperspace.system.path", root)
    sess.conf.set("hyperspace.index.build.partitionFirst", False)
    hs = Hyperspace(sess)
    t0 = time.perf_counter()
    hs.create_index(sess.read.parquet(src), CoveringIndexConfig(
        "li_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"]))
    legacy_s = time.perf_counter() - t0
    legacy_files = hs.get_index("li_idx").content.files
    names = sorted(os.path.basename(f) for f in files)
    if sorted(os.path.basename(f) for f in legacy_files) != names:
        raise AssertionError("the legacy build wrote other bucket files")
    by_name = {os.path.basename(f): f for f in legacy_files}
    for f in files:
        if file_sha(f) != file_sha(by_name[os.path.basename(f)]):
            raise AssertionError(f"{os.path.basename(f)} differs between the two build routes")
    keys = ("scan", "hash_shuffle", "sort", "write", "zonemap_capture", "sidecar_capture")
    out = {"pipelined_s": build_s, "legacy_s": legacy_s,
           "pipelined_stages": {k: stages.get(k) for k in keys},
           "legacy_stages": {k: sess.build_stats.get(k) for k in keys}, "files_equal": len(files)}
    shutil.rmtree(root, ignore_errors=True)
    tails = [(st.get("sort") or 0.0) + (st.get("write") or 0.0)
             for st in (out["pipelined_stages"], out["legacy_stages"])]
    out["sort_write_s"] = {"pipelined": tails[0], "legacy": tails[1]}
    log(f"main path: li_idx pipelined (partitionFirst on) {build_s:.3f}s against legacy "
        f"(off, the source files read warm) {legacy_s:.3f}s; sort + write "
        f"{tails[0]:.4f} / {tails[1]:.4f}s; stages s "
        + ", ".join(f"{k} {out['pipelined_stages'][k] or 0:.4f} / "
                    f"{out['legacy_stages'][k] or 0:.4f}" for k in keys)
        + f"; all {len(files)} bucket files byte-equal")
    return out


def gen_orders(out_dir: str) -> str:
    """The bench.py orders shape at SF1 scale, 8 Parquet files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED + 4)
    orders = pa.table(
        {
            "o_orderkey": np.arange(N_ORDERS, dtype=np.int64),
            "o_custkey": rng.integers(0, N_ORDERS // 10, N_ORDERS),
            "o_totalprice": rng.normal(150000, 30000, N_ORDERS),
        }
    )
    src = os.path.join(out_dir, "orders")
    os.makedirs(src)
    for i in range(N_FILES):
        lo, hi = i * N_ORDERS // N_FILES, (i + 1) * N_ORDERS // N_FILES
        pq.write_table(orders.slice(lo, hi - lo), os.path.join(src, f"part{i}.parquet"))
    return src


def gen_null_keyed(out_dir: str, name: str, cols, seed: int, n: int = 200_000) -> str:
    """Two int64 key columns (about 1 % nulls in each) and a value."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    k1, k2, v = cols
    table = pa.table(
        {
            k1: pa.array(rng.integers(0, 20_000, n), mask=rng.random(n) < 0.01),
            k2: pa.array(rng.integers(0, 5, n), mask=rng.random(n) < 0.01),
            v: rng.integers(0, 1000, n),
        }
    )
    src = os.path.join(out_dir, name)
    os.makedirs(src)
    for i in range(2):
        pq.write_table(table.slice(i * n // 2, n // 2), os.path.join(src, f"p{i}.parquet"))
    return src


def sorted_rows(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


def index_served(hs, df, names) -> None:
    text = hs.explain(df)
    with_plan = text.split("Plan without indexes:")[0]
    if with_plan.count("Hyperspace(Type: CI") != 2 or not all(
        f"Name: {n}," in with_plan for n in names
    ):
        raise AssertionError(f"join not index-served on both sides:\n{text}")


def join_path(work: str, ctx: dict, b4_inputs: B4Inputs) -> dict:
    """Phase 5: orders ⋈ lineitem served from both indexes, then a two-key
    join with null keys; launch counts read from 0 at its start. Each
    plan's first B4 inputs are kept in ``b4_inputs`` under its label."""
    from hyperspace_tpu_torch import CoveringIndexConfig
    from hyperspace_tpu_torch import ops

    sess, hs, items = ctx["session"], ctx["hs"], ctx["items"]
    src = ctx["orders_src"] = gen_orders(work)
    ops.reset_launch_counts()
    orders = sess.read.parquet(src)
    t0 = time.perf_counter()
    hs.create_index(
        orders, CoveringIndexConfig("o_idx", ["o_orderkey"], ["o_custkey", "o_totalprice"])
    )
    log(f"join path: built o_idx over {N_ORDERS} rows in {time.perf_counter() - t0:.3f}s, "
        f"stages { {k: round(v, 4) for k, v in sess.build_stats.items()} }, "
        f"B1 launches {ops.launch_counts()['murmur3_bucket_ids']}")

    def q():
        return orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
            "o_orderkey", "o_custkey", "l_quantity")

    sess.enable_hyperspace()
    index_served(hs, q(), ("o_idx", "li_idx"))
    sess.exec_stats.reset()
    before = ops.launch_counts()
    b4_inputs.label = "indexed"
    q().collect()  # warm-up, sequential (the default route)
    pipe = "hyperspace.serve.pipeline.enabled"
    times = {True: [], False: []}
    stages = {True: [], False: []}
    got = None
    for rnd in range(4):  # interleaved: on, off, off, on, on, off, off, on
        for on in ((True, False) if rnd % 2 == 0 else (False, True)):
            sess.conf.set(pipe, on)
            t0 = time.perf_counter()
            out = q().collect()
            times[on].append((time.perf_counter() - t0) * 1e3)
            stages[on].append(dict(sess.join_stats))
            if got is None:
                got = out
            elif not out.equals(got):
                raise AssertionError(f"join rows differ in order with {pipe}={on}")
    sess.conf.set(pipe, False)
    ctx["join_p50_ms"] = {"sequential": float(np.median(times[False])),
                          "pipelined": float(np.median(times[True]))}
    after = ops.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    b4_indexed = launched["bucket_match_pairs"]
    stats = sess.exec_stats.as_dict()
    if b4_indexed <= 0 or stats["co_bucketed_joins"] != 9 or stats["unbucketed_joins"]:
        raise AssertionError(f"indexed join did not run co-bucketed through B4: "
                             f"{stats}, B4 launches {b4_indexed}")
    if launched["murmur3_bucket_ids"] or launched["range_mask"]:
        raise AssertionError(f"the join sides ran device work besides B4: {launched}")
    if got.num_rows != N_ROWS:
        raise AssertionError(f"join gave {got.num_rows} rows, want {N_ROWS}")
    for on in (True, False):
        p50, p99 = np.percentile(times[on], [50, 99])
        stage_p50 = {k: float(np.median([st.get(k, 0.0) for st in stages[on]]))
                     for k in stages[on][0]}
        log(f"join path: orders ⋈ lineitem index-served, {pipe}={str(on).lower()} x4 "
            f"(interleaved): p50_ms {p50:.3f} p99_ms {p99:.3f}, {got.num_rows} rows, "
            f"stage p50 s { {k: round(v, 4) for k, v in stage_p50.items()} }")
    p50, p99 = np.percentile(times[True], [50, 99])
    log(f"join path: rows equal in order with the pipeline on and off; B4 launches "
        f"{b4_indexed} ({b4_indexed // 9} per join), B1 and B3a launches 0 across the "
        f"9 joins (no device work on the side threads), co-bucketed joins "
        f"{stats['co_bucketed_joins']}")

    sess.disable_hyperspace()
    b4_inputs.label = "unindexed"
    base_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        want = q().collect()
        base_times.append((time.perf_counter() - t0) * 1e3)
    base_stages = dict(sess.join_stats)
    stats = sess.exec_stats.as_dict()
    if stats["unbucketed_joins"] != 2:
        raise AssertionError(f"unindexed plan did not run unbucketed: {stats}")
    if not sorted_rows(got).equals(sorted_rows(want)):
        raise AssertionError("index-served join rows differ from the unindexed plan")
    log(f"join path: rows equal to the unindexed plan as a multiset; unindexed ms "
        f"{', '.join(f'{t:.3f}' for t in base_times)}, stages s "
        f"{ {k: round(v, 4) for k, v in base_stages.items()} }")

    a_src = gen_null_keyed(work, "nk_a", ("k1", "k2", "va"), SEED + 5)
    b_src = gen_null_keyed(work, "nk_b", ("j1", "j2", "vb"), SEED + 6)
    a, b = sess.read.parquet(a_src), sess.read.parquet(b_src)
    for df, name, cols in ((a, "nk_a_idx", (["k1", "k2"], ["va"])),
                           (b, "nk_b_idx", (["j1", "j2"], ["vb"]))):
        hs.create_index(df, CoveringIndexConfig(name, *cols))
        log(f"join path: built {name}, stages "
            f"{ {k: round(v, 4) for k, v in sess.build_stats.items()} }")

    def q2():
        return a.join(b, on=(a["k1"] == b["j1"]) & (a["k2"] == b["j2"])).select(
            "k1", "k2", "va", "vb")

    sess.enable_hyperspace()
    index_served(hs, q2(), ("nk_a_idx", "nk_b_idx"))
    sess.exec_stats.reset()
    b4_inputs.label = "two-key indexed"
    got2 = q2().collect()
    if sess.exec_stats.co_bucketed_joins != 1:
        raise AssertionError("two-key join did not run co-bucketed")
    sess.disable_hyperspace()
    b4_inputs.label = "two-key unindexed"
    want2 = q2().collect()
    b4_inputs.label = None
    if got2.num_rows == 0 or got2.column("k1").null_count or got2.column("k2").null_count:
        raise AssertionError("two-key join gave no rows or matched a null key")
    if not sorted_rows(got2).equals(sorted_rows(want2)):
        raise AssertionError("two-key null join differs from the unindexed plan")
    launches = ops.launch_counts()
    log(f"join path: two-key join with null keys, {got2.num_rows} rows, equal to the "
        f"unindexed plan; phase launches {launches}")
    return {"launches": launches, "p50_ms": p50, "p99_ms": p99}


# -- kernel B3a: the fused range mask -------------------------------------------


def b3a_batch_args(batch, expr, dev, offset: bool = False):
    """(route, RangeArgs or None) of ``expr`` over a host batch: the
    lowering the executor takes, the columns on ``dev``. With ``offset``
    every column and validity mask is a view one element into a fresh
    allocation, 8 (or 1) bytes off the vector loads' alignment, so the
    kernel's scalar instance runs."""
    import torch

    from hyperspace_tpu_torch.ops import filter as F

    terms = F.lower_range_terms(expr, batch)
    if terms is None:
        raise AssertionError(f"B3a: {expr!r} does not lower to range terms")
    args = F.range_args(batch, terms, dev)
    if args is None:
        return "general", None
    if args == F.NEVER_MATCH:
        return "never", None
    if offset:
        def shifted(t):
            buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=dev)
            buf[1:].copy_(t)
            return buf[1:]

        args.cols = [shifted(c) for c in args.cols]
        args.valids = [None if m is None else shifted(m) for m in args.valids]
    return "fused", args


def compare_b3a(args) -> int:
    """Hold B3a against its plain version on one set of inputs; returns
    the max abs error (0, or it raises)."""
    import torch

    from hyperspace_tpu_torch.ops import filter as F

    got = F.range_mask_kernel(args)
    torch.cuda.synchronize()
    want = F.range_mask_torch(args)
    if got.dtype != torch.bool or got.shape != want.shape or got.device != want.device:
        raise AssertionError(f"B3a: bad output {got.dtype} {tuple(got.shape)}")
    err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max()) if args.n else 0
    if err != 0:
        raise AssertionError("B3a mask differs from the plain version")
    return err


def check_b3a_cases(dev) -> tuple:
    """B3a's cases (``tests/torch_b3a_cases.py``) on the card: each
    predicate at each row count lowers by the route the case names; a
    fused one is held against the plain version with aligned columns and
    with views off the vector alignment, and against the host evaluator;
    a NEVER_MATCH one gives all-False without a launch. Returns (count,
    max abs error)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b3a_cases import B3A_PREDICATES, ROWS, b3a_table

    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.plan import expressions as E

    count, max_err = 0, 0
    for n in ROWS:
        batch = ColumnarBatch.from_arrow(b3a_table(n))
        for label, (build, route) in B3A_PREDICATES.items():
            expr = build(E)
            host = E.filter_mask(expr, batch)
            got_route, args = b3a_batch_args(batch, expr, dev)
            if got_route != route:
                raise AssertionError(f"B3a case {label!r} took route {got_route}, "
                                     f"want {route}")
            before = F.launches
            fused = F.fused_range_mask(expr, batch, dev)
            if route == "general":
                if fused is not None:
                    raise AssertionError(f"B3a case {label!r}: fused route taken")
                continue
            if not np.array_equal(fused, host):
                raise AssertionError(f"B3a case {label!r}, n={n}: differs from the host")
            if route == "never":
                if F.launches != before or fused.any():
                    raise AssertionError(f"B3a case {label!r}: launched or matched")
                continue
            max_err = max(max_err, compare_b3a(args))
            max_err = max(max_err, compare_b3a(b3a_batch_args(batch, expr, dev, True)[1]))
            count += 1
    torch.cuda.synchronize()
    log(f"kernels: B3a masks equal to plain over {count} cases, each with aligned "
        f"columns and with views off the vector alignment, and to the host evaluator "
        f"(max_abs_err {max_err}); NEVER_MATCH cases launch nothing; the +-2^53 float "
        f"bounds on int columns take the general device mask")
    return count, max_err


class B3aInputs:
    """Keeps the predicate and the host batch of the first fused range
    mask each label's plans ask for (the executor's ``fused_range_mask``),
    for the comparison with the plain version and the timing after phase
    7. The wrapper calls straight through, so its launches count as the
    main path's."""

    def __init__(self):
        from hyperspace_tpu_torch.execution import executor

        self.calls, self.label = {}, None
        inner = executor.fused_range_mask

        def recording(expr, batch, device):
            if self.label is not None:
                self.calls.setdefault(self.label, (expr, batch))
            return inner(expr, batch, device)

        executor.fused_range_mask = recording


def check_b3a_main_path(dev, recorded: dict) -> int:
    """B3a on the inputs phase 7's queries handed it: each recorded
    residual held equal to the plain version; returns the max abs error."""
    want = [f"{i} {f:.1%}" for i in ("li_idx", "li_rg_idx") for f in RANGE_FRACTIONS]
    missing = [k for k in want + ["li_idx date cut-off"] if k not in recorded]
    if missing:
        raise AssertionError(f"phase 7 made no fused range mask for {missing}")
    max_err = 0
    for label, (expr, batch) in recorded.items():
        route, args = b3a_batch_args(batch, expr, dev)
        if route != "fused":
            raise AssertionError(f"phase 7's {label} residual took route {route}")
        max_err = max(max_err, compare_b3a(args))
        log(f"kernels: B3a mask equal to plain on phase 7's {label} residual "
            f"({args.n} rows, {len(args.cols)} columns, {len(args.term_col)} terms)")
    return max_err


def b3a_timings(dev, recorded: dict, labels) -> dict:
    """Times B3a on phase 7's recorded residuals under ``labels``; logs each
    beside its bound, the plain version, the general device mask and the
    copy; returns B3a's record for the kernels line from the first."""
    import torch

    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)  # 256 MiB
    timed = {}
    for label in labels:
        expr, batch = recorded[label]
        _route, args = b3a_batch_args(batch, expr, dev)
        timed[label] = r = time_b3a(args, batch, expr, flush)
        log(f"kernels: B3a cold on phase 7's {label} residual, {r['n']} rows, "
            f"{r['columns']} columns, {r['terms']} terms: ms {r['ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%}; bytes {r['bytes']} -> "
            f"{r['bytes_ms']:.4f} ms, int32 ops {r['int32_ops']} -> {r['ops_ms']:.4f} ms); "
            f"warm ms {r['warm_ms']:.4f}; plain_ms {r['plain_ms']:.4f}; general device "
            f"mask (B3 torch ops, columns on the card) warm ms {r['general_mask_ms']:.4f}, "
            f"cold ms {r['general_mask_cold_ms']:.4f}; host-to-device copy of the columns "
            f"and validity (host clock) ms {r['h2d_ms']:.4f}; library_ms n/a")
    label = labels[0]
    r = timed[label]
    keys = ("n", "columns", "terms", "bytes", "ms", "warm_ms", "plain_ms", "bound_ms",
            "general_mask_ms", "general_mask_cold_ms", "h2d_ms")
    return {
        "name": "range_mask",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/range_mask.cu",
        "replaces": "hyperspace_tpu/ops/filter.py:561",
        "launches": None,  # the main path's count, filled in by main
        "max_abs_err": 0,
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
        "timing": f"cold: 256 MiB read before each run, median of 30; on phase 7's "
                  f"{label} residual",
        **{k: r[k] for k in ("n", "columns", "terms", "bytes", "warm_ms",
                              "general_mask_ms", "general_mask_cold_ms", "h2d_ms")},
        "other_residuals": {k: {x: v[x] for x in keys} for k, v in timed.items()
                            if k != label},
    }


def b3a_bound(args) -> dict:
    """Least time of B3a on one set of inputs: the larger of its bytes
    (each distinct column read once, 8 bytes a row; each validity mask
    once, 1 byte a row; the mask written, 1 byte a row) over HBM bandwidth
    and its operations over the int32 peak: 6 a term and row (two 64-bit
    compares at 2 int32 operations each, two ANDs) and 1 a validity mask
    and row."""
    n = args.n
    nvalid = sum(m is not None for m in args.valids)
    nbytes = n * (8 * len(args.cols) + nvalid + 1)
    ops = n * (6 * len(args.term_col) + nvalid)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes,
        "bytes_ms": bytes_ms,
        "int32_ops": ops,
        "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def time_b3a(args, batch, expr, flush) -> dict:
    """B3a on one recorded set of inputs: cold, warm and the plain
    version, beside the bound; the general device mask (B3's torch ops)
    on the same columns already on the card; and the host-to-device copy
    of the columns and validity masks that the fused route makes a
    query."""
    import torch

    from hyperspace_tpu_torch.ops import filter as F

    med = lambda t: float(np.median(t))  # noqa: E731
    ms = med(time_cold(lambda: F.range_mask_kernel(args), flush))
    warm_ms = time_cuda(lambda: F.range_mask_kernel(args))
    plain_ms = time_cuda(lambda: F.range_mask_torch(args), launches=5, repeats=3)
    # B3's torch-op mask with its argument tensors moved once (cached)
    prep = F._Prep(batch)
    spec = prep.lower(expr)
    dargs = F._Args(prep.args, args.cols[0].device)

    def general():
        vals, known = F._eval_spec(spec, dargs, batch.num_rows)
        return vals & known

    if not torch.equal(general(), F.range_mask_kernel(args)):
        raise AssertionError("B3a and the general device mask differ on phase 7's inputs")
    general_ms = time_cuda(general, launches=5, repeats=3)
    general_cold_ms = med(time_cold(general, flush, iters=10))
    h2d = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F.range_args(batch, F.lower_range_terms(expr, batch), args.cols[0].device)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    return {"n": args.n, "columns": len(args.cols), "terms": len(args.term_col),
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "general_mask_ms": general_ms, "general_mask_cold_ms": general_cold_ms,
            "h2d_ms": med(h2d), **b3a_bound(args)}


RANGE_FRACTIONS = (0.001, 0.01, 0.1)  # of the orderkeys a range query spans
# a date cut-off between two ticks of the date column: it lowers exactly
# for the mask (l_shipdate < 1996-01-02) but not for pyarrow's pushdown
# filters, so the residual mask runs over every row of the index
SHIP_CUTOFF = "1996-01-01T12:00"


def range_path(work: str, ctx: dict, b3a_inputs: B3aInputs) -> dict:
    """Phase 7: range filters ``l_orderkey >= a AND l_orderkey < b AND
    l_quantity < 24`` over about 0.1 %, 1 % and 10 % of the orderkeys,
    first over phase 4's li_idx (200 buckets, one row group a file: zone
    maps prune nothing, pyarrow's pushdown filters thin the read), with a
    fourth query ``l_orderkey >= 0 AND l_shipdate < SHIP_CUTOFF`` whose
    residual mask runs over all 6,001,215 rows; then the three ranges over
    li_rg_idx (8 buckets, about 12 row groups a file: row-group narrowing
    keeps about one a file at the narrow end). Each query is index-served,
    takes the fused route (B3a) with the fused pipeline off, equals the
    unindexed plan as a multiset and the same plan without range pruning
    in order; then 5 runs on the default route (the fused pipeline on: the
    fused select, B3b, for residuals of 32,768 rows or more), rows equal
    in order, with its route, p50 and B3b / B3a launches. Launch counts
    read from 0 at its start."""
    from hyperspace_tpu_torch import CoveringIndexConfig
    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.indexes import zonemaps

    sess, hs, items = ctx["session"], ctx["hs"], ctx["items"]
    ops.reset_launch_counts()
    # the mask route (B3a) first, with the fused pipeline off; then the
    # default route, where residuals of 32,768 rows or more take the fused
    # select (B3b)
    sess.conf.set(FUSED_SWITCH, False)
    rng = np.random.default_rng(SEED + 9)
    key, qty, ship = items["l_orderkey"], items["l_quantity"], items["l_shipdate"]
    queries = []  # (label suffix, condition, selected columns)
    for frac in RANGE_FRACTIONS:
        width = int(frac * N_ORDERS)
        a = int(rng.integers(0, N_ORDERS - width))
        queries.append((f"{frac:.1%}", (key >= a) & (key < a + width) & (qty < 24),
                        ("l_orderkey", "l_quantity")))
    cutoff = ("date cut-off", (key >= 0) & (ship < np.datetime64(SHIP_CUTOFF)),
              ("l_orderkey", "l_shipdate"))
    results = []
    for index in ("li_idx", "li_rg_idx"):
        if index == "li_rg_idx":
            sess.conf.set("hyperspace.index.num_buckets", 8)
            t0 = time.perf_counter()
            hs.create_index(items, CoveringIndexConfig(
                "li_rg_idx", ["l_orderkey"], ["l_quantity"]))
            sess.conf.set("hyperspace.index.num_buckets", N_BUCKETS)
            files = hs.get_index("li_rg_idx").content.files
            log(f"range path: built li_rg_idx (8 buckets) in "
                f"{time.perf_counter() - t0:.3f}s, {len(files)} files, stages "
                f"{ {k: round(v, 4) for k, v in sess.build_stats.items()} }")
        for suffix, cond, cols in queries + ([cutoff] if index == "li_idx" else []):
            label = f"{index} {suffix}"

            def plan():
                return items.filter(cond).select(*cols)

            sess.enable_hyperspace()
            text = hs.explain(plan())
            with_plan, used = text.split("Plan without indexes:")[0], text.split(
                "Indexes used:")[1]
            if f"Name: {index}," not in with_plan or index not in used:
                raise AssertionError(f"{label}: {index} not used:\n{text}")
            b3a_inputs.label = label
            plan().collect()  # warm-up
            b3a_inputs.label = None
            sess.exec_stats.reset()
            before = ops.launch_counts()["range_mask"]
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                got = plan().collect()
                times.append((time.perf_counter() - t0) * 1e3)
            prune = dict(zonemaps.last_prune_stats)
            stats = sess.exec_stats.as_dict()
            launched = ops.launch_counts()["range_mask"] - before
            if launched <= 0 or stats["host_filter_evals"] or stats["fused_range_masks"] != 5:
                raise AssertionError(f"{label}: not masked by B3a: {stats}, "
                                     f"launches {launched}")
            sess.conf.set("hyperspace.serve.rangeprune.enabled", False)
            unpruned = plan().collect()
            sess.conf.set("hyperspace.serve.rangeprune.enabled", True)
            if not got.equals(unpruned):
                raise AssertionError(f"{label}: rows differ from the unpruned plan")
            sess.disable_hyperspace()
            want = plan().collect()
            if got.num_rows == 0 or not sorted_rows(got).equals(sorted_rows(want)):
                raise AssertionError(f"{label}: rows differ from the unindexed plan")
            # the default route: residuals of 32,768 rows or more take the
            # fused select (B3b), smaller ones stay on B3a
            sess.enable_hyperspace()
            sess.conf.set(FUSED_SWITCH, True)
            sess.exec_stats.reset()
            before = ops.launch_counts()
            default_times = []
            for _ in range(5):
                t0 = time.perf_counter()
                default_got = plan().collect()
                default_times.append((time.perf_counter() - t0) * 1e3)
            dstats = sess.exec_stats.as_dict()
            after = ops.launch_counts()
            sess.conf.set(FUSED_SWITCH, False)
            sess.disable_hyperspace()
            if not default_got.equals(got):
                raise AssertionError(f"{label}: the default route's rows differ from B3a's")
            if dstats["fused_selects"] == 5:
                default_route = "fused select (B3b)"
            elif dstats["fused_range_masks"] == 5:
                default_route = "mask (B3a)"
            else:
                raise AssertionError(f"{label}: the default route took no single route: {dstats}")
            p50 = float(np.median(times))
            residual = b3a_inputs.calls[label][1].num_rows
            r = {"query": label, "rows": got.num_rows, "residual_rows": residual,
                 "p50_ms": p50, "b3a_launches": launched,
                 "default_route": default_route,
                 "default_p50_ms": float(np.median(default_times)),
                 "default_b3b_launches": after["fused_select"] - before["fused_select"],
                 "default_b3a_launches": after["range_mask"] - before["range_mask"],
                 **{k: prune.get(k) for k in ("files_kept", "files_total",
                                              "row_groups_kept", "row_groups_total",
                                              "zonemap_files_sidecar",
                                              "zonemap_files_footer")}}
            results.append(r)
            log(f"range path: {label}: p50_ms {p50:.3f} over 5, {got.num_rows} rows from a "
                f"residual of {residual}; files kept {r['files_kept']}/{r['files_total']}, "
                f"row groups kept {r['row_groups_kept']}/{r['row_groups_total']}; zone maps "
                f"from sidecar {r['zonemap_files_sidecar']}, footer "
                f"{r['zonemap_files_footer']}; B3a launches {launched}; equal to the "
                f"unpruned plan in order and to the unindexed plan as a multiset; default "
                f"route (fused pipeline on) {default_route}: p50_ms "
                f"{r['default_p50_ms']:.3f} over 5, B3b launches "
                f"{r['default_b3b_launches']}, B3a launches {r['default_b3a_launches']}, rows "
                f"equal in order")
    narrow = next(r for r in results if r["query"] == f"li_rg_idx {RANGE_FRACTIONS[0]:.1%}")
    if narrow["row_groups_kept"] > 2 * narrow["files_total"]:
        raise AssertionError(f"row-group narrowing kept too much: {narrow}")
    sess.conf.set(FUSED_SWITCH, True)
    launches = ops.launch_counts()
    log(f"range path: phase launches {launches}")
    return {"launches": launches, "queries": results}


# ---------------------------------------------------------------------------
# Phase 8: aggregates, ORDER BY and LIMIT (kernel B5)
# ---------------------------------------------------------------------------

AGG_LO, AGG_HI = 375_000, 562_500  # bench.py's agg_lo / agg_hi at SF1
E_SHIP_CUTOFF = "1994-02-01"
PEAK_F64_FLOPS = 34e12  # H100 SXM FP64 outside the tensor cores (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores


def aggregate_queries(F, df) -> dict:
    """Phase 8's queries over a lineitem DataFrame ``df`` of either
    session, with ``F`` the port's functions module."""
    key, qty, ship = df["l_orderkey"], df["l_quantity"], df["l_shipdate"]
    window = df.filter((key >= AGG_LO) & (key < AGG_HI))
    return {
        "a": window.agg(F.count(), F.sum("l_quantity"), F.avg("l_quantity"),
                        F.min("l_shipdate"), F.max("l_shipdate")),
        "b": window.group_by("l_quantity").agg(F.count(), F.sum("l_extendedprice")),
        "c": df.agg(F.sum("l_extendedprice"), F.min("l_extendedprice"),
                    F.max("l_extendedprice")),
        "d": df.group_by("l_orderkey").agg(F.sum("l_quantity").alias("q"))
        .sort(("q", False), "l_orderkey").limit(100),
        "e_top": df.filter(ship < np.datetime64(E_SHIP_CUTOFF))
        .sort(("l_extendedprice", False)).limit(10),
        "e_stream": df.filter(qty == 7).limit(1000),
    }


def check_b5_cases(dev) -> tuple:
    """B5's cases (``tests/torch_b5_cases.py``) on the card: every launch
    function on each case and on each group layout around its 2,048-row
    ranges, with and without nulls, bit-equal to the plain version on a
    CPU copy; returns (count, max abs error)."""
    import torch

    from hyperspace_tpu_torch.ops import aggregate as A

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5_cases import B5_CASES, b5_kernel_errors, b5_layouts, groups

    count, max_err = 0, 0.0
    for gid, vals, valid, num in B5_CASES.values():
        perm, offs = groups(gid, num)
        v, unsigned = A.device_values(vals, dev)
        ok = None if valid is None else torch.from_numpy(valid).to(dev)
        errs = b5_kernel_errors(perm.to(dev), offs.to(dev), v, ok, unsigned)
        max_err, count = max(max_err, *errs.values()), count + 1
    for perm, offs, vals in b5_layouts().values():
        p = None if perm is None else torch.from_numpy(perm).to(dev)
        o = torch.from_numpy(offs).to(dev)
        for dtype in ("float64", "float32", "int64", "uint64"):
            host = vals[dtype].view(np.int64) if dtype == "uint64" else vals[dtype]
            v = torch.from_numpy(host).to(dev)
            for valid in (None, torch.from_numpy(vals["valid"]).to(dev)):
                errs = b5_kernel_errors(p, o, v, valid, unsigned=dtype == "uint64")
                max_err, count = max(max_err, *errs.values()), count + 1
    torch.cuda.synchronize()
    if max_err != 0:
        raise AssertionError(f"B5 differs from its plain version (max_abs_err {max_err})")
    log(f"kernels: B5 (sum and count, float fold, min, max, count of valid rows) bit-equal "
        f"to the plain version over {count} cases (max_abs_err {max_err})")
    return count, max_err


class B5Inputs:
    """Keeps every B5 call the aggregate executor makes while ``label`` is
    set (the phase's warm-up runs): the op, its device tensors and the
    host values each column came from, for the comparison with the plain
    version and the timing after the phase. The wrappers call straight
    through, so their launches count as the main path's."""

    OPS = ("segment_sum_count", "segment_minmax", "segment_count")

    def __init__(self):
        from hyperspace_tpu_torch.ops import aggregate as A

        self.calls, self.host, self.label = {}, {}, None
        # phase 20's frontend threads record under one window label; the
        # calls from the frontend's ``hs-serve-*`` workers count in
        # ``serve_calls``
        self._lock = threading.Lock()
        self.serve_calls = 0
        for op in self.OPS:
            setattr(A, op, self._recording(op, getattr(A, op)))
        inner_values = A.device_values

        def values(host, device):
            out = inner_values(host, device)
            if self.label is not None:
                with self._lock:
                    self.host[id(out[0])] = host  # the recorded call keeps the tensor alive
            return out

        A.device_values = values

    def _recording(self, op, inner):
        def recording(*args):
            label = self.label
            if label is not None:
                serving = threading.current_thread().name.startswith(SERVE_THREADS)
                with self._lock:
                    self.calls.setdefault(label, []).append((op, args))
                    self.serve_calls += serving
            return inner(*args)

        return recording


def compare_b5_call(op, args) -> float:
    """One recorded B5 call: the kernel on its device tensors against the
    plain version on CPU copies (the float fold's plain version needs the
    CPU's ordered ``index_add_``); returns the max abs error."""
    import torch

    from hyperspace_tpu_torch.ops import aggregate as A
    from torch_b5_cases import abs_err

    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    if op == "segment_count":
        if args[2] is None:  # group sizes: no reduction runs
            return 0.0
        return abs_err(A.segment_count_kernel(*args), A.segment_count_torch(*cpu))
    if op == "segment_minmax":
        return abs_err(A.segment_minmax_kernel(*args), A.segment_minmax_torch(*cpu))
    got, want = A.segment_sum_count_kernel(*args), A.segment_sum_count_torch(*cpu)
    return max(abs_err(got[0], want[0]), abs_err(got[1], want[1]))


def b5_bound(op, args, chain_ns: dict) -> dict:
    """Least time of one B5 call: the larger of its bytes (the permutation,
    values and validity read once, the offsets read once, the per-group
    outputs written once) over HBM bandwidth and its adds or compares
    over the peak of their type; for the float fold also the chain bound,
    the longest group's length times one dependent add's latency."""
    perm, offs, vals, valid = args[0], args[1], args[2], args[3] if len(args) > 3 else None
    if op == "segment_count":
        perm, offs, valid, vals = args[0], args[1], args[2], None
    n = int(valid.numel() if vals is None else vals.numel())
    groups = int(offs.numel()) - 1
    nbytes = 8 * (groups + 1) + (0 if perm is None else 8 * n) + (0 if valid is None else n)
    out_bytes = 8 * groups
    if vals is not None:
        nbytes += vals.element_size() * n
        out_bytes = (16 if op == "segment_sum_count" else vals.element_size()) * groups
    nbytes += out_bytes
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    floats = vals is not None and vals.dtype.is_floating_point
    if floats:
        peak = PEAK_F64_FLOPS if vals.element_size() == 8 else PEAK_F32_FLOPS
        ops_ms = n / peak * 1e3
    else:  # a 64-bit add or compare (2 int32 ops) and a count add a row
        ops_ms = 3 * n / PEAK_INT32_OPS_PER_S * 1e3
    out = {"n": n, "groups": groups, "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if floats and op == "segment_sum_count":
        longest = int((offs[1:] - offs[:-1]).max()) if groups else 0
        ns = chain_ns["f64" if vals.element_size() == 8 else "f32"]
        out.update(longest_group=longest, add_latency_ns=ns, chain_bound_ms=longest * ns * 1e-6)
    return out


def b5_library_call(op, args):
    """The PyTorch call that computes the same reduction on the card
    (``index_add_`` for sums and for the count of valid rows, whose
    validity it takes as int64, converted before the timing;
    ``scatter_reduce_`` for MIN and MAX), on the same values in row order;
    float sums through its atomics are not bit-equal to the ordered fold.
    Returns a function to time."""
    import torch

    perm, offs, vals = args[0], args[1], args[2]
    n, groups = vals.numel(), offs.numel() - 1
    gid_sorted = torch.repeat_interleave(
        torch.arange(groups, device=vals.device), offs[1:] - offs[:-1], output_size=n)
    gid = gid_sorted if perm is None else torch.empty_like(gid_sorted).scatter_(0, perm, gid_sorted)
    if op == "segment_count":
        ones = vals.to(torch.int64)
        return lambda: torch.zeros(groups, dtype=torch.int64, device=vals.device).index_add_(
            0, gid, ones)
    if op == "segment_sum_count":
        return lambda: torch.zeros(groups, dtype=vals.dtype, device=vals.device).index_add_(
            0, gid, vals)
    reduce = "amin" if args[4] == "min" else "amax"
    return lambda: torch.empty(groups, dtype=vals.dtype, device=vals.device).scatter_reduce_(
        0, gid, vals, reduce, include_self=False)


B5_KERNELS = {"segment_sum_count": ("segment_sum_count_kernel", "segment_sum_count_torch"),
              "segment_minmax": ("segment_minmax_kernel", "segment_minmax_torch"),
              "segment_count": ("segment_count_kernel", "segment_count_torch")}
B5_LIBRARY = {"segment_sum_count": "index_add_", "segment_minmax": "scatter_reduce_",
              "segment_count": "index_add_ of the validity"}


def time_b5(label, op, args, flush, chain_ns, host_values) -> dict:
    """B5 on one call: cold (L2 flushed) and warm, beside the bound, the
    plain version (on the card, or for the float fold on a CPU copy by the
    host clock), the library call, and the host-to-device copy of the
    column's values (of the validity, for a count)."""
    import torch

    from hyperspace_tpu_torch.ops import aggregate as A

    med = lambda t: float(np.median(t))  # noqa: E731
    kernel, plain = (getattr(A, f) for f in B5_KERNELS[op])
    fold = op == "segment_sum_count" and args[2].dtype.is_floating_point
    slow = fold and int(args[1][-1]) > 1_000_000
    ms = med(time_cold(lambda: kernel(*args), flush, iters=8 if slow else 30))
    warm_ms = time_cuda(lambda: kernel(*args), launches=3 if slow else 30,
                        repeats=3 if slow else 5)
    if fold:
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            plain(*cpu)
            t.append((time.perf_counter() - t0) * 1e3)
        plain_ms, plain_where = med(t), "cpu (host clock)"
    else:
        plain_ms, plain_where = time_cuda(lambda: plain(*args), launches=3, repeats=3), "card"
    library_ms = time_cuda(b5_library_call(op, args), launches=3 if slow else 10, repeats=3)
    h2d = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if op == "segment_count":
            torch.from_numpy(host_values).to(args[2].device)
        else:
            A.device_values(host_values, args[2].device)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    r = {"query": label, "op": op if not fold else "float fold",
         "mode": args[4] if op == "segment_minmax" else None,
         "dtype": str(args[2].dtype).replace("torch.", ""), "identity_perm": args[0] is None,
         "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "plain_on": plain_where,
         "library_ms": library_ms, "library": B5_LIBRARY[op], "h2d_ms": med(h2d),
         **b5_bound(op, args, chain_ns)}
    extra = (f"; chain bound {r['chain_bound_ms']:.4f} ms (longest group {r['longest_group']} "
             f"x {r['add_latency_ns']:.3f} ns)" if "chain_bound_ms" in r else "")
    log(f"kernels: B5 {r['op']}{'' if r['mode'] is None else ' ' + r['mode']} cold on phase "
        f"8's query {label} ({r['n']} rows, {r['groups']} groups, {r['dtype']}, "
        f"perm {'identity' if r['identity_perm'] else 'given'}): ms {ms:.4f}, warm ms "
        f"{warm_ms:.4f}; bound_ms {r['bound_ms']:.4f} ({r['bound_ms'] / ms:.1%}; bytes "
        f"{r['bytes']}){extra}; plain_ms {plain_ms:.4f} ({plain_where}); library_ms "
        f"{library_ms:.4f} ({r['library']}{', not bit-equal: atomics' if fold else ''}); "
        f"host-to-device copy of the {'validity' if op == 'segment_count' else 'values'} "
        f"{r['h2d_ms']:.4f} ms (host clock)")
    return r


def b5_pass_ms(fn, flush, iters: int = 10) -> dict:
    """Each B5 kernel that ``fn`` launches (range pass, fix-up pass, fold),
    over ``iters`` runs each after the L2 flush, from torch.profiler's
    kernel records: the median ms from its start to its end, and for the
    fix-up pass also how long it runs on after the range pass ends (its
    blocks launch early, as programmatic dependents, and wait for the
    range pass, so its span overlaps). {} when the profiler recorded no
    device kernel (the card's tracing unavailable)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    spans = {}
    for ev in prof.events():
        for name in ("range_pass", "fixup_pass", "fold_sum"):
            if name in ev.name:
                spans.setdefault(name, []).append((ev.time_range.start, ev.time_range.end))
    out = {f"{name}_ms": float(np.median([e - s for s, e in v])) / 1e3
           for name, v in sorted(spans.items())}
    if "range_pass" in spans and "fixup_pass" in spans:
        pairs = zip(sorted(spans["range_pass"]), sorted(spans["fixup_pass"]))
        out["fixup_after_range_ms"] = float(np.median([f[1] - r[1] for r, f in pairs])) / 1e3
    return out


def build_chain_probe():
    """Start nvcc on scripts/torch_chain_probe.cu beside the package build;
    returns (process, library path)."""
    from hyperspace_tpu_torch import kernels

    out_dir = os.path.join(ROOT, "build", "chain_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libchain_probe.so")
    src = os.path.join(ROOT, "scripts", "torch_chain_probe.cu")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def add_latency_ns(proc, lib: str) -> dict:
    """Nanoseconds of one dependent add (float64 and float32) on the card:
    one thread's chain of 2^20 and 2^22 adds, each timed with CUDA events
    (median of 3), the difference over the extra adds."""
    import ctypes

    import torch

    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the chain probe:\n{out}")
    fn = ctypes.CDLL(lib).hs_add_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    res = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        acc = torch.zeros(1, dtype=dtype, device="cuda")
        x = torch.full((1,), 1e-3, dtype=dtype, device="cuda")

        def run(iters):
            err = fn(acc.data_ptr(), x.data_ptr(), iters, int(dtype == torch.float64),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"chain probe launch failed: CUDA error {err}")

        ms = {}
        for iters in (1 << 20, 1 << 22):
            run(iters)
            t = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                run(iters)
                end.record()
                end.synchronize()
                t.append(start.elapsed_time(end))
            ms[iters] = float(np.median(t))
        res[name] = (ms[1 << 22] - ms[1 << 20]) * 1e6 / ((1 << 22) - (1 << 20))
    log(f"kernels: dependent add latency (one thread's chain, chain probe): float64 "
        f"{res['f64']:.3f} ns, float32 {res['f32']:.3f} ns")
    return res


def pyarrow_int_checks(label, got, src_table) -> None:
    """The integer columns of phase 8's answers against pyarrow's own
    group_by over the source rows."""
    import pyarrow.compute as pc

    t = src_table
    if label in ("a", "b"):
        k = t.column("l_orderkey")
        t = t.filter(pc.and_(pc.greater_equal(k, AGG_LO), pc.less(k, AGG_HI)))
    if label == "a":
        want = {"count(*)": t.num_rows, "sum(l_quantity)": pc.sum(t["l_quantity"]).as_py(),
                "min(l_shipdate)": pc.min(t["l_shipdate"]).as_py(),
                "max(l_shipdate)": pc.max(t["l_shipdate"]).as_py()}
        row = got.to_pylist()[0]
        if any(row[k] != v for k, v in want.items()):
            raise AssertionError(f"query a differs from pyarrow: {row} against {want}")
    elif label == "b":
        want = t.group_by("l_quantity").aggregate([([], "count_all")])
        got_map = dict(zip(got["l_quantity"].to_pylist(), got["count(*)"].to_pylist()))
        if got_map != dict(zip(want["l_quantity"].to_pylist(), want["count_all"].to_pylist())):
            raise AssertionError("query b's counts differ from pyarrow's group_by")
    elif label == "d":
        want = (t.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
                .sort_by([("l_quantity_sum", "descending"), ("l_orderkey", "ascending")])
                .slice(0, 100))
        if (got["l_orderkey"].to_pylist() != want["l_orderkey"].to_pylist()
                or got["q"].to_pylist() != want["l_quantity_sum"].to_pylist()):
            raise AssertionError("query d differs from pyarrow's group_by")
    elif label == "e_stream":
        q = got["l_quantity"].to_numpy()
        if got.num_rows != 1000 or not (q == 7).all():
            raise AssertionError("query e_stream's rows are not 1000 rows of l_quantity 7")


def aggregate_path(work: str, ctx: dict, b5_inputs: B5Inputs) -> dict:
    """Phase 8: queries a-e over lineitem (``aggregate_queries``) through
    the default cuda session, with li_idx (phase 4), li_rg_idx (phase 7)
    and o_idx (phase 5) active. Each query: explain as the rules choose,
    one warm-up (its B5 calls recorded), p50 over 5 runs with stage
    seconds; rows equal in order, floats bit for bit, to the same query
    in a ``device="cpu"`` session of the port; equal as a multiset to the
    plan with Hyperspace disabled (d in order); integer columns equal to
    pyarrow's group_by. Launch counts read from 0 at its start."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import HyperspaceSession, functions as F
    from hyperspace_tpu_torch import ops

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5_cases import same_rows

    sess, hs, items, src = ctx["session"], ctx["hs"], ctx["items"], ctx["src"]
    cpu = HyperspaceSession(device="cpu")
    for key in ("hyperspace.system.path", "hyperspace.index.filterRule.useBucketSpec"):
        cpu.conf.set(key, sess.conf.get(key))
    cpu.enable_hyperspace()
    source = pq.read_table(src)
    ops.reset_launch_counts()
    sess.enable_hyperspace()
    queries = aggregate_queries(F, items)
    cpu_queries = aggregate_queries(F, cpu.read.parquet(src))
    sizes = {n: hs.get_index(n).content.size_in_bytes for n in ("li_idx", "li_rg_idx")}
    smallest = min(sizes, key=lambda n: (sizes[n], n))
    results = []
    for label, q in queries.items():
        text = hs.explain(q)
        used = text.split("Indexes used:")[1].split("\n")[2].split()[0]
        if label == "d" and used != smallest:
            raise AssertionError(f"d: the aggregate rule took {used}, not the smallest "
                                 f"covering index {smallest} ({sizes}):\n{text}")
        if label == "a" and used == "(none)":
            raise AssertionError(f"a: not index-served:\n{text}")
        b5_inputs.label = label
        q.collect()  # warm-up
        b5_inputs.label = None
        times, stages = [], []
        before = ops.launch_counts()["segment_reduce"]
        for _ in range(5):
            t0 = time.perf_counter()
            got = q.collect()
            times.append((time.perf_counter() - t0) * 1e3)
            stages.append(dict(sess.agg_stats))
        launched = ops.launch_counts()["segment_reduce"] - before
        on_cpu = cpu_queries[label].collect()
        if not same_rows(got, on_cpu):
            raise AssertionError(f"{label}: rows differ from the cpu session's")
        sess.disable_hyperspace()
        want = q.collect()
        sess.enable_hyperspace()
        if label != "d":
            got_cmp, want = sorted_rows(got), sorted_rows(want)
        else:
            got_cmp = got
        if got.num_rows == 0 or not same_rows(got_cmp, want):
            raise AssertionError(f"{label}: rows differ from the plan without Hyperspace")
        pyarrow_int_checks(label, got, source)
        p50 = float(np.median(times))
        stage_p50 = {k: float(np.median([s.get(k, 0.0) for s in stages]))
                     for k in sorted({k for s in stages for k in s})}
        results.append({"query": label, "p50_ms": p50, "rows": got.num_rows, "index": used,
                        "b5_launches": launched, "stages_p50_s": stage_p50})
        log(f"aggregate path: {label}: p50_ms {p50:.3f} over 5, {got.num_rows} rows, index "
            f"{used}; stage p50 s { {k: round(v, 4) for k, v in stage_p50.items()} }; B5 "
            f"launches {launched}; equal to the cpu session bit for bit, to the plan without "
            f"Hyperspace{' in order' if label == 'd' else ' as a multiset'}, and to pyarrow "
            f"in its integer columns")
    launches = ops.launch_counts()
    if launches["segment_reduce"] <= 0:
        raise AssertionError("phase 8 launched B5 no time")
    log(f"aggregate path: phase launches {launches}")
    return {"launches": launches, "queries": results}


def check_b5_main_path(recorded: dict, where: str = "phase 8") -> tuple:
    """B5 on the inputs phase 8's queries handed it (or ``where`` says what
    made them): every recorded call held against the plain version;
    returns (calls, max abs error)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    calls, max_err = 0, 0.0
    for label, recs in recorded.items():
        for op, args in recs:
            err = compare_b5_call(op, args)
            if err != 0:
                raise AssertionError(f"B5 {op} on query {label}'s inputs differs from the "
                                     f"plain version (max_abs_err {err})")
            calls += 1
    log(f"kernels: B5 equal bit for bit to the plain version on all {calls} calls of {where} "
        f"(queries {sorted(recorded)})")
    return calls, max_err


def b5_small_group_calls(args, host) -> list:
    """MIN, MAX and the count of valid rows on the layout of query d's
    integer SUM ``args`` (its permutation and 1,472,478 groups of 1-7
    rows): MIN and MAX over its values, as the query's column has no
    nulls; the count over a validity with about 10 % nulls from a seed,
    since without one no kernel runs. -> [(op, args, host values)]."""
    import torch

    perm, offs, vals = args[0], args[1], args[2]
    fill = {"min": I64_MAX, "max": I64_MIN}
    valid_host = np.random.default_rng(SEED + 9).random(vals.numel()) > 0.1
    valid = torch.from_numpy(valid_host).to(vals.device)
    return [("segment_minmax", (perm, offs, vals, None, m, fill[m], False), host)
            for m in ("min", "max")] + [("segment_count", (perm, offs, valid), valid_host)]


def b5_timings(dev, recorded: dict, hosts: dict, chain_ns: dict) -> dict:
    """Times B5 on the recorded calls of queries b (the float fold over 50
    groups), c (the fold over one group of 6,001,215 rows, and its MIN)
    and d (the integer SUM over 1,472,478 groups), then MIN, MAX and the
    count of valid rows on d's layout (:func:`b5_small_group_calls`, each
    held bit-equal to its plain version first), and each pass's own time
    on c's MIN and d's SUM (:func:`b5_pass_ms`); returns B5's record for
    the kernels line, headed by d's call."""
    import torch

    from hyperspace_tpu_torch.ops import aggregate as A

    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)  # 256 MiB

    def first(label, op, mode=None):
        for o, args in recorded[label]:
            if o == op and (mode is None or args[4] == mode):
                return args, hosts[id(args[2])]
        raise AssertionError(f"query {label} made no {op} call")

    picks = [("d", "segment_sum_count", None), ("b", "segment_sum_count", None),
             ("c", "segment_sum_count", None), ("c", "segment_minmax", "min")]
    timed = []
    for label, op, mode in picks:
        args, host = first(label, op, mode)
        timed.append(time_b5(label, op, args, flush, chain_ns, host))
    d_args, d_host = first("d", "segment_sum_count")
    for op, args, host in b5_small_group_calls(d_args, d_host):
        err = compare_b5_call(op, args)
        if err != 0:
            raise AssertionError(f"B5 {op} on query d's layout differs from the plain version "
                                 f"(max_abs_err {err})")
        timed.append(time_b5("d", op, args, flush, chain_ns, host))
    passes = {}
    for label, op, mode in (("c", "segment_minmax", "min"), ("d", "segment_sum_count", None)):
        args, _ = first(label, op, mode)
        kernel = getattr(A, B5_KERNELS[op][0])
        passes[f"{label} {mode or 'sum'}"] = ms = b5_pass_ms(lambda: kernel(*args), flush)
        log(f"kernels: B5 passes on query {label}'s {mode or 'integer sum'} call, cold, "
            f"torch.profiler's kernel records: "
            + (", ".join(f"{k} {v:.4f}" for k, v in ms.items()) or "not measured "
               "(no device time recorded)"))
    head = timed[0]
    return {
        "name": "segment_reduce",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "hyperspace_tpu/ops/aggregate.py:25",
        "launches": None,  # the main path's count, filled in by main
        "max_abs_err": 0,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timing": f"cold: 256 MiB read before each run, median; on phase 8's query d "
                  f"(integer SUM, {head['groups']} groups)",
        **{k: head[k] for k in ("n", "groups", "bytes", "warm_ms", "h2d_ms")},
        "other_inputs": timed[1:],
        "passes_ms": passes,
    }


def b5_replica(dev) -> tuple:
    """B5's calls in phase 8's queries b, c and d, built on the card from
    phase 4's generators and seeds without writing the tables: d's integer
    SUM of l_quantity over li_rg_idx's rows (l_orderkey in B1's 8 buckets,
    key-sorted within each) in the stable group sort by l_orderkey; b's
    float fold of l_extendedprice over the agg window's source rows in 50
    groups by l_quantity; c's fold and MIN of l_extendedprice over every
    row (the identity). -> (recorded calls by query, host values by id of
    the device values), as :class:`B5Inputs` keeps them."""
    import torch

    from hyperspace_tpu_torch.ops import aggregate as A
    from hyperspace_tpu_torch.ops import hash as H
    from hyperspace_tpu_torch.ops.sort import sort_permutation

    cols = lineitem_columns()
    hosts = {}

    def values(host):
        v, _ = A.device_values(host, dev)
        hosts[id(v)] = host
        return v

    def group_sort(keys):
        perm = sort_permutation(keys[None])
        srt = keys[perm]
        starts = torch.nonzero(srt[1:] != srt[:-1]).flatten() + 1
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        return perm, torch.cat([zero, starts, zero + keys.numel()])

    key = torch.from_numpy(cols["l_orderkey"]).to(dev)
    stored = sort_permutation(key[None], H.bucket_ids_kernel(key[None], 8).long())
    d_perm, d_offs = group_sort(key[stored])
    d_vals = values(cols["l_quantity"][stored.cpu().numpy()])
    window = (cols["l_orderkey"] >= AGG_LO) & (cols["l_orderkey"] < AGG_HI)
    b_perm, b_offs = group_sort(torch.from_numpy(cols["l_quantity"][window]).to(dev))
    b_vals = values(cols["l_extendedprice"][window])
    c_offs = torch.tensor([0, N_ROWS], dtype=torch.int64, device=dev)
    c_vals = values(cols["l_extendedprice"])
    recorded = {
        "d": [("segment_sum_count", (d_perm, d_offs, d_vals, None))],
        "b": [("segment_sum_count", (b_perm, b_offs, b_vals, None))],
        "c": [("segment_sum_count", (None, c_offs, c_vals, None)),
              ("segment_minmax", (None, c_offs, c_vals, None, "min", None, False))],
    }
    return recorded, hosts


# ---------------------------------------------------------------------------
# Phase 3 (B3b, B5f) and phase 9: the aggregate index plane and the fused
# filter→aggregate / filter→select (kernels B5f and B3b)
# ---------------------------------------------------------------------------


def check_b3b_b5f_cases(dev) -> tuple:
    """B3b's and B5f's cases (``tests/torch_b5f_cases.py``) on the card,
    each bit-equal to its plain version (B3b's indices against
    ``torch.nonzero`` of the plain mask on the same device columns, B5f's
    carried state after every chunk against the plain version's on the
    CPU), each timed cold (host clock around a synchronised call after the
    L2 flush: both read their counts back); NEVER_MATCH launches nothing.
    Returns (count, max abs error)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5f_cases import B3B_CASES, B5F_CASES, fused_kernel_errors, port_plan
    from torch_b5f_cases import select_kernel_errors

    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops import filter as F

    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    count, times = 0, {}
    for name, (table, terms) in B3B_CASES.items():
        before = F.select_launches
        if select_kernel_errors(table, terms, dev) != 0:
            raise AssertionError(f"B3b case {name!r} differs from its plain version")
        batch = ColumnarBatch.from_arrow(table)
        got = F.fused_filter_select(list(terms), batch, dev)
        if not np.array_equal(got, np.nonzero(F.range_mask_numpy(batch, list(terms)))[0]):
            raise AssertionError(f"B3b case {name!r} differs from np.nonzero of the mask")
        if name in ("never_match", "empty") and F.select_launches != before:
            raise AssertionError(f"B3b case {name!r} launched")
        args = F.range_args(batch, list(terms), dev)
        if args is not None and args != F.NEVER_MATCH and batch.num_rows:
            times[f"b3b {name}"] = host_cold_ms(lambda: F.select_kernel(args), flush)
        count += 1
    for name, case in B5F_CASES.items():
        errs = fused_kernel_errors(case, dev)
        if any(errs.values()):
            raise AssertionError(f"B5f case {name!r} differs from its plain version: {errs}")
        plan = port_plan(case)
        batches = [ColumnarBatch.from_arrow(t) for t in case["chunks"]]

        def run():
            st = PC.AggState(plan, dev)
            for b in batches:
                st.accumulate(b)

        times[f"b5f {name}"] = host_cold_ms(run, flush)
        count += 1
    torch.cuda.synchronize()
    log(f"kernels: B3b indices and B5f states equal bit for bit to their plain versions over "
        f"{count} cases (tests/torch_b5f_cases.py); NEVER_MATCH launches nothing; cold ms "
        f"(host clock, synchronised, L2 flushed) "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return count, 0


def host_cold_ms(fn, flush, iters: int = 5) -> float:
    """Median host-clock milliseconds of ``fn`` followed by a
    synchronise, each run after reading ``flush``: for a call that reads a
    count back from the card mid-way, so the device events would time the
    host's round trip anyway."""
    import torch

    fn()
    out = []
    for _ in range(iters):
        flush.sum()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


class B3bInputs:
    """Keeps the terms and host batch of the first fused select each label's
    plans ask for (``ops/filter.fused_filter_select``, as the executor's
    fused Filter calls it), for the timing after phase 9. Calls straight
    through, so its launches count as the main path's."""

    def __init__(self):
        from hyperspace_tpu_torch.ops import filter as F

        self.calls, self.label = {}, None
        inner = F.fused_filter_select

        def recording(terms, batch, device):
            if self.label is not None:
                self.calls.setdefault(self.label, (list(terms), batch))
            return inner(terms, batch, device)

        F.fused_filter_select = recording


def agg_plane_queries(F, df) -> dict:
    """Phase 9's queries over a lineitem DataFrame of either session:
    label -> (plan, the index the rules should take, the switch of the
    route under test)."""
    key, qty = df["l_orderkey"], df["l_quantity"]
    window = (key >= AGG_LO) & (key < AGG_HI)
    return {
        "m1": (df.filter(key >= 0).group_by("l_quantity").agg(
            F.count().alias("n"), F.min("l_orderkey").alias("mn"),
            F.max("l_orderkey").alias("mx"), F.sum("l_orderkey").alias("s")),
            "li_rg_idx", AGG_SWITCH),
        "m2": (df.filter(window).agg(F.count(), F.sum("l_quantity"), F.min("l_quantity"),
                                     F.max("l_quantity")), "li_rg_idx", AGG_SWITCH),
        "f1": (aggregate_queries(F, df)["a"], "li_idx", FUSED_SWITCH),
        "f2": (df.filter(window).group_by("l_quantity").agg(
            F.count(), F.sum("l_quantity"), F.min("l_shipdate"), F.max("l_shipdate")),
            "li_idx", FUSED_SWITCH),
        "s1": (df.filter(window & (qty < 24)).select("l_shipdate"), "li_idx", FUSED_SWITCH),
    }


def aggplane_path(work: str, ctx: dict, b3b_inputs: B3bInputs) -> dict:
    """Phase 9: the aggregate index plane and the fused routes over phase
    4's lineitem, li_idx and li_rg_idx with the sidecars their creates
    captured (``agg_plane_queries``): m1 from metadata alone, m2 with its
    boundary row groups through B5f, f1 and f2 on the fused aggregate,
    s1 on the fused select. Each: explain names its index; one warm-up;
    5 rounds of the route on and off in turns (p50 of each, the route's
    stats); rows equal bit for bit in order to the route off, to a
    ``device="cpu"`` session's and to the plan without Hyperspace (s1 as a
    multiset: index rows come bucket by bucket). Then the
    ``_aggstate.json`` of li_rg_idx, li_idx and o_idx against the doc a
    cpu session computes over the same files. Launch counts read from 0
    at its start."""
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import HyperspaceSession, functions as F
    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.indexes import aggindex

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5_cases import same_rows

    sess, hs, items, src = ctx["session"], ctx["hs"], ctx["items"], ctx["src"]
    cpu = HyperspaceSession(device="cpu")
    for key in ("hyperspace.system.path", "hyperspace.index.filterRule.useBucketSpec"):
        cpu.conf.set(key, sess.conf.get(key))
    cpu.enable_hyperspace()
    ops.reset_launch_counts()
    sess.enable_hyperspace()
    queries = agg_plane_queries(F, items)
    cpu_queries = agg_plane_queries(F, cpu.read.parquet(src))
    results = []
    for label, (q, index, switch) in queries.items():
        text = hs.explain(q)
        if f"Name: {index}," not in text.split("Plan without indexes:")[0]:
            raise AssertionError(f"{label}: {index} not used:\n{text}")
        b3b_inputs.label = label
        q.collect()  # warm-up
        b3b_inputs.label = None
        on_ms, off_ms, stages, got = [], [], [], None
        for _ in range(5):
            for route in (True, False):
                sess.conf.set(switch, route)
                PC.last_aggplane_stats, PC.last_fused_stats = {}, {}
                sess.exec_stats.reset()
                t0 = time.perf_counter()
                out = q.collect()
                (on_ms if route else off_ms).append((time.perf_counter() - t0) * 1e3)
                if route:
                    got, stats = out, (dict(PC.last_aggplane_stats), dict(PC.last_fused_stats),
                                       sess.exec_stats.as_dict())
                    stages.append(dict(sess.agg_stats))
                elif not same_rows(got, out):
                    raise AssertionError(f"{label}: rows differ with {switch} off")
        sess.conf.set(switch, True)
        plane, fused, counts = stats
        if label == "m1" and not (plane.get("mode") == "agg_metadata"
                                  and plane["row_groups_scanned"] == 0
                                  and plane["row_groups_metadata"] == plane["row_groups_total"]
                                  == 96):
            raise AssertionError(f"m1: not answered from metadata alone: {plane}")
        if label == "m2" and not (plane.get("mode") == "agg_metadata"
                                  and plane["row_groups_metadata"] > 0):
            raise AssertionError(f"m2: not answered from metadata: {plane}")
        if label in ("f1", "f2") and fused.get("mode") != "agg":
            raise AssertionError(f"{label}: not on the fused aggregate: {fused}")
        if label == "s1" and fused.get("mode") != "select":
            raise AssertionError(f"s1: not on the fused select: {fused}")
        if not same_rows(got, cpu_queries[label][0].collect()):
            raise AssertionError(f"{label}: rows differ from the cpu session's")
        sess.disable_hyperspace()
        want = q.collect()
        sess.enable_hyperspace()
        got_cmp, want = (sorted_rows(got), sorted_rows(want)) if label == "s1" else (got, want)
        if got.num_rows == 0 or not same_rows(got_cmp, want):
            raise AssertionError(f"{label}: rows differ from the plan without Hyperspace")
        stage_p50 = {k: float(np.median([s.get(k, 0.0) for s in stages]))
                     for k in sorted({k for s in stages for k in s})}
        r = {"query": label, "index": index, "rows": got.num_rows,
             "p50_ms": float(np.median(on_ms)), "off_p50_ms": float(np.median(off_ms)),
             "stages_p50_s": stage_p50,
             "aggplane": {k: v for k, v in plane.items() if k != "wall_s"},
             "fused": {k: v for k, v in fused.items() if k != "wall_s"},
             "routes": {k: counts[k] for k in ("metadata_aggregates", "fused_aggregates",
                                               "fused_selects", "fused_range_masks")}}
        results.append(r)
        log(f"aggplane path: {label} over {index}: p50_ms {r['p50_ms']:.3f} with the route, "
            f"{r['off_p50_ms']:.3f} with {switch} off (5 each, in turns); {got.num_rows} rows; "
            f"routes {r['routes']}; metadata {r['aggplane']}; fused {r['fused']}; stage p50 s "
            f"{ {k: round(v, 4) for k, v in stage_p50.items()} }; equal bit for bit to the "
            f"route off, to the cpu session and to the plan without Hyperspace"
            f"{' as a multiset' if label == 's1' else ''}")
    launches = ops.launch_counts()
    if launches["fused_select"] <= 0 or launches["fused_filter_agg"] <= 0:
        raise AssertionError(f"phase 9 launched B3b or B5f no time: {launches}")
    log(f"aggplane path: phase launches {launches}")

    # every captured sidecar: li_rg_idx's, li_idx's (whose l_orderkey pass
    # overflows B5f's one pass to the ordered route) and o_idx's (a float
    # SUM folded on the ordered route)
    sidecars = {}
    for name in ("li_rg_idx", "li_idx", "o_idx"):
        files = hs.get_index(name).content.files
        with open(os.path.join(os.path.dirname(files[0]), aggindex.SIDECAR_NAME)) as fh:
            stored = json.load(fh)["files"]
        t0 = time.perf_counter()
        groups = 0
        for f, (entry, _sample) in zip(files, aggindex.file_agg_docs(files, device="cpu")):
            mine = dict(stored[os.path.basename(f)])
            mine.pop("size")
            mine.pop("mtime_ns")
            if mine != entry:
                raise AssertionError(f"{name}'s _aggstate.json differs from the cpu doc for {f}")
            groups += pq.ParquetFile(f).metadata.num_row_groups
        sidecars[name] = {"files": len(files), "row_groups": groups,
                          "cpu_s": time.perf_counter() - t0}
        log(f"aggplane path: {name}'s _aggstate.json (captured on the card) equals the doc a "
            f"cpu session computes over its {len(files)} files and {groups} row groups apart "
            f"from mtime_ns ({sidecars[name]['cpu_s']:.2f}s on the cpu)")
    return {"launches": launches, "queries": results, "sidecars": sidecars,
            "capture": capture_profile(torch.device("cuda"), hs)}


#: kernel names of each part of a capture's fold, as torch.profiler
#: names them (B5f's one pass and ordered route, B3b, B5)
FOLD_PARTS = {
    "b5f": ("agg_block_pass", "merge_init", "insert_carried", "merge_records",
            "finish_groups", "group_pass", "insert_groups"),
    "b3b": ("select_tiles",),
    "b5": ("range_pass", "fixup_pass", "fold_sum"),
    "copies": ("Memcpy", "Memset"),
}


def capture_profile(dev, hs, names=("li_idx", "o_idx")) -> dict:
    """Each named index's sidecar folds computed again, as its create's
    capture computes them (``aggindex.file_agg_docs`` over the index's
    files on the card): the host clock of one run, then one run under
    torch.profiler, its device time split by :data:`FOLD_PARTS` (the
    rest: torch's own kernels), and the capture's passes and overflowed
    chunks. -> name -> record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperspace_tpu_torch.indexes import aggindex

    out = {}
    for name in names:
        files = hs.get_index(name).content.files
        torch.cuda.synchronize()
        aggindex.capture_stats.update(read=0.0, fold=0.0, passes=0, overflowed=0)
        t0 = time.perf_counter()
        aggindex.file_agg_docs(files, device=dev)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        stats = dict(aggindex.capture_stats)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            aggindex.file_agg_docs(files, device=dev)
            torch.cuda.synchronize()
        parts = {k: 0.0 for k in (*FOLD_PARTS, "other")}
        for ev in prof.key_averages():
            part = next((k for k, keys in FOLD_PARTS.items()
                         if any(x in ev.key for x in keys)), "other")
            parts[part] += ev.device_time_total / 1e3
        out[name] = r = {"host_s": host_s, "read_s": stats["read"], "fold_s": stats["fold"],
                         "passes": stats["passes"], "overflowed": stats["overflowed"],
                         "device_ms": parts, "device_ms_total": sum(parts.values())}
        log(f"capture profile: {name}'s sidecar folds over {len(files)} files: host "
            f"{host_s:.4f} s (reads {stats['read']:.4f}, folds {stats['fold']:.4f}), "
            f"{stats['passes']} fused passes, {stats['overflowed']} overflowed to the ordered "
            f"route; device ms {r['device_ms_total']:.4f} in all: "
            f"{ {k: round(v, 4) for k, v in parts.items()} } (torch.profiler, one run)")
    return out


def f_inputs(dev, ctx) -> dict:
    """f1's and f2's inputs on the card: li_idx's columns l_orderkey,
    l_shipdate and l_quantity over all its files in file order (the rows
    the fused route reads, as one chunk of 6,001,215 rows), with each
    query's lowered plan. -> label -> (plan, chunk, host batch)."""
    import pyarrow as pa

    from hyperspace_tpu_torch import functions as F
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.io import parquet as pio
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch

    files = ctx["hs"].get_index("li_idx").content.files
    cols = ["l_orderkey", "l_shipdate", "l_quantity"]
    batch = ColumnarBatch.from_arrow(pa.concat_tables(pio.read_tables(files, cols)))
    schema = {c: batch.column(c).arrow_type for c in cols}
    out = {}
    for label, (q, _index, _switch) in agg_plane_queries(F, ctx["items"]).items():
        if label not in ("f1", "f2"):
            continue
        plan = q.logical_plan
        cond = plan.child.condition
        fplan = PC._lower_fused_agg(cond, plan.group_by, plan.aggs, schema, cols)
        chunk = PC.AggState(fplan, dev)._chunk(batch)
        out[label] = (fplan, chunk, batch)
    return out


def fused_agg_bound(chunk) -> dict:
    """Least time of B5f on one chunk over HBM bandwidth: the least bytes
    its inputs need, the term columns whole and, of the key and value
    columns (and their validity), only the 32-byte sectors that hold a
    passing row (the one pass reads no other). Beside it, as commit
    2396f04's kernel table counted it, the bytes of every distinct input column
    read whole once (8 bytes a row) and each validity once (1 byte a
    row). The outputs (a few words a group) and its operations (a few a
    row and column) are below either."""
    import torch

    from hyperspace_tpu_torch.ops import filter as F

    terms, others, seen = [], [], set()
    if chunk.terms is not None:
        terms = list(chunk.terms.cols) + [v for v in chunk.terms.valids if v is not None]
    others = [t for b, v, _f in chunk.keys for t in (b, v) if t is not None]
    others += [t for _op, x, v in chunk.aggs for t in (x, v) if t is not None]
    rows = (torch.nonzero(F.range_mask_kernel(chunk.terms)).flatten() if chunk.terms is not None
            else torch.arange(chunk.n, device=chunk.device))
    whole = least = 0
    for t in terms + others:
        if t.data_ptr() in seen:
            continue
        seen.add(t.data_ptr())
        nbytes = t.numel() * t.element_size()
        whole += nbytes
        if any(t is x for x in terms):
            least += nbytes
        else:  # the sectors of passing rows: 4 rows of 8 bytes, 32 of 1 byte
            least += 32 * int(torch.unique(rows // (32 // t.element_size())).numel())
    return {"bytes": least, "bound_ms": least / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "whole_column_bytes": whole,
            "whole_column_bound_ms": whole / PEAK_BYTES_PER_S * 1e3}


def interpreted_chain(fplan, chunk):
    """The port's interpreted chain on the same device columns: B3a's
    mask, the passing rows gathered, the group keys factorized (a stable
    device sort of the rep planes and the boundaries) and B5 per
    aggregate, as ``aggregate_exec`` runs it; the B5f yardstick."""
    import torch

    from hyperspace_tpu_torch.ops import aggregate as A
    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.ops import fused_agg as FA
    from hyperspace_tpu_torch.ops.sort import sort_permutation

    mask = F.range_mask_kernel(chunk.terms)
    rows = torch.nonzero(mask).flatten()
    n = rows.numel()
    dev = rows.device
    perm, offs = None, torch.tensor([0, n], dtype=torch.int64, device=dev)
    if chunk.keys:
        planes = []
        for bits, valid, f64 in chunk.keys:
            rep, nul = FA.key_rep_torch(bits[rows], None if valid is None else valid[rows], f64)
            planes += [rep, nul.to(torch.int64)]
        reps = torch.stack(planes)
        perm = sort_permutation(reps)
        srt = reps[:, perm]
        neq = (srt[:, 1:] != srt[:, :-1]).any(dim=0)
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.nonzero(neq).flatten() + 1])
        offs = torch.cat([starts, torch.full((1,), n, dtype=torch.int64, device=dev)])
    out = []
    for op, vals, valid in chunk.aggs:
        if vals is None:
            out.append(A.segment_count(perm, offs, None if valid is None else valid[rows]))
            continue
        v = vals[rows]
        ok = None if valid is None else valid[rows]
        if op in (FA.OP_SUM_I64, FA.OP_SUM_F64):
            out.append(A.segment_sum_count_kernel(perm, offs, v, ok))
        else:
            mode = "min" if op in (FA.OP_MIN_I64, FA.OP_MIN_F64) else "max"
            fill = None if v.dtype == torch.float64 else (I64_MAX if mode == "min" else I64_MIN)
            out.append(A.segment_minmax_kernel(perm, offs, v, ok, mode, fill))
    return out


def device_ms_per_call(fn, flush, calls: int = 5) -> tuple:
    """(device milliseconds of one call of ``fn``: every kernel, memset
    and copy it launched, from torch.profiler's records, cold: ``flush``
    read before each call and its own kernels left out; the same per
    kernel name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def names(body):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return prof.key_averages()

    f32 = flush.view(torch.float32)  # one reduction kernel, no conversion copy
    flush_keys = {ev.key for ev in names(f32.sum) if ev.device_time_total > 0}
    fn()

    def cold():
        for _ in range(calls):
            f32.sum()
            fn()

    per = {}
    for ev in names(cold):
        if ev.device_time_total > 0 and ev.key not in flush_keys:
            per[ev.key[:60]] = per.get(ev.key[:60], 0.0) + ev.device_time_total / calls / 1e3
    total = sum(per.values())
    return (total if total > 0 else None), per


def synchronisations(fn) -> int:
    """The synchronising calls one run of ``fn`` makes, as torch's sync
    debug mode warns of them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
               for w in seen)


def fused_timings(dev, inputs: dict, b3b_calls: dict) -> tuple:
    """B5f and B3b on phase 9's inputs: B5f on f1's and f2's (one chunk of
    6,001,215 rows), first held bit-equal to the plain version on the CPU,
    then timed cold on the card: the whole call on its route (CUDA events
    around it, so the host's round trips between its launches count, and
    the host clock), its synchronisations (torch's sync debug mode), the
    device time of every kernel of one call (torch.profiler, cold, and
    warm, 5 calls back to back), the ordered route on the
    same chunk, the group pass alone (f2; its C function launched
    directly) beside both byte bounds, the plain version (host clock)
    and the interpreted chain on the same device columns. B3b on f1's
    terms over the same l_orderkey column and on s1's recorded batch: its
    one kernel launched directly (no count read back), cold, beside its
    bound, the plain version on the card, and B3a plus
    ``torch.nonzero``. Returns (B3b record, B5f record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5f_cases import _state_bits

    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.ops import fused_agg as FA

    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    med = lambda t: float(np.median(t))  # noqa: E731
    b5f = {}
    for label, (fplan, chunk, batch) in inputs.items():
        empty = lambda: PC.AggState(fplan, dev).state  # noqa: E731
        start = empty()  # the calls fold into a new state and leave this one as it was
        call = lambda: FA.fused_filter_agg_kernel(start, chunk)  # noqa: E731
        ordered = lambda: FA._fold(start, chunk, FA.group_ids_kernel, plain=False)  # noqa: E731
        got = call()
        cpu_state = PC.AggState(fplan, "cpu")
        cpu_chunk = cpu_state._chunk(batch)
        t0 = time.perf_counter()
        want = FA.fused_filter_agg_torch(cpu_state.state, cpu_chunk)
        plain_ms = (time.perf_counter() - t0) * 1e3
        for name, st in (("its route", got), ("the ordered route", ordered())):
            a, b = _state_bits(st), _state_bits(want)
            bad = {k: int((a[k] != b[k]).sum()) for k in a if a[k].shape == b[k].shape}
            if any(bad.values()) or any(a[k].shape != b[k].shape for k in a):
                raise AssertionError(f"B5f on {label}'s inputs by {name} differs from its plain "
                                     f"version: {bad}")
        route = FA.route(got.ops)
        syncs = synchronisations(call)
        ms = med(time_cold(call, flush, iters=10))
        host_ms = host_cold_ms(call, flush, iters=10)
        ordered_ms = med(time_cold(ordered, flush, iters=10))
        dev_ms, per_kernel = device_ms_per_call(call, flush)
        gp = group_pass_launcher(chunk, empty())
        gp_ms = None if gp is None else med(time_cold(gp, flush, iters=10))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        kernel_us = sum(ev.device_time_total for ev in prof.key_averages())
        chain_ms = med(time_cold(lambda: interpreted_chain(fplan, chunk), flush, iters=10))
        before = FA.launches
        call()
        r = {"n": chunk.n, "groups": got.n_groups, "rows_passed": got.rows_passed,
             "route": route, "overflowed": got.overflowed, "launches_per_call": FA.launches - before,
             "syncs_per_call": syncs, "ms": ms, "host_ms": host_ms,
             "device_ms": dev_ms, "device_ms_by_kernel": per_kernel,
             "kernels_warm_ms": kernel_us / 5e3 if kernel_us > 0 else None,
             "ordered_route_ms": ordered_ms, "group_pass_ms": gp_ms,
             "plain_ms": plain_ms, "interpreted_chain_ms": chain_ms, **fused_agg_bound(chunk)}
        b5f[label] = r
        fmt = lambda v: "not measured" if v is None else format(v, ".4f")  # noqa: E731
        log(f"kernels: B5f on {label}'s inputs ({r['n']} rows, {r['groups']} groups, "
            f"{r['rows_passed']} passing) equal bit for bit to its plain version on its route "
            f"({route}, {r['overflowed']} overflowed, {r['launches_per_call']} launches, "
            f"{syncs} synchronisations a call) and on the ordered route; cold ms {ms:.4f} the "
            f"whole call (device timeline, host syncs included; host clock {host_ms:.4f}), "
            f"device time of its kernels {fmt(dev_ms)} cold, {fmt(r['kernels_warm_ms'])} warm "
            f"(torch.profiler); by kernel { {k: round(v, 4) for k, v in per_kernel.items()} }; "
            f"bound_ms {r['bound_ms']:.4f} the sectors of passing rows ({r['bytes']} B; "
            f"{r['bound_ms'] / dev_ms if dev_ms else 0:.1%} of the device time), "
            f"{r['whole_column_bound_ms']:.4f} whole columns ({r['whole_column_bytes']} B; "
            f"{r['whole_column_bound_ms'] / dev_ms if dev_ms else 0:.1%}); "
            f"ordered route {ordered_ms:.4f}; group pass alone {fmt(gp_ms)}; plain_ms "
            f"{plain_ms:.2f} (cpu, host clock); interpreted chain on the same device columns "
            f"(B3a, gather, factorize, B5) {chain_ms:.4f}")
    b3b = {}
    f1_terms = inputs["f1"][1].terms
    sources = {"f1": f1_terms}
    for label, (terms, batch) in b3b_calls.items():
        sources[label] = F.range_args(batch, terms, dev)
    for label, args in sources.items():
        launch = select_launcher(args)
        before = F.select_launches
        idx = F.select_kernel(args)
        launches = F.select_launches - before
        if not torch.equal(idx, F.select_torch(args)):
            raise AssertionError(f"B3b on {label}'s inputs differs from its plain version")
        for _ in range(20):  # the look-back, again and again
            if not torch.equal(F.select_kernel(args), idx):
                raise AssertionError(f"B3b on {label}'s inputs differs on a repeat")
        ms = med(time_cold(launch, flush))
        plain_ms = med(time_cold(lambda: F.select_torch(args), flush, iters=10))
        yard_ms = med(time_cold(lambda: torch.nonzero(F.range_mask_kernel(args)), flush,
                                iters=10))
        n = args.n
        nbytes = sum(c.numel() * 8 for c in args.cols) + sum(
            v.numel() for v in args.valids if v is not None) + 8 * idx.numel()
        b3b[label] = r = {"n": n, "passing": int(idx.numel()), "launches_per_call": launches,
                          "ms": ms, "plain_ms": plain_ms,
                          "b3a_nonzero_ms": yard_ms, "bytes": nbytes,
                          "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(f"kernels: B3b on {label}'s inputs ({n} rows, {r['passing']} passing) equal to its "
            f"plain version in 21 calls; cold ms {ms:.4f} ({launches} launch a call), bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_ms'] / ms:.1%}; bytes {nbytes}); plain_ms "
            f"{plain_ms:.4f} (torch mask and nonzero on the card); B3a + torch.nonzero "
            f"{yard_ms:.4f}")
    head3, head5 = b3b["f1"], b5f["f1"]
    b3b_rec = {
        "name": "fused_select", "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/fused_select.cu",
        "replaces": "hyperspace_tpu/native/hs_native.cpp:542",
        "launches": None, "max_abs_err": 0,
        "ms": head3["ms"], "plain_ms": head3["plain_ms"], "bound_ms": head3["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "timing": "cold: 256 MiB read before each run, median of 30; on f1's window terms "
                  "over li_idx's l_orderkey column",
        "b3a_nonzero_ms": head3["b3a_nonzero_ms"],
        "other_inputs": {k: v for k, v in b3b.items() if k != "f1"},
    }
    b5f_rec = {
        "name": "fused_filter_agg", "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/fused_agg.cu",
        "replaces": "hyperspace_tpu/native/hs_native.cpp:632",
        "launches": None, "max_abs_err": 0,
        "ms": head5["ms"], "plain_ms": head5["plain_ms"], "bound_ms": head5["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "timing": "cold: 256 MiB read before each run, median of 10; the whole call on f1's "
                  "inputs as one chunk on its route (one pass: block pass, merge, one read "
                  "back, next state), host syncs included",
        "fused_route": head5["route"],
        **{k: head5[k] for k in ("n", "groups", "rows_passed", "syncs_per_call",
                                 "launches_per_call", "device_ms", "kernels_warm_ms",
                                 "ordered_route_ms", "interpreted_chain_ms", "bytes",
                                 "whole_column_bytes", "whole_column_bound_ms")},
        "other_inputs": {k: v for k, v in b5f.items() if k != "f1"},
    }
    return b3b_rec, b5f_rec


def b5f_replica(dev) -> tuple:
    """Phase 9's B5f and B3b inputs built on the card from phase 4's
    generators without writing the tables: li_idx's rows (l_orderkey in
    B1's 200 buckets, key-sorted within each) as one chunk of l_orderkey,
    l_shipdate and l_quantity; f1's and f2's plans lowered from their
    terms and aggregates; s1's batch, the rows of the agg window with
    l_quantity < 24. -> (label -> (plan, chunk, host batch), {"s1":
    (terms, batch)}), as :func:`f_inputs` and :class:`B3bInputs` give."""
    import pyarrow as pa
    import torch

    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops import hash as H
    from hyperspace_tpu_torch.ops.filter import range_mask_numpy
    from hyperspace_tpu_torch.ops.sort import sort_permutation
    from hyperspace_tpu_torch.plan.nodes import AggSpec

    cols = lineitem_columns()
    key = torch.from_numpy(cols["l_orderkey"]).to(dev)
    stored = sort_permutation(key[None], H.bucket_ids_kernel(key[None], 200).long()).cpu().numpy()
    names = ["l_orderkey", "l_shipdate", "l_quantity"]
    table = pa.table({c: pa.array(cols[c][stored]) for c in names})
    batch = ColumnarBatch.from_arrow(table)
    schema = {c: table.schema.field(c).type for c in names}
    window = (("l_orderkey", AGG_LO, False, None, False, False),
              ("l_orderkey", None, False, AGG_HI, True, False))
    plans = {
        "f1": ((), [AggSpec("count", None, "n"), AggSpec("sum", "l_quantity", "s"),
                    AggSpec("avg", "l_quantity", "a"), AggSpec("min", "l_shipdate", "mn"),
                    AggSpec("max", "l_shipdate", "mx")]),
        "f2": (("l_quantity",), [AggSpec("count", None, "n"), AggSpec("sum", "l_quantity", "s"),
                                 AggSpec("min", "l_shipdate", "mn"),
                                 AggSpec("max", "l_shipdate", "mx")]),
    }
    out = {}
    for label, (group_by, aggs) in plans.items():
        fplan = PC._lower_from_terms(list(window), list(group_by), aggs, schema, names)
        out[label] = (fplan, PC.AggState(fplan, dev)._chunk(batch), batch)
    s1_terms = list(window) + [("l_quantity", None, False, 24, True, False)]
    keep = np.nonzero(range_mask_numpy(batch, s1_terms))[0]
    return out, {"s1": (s1_terms, ColumnarBatch.from_arrow(table.take(keep)))}


def select_launcher(args):
    """B3b's C function on ``args`` with its buffers allocated once: the
    three launches without the count's read back, for event timing."""
    import torch

    from hyperspace_tpu_torch.ops import filter as F

    lib = F._select_lib()
    dev = args.cols[0].device
    out = torch.empty(args.n, dtype=torch.int64, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    scratch = torch.empty(int(lib.hs_select_scratch_bytes(args.n)), dtype=torch.uint8, device=dev)
    arrays = F.term_arrays(args)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.hs_fused_select(*arrays, args.n, out.data_ptr(), total.data_ptr(),
                                  scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B3b launch failed: CUDA error {err}")

    return launch


def group_pass_launcher(chunk, state):
    """B5f's group pass (``hs_fused_group``) over ``chunk``'s passing rows
    (compacted by B3b once, beforehand) with its buffers allocated once,
    for event timing; None for a chunk without keys (no group pass)."""
    import ctypes
    import torch

    from hyperspace_tpu_torch.ops import filter as F
    from hyperspace_tpu_torch.ops import fused_agg as FA

    nk, G = len(chunk.keys), state.n_groups
    if not nk:
        return None
    lib = FA._lib()
    dev = chunk.device
    rows = F.select_kernel(chunk.terms) if chunk.terms is not None else None
    m = chunk.n if rows is None else rows.numel()
    T = FA.table_size(G, m)
    table = torch.empty(T, dtype=torch.int64, device=dev)
    slot = torch.empty(max(m, 1), dtype=torch.int64, device=dev)
    keys = (ctypes.c_void_p * nk)(*[b.data_ptr() for b, _v, _f in chunk.keys])
    valids = (ctypes.c_void_p * nk)(
        *[None if v is None else v.data_ptr() for _b, v, _f in chunk.keys])
    f64 = sum(1 << j for j, (_b, _v, f) in enumerate(chunk.keys) if f)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.hs_fused_group(keys, valids, f64, nk, None, None, 0,
                                 None if rows is None else rows.data_ptr(), m,
                                 table.data_ptr(), T, slot.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B5f group pass failed: CUDA error {err}")

    return launch


# ---------------------------------------------------------------------------
# Phase 3 (B6) and phase 10: the z-order covering index (kernel B6)
# ---------------------------------------------------------------------------

#: bench.py's z-range window (q_zrange) and the index configurations of
#: its aggregate plane (agg_idx) and z-range query (z_idx)
ZLO, ZHI = "1995-06-01", "1995-06-30"
Z_INDEXES = {
    "agg_idx": (["l_orderkey"], ["l_quantity", "l_extendedprice"]),
    "z_idx": (["l_shipdate", "l_quantity"], ["l_orderkey"]),
}
PRUNE_SWITCH = "hyperspace.serve.rangeprune.enabled"


def b6_ops_per_row(k: int) -> int:
    """32-bit integer operations per row of B6's specialised route (16 bits
    a column). k = 1 shifts its word into place (1). k = 2 stays in 32
    bits: each word takes the mask and four shift-or-and steps of the
    spread (13) and its shift and or into the address (2), then the
    padding shift (2 in all: 32). k >= 3 works on 64 bits, two 32-bit
    operations each: 30 a word, then the padding shift and the split into
    two planes (4)."""
    if k == 1:
        return 1
    if k == 2:
        return 32
    return 30 * k + 4


def b6_bound(n: int, k: int, bits: int = 16) -> dict:
    """Least time of B6 on [k, n] words: the larger of its bytes (k words
    read and the planes written, 4 bytes each) over HBM bandwidth and its
    integer operations over the int32 peak."""
    nplanes = (k * bits + 31) // 32
    nbytes = 4 * (k + nplanes) * n
    ops = n * b6_ops_per_row(k)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "int32_ops": ops, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def check_b6_cases(dev) -> tuple:
    """B6 bit-equal to the plain version over ``tests/torch_b6_cases.py``
    (phase 3); views 4 bytes past a 16-byte boundary where a case asks for
    one. The plain version runs on the same card tensor: its integer bit
    operations are exact on either device, and on the card its one pass a
    z-bit takes seconds where the CPU took a minute. Returns (cases, max
    abs error)."""
    import torch

    from hyperspace_tpu_torch.ops import zorder as Z

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_b6_cases as B6

    t0 = time.perf_counter()
    for case in B6.CASES:
        n, _k, bits, _fill, offset = case
        words = B6.words_tensor(case, dev)
        if offset and n and words.data_ptr() % 16 != 4:
            raise AssertionError(f"B6 case {B6.case_id(case)}: not 4 bytes off 16")
        got = Z.interleave_kernel(words, bits)
        if not torch.equal(got, Z.interleave_torch(words, bits)):
            raise AssertionError(f"B6 differs from its plain version on {B6.case_id(case)}")
    log(f"kernels: B6 bit-equal to plain over {len(B6.CASES)} cases "
        f"(max_abs_err 0; {time.perf_counter() - t0:.1f}s)")
    return len(B6.CASES), 0


def b6_timings(dev) -> dict:
    """B6 cold at 6,001,215 rows of 16-bit words for k = 1, 2, 3 (phase
    3) beside its bound and the plain version on the same device words."""
    import torch

    from hyperspace_tpu_torch.ops import zorder as Z

    rng = np.random.default_rng(SEED + 21)
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    cold = []
    for k in (1, 2, 3):
        words = torch.from_numpy(
            rng.integers(0, 1 << 16, size=(k, N_ROWS), dtype=np.int64).astype(np.int32)
        ).to(dev)
        ms = float(np.median(time_cold(lambda: Z.interleave_kernel(words, 16), flush)))
        plain_ms = time_cuda(lambda: Z.interleave_torch(words, 16), launches=5)
        b = b6_bound(N_ROWS, k)
        cold.append({"k": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"], "bytes": b["bytes"],
                     "share_of_bound": b["bound_ms"] / ms})
        log(f"kernels: B6 cold at {N_ROWS} rows, k={k}, 16 bits: ms {ms:.4f} bound_ms "
            f"{b['bound_ms']:.4f} ({b['bound_ms'] / ms:.1%}; bytes {b['bytes']} -> "
            f"{b['bytes_ms']:.4f} ms, int32 ops {b['int32_ops']} -> {b['ops_ms']:.4f} ms); "
            f"plain_ms {plain_ms:.4f}; library_ms none (no PyTorch call interleaves bits)")
    k1 = cold[0]
    return {
        "name": "zorder_interleave",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/zorder_interleave.cu",
        "replaces": "hyperspace_tpu/ops/zorder.py:60",
        "launches": None,  # phase 10's count, filled in by main
        "max_abs_err": None,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "timing": "cold: 256 MiB read before each run, median of 30; k = 1, 16 bits, "
                  f"{N_ROWS} rows (agg_idx's shape)",
        "cold_by_k": cold,
    }


class KernelCalls:
    """Every call of B1, B6, B7 (its indices and its build) and B5f that
    phases 10-15 make while ``label`` is set, and of B3a between
    ``record_b3a(True)`` and ``record_b3a(False)`` (phase 15; the other
    phases time B3a unwrapped), kept with its kind, label, inputs and
    result. The wrappers are replaced once by recording ones
    that call straight through, so their launches count as the main
    path's. ``settle``, outside any timed window, holds each kept call
    against its plain version on the same inputs and drops it. B1, B6 and
    B7 compute integer functions, and a B5f chunk of counts, int64 sums,
    min and max folds integers, which any order computes exactly: their
    plain versions run on the card's tensors. A B5f chunk with a float
    aggregate is held on CPU copies, where the ordered float fold's plain
    version is bit-exact."""

    FLOAT_OPS = (3, 6, 7)  # ops.fused_agg OP_SUM_F64, OP_MIN_F64, OP_MAX_F64

    def __init__(self):
        from hyperspace_tpu_torch.ops import bloom as B
        from hyperspace_tpu_torch.ops import filter as F
        from hyperspace_tpu_torch.ops import fused_agg as FA
        from hyperspace_tpu_torch.ops import hash as H
        from hyperspace_tpu_torch.ops import zorder as Z

        self.label, self.calls, self.settle_s, self._b3a = None, [], 0.0, None
        # phase 20 launches the kernels from the serve frontend's threads: a
        # call is kept under the lock, with the label its window set before
        # the threads started (a window's label never changes inside it),
        # and counted by kind in ``serve_calls`` where the calling thread is
        # one of the frontend's ``hs-serve-*`` workers
        self._lock = threading.Lock()
        self.serve_calls = {}
        # phase 16 keeps CPU copies, so that no recorded call holds device
        # memory while it measures a write's peak device bytes
        self.on_host = False
        self.totals()
        self.plain = {"b1": H.bucket_ids_torch, "b6": Z.interleave_torch,
                      "b7 indices": B.bit_indices_torch, "b7 build": B.build_bloom_torch,
                      "b5f": FA.fused_filter_agg_torch, "b3a": F.range_mask_torch}
        for mod, name, kind in ((H, "bucket_ids_kernel", "b1"), (Z, "interleave_kernel", "b6"),
                                (B, "bit_indices_kernel", "b7 indices"),
                                (B, "build_bloom_kernel", "b7 build"),
                                (FA, "fused_filter_agg_kernel", "b5f")):
            setattr(mod, name, self._recording(getattr(mod, name), kind))

    def _recording(self, inner, kind: str):
        def recording(*args):
            out = inner(*args)
            label = self.label
            if label is not None:
                kept = (to_cpu(args), to_cpu(out)) if self.on_host else (args, out)
                serving = threading.current_thread().name.startswith(SERVE_THREADS)
                with self._lock:
                    self.calls.append((kind, label, *kept))
                    if serving:
                        self.serve_calls[kind] = self.serve_calls.get(kind, 0) + 1
            return out

        return recording

    def record_b3a(self, on: bool) -> None:
        """Replace B3a's wrapper by a recording one (``on``), or put the
        original back."""
        from hyperspace_tpu_torch.ops import filter as F

        if on and self._b3a is None:
            self._b3a = F.range_mask_kernel
            F.range_mask_kernel = self._recording(self._b3a, "b3a")
        elif not on and self._b3a is not None:
            F.range_mask_kernel, self._b3a = self._b3a, None

    def record_b4(self, on: bool) -> None:
        """Replace B4's wrapper by a recording one (``on``, phase 17; the
        earlier phases hold B4 through ``B4Inputs``), or put it back."""
        from hyperspace_tpu_torch.ops import join as J

        if on and getattr(self, "_b4", None) is None:
            self._b4 = J.match_pairs_kernel
            self.plain["b4"] = J.match_pairs_torch
            J.match_pairs_kernel = self._recording(self._b4, "b4")
        elif not on and getattr(self, "_b4", None) is not None:
            J.match_pairs_kernel, self._b4 = self._b4, None

    def record_b8(self, on: bool) -> None:
        """Replace B8a's and B8b's wrappers by recording ones (``on``, phase
        18), or put them back."""
        from hyperspace_tpu_torch.ops import exchange as X

        if on and getattr(self, "_b8", None) is None:
            self._b8 = (X.pack_kernel, X.order_kernel)
            self.plain["b8a"], self.plain["b8b"] = X.pack_torch, X.order_torch
            X.pack_kernel = self._recording(self._b8[0], "b8a")
            X.order_kernel = self._recording(self._b8[1], "b8b")
        elif not on and getattr(self, "_b8", None) is not None:
            (X.pack_kernel, X.order_kernel), self._b8 = self._b8, None

    def settle(self) -> list:
        """Hold every kept call against its plain version (the first that
        differs raises), count it and its rows under its kind and label,
        and drop it. Returns the calls held."""
        import torch

        t0 = time.perf_counter()
        with self._lock:
            calls, self.calls = self.calls, []
        for kind, label, args, out in calls:
            plain = self.plain[kind]
            floats = kind == "b5f" and any(op in self.FLOAT_OPS for op, _v, _valid in args[1].aggs)
            if self.on_host and not floats:  # an integer function: held on the card
                args, out = to_cpu(args, "cuda"), to_cpu(out, "cuda")
            if kind == "b3a":  # a mask: exact in any order, held on the card
                ok = torch.equal(out, plain(*args))
                rows = args[0].n
            elif kind == "b4":  # (li, ri) pair lists: equal in order
                ok = all(torch.equal(a, b) for a, b in zip(out, plain(*args)))
                rows = args[0].shape[0] + args[2].shape[0]
            elif kind in ("b8a", "b8b"):  # counts and columns, bit for bit
                ok = b8_same(out, plain(*args))
                rows = args[0].shape[0]
            elif kind != "b5f":
                ok = torch.equal(out, plain(*args))
                rows = args[0].shape[-1]
            elif floats:
                ok = states_equal(to_cpu(out), plain(*to_cpu(args)))
                rows = args[1].n
            else:
                ok = states_equal(out, plain(*args))
                rows = args[1].n
            if not ok:
                raise AssertionError(f"{kind} differs from its plain version on {label}")
            key = kind.split()[0]
            self.held.setdefault(key, {})
            self.held[key][label] = self.held[key].get(label, 0) + 1
            self.rows[key] = self.rows.get(key, 0) + rows
        self.settle_s += time.perf_counter() - t0
        return calls

    def totals(self) -> tuple:
        """(kernel -> label -> calls held, kernel -> rows held) since the
        last ``totals``, which starts them anew."""
        out = getattr(self, "held", {}), getattr(self, "rows", {})
        self.held, self.rows = {}, {}
        return out

    def summary(self, where: str, required=()) -> dict:
        """Log the calls held since the last ``totals`` by kernel and label
        and start them anew; each (kernel, label) in ``required`` must have
        been held at least once. Returns kernel -> calls held."""
        held, rows = self.totals()
        for key, label in required:
            if not held.get(key, {}).get(label):
                raise AssertionError(f"{where}'s {label} made no {key.upper()} call")
        counts = {k: sum(v.values()) for k, v in held.items()}
        log(f"kernels: {where}'s calls bit-equal to their plain versions: "
            + ", ".join(f"{k.upper()} {counts[k]} calls ({rows[k]} rows)" for k in sorted(held))
            + f" (held after each action, outside its timed window; {self.settle_s:.1f}s so far)")
        for k in sorted(held):
            log(f"kernels: {where} {k} calls by label: "
                + ", ".join(f"{lab} {n}" for lab, n in sorted(held[k].items())))
        return counts


def check_b6_main_path(calls: list) -> int:
    """Phase 10's B6 calls, each already held bit-equal to the plain
    version (``KernelCalls.settle``): each create made at least one."""
    b6 = [c for c in calls if c[0] == "b6"]
    labels = sorted({c[1] for c in b6})
    for name in Z_INDEXES:
        if not any(label.startswith(name) for label in labels):
            raise AssertionError(f"phase 10's {name} create launched B6 no time")
    log(f"kernels: B6 planes bit-equal to plain on all {len(b6)} calls of phase 10 "
        f"({sum(c[2][0].shape[1] for c in b6)} rows in all; {', '.join(labels)})")
    return len(b6)


def lexsort_timings(calls: list) -> dict:
    """The z-order sort (stable torch.sort passes, ``lexsort_permutation``)
    cold on the planes of each create's build call."""
    import torch

    from hyperspace_tpu_torch.ops.sort import lexsort_permutation

    flush = torch.zeros(1 << 26, dtype=torch.int32, device="cuda")
    out = {}
    for kind, label, _args, planes in calls:
        if kind != "b6" or not label.endswith(" build"):
            continue
        ms = float(np.median(time_cold(lambda: lexsort_permutation(planes), flush,
                                       iters=10)))
        out[label] = {"planes": planes.shape[0], "rows": planes.shape[1], "ms": ms}
        log(f"kernels: z-order lexsort (torch.sort passes) cold on {label}'s "
            f"{planes.shape[0]} plane(s) x {planes.shape[1]} rows: ms {ms:.4f}")
    return out


def zorder_queries(df) -> dict:
    """Phase 10's queries over a lineitem DataFrame of either session:
    bench.py's q_meta over agg_idx and q_zrange over z_idx."""
    from hyperspace_tpu_torch import functions as F

    ship, qty = df["l_shipdate"], df["l_quantity"]
    return {
        "m1": (df.filter(df["l_orderkey"] >= 0).group_by("l_quantity").agg(
            F.count().alias("n"), F.min("l_orderkey").alias("kmin"),
            F.max("l_orderkey").alias("kmax"), F.sum("l_orderkey").alias("ksum")),
            "agg_idx", AGG_SWITCH),
        "q_zrange": (df.filter((ship >= np.datetime64(ZLO)) & (ship <= np.datetime64(ZHI))
                               & (qty <= 5)).select("l_shipdate", "l_quantity", "l_orderkey"),
                     "z_idx", PRUNE_SWITCH),
    }


def zorder_path(work: str, ctx: dict, kernels: KernelCalls) -> dict:
    """Phase 10: the z-order covering index over phase 4's lineitem, as
    bench.py builds it, in a session of its own (so the covering indexes of
    the phases before do not take its queries): agg_idx on l_orderkey and
    z_idx on (l_shipdate, l_quantity), each create's stage seconds and
    rows/s; then m1 over agg_idx from its ``_aggstate.json`` and q_zrange
    over z_idx with z-span pruning. Each: the explain names its index
    (ZOCI); one warm-up; 5 rounds with its route (the metadata plane, range
    pruning) on and off in turns; m1's rows equal bit for bit in order to
    the route off, a ``device="cpu"`` session's and the plan without
    Hyperspace, q_zrange's equal in order to pruning off and to a cpu
    session's and as a multiset to the plan without Hyperspace. Then each
    index's ``_zonemaps.json`` and ``_aggstate.json`` against the docs a
    cpu session computes over its files. Launch counts read from 0 at its
    start; every B6 and B5f call is recorded in ``kernels``."""
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch import ZOrderCoveringIndexConfig
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.indexes import aggindex, zonemaps

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5_cases import same_rows

    src = ctx["src"]
    system = os.path.join(work, "zindexes")
    sess = HyperspaceSession()
    sess.conf.set("hyperspace.system.path", system)
    hs = Hyperspace(sess)
    items = sess.read.parquet(src)
    ops.reset_launch_counts()
    creates = {}
    for name, (indexed, included) in Z_INDEXES.items():
        before = ops.launch_counts()["zorder_interleave"]
        kernels.label = name
        t0 = time.perf_counter()
        hs.create_index(items, ZOrderCoveringIndexConfig(name, indexed, included))
        build_s = time.perf_counter() - t0
        kernels.label = None
        # the create's first B6 call is its build's; the z-span capture's follow
        mine = [i for i, c in enumerate(kernels.calls) if c[:2] == ("b6", name)]
        for i in mine:
            part = "build" if i == mine[0] else "capture"
            kind, _label, args, out = kernels.calls[i]
            kernels.calls[i] = (kind, f"{name} {part}", args, out)
        launches = ops.launch_counts()["zorder_interleave"] - before
        files = hs.get_index(name).content.files
        stages = dict(sess.build_stats)
        creates[name] = {"seconds": build_s, "rows_per_s": N_ROWS / build_s, "files": len(files),
                         "b6_launches": launches,
                         "stages_s": {k: v for k, v in stages.items()
                                      if isinstance(v, float)}}
        log(f"zorder path: built {name} on {indexed} in {build_s:.3f}s, "
            f"{N_ROWS / build_s:,.0f} rows/s, {len(files)} file(s), B6 launches {launches}, "
            f"stages { {k: round(v, 4) if isinstance(v, float) else v for k, v in stages.items()} }")
        if launches < 2:
            raise AssertionError(f"{name}: the build and its z-span capture launched B6 "
                                 f"{launches} times")

    cpu = HyperspaceSession(device="cpu")
    cpu.conf.set("hyperspace.system.path", system)
    cpu.enable_hyperspace()
    sess.enable_hyperspace()
    queries = zorder_queries(items)
    cpu_queries = zorder_queries(cpu.read.parquet(src))
    results = []
    for label, (q, index, switch) in queries.items():
        text = hs.explain(q)
        if f"Hyperspace(Type: ZOCI, Name: {index}," not in text.split("Plan without indexes:")[0]:
            raise AssertionError(f"{label}: {index} not used:\n{text}")
        q.collect()  # warm-up
        on_ms, off_ms, got = [], [], None
        for _ in range(5):
            for route in (True, False):
                sess.conf.set(switch, route)
                PC.last_aggplane_stats = {}
                zonemaps.last_prune_stats = {}
                t0 = time.perf_counter()
                out = q.collect()
                (on_ms if route else off_ms).append((time.perf_counter() - t0) * 1e3)
                if route:
                    got = out
                    stats = (dict(PC.last_aggplane_stats), dict(zonemaps.last_prune_stats))
                elif not same_rows(got, out):
                    raise AssertionError(f"{label}: rows differ with {switch} off")
        sess.conf.set(switch, True)
        plane, prune = stats
        if label == "m1" and not (plane.get("mode") == "agg_metadata"
                                  and plane["row_groups_scanned"] == 0
                                  and plane["row_groups_metadata"] == plane["row_groups_total"]):
            raise AssertionError(f"m1: not answered from metadata alone: {plane}")
        if label == "q_zrange" and not (prune.get("z_pruned") and prune["row_groups_kept"]
                                        < prune["row_groups_total"]):
            raise AssertionError(f"q_zrange: z-spans pruned nothing: {prune}")
        if not same_rows(got, cpu_queries[label][0].collect()):
            raise AssertionError(f"{label}: rows differ from the cpu session's")
        sess.disable_hyperspace()
        want = q.collect()
        sess.enable_hyperspace()
        got_cmp, want = (sorted_rows(got), sorted_rows(want)) if label == "q_zrange" else (
            got, want)
        if got.num_rows == 0 or not same_rows(got_cmp, want):
            raise AssertionError(f"{label}: rows differ from the plan without Hyperspace")
        r = {"query": label, "index": index, "rows": got.num_rows,
             "p50_ms": float(np.median(on_ms)), "off_p50_ms": float(np.median(off_ms)),
             "aggplane": {k: v for k, v in plane.items() if k != "wall_s"},
             "prune": prune}
        results.append(r)
        log(f"zorder path: {label} over {index}: p50_ms {r['p50_ms']:.3f} with the route, "
            f"{r['off_p50_ms']:.3f} with {switch} off (5 each, in turns); {got.num_rows} rows; "
            f"metadata {r['aggplane']}; pruning {prune}; equal to the route off and to the "
            f"cpu session in order, to the plan without Hyperspace"
            f"{' as a multiset' if label == 'q_zrange' else ' bit for bit'}")
    launches = ops.launch_counts()
    log(f"zorder path: phase launches {launches}")

    for name in Z_INDEXES:
        entry = hs.get_index(name)
        files = entry.content.files
        d = os.path.dirname(files[0])
        t0 = time.perf_counter()
        with open(os.path.join(d, zonemaps.SIDECAR_NAME)) as fh:
            stored = json.load(fh)
        mine = zonemaps.zonemap_doc(d, entry.derived_dataset, "cpu")
        for doc in (stored, mine):
            for e in doc["files"].values():
                e.pop("mtime_ns")
        if stored != mine or "zorder" not in stored:
            raise AssertionError(f"{name}'s _zonemaps.json differs from the cpu doc")
        with open(os.path.join(d, aggindex.SIDECAR_NAME)) as fh:
            agg = json.load(fh)["files"]
        for f, (doc, _sample) in zip(files, aggindex.file_agg_docs(files, device="cpu")):
            kept = dict(agg[os.path.basename(f)])
            kept.pop("size")
            kept.pop("mtime_ns")
            if kept != doc:
                raise AssertionError(f"{name}'s _aggstate.json differs from the cpu doc for {f}")
        spans = sum(len(e["rg_zspans"]) for e in stored["files"].values())
        log(f"zorder path: {name}'s _zonemaps.json ({spans} row-group z-spans, "
            f"{stored['zorder']['nplanes']} plane(s)) and _aggstate.json, captured on the "
            f"card, equal the docs a cpu session computes over its {len(files)} file(s) apart "
            f"from mtime_ns ({time.perf_counter() - t0:.2f}s on the cpu)")
    torch.cuda.synchronize()
    return {"launches": launches, "creates": creates, "queries": results}


# ---------------------------------------------------------------------------
# Phase 3 (B7) and phase 11: the data-skipping index (kernel B7)
# ---------------------------------------------------------------------------

#: phase 11's Bloom filter sketch on l_orderkey: about the distinct keys of
#: one source file (the seeded generator gives 589,933-590,691 a file;
#: upstream's expectedDistinctCountPerFile) at fpp 0.01
DS_EXPECTED, DS_FPP = 600_000, 0.01
#: the rows of the largest source file, what one create launch of B7 takes
FILE_ROWS = -(-N_ROWS // N_FILES)


def b7_ops_per_row(k: int, build: bool) -> int:
    """32-bit integer operations per row of B7, counted from
    ``csrc/bloom_bits.cu``: the two murmur3 hashes of the rep's two words
    (21 each, as :func:`murmur3_ops_per_row` counts one key: 12 for the
    word mixes, 9 for fmix), less the word's own transform that both
    hashes share (k *= c1, rotl 15, k *= c2: 3 a word, computed once, as
    the force-inlined ``row_hashes`` lets the compiler do), and h2's OR
    (37 in all); then each of the k indices takes the remainder by the
    precomputed constant (6) and the next sum's add (1); the build adds
    the word index's shift, the bit's mask and its 64-bit shift (two
    32-bit operations), 4 an index."""
    return 37 + (11 if build else 7) * k


def b7_bound(n: int, m: int, k: int, build: bool) -> dict:
    """Least time of one B7 call on n reps: the larger of its bytes (the
    reps read, then the [k, n] int32 indices or the m / 8 bytes of one
    filter written) over HBM bandwidth and its integer operations over the
    int32 peak."""
    nbytes = 8 * n + (m // 8 if build else 4 * k * n)
    ops = n * b7_ops_per_row(k, build)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "int32_ops": ops, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def b7_cases_module():
    """``tests/torch_b7_cases.py``, imported once."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_b7_cases

    return torch_b7_cases


def compare_b7(entry: str, reps, m: int, k: int, out) -> None:
    """One B7 result held bit-equal to the plain version on a CPU copy of
    its reps (a build over the wrap case's 2^31 - 64 bits against the
    words of the plain indices: its plain plane would take 2 GiB)."""
    import torch

    from hyperspace_tpu_torch.ops import bloom as B

    B7 = b7_cases_module()
    host = reps.cpu()
    if entry == "indices":
        ok = torch.equal(out.cpu(), B.bit_indices_torch(host, m, k))
    elif m != B7.WRAP_M:
        ok = torch.equal(out.cpu(), B.build_bloom_torch(host, m, k))
    else:
        want = B7.words_from_indices(B.bit_indices_torch(host, m, k).numpy(), m)
        ok = np.array_equal(out.cpu().numpy().view(np.uint64), want)
    if not ok:
        raise AssertionError(f"B7's {entry} differs from its plain version (n {len(host)}, "
                             f"m {m}, k {k})")


def check_b7_cases(dev) -> tuple:
    """B7's two entries bit-equal to the plain version on a CPU copy over
    ``tests/torch_b7_cases.py`` (phase 3): the indices on every case, the
    build on every case (all of whose m are a filter's, multiples of 64)
    and on the build's route boundaries (``BOUNDARY_CASES``), each by the
    route its m takes, counted by route; the build's plan on the card
    (``hs_bloom_build_plan``) equal to ``ops/bloom.build_plan`` at every
    case's m. Returns (calls checked, max abs error)."""
    import torch

    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.ops import bloom as B

    B7 = b7_cases_module()
    t0 = time.perf_counter()
    calls = 0
    ops.reset_launch_counts()
    for case in B7.CASES + B7.BOUNDARY_CASES:
        n, m, k, _fill = case
        reps = torch.from_numpy(B7.reps_for(case)).to(dev)
        compare_b7("indices", reps, m, k, B.bit_indices_kernel(reps, m, k))
        compare_b7("build", reps, m, k, B.build_bloom_kernel(reps, m, k))
        calls += 2
    routes = {r: ops.launch_counts()[f"bloom_bits.build_{r}"] for r in B.ROUTES}
    builds = [c for c in B7.CASES + B7.BOUNDARY_CASES if c[0]]
    want = {r: sum(1 for c in builds if B.build_route(c[1]) == r) for r in B.ROUTES}
    if routes != want:
        raise AssertionError(f"B7's builds took the routes {routes}, want {want}")
    plans = {}
    for m in sorted({c[1] for c in B7.CASES + B7.BOUNDARY_CASES}):
        for n in (0, 1, 65_537, FILE_ROWS, N_ROWS):
            for k in (1, 7, 16):
                plan, resident = B.kernel_build_plan(n, m, k, dev)
                if plan != B.build_plan(m, n, k, resident):
                    raise AssertionError(f"B7's plan on the card {plan} differs from build_plan "
                                         f"at m {m}, n {n}, k {k} (resident {resident})")
                plans[(m, n, k)] = (plan, resident)
    for m in sorted({m for m, _n, _k in plans}):
        plan, resident = plans[(m, FILE_ROWS, 7)]
        log(f"kernels: B7 build plan at m={m}, k=7: {plan.route} route"
            + (f", {plan.partials} blocks at {FILE_ROWS} rows, "
               f"{plans[(m, N_ROWS, 7)][0].partials} at {N_ROWS} (the card holds {resident})"
               if plan.route == "block" else "")
            + (f", {-(-m >> B.SLICE_SHIFT)} slices, {plan.partials} copies a slice (the "
               f"card holds {resident} blocks), {plan.scratch_bytes} B of scratch at "
               f"{FILE_ROWS} rows" if plan.route == "binned" else ""))
    log(f"kernels: B7 indices and build bit-equal to plain on a CPU copy over "
        f"{len(B7.CASES)} cases and {len(B7.BOUNDARY_CASES)} route boundaries, {calls} "
        f"calls, builds by route {routes}; plans equal build_plan at {len(plans)} shapes "
        f"(max_abs_err 0; {time.perf_counter() - t0:.1f}s)")
    return calls, 0


def b7_timings(dev) -> dict:
    """B7's two entries cold (phase 3) at a source file's rows and at all
    6,001,215 in one launch, l_orderkey-like reps, beside each bound and
    the plain version on the same device reps: the indices at phase 11's
    m and k, the build by route at m = 95,872 (the block route), phase
    11's m (binned) and 2^31 - 64 (global), k = 7 (its plain
    version not timed there: a 2 GiB plane of bits, 16 GiB as int64
    words); then the indices at the probe's own shape, 1 and 8 reps, cold
    and back to back. The record's top-level numbers are the build at a
    file's rows and phase 11's m, the call each create makes once a
    file."""
    import torch

    from hyperspace_tpu_torch.ops import bloom as B

    B7 = b7_cases_module()
    m, k = B.optimal_params(DS_EXPECTED, DS_FPP)
    rng = np.random.default_rng(SEED + 31)
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    cold = []
    for n in (FILE_ROWS, N_ROWS):
        reps = torch.from_numpy(rng.integers(0, N_ORDERS, n, dtype=np.int64)).to(dev)
        runs = [("indices", m, B.bit_indices_kernel, B.bit_indices_torch)]
        runs += [("build", bm, B.build_bloom_kernel, B.build_bloom_torch)
                 for bm in (95_872, m, B7.WRAP_M)]
        for entry, em, fn, plain in runs:
            ms = float(np.median(time_cold(lambda: fn(reps, em, k), flush)))
            plain_ms = (None if em == B7.WRAP_M else
                        time_cuda(lambda: plain(reps, em, k), launches=3, repeats=3))
            b = b7_bound(n, em, k, entry == "build")
            route = "indices"
            if entry == "build":
                plan, resident = B.kernel_build_plan(n, em, k, dev)
                route = {"block": f"block route: {plan.partials} blocks (the card holds "
                                  f"{resident})",
                         "binned": f"binned route: {-(-em >> B.SLICE_SHIFT)} slices, "
                                   f"{plan.partials} copies a slice, {plan.scratch_bytes} B "
                                   f"of scratch",
                         "global": "global route"}[plan.route]
            cold.append({"entry": entry, "route": route, "n": n, "m": em, "k": k, "ms": ms,
                         "plain_ms": plain_ms, **b, "share_of_bound": b["bound_ms"] / ms})
            log(f"kernels: B7 {entry} cold at {n} rows, m={em}, k={k} ({route}): ms {ms:.4f} "
                f"bound_ms {b['bound_ms']:.4f} ({b['bound_ms'] / ms:.1%}; bytes {b['bytes']} -> "
                f"{b['bytes_ms']:.4f} ms, int32 ops {b['int32_ops']} -> {b['ops_ms']:.4f} ms); "
                f"plain_ms {'not measured' if plain_ms is None else f'{plain_ms:.4f}'}; "
                f"library_ms none (no PyTorch call computes murmur3)")
    probe = []
    for n in (1, 8):
        reps = torch.from_numpy(rng.integers(0, N_ORDERS, n, dtype=np.int64)).to(dev)
        ms = float(np.median(time_cold(lambda: B.bit_indices_kernel(reps, m, k), flush)))
        warm = time_cuda(lambda: B.bit_indices_kernel(reps, m, k))
        b = b7_bound(n, m, k, False)
        probe.append({"n": n, "ms": ms, "warm_ms": warm, "bound_ms": b["bound_ms"]})
        log(f"kernels: B7 indices at the probe's shape, {n} rep(s), m={m}, k={k}: cold ms "
            f"{ms:.4f}, back to back {warm:.4f} ms a launch; bound_ms {b['bound_ms']:.2e}")
    top = next(c for c in cold if c["entry"] == "build" and c["n"] == FILE_ROWS and c["m"] == m)
    return {
        "name": "bloom_bits",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/bloom_bits.cu",
        "replaces": "hyperspace_tpu/ops/bloom.py:34",
        "launches": None,  # phase 11's count, filled in by main
        "max_abs_err": None,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "timing": f"cold: 256 MiB read before each run, median of 30; hs_bloom_build at "
                  f"{FILE_ROWS} rows (one source file), m = {m}, k = {k}, binned route",
        "cold": cold,
        "probe": probe,
    }


def b7_real_timing(dev, recorded: list) -> dict:
    """The build cold on the reps of phase 11's first recorded build (one
    source file's l_orderkey, duplicates included), beside its bound and
    the plain version on the same device reps."""
    import torch

    from hyperspace_tpu_torch.ops import bloom as B

    reps, m, k = next(c for c in recorded if c[0] == "b7 build")[2]
    n = len(reps)
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    ms = float(np.median(time_cold(lambda: B.build_bloom_kernel(reps, m, k), flush)))
    plain_ms = time_cuda(lambda: B.build_bloom_torch(reps, m, k), launches=3, repeats=3)
    b = b7_bound(n, m, k, True)
    distinct = int(torch.unique(reps).numel())
    log(f"kernels: B7 build cold on phase 11's first file's l_orderkey ({n} reps, {distinct} "
        f"distinct), m={m}, k={k}: ms {ms:.4f} bound_ms {b['bound_ms']:.4f} "
        f"({b['bound_ms'] / ms:.1%}); plain_ms {plain_ms:.4f}")
    return {"n": n, "distinct": distinct, "m": m, "k": k, "ms": ms, "plain_ms": plain_ms, **b,
            "share_of_bound": b["bound_ms"] / ms}


def check_b7_main_path(calls: list) -> int:
    """Phase 11's B7 calls, each already held bit-equal to the plain
    version (``KernelCalls.settle``): the create built one filter a
    source file and the queries probed."""
    builds = [c for c in calls if c[0] == "b7 build"]
    probes = [c for c in calls if c[0] == "b7 indices"]
    if len(builds) != N_FILES or not probes:
        raise AssertionError(f"phase 11 made {len(builds)} B7 builds and {len(probes)} probes")
    log(f"kernels: B7 bit-equal to plain on all {len(builds) + len(probes)} calls of phase 11 "
        f"({len(builds)} builds of {sum(len(c[2][0]) for c in builds)} reps, {len(probes)} "
        f"probes of {sum(len(c[2][0]) for c in probes)} literal reps)")
    return len(builds) + len(probes)


def ds_queries(df) -> dict:
    """Phase 11's queries over a lineitem DataFrame of either session: (d1)
    bench.py's q_zrange, pruned by the min/max sketch; (d2) phase 4's 32
    point keys and 4 keys no file holds, pruned by the Bloom filter
    sketch; (d3) phase 4's 4 IN-lists of 8 keys."""
    point_keys, in_lists = phase4_keys()
    absent = [N_ORDERS + 17 * i for i in range(4)]
    ship, qty, key = df["l_shipdate"], df["l_quantity"], df["l_orderkey"]
    cols = ("l_orderkey", "l_shipdate", "l_quantity")
    return {
        "d1": [df.filter((ship >= np.datetime64(ZLO)) & (ship <= np.datetime64(ZHI))
                         & (qty <= 5)).select("l_shipdate", "l_quantity", "l_orderkey")],
        "d2": [df.filter(key == k).select(*cols) for k in point_keys + absent],
        "d3": [df.filter(key.isin(keys)).select(*cols) for keys in in_lists],
    }


def ds_stage_split(sess, plans, rounds: int = 2) -> dict:
    """Phase 11's stage split: each query run ``rounds`` times with
    Hyperspace on and off in turns, its host ms split into the optimizer
    (the rewrite, the sketches' probe included), the range-pruning pass,
    the scan's file reads, the filter (the fused select or the mask) and
    the rest (batch assembly and the result's arrow table), by timing the
    executor's functions of those stages while they run. Returns each
    stage's p50 over queries x rounds for either side, and the routes of
    the last query: the ``exec_stats`` counters it moved and the
    range-pruning stats."""
    from hyperspace_tpu_torch.execution import executor as X
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.indexes import zonemaps

    acc: dict = {}

    def timed(stage, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[stage] = acc.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3
        return run

    stages = {(X, "_range_pruned_scan"): "range_prune", (X, "_exec_scan"): "scan_read",
              (X, "_filter_mask"): "filter", (PC, "fused_filter_batch"): "filter"}
    saved = {key: getattr(*key) for key in stages}
    rows = {"on": [], "off": []}
    routes = {}
    try:
        for (mod, attr), stage in stages.items():
            setattr(mod, attr, timed(stage, saved[(mod, attr)]))
        for _ in range(rounds):
            for q in plans:
                for side in ("on", "off"):
                    (sess.enable_hyperspace if side == "on" else sess.disable_hyperspace)()
                    acc.clear()
                    zonemaps.last_prune_stats = {}
                    before = sess.exec_stats.as_dict()
                    t0 = time.perf_counter()
                    plan = sess.optimize(q.logical_plan)
                    t1 = time.perf_counter()
                    X.execute(plan, sess)
                    total = (time.perf_counter() - t0) * 1e3
                    row = {"optimize": (t1 - t0) * 1e3, **acc}
                    row["rest"] = total - sum(row.values())
                    row["total"] = total
                    rows[side].append(row)
                    after = sess.exec_stats.as_dict()
                    routes[side] = {"exec_stats": {k: v - before[k] for k, v in after.items()
                                                   if v != before[k]},
                                    "prune": dict(zonemaps.last_prune_stats)}
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
        sess.enable_hyperspace()
    names = ("optimize", "range_prune", "scan_read", "filter", "rest", "total")
    return {side: {"p50_ms": {n: float(np.median([r.get(n, 0.0) for r in rows[side]]))
                              for n in names},
                   "routes": routes[side]} for side in rows}


def dataskipping_path(work: str, ctx: dict, kernels: KernelCalls) -> dict:
    """Phase 11: the data-skipping index over phase 4's lineitem in a
    session of its own (a covering index on the same filter would outrank
    it): ds_idx with a min/max sketch on l_shipdate and a Bloom filter
    sketch on l_orderkey, its create's seconds split into file reads and
    sketching and its B7 launches (one a file), its sketch file against
    the one a ``device="cpu"`` session writes; then d1, d2 and d3
    (``ds_queries``). Each query: the explain names ``Type: DS``; the files
    kept equal the cpu session's; one warm-up, 3 rounds with Hyperspace on
    and off in turns; rows equal as a multiset to the plan without
    Hyperspace and in order to the cpu session's. Launch counts read from
    0 at its start; every B7 call is recorded in ``kernels``."""
    import torch

    from hyperspace_tpu_torch import DataSkippingIndexConfig, Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.indexes import zonemaps
    from hyperspace_tpu_torch.indexes.sketches import BloomFilterSketch, MinMaxSketch

    src = ctx["src"]

    def config():
        return DataSkippingIndexConfig("ds_idx", MinMaxSketch("l_shipdate"),
                                       BloomFilterSketch("l_orderkey", DS_FPP, DS_EXPECTED))

    sess = HyperspaceSession()
    sess.conf.set("hyperspace.system.path", os.path.join(work, "dsindexes"))
    hs = Hyperspace(sess)
    items = sess.read.parquet(src)
    ops.reset_launch_counts()
    kernels.label = "create"
    t0 = time.perf_counter()
    hs.create_index(items, config())
    build_s = time.perf_counter() - t0
    kernels.label = None
    counts = ops.launch_counts()
    launches = counts["bloom_bits"]
    routes = tuple(counts[f"bloom_bits.build_{r}"] for r in ("block", "binned", "global"))
    stages = {k: v for k, v in sess.build_stats.items() if isinstance(v, float)}
    sketch_file = hs.get_index("ds_idx").content.files
    log(f"dataskipping path: built ds_idx over {N_FILES} files in {build_s:.3f}s, "
        f"{N_ROWS / build_s:,.0f} rows/s, file reads {stages.get('sketch_read', 0.0):.4f}s, "
        f"sketching {stages.get('sketch', 0.0):.4f}s, B7 launches {launches} (builds by "
        f"route: block {routes[0]}, binned {routes[1]}, global {routes[2]})")
    if launches != N_FILES or routes != (0, N_FILES, 0) or len(sketch_file) != 1:
        raise AssertionError(f"ds_idx: {launches} B7 launches for {N_FILES} files (routes "
                             f"{routes}), {len(sketch_file)} sketch files")

    cpu = HyperspaceSession(device="cpu")
    cpu.conf.set("hyperspace.system.path", os.path.join(work, "dsindexes_cpu"))
    t0 = time.perf_counter()
    Hyperspace(cpu).create_index(cpu.read.parquet(src), config())
    cpu_s = time.perf_counter() - t0
    cpu_file = Hyperspace(cpu).get_index("ds_idx").content.files
    with open(sketch_file[0], "rb") as a, open(cpu_file[0], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("ds_idx's sketch file differs from the cpu session's")
    log(f"dataskipping path: ds_idx's sketch file ({os.path.getsize(sketch_file[0])} bytes) "
        f"equals the one a cpu session writes (its create {cpu_s:.2f}s)")

    sess.enable_hyperspace()
    cpu.enable_hyperspace()
    queries = ds_queries(items)
    cpu_queries = ds_queries(cpu.read.parquet(src))
    results = {}
    for label, plans in queries.items():
        kept = []
        for q, cq in zip(plans, cpu_queries[label]):
            text = hs.explain(q)
            if "Hyperspace(Type: DS, Name: ds_idx" not in text.split("Plan without indexes:")[0]:
                raise AssertionError(f"{label}: ds_idx not used:\n{text}")
            files = tuple(os.path.basename(f) for f in
                          sess.optimize(q.logical_plan).collect_leaves()[0].relation.files)
            cpu_files = tuple(os.path.basename(f) for f in
                              cpu.optimize(cq.logical_plan).collect_leaves()[0].relation.files)
            if files != cpu_files:
                raise AssertionError(f"{label}: files kept {files}, the cpu session's {cpu_files}")
            kept.append(len(files))
        kernels.label = label
        for q in plans:
            q.collect()  # warm-up
        rewrite_ms = []
        for q in plans:
            t0 = time.perf_counter()
            sess.optimize(q.logical_plan)
            rewrite_ms.append((time.perf_counter() - t0) * 1e3)
        on_ms, off_ms, got = [], [], [None] * len(plans)
        for _ in range(3):
            for i, q in enumerate(plans):
                for enabled in (True, False):
                    (sess.enable_hyperspace if enabled else sess.disable_hyperspace)()
                    zonemaps.last_prune_stats = {}
                    t0 = time.perf_counter()
                    out = q.collect()
                    (on_ms if enabled else off_ms).append((time.perf_counter() - t0) * 1e3)
                    if enabled:
                        got[i] = out
                    elif not sorted_rows(got[i]).equals(sorted_rows(out)):
                        raise AssertionError(f"{label}[{i}]: rows differ from the plan without "
                                             f"Hyperspace")
        split = ds_stage_split(sess, plans, rounds=max(2, 20 // len(plans)))
        kernels.label = None
        sess.enable_hyperspace()
        rows = []
        for i, cq in enumerate(cpu_queries[label]):
            if not got[i].equals(cq.collect()):
                raise AssertionError(f"{label}[{i}]: rows differ from the cpu session's")
            rows.append(got[i].num_rows)
        r = {"queries": len(plans), "rows": rows, "files_kept": kept,
             "p50_ms": float(np.percentile(on_ms, 50)), "p99_ms": float(np.percentile(on_ms, 99)),
             "off_p50_ms": float(np.percentile(off_ms, 50)),
             "off_p99_ms": float(np.percentile(off_ms, 99)),
             "paired_gap_p50_ms": float(np.median(np.subtract(on_ms, off_ms))),
             "rewrite_p50_ms": float(np.median(rewrite_ms)), "stages": split}
        if label == "d2":
            r["files_kept_present_mean"] = float(np.mean(kept[:32]))
            r["files_kept_absent"] = kept[32:]
            if any(rows[32:]) or not sum(rows[:32]):
                raise AssertionError(f"d2: rows {rows}")
        elif sum(rows) == 0:
            raise AssertionError(f"{label}: no row matched")
        results[label] = r
        log(f"dataskipping path: {label} ({len(plans)} quer{'y' if len(plans) == 1 else 'ies'}) "
            f"over ds_idx: p50_ms {r['p50_ms']:.3f} p99_ms {r['p99_ms']:.3f} with Hyperspace, "
            f"{r['off_p50_ms']:.3f} / {r['off_p99_ms']:.3f} without (3 rounds each, in turns; "
            f"p50 of each query's on-off difference {r['paired_gap_p50_ms']:.3f}); "
            f"the rewrite (optimizer with the sketches' probe) p50_ms {r['rewrite_p50_ms']:.3f}; "
            f"files kept of {N_FILES} {kept}; rows {sum(rows)}; last prune "
            f"{zonemaps.last_prune_stats}; equal as a multiset to the plan without Hyperspace, "
            f"in order to the cpu session's, the same files kept")
        log(f"dataskipping path: {label} stage split, p50 ms over {len(plans)} quer"
            f"{'y' if len(plans) == 1 else 'ies'} x {max(2, 20 // len(plans))} rounds in turns: "
            f"with Hyperspace "
            f"{split['on']['p50_ms']}, routes {split['on']['routes']}; without "
            f"{split['off']['p50_ms']}, routes {split['off']['routes']}")
    launches = ops.launch_counts()
    log(f"dataskipping path: phase launches {launches}")
    torch.cuda.synchronize()
    return {"launches": launches,
            "create": {"seconds": build_s, "rows_per_s": N_ROWS / build_s, "b7_launches": N_FILES,
                       "stages_s": stages, "sketch_bytes": os.path.getsize(sketch_file[0]),
                       "cpu_create_s": cpu_s},
            "queries": results}


# ---------------------------------------------------------------------------
# Phase 12: the index lifecycle (B1, B2, B5f/B5, B6 and B7 on its paths)
# ---------------------------------------------------------------------------

#: TPC-H's refresh function RF1 at SF1: SF x 1,500 new orders of 1-7 lines
RF1_ORDERS = 1_500
#: phase 12's indexes: lc_idx is li_idx's covering config, lc_z phase 10's
#: z_idx, lc_ds phase 11's ds_idx
#: phase 12's source: the first LC_FILES of phase 4's N_FILES lineitem files
LC_FILES = 1
#: rows of the day's file phases 12 and 13 append (half a source file's)
DAY_ROWS = FILE_ROWS // 2
#: phase 13's source: the first RC_FILES of phase 4's N_FILES lineitem files
RC_FILES = 2
LC_MAIN = ("lc_idx", "lc_z")
LC_ALL = ("lc_idx", "lc_z", "lc_ds")


def lc_config(name):
    from hyperspace_tpu_torch import (
        CoveringIndexConfig,
        DataSkippingIndexConfig,
        ZOrderCoveringIndexConfig,
    )
    from hyperspace_tpu_torch.indexes.sketches import BloomFilterSketch, MinMaxSketch

    if name.endswith("_idx"):  # lc_idx, rc_idx
        return CoveringIndexConfig(name, ["l_orderkey"], ["l_shipdate", "l_quantity"])
    if name.endswith("_z"):
        return ZOrderCoveringIndexConfig(name, *Z_INDEXES["z_idx"])
    return DataSkippingIndexConfig(name, MinMaxSketch("l_shipdate"),
                                   BloomFilterSketch("l_orderkey", DS_FPP, DS_EXPECTED))


def lc_batch(path: str, first_key: int, n_orders: int, seed: int, rows=None) -> int:
    """A lineitem file of new orders ``first_key ..``: 1-7 lines an order
    (RF1's), or ``rows`` lines over the orders; the other columns drawn
    as the generator draws them. Returns its rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    if rows is None:
        keys = np.repeat(np.arange(first_key, first_key + n_orders, dtype=np.int64),
                         rng.integers(1, 8, n_orders))
    else:
        keys = np.sort(rng.integers(first_key, first_key + n_orders, rows, dtype=np.int64))
    n = len(keys)
    ship = np.datetime64("1994-01-01") + rng.integers(0, 2400, n).astype("timedelta64[D]")
    pq.write_table(pa.table({
        "l_orderkey": keys,
        "l_shipdate": pa.array(ship.astype("datetime64[D]")),
        "l_quantity": rng.integers(1, 51, n, dtype=np.int64),
        "l_extendedprice": rng.normal(30000, 8000, n),
    }), path)
    return n


def to_cpu(x, device="cpu"):
    """A copy of ``x`` (tensors, devices, dataclasses, lists and tuples of
    them) on the CPU, or on ``device``."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if isinstance(x, torch.device):
        return torch.device(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v, device) for v in x)
    return x


def states_equal(a, b) -> bool:
    """Two B5f states equal bit for bit (float accumulators by their bits)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5f_cases import _state_bits

    x, y = _state_bits(a), _state_bits(b)
    return a.ops == b.ops and all(x[k].shape == y[k].shape and torch.equal(x[k], y[k]) for k in x)


class LcSide:
    """One device's sessions of phase 12: ``main`` (lc_idx and lc_z, beside
    an o_idx) and ``ds`` (lc_ds, in a system path of its own: a covering
    index on the same filter would outrank it), both with lineage on."""

    def __init__(self, device, main_path: str, ds_path: str):
        from hyperspace_tpu_torch import Hyperspace, HyperspaceSession

        self.main, self.ds = HyperspaceSession(device=device), HyperspaceSession(device=device)
        for s, p in ((self.main, main_path), (self.ds, ds_path)):
            s.conf.set("hyperspace.system.path", p)
            s.conf.set("hyperspace.index.lineage.enabled", True)
        self.hs = {"main": Hyperspace(self.main), "ds": Hyperspace(self.ds)}

    def of(self, name):
        key = "ds" if name.endswith("_ds") else "main"
        return getattr(self, key), self.hs[key]

    def index_path(self, name) -> str:
        sess, _hs = self.of(name)
        return os.path.join(sess.conf.get("hyperspace.system.path"), name)


def lc_tree(root: str) -> dict:
    """Relative path -> (size, mtime_ns) of every file of an index but
    its log."""
    from torch_index_files import index_paths

    return {rel: (st.st_size, st.st_mtime_ns)
            for rel, st in ((r, os.stat(os.path.join(root, r))) for r in index_paths(root))}


class LcCompare:
    """Phase 12's index files and log entries, the card's against the cpu
    session's, in the form ``tests/torch_index_files.py`` gives them; a
    file already held equal and unchanged on both sides is not read
    again."""

    def __init__(self, cuda: LcSide, cpu: LcSide):
        self.cuda, self.cpu, self.seen, self.seconds = cuda, cpu, {}, 0.0

    def __call__(self, names, step: str) -> int:
        from torch_index_files import index_file, normalized_log

        t0 = time.perf_counter()
        read = 0
        for name in names:
            a, b = self.cuda.index_path(name), self.cpu.index_path(name)
            ta, tb = lc_tree(a), lc_tree(b)
            if sorted(ta) != sorted(tb):
                raise AssertionError(f"{step}: {name}'s files differ from the cpu session's: "
                                     f"{sorted(set(ta) ^ set(tb))}")
            for rel in sorted(ta):
                key = (name, rel)
                if self.seen.get(key) == (ta[rel], tb[rel]):
                    continue
                if index_file(os.path.join(a, rel)) != index_file(os.path.join(b, rel)):
                    raise AssertionError(f"{step}: {name}/{rel} differs from the cpu session's")
                self.seen[key] = (ta[rel], tb[rel])
                read += 1
            sa, sb = (s.of(name)[0].conf.get("hyperspace.system.path") for s in (self.cuda, self.cpu))
            if normalized_log(a, sa) != normalized_log(b, sb):
                raise AssertionError(f"{step}: {name}'s log entries differ from the cpu session's")
        self.seconds += time.perf_counter() - t0
        return read


def lc_rows_written(path: str) -> int:
    import pyarrow.parquet as pq

    if not os.path.isdir(path):
        return 0
    return sum(pq.ParquetFile(os.path.join(path, f)).metadata.num_rows
               for f in sorted(os.listdir(path)) if f.startswith("part"))


def lc_versions(side: LcSide, name: str) -> list:
    p = side.index_path(name)
    return sorted((d for d in os.listdir(p) if d.startswith("v__=")),
                  key=lambda d: int(d.split("=")[1])) if os.path.isdir(p) else []


def lc_buckets(side: LcSide, name: str) -> dict:
    """Files a bucket of an index's content: the most and the mean."""
    from collections import Counter

    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    sess, hs = side.of(name)
    per = Counter(bucket_id_of_file(f) for f in hs.get_index(name).content.files)
    return {"buckets": len(per), "max": max(per.values()), "mean": float(np.mean(list(per.values())))}


def lc_action(card, cuda, cpu, kernels, actions, name, op, *args) -> dict:
    """``hs.<op>(name, *args)`` on the card, its kernel calls recorded under
    ``"<op> <args> <name>"``, then in the cpu session, then the calls held
    to their plain versions; its seconds, stages (``build_stats``), rows
    written and rows/s, and launches by kernel logged and kept in
    ``actions``."""
    import torch

    from hyperspace_tpu_torch import ops

    label = " ".join([op.replace("_index", ""), *map(str, args), name])
    if op == "create_index":  # args: the source directory
        label = f"create {name}"
    out = {"action": label}
    for side in (cuda, cpu):
        sess, hs = side.of(name)
        sess.build_stats.clear()
        before_v = lc_versions(side, name)
        on_card = side is cuda
        if on_card:
            before = ops.launch_counts()
            kernels.label = label
        t0 = time.perf_counter()
        try:
            if op == "create_index":
                hs.create_index(sess.read.parquet(args[0]), lc_config(name))
            else:
                getattr(hs, op)(name, *args)
            torch.cuda.synchronize()
        finally:
            kernels.label = None
        secs = time.perf_counter() - t0
        after_v = lc_versions(side, name)
        new = [v for v in after_v if v not in before_v]
        rows = lc_rows_written(os.path.join(side.index_path(name), new[-1])) if new else 0
        if on_card:
            after = ops.launch_counts()
            out.update(seconds=secs, rows_written=rows, versions_before=before_v,
                       rows_per_s=rows / secs if rows else 0.0,
                       stages={k: v for k, v in sess.build_stats.items()},
                       launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
                       versions=after_v)
        else:
            out["cpu_seconds"] = secs
    kernels.settle()
    actions.append(out)
    rate = f" at {out['rows_per_s']:,.0f} rows/s" if out["rows_written"] else ""
    stages = {k: round(v, 4) if isinstance(v, float) else v for k, v in out["stages"].items()}
    log(f"lifecycle path [{card}]: {label}: {out['seconds']:.3f}s on the card "
        f"({out['cpu_seconds']:.3f}s in the cpu session), rows written "
        f"{out['rows_written']}{rate}, stages {stages}, launches {out['launches']}, "
        f"versions {out['versions']}")
    return out


#: the quick-refresh checkpoint's filters (indices into ``lc_filters``):
#: 4 of the 32 point keys, the 4 new keys and 2 of the 4 IN-lists. Each
#: filter reads the whole index side through the Union (about 0.5 s on the
#: card, as long in the cpu session), so the 40 of the other checkpoints
#: would cost the script about 30 s more (PERF.md section 4).
LC_QUICK_FILTERS = tuple(range(4)) + tuple(range(32, 38))
#: d2's point keys at each checkpoint (indices into ``ds_queries``'s d2,
#: the filters' first 36 keys): 8 of the 32 present keys and the 4 new
#: ones, for the script's time (PERF.md section 4)
LC_D2 = tuple(range(8)) + tuple(range(32, 36))


def lc_keys():
    """Phase 4's 32 point keys and 4 IN-lists, and d2's 4 keys absent from
    phase 4's files, which phase 12's first append makes present."""
    point_keys, in_lists = phase4_keys()
    return point_keys, in_lists, [N_ORDERS + 17 * i for i in range(4)]


def lc_filters(df):
    point_keys, in_lists, new_keys = lc_keys()
    key = df["l_orderkey"]
    cols = ("l_orderkey", "l_shipdate", "l_quantity")
    return ([df.filter(key == k).select(*cols) for k in point_keys + new_keys]
            + [df.filter(key.isin(keys)).select(*cols) for keys in in_lists])


def lc_filter_keys(i: int) -> list:
    """The keys of ``lc_filters``' filter ``i`` (and of d2's point ``i``)."""
    point_keys, in_lists, new_keys = lc_keys()
    points = point_keys + new_keys
    return [points[i]] if i < len(points) else list(in_lists[i - len(points)])


def unindexed_key_filters(df, ids) -> dict:
    """The plan without Hyperspace (the caller turned it off) of the
    ``lc_filters`` in ``ids``, run once: ``df`` filtered to the union of
    their keys, each filter's rows then taken from it by its own keys,
    sorted (``sorted_rows``). A key filter's rows are exactly the union's
    rows with its keys, so this equals each filter's own unindexed plan
    while reading the source once instead of once a filter."""
    import pyarrow as pa
    import pyarrow.compute as pc

    keys = {i: lc_filter_keys(i) for i in ids}
    every = sorted({k for ks in keys.values() for k in ks})
    whole = df.filter(df["l_orderkey"].isin(every)).select(
        "l_orderkey", "l_shipdate", "l_quantity").collect()
    col = whole.column("l_orderkey")
    return {i: sorted_rows(whole.filter(pc.is_in(col, value_set=pa.array(ks, pa.int64()))))
            for i, ks in keys.items()}


def lc_check(card, cuda, cpu, kernels, src, orders_src, step: str, served: dict,
             join: bool, filters=None) -> dict:
    """One checkpoint of phase 12. The filters (``lc_filters``) over the
    main session; d2's point keys ``LC_D2`` over the ds session (lc_ds); bench's
    q_zrange (lc_z): each explain names the index ``served`` gives for its
    set (None: no index), one warm-up, one timed run a query, rows equal as
    a multiset to the plan without Hyperspace and in order to the cpu
    session's; with ``join`` also the join (``lc_join``).
    The queries' kernel calls are recorded in ``kernels`` under the step
    and held to their plain versions after it. ``filters`` (indices into
    ``lc_filters``) runs a subset of the filters."""
    out = {"step": step}
    unindexed = {}

    def run(label, sess, hs, cpu_sess, plans, cpu_plans, index, kind, ids=None):
        t_set = time.perf_counter()
        ids = range(len(plans)) if ids is None else ids
        text = [hs.explain(q).split("Plan without indexes:")[0] for q in plans]
        for t in text:
            if index is None and "Hyperspace(" in t:
                raise AssertionError(f"{step} {label}: an index served:\n{t}")
            if index is not None and f"Hyperspace(Type: {kind}, Name: {index}," not in t:
                raise AssertionError(f"{step} {label}: {index} not used:\n{t}")
        sess.enable_hyperspace()
        plans[0].collect()  # warm-up
        times, got = [], []
        for q in plans:
            t0 = time.perf_counter()
            got.append(q.collect())
            times.append((time.perf_counter() - t0) * 1e3)
        sess.disable_hyperspace()
        cpu_sess.enable_hyperspace()
        if label in ("filters", "d2"):
            # d2's point keys are the filters' first 36, in order: one
            # unindexed read of the source for both sets
            todo = [i for i in ids if ("filters", i) not in unindexed]
            if todo:
                for i, rows in unindexed_key_filters(sess.read.parquet(src), todo).items():
                    unindexed[("filters", i)] = rows
        for i, (q, cq) in enumerate(zip(plans, cpu_plans)):
            key = ("filters" if label == "d2" else label, ids[i])
            if key not in unindexed:
                unindexed[key] = sorted_rows(q.collect())
            if not sorted_rows(got[i]).equals(unindexed[key]):
                raise AssertionError(f"{step} {label}[{i}]: rows differ from the plan without "
                                     f"Hyperspace")
            if not got[i].equals(cq.collect()):
                raise AssertionError(f"{step} {label}[{i}]: rows differ from the cpu session's")
        cpu_sess.disable_hyperspace()
        p50, p99 = np.percentile(times, [50, 99])
        out[label] = {"p50_ms": float(p50), "p99_ms": float(p99), "queries": len(plans),
                      "rows": int(sum(g.num_rows for g in got)), "index": index,
                      "seconds": time.perf_counter() - t_set}
        log(f"lifecycle path [{card}]: {step}: {label} ({len(plans)} queries) p50_ms {p50:.3f} "
            f"p99_ms {p99:.3f}, {out[label]['rows']} rows, served by {index}; equal to the plan "
            f"without Hyperspace and in order to the cpu session's; "
            f"{out[label]['seconds']:.1f}s with the checks")

    kernels.label = f"{step} queries"
    try:
        _lc_check_sets(run, cuda, cpu, src, served, filters)
        if join:
            out["join"] = lc_join(card, cuda, cpu, src, orders_src, step)
    finally:
        kernels.label = None
    kernels.settle()
    return out


def _lc_check_sets(run, cuda, cpu, src, served, filters=None) -> None:
    items = cuda.main.read.parquet(src)
    citems = cpu.main.read.parquet(src)
    plans, cpu_plans = lc_filters(items), lc_filters(citems)
    if filters is not None:
        plans, cpu_plans = [plans[i] for i in filters], [cpu_plans[i] for i in filters]
    run("filters", cuda.main, cuda.hs["main"], cpu.main, plans, cpu_plans,
        served.get("lc_idx"), "CI", filters)
    if "lc_z" in served:
        zq = [zorder_queries(d)["q_zrange"][0] for d in (items, citems)]
        run("q_zrange", cuda.main, cuda.hs["main"], cpu.main, [zq[0]], [zq[1]],
            served["lc_z"], "ZOCI")
    if "lc_ds" in served:
        d2 = [[ds_queries(s.ds.read.parquet(src))["d2"][i] for i in LC_D2] for s in (cuda, cpu)]
        run("d2", cuda.ds, cuda.hs["ds"], cpu.ds, d2[0], d2[1], served["lc_ds"], "DS", LC_D2)


#: phase 12's timed join runs at a checkpoint, after the warm-up
LC_JOIN_RUNS = 1


def lc_join(card, cuda, cpu, src, orders_src, step: str) -> dict:
    """Phase 5's orders ⋈ lineitem over phase 12's lineitem: o_idx and
    lc_idx both serve it; one timed run after a warm-up, rows equal in order
    across the two runs, equal as a multiset to the unindexed plan and in
    order to the cpu session's."""
    def q(sess):
        orders, items = sess.read.parquet(orders_src), sess.read.parquet(src)
        return orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
            "o_orderkey", "o_custkey", "l_quantity")

    t_set = time.perf_counter()
    sess, hs = cuda.main, cuda.hs["main"]
    index_served(hs, q(sess), ("o_idx", "lc_idx"))
    sess.enable_hyperspace()
    got = q(sess).collect()  # warm-up
    times = []
    sess.exec_stats.reset()
    for _ in range(LC_JOIN_RUNS):
        t0 = time.perf_counter()
        res = q(sess).collect()
        times.append((time.perf_counter() - t0) * 1e3)
        if not res.equals(got):
            raise AssertionError(f"{step}: join rows differ between runs")
    stats = sess.exec_stats.as_dict()
    stages = dict(sess.join_stats)
    sess.disable_hyperspace()
    if stats["co_bucketed_joins"] != LC_JOIN_RUNS:
        raise AssertionError(f"{step}: the join did not run co-bucketed: {stats}")
    want = q(sess).collect()
    if not sorted_rows(got).equals(sorted_rows(want)):
        raise AssertionError(f"{step}: index-served join rows differ from the unindexed plan")
    cpu.main.enable_hyperspace()
    if not got.equals(q(cpu.main).collect()):
        raise AssertionError(f"{step}: join rows differ from the cpu session's")
    cpu.main.disable_hyperspace()
    p50, secs = float(np.median(times)), time.perf_counter() - t_set
    log(f"lifecycle path [{card}]: {step}: join p50_ms {p50:.3f} ({LC_JOIN_RUNS} runs), {got.num_rows} rows, "
        f"stages s { {k: round(v, 4) for k, v in stages.items()} }; equal to the unindexed "
        f"plan and in order to the cpu session's; {secs:.1f}s with the checks")
    return {"p50_ms": p50, "rows": got.num_rows, "stages_s": stages, "seconds": secs}


def lifecycle_path(work: str, ctx: dict, kernels: KernelCalls, card: str) -> dict:
    """Phase 12: the index lifecycle over a copy of the first LC_FILES of
    phase 4's 8 lineitem files, lineage on, in sessions of its own on the card and, step for
    step, on the cpu: lc_idx (li_idx's config) and
    lc_z (phase 10's z_idx) in phase 4's system path beside phase 5's
    o_idx, which stays unchanged; lc_ds (phase 11's ds_idx) in one of its
    own. The steps follow TPC-H's refresh functions at lake granularity:
    (1) RF1's batch, 1,500 new orders of 1-7 lines, then an incremental
    refresh of all three; (2) a day's file of DAY_ROWS rows of new orders,
    incremental again; (3) RF2 as the delete of source file 0, incremental
    (the lineage rewrite, which leaves one file a bucket); (4) a second RF1
    batch indexed incrementally by all three (two files a bucket again),
    lc_idx optimized full (compacted), then quick (a no-op), a third RF1
    batch recorded by a quick refresh of lc_idx (lc_idx serves the filters
    through a Union with the batch read from the source), then indexed by
    an incremental one; (5) a fourth RF1 batch, a full refresh
    and a vacuum of the outdated versions of all three, delete, restore,
    delete and vacuum, and a cancel over a transient entry written through
    the log manager. After each step every index file and log entry
    equals the cpu session's; the checkpoint queries (``lc_check``) run
    before step 1, after steps 2, 3 and 5 and in the quick-refresh state;
    the join after step 2 (buckets of two files: the device re-sort route)
    and after step 3 (one file a bucket), each time held to the unindexed
    plan and the cpu session's. (For the script's time: no checkpoint
    after steps 1 and 4, whose indexes' layouts steps 2 and 3 already
    query, and no join before step 1, whose one-file buckets phase 5 and
    step 3 already join; the join one timed run after its warm-up, and
    half a source file's rows in the day's file.) Every B1,
    B6, B7 and B5f call on the card is recorded in ``kernels`` under its
    action and held to its plain version after it. Launch counts read
    from 0 at its start."""
    import shutil as _shutil

    import torch

    from hyperspace_tpu_torch import CoveringIndexConfig, ops
    from hyperspace_tpu_torch.constants import States

    sys.path.insert(0, os.path.join(ROOT, "tests"))

    t_phase = time.perf_counter()
    src = os.path.join(work, "lc_lineitem")
    # the first LC_FILES of phase 4's files (a depth cut: the cpu session's
    # SF1 actions were the script's largest share)
    os.makedirs(src)
    for i in range(LC_FILES):
        _shutil.copy(os.path.join(ctx["src"], f"part{i}.parquet"), src)
    orders_src = ctx["orders_src"]
    cuda = LcSide(None, ctx["session"].conf.get("hyperspace.system.path"),
                  os.path.join(work, "lc_ds_indexes"))
    # system paths of one depth on both sides: the log entries' directory
    # trees then differ only in the names normalized_log replaces
    cpu = LcSide("cpu", os.path.join(work, "lc_cpu_main"), os.path.join(work, "lc_cpu_ds"))
    compare = LcCompare(cuda, cpu)
    ops.reset_launch_counts()
    actions, checks = [], []
    # the cpu session's o_idx, phase 5's config over phase 5's orders
    cpu.hs["main"].create_index(cpu.main.read.parquet(orders_src), CoveringIndexConfig(
        "o_idx", ["o_orderkey"], ["o_custkey", "o_totalprice"]))
    for side in (cuda, cpu):
        side.main.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    for name in LC_ALL:
        lc_action(card, cuda, cpu, kernels, actions, name, "create_index", src)
    compare(LC_ALL, "create")
    all_served = {n: n for n in LC_ALL}
    checks.append(lc_check(card, cuda, cpu, kernels, src, orders_src, "before step 1", all_served,
                           False))

    def refresh_all(mode="incremental"):
        for name in LC_ALL:
            lc_action(card, cuda, cpu, kernels, actions, name, "refresh_index", mode)

    # (1) RF1's batch: 1,500 new orders above phase 4's keys
    n1 = lc_batch(os.path.join(src, "rf1_a.parquet"), N_ORDERS, RF1_ORDERS, SEED + 20)
    log(f"lifecycle path [{card}]: step 1: appended RF1's batch, {RF1_ORDERS} orders, {n1} rows")
    refresh_all()
    read = compare(LC_ALL, "step 1")
    # (2) a day's file of new orders
    n2 = lc_batch(os.path.join(src, "day_a.parquet"), N_ORDERS + RF1_ORDERS, FILE_ROWS // 4,
                  SEED + 21, rows=DAY_ROWS)
    log(f"lifecycle path [{card}]: step 2: appended a day's file, {n2} rows")
    refresh_all()
    read += compare(LC_ALL, "step 2")
    before_opt = lc_buckets(cuda, "lc_idx")
    checks.append(lc_check(card, cuda, cpu, kernels, src, orders_src, "after step 2", all_served, True))
    # (3) RF2 at file granularity: source file 0 deleted
    os.remove(os.path.join(src, "part0.parquet"))
    log(f"lifecycle path [{card}]: step 3: deleted source file part0.parquet")
    refresh_all()
    read += compare(LC_ALL, "step 3")
    checks.append(lc_check(card, cuda, cpu, kernels, src, orders_src, "after step 3", all_served, True))
    # (4) RF2's rewrite left one file a bucket: a second RF1 batch indexed
    # incrementally gives lc_idx two again, then optimize full compacts them
    # (quick after it is a no-op); a third batch is recorded by a quick
    # refresh (lc_idx serves through a Union) and indexed by an incremental one
    next_key = N_ORDERS + RF1_ORDERS + FILE_ROWS // 4
    n4 = lc_batch(os.path.join(src, "rf1_b.parquet"), next_key, RF1_ORDERS, SEED + 22)
    next_key += RF1_ORDERS
    log(f"lifecycle path [{card}]: step 4: appended RF1's second batch, {n4} rows")
    refresh_all()
    read += compare(LC_ALL, "step 4 incremental")
    pre = lc_buckets(cuda, "lc_idx")
    lc_action(card, cuda, cpu, kernels, actions, "lc_idx", "optimize_index", "full")
    post = lc_buckets(cuda, "lc_idx")
    lc_action(card, cuda, cpu, kernels, actions, "lc_idx", "optimize_index", "quick")
    if actions[-2]["versions"] == actions[-2]["versions_before"] or \
            actions[-1]["versions"] != actions[-2]["versions"]:
        raise AssertionError("optimize full wrote no version, or quick after it wrote one")
    log(f"lifecycle path [{card}]: step 4: lc_idx files a bucket after step 2 {before_opt}, "
        f"before optimize {pre}, after {post}")
    if pre["max"] < 2 or post["max"] != 1:
        raise AssertionError(f"optimize full did not compact: before {pre}, after {post}")
    read += compare(("lc_idx",), "step 4 optimize")
    n4q = lc_batch(os.path.join(src, "rf1_c.parquet"), next_key, RF1_ORDERS, SEED + 23)
    next_key += RF1_ORDERS
    lc_action(card, cuda, cpu, kernels, actions, "lc_idx", "refresh_index", "quick")
    read += compare(("lc_idx",), "step 4 quick")
    # the quick-refreshed entry serves in exact mode, its recorded batch
    # read from the source beside the index through a Union
    quick_text = cuda.hs["main"].explain(lc_filters(cuda.main.read.parquet(src))[0])
    if "Union" not in quick_text.split("Plan without indexes:")[0]:
        raise AssertionError(f"the quick-refreshed lc_idx served no Union:\n{quick_text}")
    quick = lc_check(card, cuda, cpu, kernels, src, orders_src, "step 4, quick refresh",
                     {"lc_idx": "lc_idx"}, False, filters=LC_QUICK_FILTERS)
    lc_action(card, cuda, cpu, kernels, actions, "lc_idx", "refresh_index", "incremental")
    read += compare(("lc_idx",), "step 4")
    log(f"lifecycle path [{card}]: step 4: appended RF1's third batch ({n4q} rows), recorded by "
        f"a quick refresh (lc_idx served the filters through a Union with the batch), "
        f"indexed by an incremental one")
    # (5) full refresh after a fourth RF1 batch, vacuum, delete / restore,
    # vacuum, cancel
    n5 = lc_batch(os.path.join(src, "rf1_d.parquet"), next_key, RF1_ORDERS, SEED + 24)
    refresh_all("full")
    read += compare(LC_ALL, "step 5 full")
    versions = {n: lc_versions(cuda, n) for n in LC_ALL}
    for name in LC_ALL:
        lc_action(card, cuda, cpu, kernels, actions, name, "vacuum_index")
    vacuumed = {n: lc_versions(cuda, n) for n in LC_ALL}
    log(f"lifecycle path [{card}]: step 5: RF1's fourth batch ({n5} rows), full refreshes; "
        f"versions on disk before vacuum {versions}, after {vacuumed}")
    if any(len(v) != 1 for v in vacuumed.values()):
        raise AssertionError(f"vacuum left outdated versions: {vacuumed}")
    read += compare(LC_ALL, "step 5 vacuum")
    after5 = lc_check(card, cuda, cpu, kernels, src, orders_src, "after step 5", all_served, False)
    for name in LC_ALL:
        for op in ("delete_index", "restore_index", "delete_index", "vacuum_index"):
            lc_action(card, cuda, cpu, kernels, actions, name, op)
        if lc_versions(cuda, name) or cuda.of(name)[1].get_index(name).state != States.DOESNOTEXIST:
            raise AssertionError(f"{name}: the hard vacuum left data or state")
    for side in (cuda, cpu):
        sess, hs = side.of("lc_idx")
        log_mgr = sess.index_manager._managers("lc_idx")[0]
        tip = log_mgr.get_latest_id()
        transient = log_mgr.get_log(tip).with_state(States.CREATING)
        if not log_mgr.write_log(tip + 1, transient):
            raise AssertionError("the transient entry was not written")
        hs.cancel("lc_idx")
        if log_mgr.get_latest_log().state != States.DOESNOTEXIST:
            raise AssertionError("cancel did not roll the transient entry back")
    compare(LC_ALL, "step 5 delete, vacuum, cancel")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    secs = time.perf_counter() - t_phase
    log(f"lifecycle path [{card}]: all steps ran; {read} index files held equal to the cpu "
        f"session's, log entries equal ({compare.seconds:.1f}s reading them); phase launches "
        f"{launches}; {secs:.1f}s in all")
    held = kernels.summary("phase 12", (
        ("b1", "refresh incremental lc_idx"), ("b1", "optimize full lc_idx"),
        ("b6", "refresh incremental lc_z"), ("b6", "refresh full lc_z"),
        ("b7", "refresh incremental lc_ds"), ("b5f", "refresh incremental lc_idx")))
    return {"launches": launches, "actions": actions, "checks": checks, "quick_state": quick,
            "after_step_5": after5, "files_compared": read, "seconds": secs, "held": held,
            "buckets": {"after_step_2": before_opt, "before_optimize": pre,
                        "after_optimize": post}}


# ---------------------------------------------------------------------------
# Phase 13: crash recovery (B1, B5f, B6 and B7 on the recovered and retried
# actions)
# ---------------------------------------------------------------------------

#: phase 13's writer lease: short, so a crashed writer's entry ages out in
#: seconds; the orphan grace is 0 (GC purges at once)
RC_LEASE_MS = 2_000


class RcSide(LcSide):
    """One system-path pair of phase 13 (``main`` for rc_idx and rc_z, ``ds``
    for rc_ds), lineage on, the lease at ``RC_LEASE_MS``, orphan grace 0;
    the filters bucket-pruned, as in phases 4 and 12."""

    def __init__(self, device, main_path: str, ds_path: str):
        super().__init__(device, main_path, ds_path)
        for s in (self.main, self.ds):
            s.conf.set("hyperspace.recovery.leaseMs", RC_LEASE_MS)
            s.conf.set("hyperspace.recovery.orphanGraceMs", 0)
        self.main.conf.set("hyperspace.index.filterRule.useBucketSpec", True)


class RcClock:
    """The recovery plane's own costs in phase 13: each ``ensure_recovered``
    and ``gc_orphans`` call's seconds and report (the module functions
    wrapped, so the manager's and the actions' calls are timed too), and
    each lease heartbeat's renewals (``IndexLogManager.overwrite_log``, its
    one caller) between its start and its stop."""

    def __init__(self):
        from hyperspace_tpu_torch.metadata import log_manager, recovery

        self.calls, self.beats, self.renewals = [], [], []
        for name in ("ensure_recovered", "gc_orphans"):
            inner = getattr(recovery, name)

            def timed(*args, inner=inner, name=name, **kw):
                t0 = time.perf_counter()
                out = inner(*args, **kw)
                self.calls.append((name, time.perf_counter() - t0, out))
                return out

            setattr(recovery, name, timed)
        overwrite = log_manager.IndexLogManager.overwrite_log

        def renewal(lm, log_id, entry):
            overwrite(lm, log_id, entry)
            self.renewals.append((lm.index_path, log_id, time.perf_counter()))

        log_manager.IndexLogManager.overwrite_log = renewal
        start, stop = recovery.LeaseHeartbeat.start, recovery.LeaseHeartbeat.stop

        def started(hb):
            hb.started_at = time.perf_counter()
            return start(hb)

        def stopped(hb):
            stop(hb)
            self.beats.append((hb._log_manager.index_path, hb._log_id, hb.started_at,
                               time.perf_counter()))

        recovery.LeaseHeartbeat.start, recovery.LeaseHeartbeat.stop = started, stopped

    def gaps(self, beats=None) -> dict:
        """Renewals and the longest gap (ms) between the start, each renewal
        and the stop of each heartbeat."""
        longest, renewals = 0.0, 0
        for path, log_id, t0, t1 in beats if beats is not None else self.beats:
            ts = sorted(t for p, i, t in self.renewals if p == path and i == log_id and t0 <= t <= t1)
            renewals += len(ts)
            marks = [t0, *ts, t1]
            longest = max([longest] + [b - a for a, b in zip(marks, marks[1:])])
        return {"heartbeats": len(beats if beats is not None else self.beats),
                "renewals": renewals, "longest_gap_ms": longest * 1e3}


def rc_data_files(path: str) -> set:
    """Relative paths of the data files under an index's version dirs."""
    from hyperspace_tpu_torch.utils.files import list_leaf_files
    from hyperspace_tpu_torch.utils.paths import is_data_path

    out = set()
    for name in sorted(os.listdir(path)) if os.path.isdir(path) else ():
        root = os.path.join(path, name)
        if not name.startswith("_") and os.path.isdir(root):
            out.update(os.path.relpath(p, path) for p, _s, _m in list_leaf_files(root)
                       if is_data_path(p))
    return out


def rc_entries(side: RcSide, name: str) -> list:
    """The last action's begin and end entries of ``name`` as
    ``torch_index_files.normalized_entry`` gives them (the writer lease
    compared by its presence); the begin entry must carry the lease, the end
    entry not."""
    from torch_index_files import LEASE_PROPS, normalized_entry, read_log

    sess, _hs = side.of(name)
    log = read_log(side.index_path(name))
    ids = sorted(int(f) for f in log if f.isdigit())
    out = []
    for i in ids[-2:]:
        entry = log[str(i)]
        leased = all(p in entry.get("properties", {}) for p in LEASE_PROPS)
        if (entry["state"] not in ("ACTIVE", "DELETED", "DOESNOTEXIST")) != leased:
            raise AssertionError(f"{name}: entry {i} ({entry['state']}) leased {leased}")
        out.append(normalized_entry(entry, sess.conf.get("hyperspace.system.path")))
    return out


def rc_same(rc: RcSide, ref: RcSide, name: str, label: str) -> int:
    """``name``'s index files (``torch_index_files.index_file``: bytes, the
    JSON sidecars without mtime_ns) and its last action's entries equal the
    crash-free run's. Version dirs are matched in order: a crash before an
    action's first data file leaves its version dir empty, which GC keeps
    (as the reference's does), so the retry writes the next version.
    Returns the files compared."""
    import json as _json

    from torch_index_files import index_files

    got, want = index_files(rc.index_path(name)), index_files(ref.index_path(name))

    def versions(files):
        return sorted({r.split("/")[0] for r in files if r.startswith("v__=")},
                      key=lambda v: int(v.split("=")[1]))

    renamed = dict(zip(versions(got), versions(want)))
    if any(a != b for a, b in renamed.items()):
        log(f"recovery path: {label}: the retry's version dirs {sorted(renamed)} match the "
            f"crash-free run's {sorted(renamed.values())}")
    got = {"/".join([renamed.get(r.split("/")[0], r.split("/")[0])] + r.split("/")[1:]): v
           for r, v in got.items()}
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: {name}'s files differ from the crash-free run's: "
                             f"{sorted(set(got) ^ set(want))[:8]}")
    for rel in got:
        if got[rel] != want[rel]:
            raise AssertionError(f"{label}: {name}/{rel} differs from the crash-free run's")
    text = _json.dumps(rc_entries(rc, name))
    for a, b in renamed.items():
        text = text.replace(f'"{a}"', f'"{b}"')
    if _json.loads(text) != rc_entries(ref, name):
        raise AssertionError(f"{label}: {name}'s entries differ from the crash-free run's")
    return len(got)


class RcQueries:
    """The queries each cell runs after its recovery: phase 4's 36 filters
    over rc_idx, q_zrange over rc_z, d2 over rc_ds. Where the index serves
    them, their rows equal as a multiset the plan without Hyperspace's,
    computed once a source state (the point filters' and d2's by one read
    of the source, ``unindexed_key_filters``); where it serves none (rolled back, or
    stale after a source change), each plan is the unindexed one and is
    not run again. Their kernel calls (B1 on the literals, B7's probes) go
    to ``kernels``."""

    def __init__(self, rc, src: str, kernels: KernelCalls):
        self.rc, self.src, self.kernels = rc, src, kernels
        self.unindexed, self.state = {}, "initial"

    def plans(self, name):
        if name.endswith("_idx"):
            return lc_filters(self.rc.main.read.parquet(self.src))[:36]
        if name.endswith("_z"):
            return [zorder_queries(self.rc.main.read.parquet(self.src))["q_zrange"][0]]
        return ds_queries(self.rc.ds.read.parquet(self.src))["d2"]

    def __call__(self, name: str, label: str) -> dict:
        sess, hs = self.rc.of(name)
        plans = self.plans(name)
        self.kernels.label = f"{label}, queries"
        try:
            served = any(f"Name: {name}," in hs.explain(q).split("Plan without indexes:")[0]
                         for q in plans)
            if not served:
                return {"queries": len(plans), "rows": None, "served": False, "seconds": 0.0}
            sess.enable_hyperspace()
            t0 = time.perf_counter()
            got = [q.collect() for q in plans]
            secs = time.perf_counter() - t0
        finally:
            self.kernels.label = None
            sess.disable_hyperspace()
        if name.endswith(("_idx", "_ds")) and (self.state, name, 0) not in self.unindexed:
            # the 36 point filters' (or d2's, the same keys) unindexed plan,
            # one read of the source
            base = sess.read.parquet(self.src)
            for i, rows in unindexed_key_filters(base, range(len(plans))).items():
                self.unindexed[(self.state, name, i)] = rows
        for i, q in enumerate(plans):
            key = (self.state, name, i)
            if key not in self.unindexed:
                self.unindexed[key] = sorted_rows(q.collect())
            if not sorted_rows(got[i]).equals(self.unindexed[key]):
                raise AssertionError(f"{label}: {name}'s query {i} differs from the plan without "
                                     f"Hyperspace")
        return {"queries": len(plans), "rows": sum(g.num_rows for g in got), "served": served,
                "seconds": secs}


def rc_run(side, name, op, *args):
    """``hs.<op>(name, *args)``; ``create_index`` takes the source dir."""
    sess, hs = side.of(name)
    if op == "create_index":
        hs.create_index(sess.read.parquet(args[0]), lc_config(name))
    else:
        getattr(hs, op)(name, *args)


#: the kernels each index's creates, refreshes and optimizes run
RC_KERNELS = {"_idx": ("murmur3_bucket_ids", "fused_filter_agg"),
              "_z": ("zorder_interleave", "fused_filter_agg"), "_ds": ("bloom_bits",)}


def rc_kernels(name: str):
    return next(k for suffix, k in RC_KERNELS.items() if name.endswith(suffix))


def rc_timed(kernels: KernelCalls, label: str, fn) -> tuple:
    """``fn()`` with its kernel calls recorded under ``label``: (seconds,
    launches by kernel, the exception it raised or None)."""
    import torch

    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.testing.faults import SimulatedCrash

    before = ops.launch_counts()
    kernels.label = label
    t0 = time.perf_counter()
    err = None
    try:
        fn()
        torch.cuda.synchronize()
    except (SimulatedCrash, Exception) as e:  # the cell decides what it expects
        err = e
    finally:
        kernels.label = None
    secs = time.perf_counter() - t0
    after = ops.launch_counts()
    return secs, {k: after[k] - before[k] for k in after if after[k] != before[k]}, err


def rc_wait_lease(log_mgr) -> float:
    """Sleep until the tip's writer lease has expired; returns its expiry
    (epoch seconds). A committed tip (no lease) returns now."""
    tip = log_mgr.get_latest_log()
    raw = tip.properties.get("recovery.leaseExpiresAtMs") if tip is not None else None
    if raw is None:
        return time.time()
    expires = int(raw) / 1000.0
    time.sleep(max(0.0, expires - time.time()) + 0.01)
    return expires


def rc_cell(card, ctx: dict, name: str, label: str, point: str, spec: str, op, *args,
            ref_op=True) -> dict:
    """One crash cell of phase 13: ``op`` on rc crashes at ``point`` (spec
    ``spec``, in-process ``raise``); then (1) the crash fired once and the
    tip is transient (committed for after_end_log); (2) after the lease,
    ``hs.recover`` reports rolled_back (healed_pointer); (3) the data files
    equal the set before (a subset, for a vacuum), no orphan is left and a
    second GC moves nothing; (4) the index's queries give the unindexed
    plan's rows; (5) the retried action's index files and entries equal the
    crash-free run's (the same action on ref, unless ``ref_op`` is False:
    ref is already there), and it made a call of each kernel it runs."""
    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.metadata import recovery
    from hyperspace_tpu_torch.testing import faults

    rc, ref, kernels, clock = ctx["rc"], ctx["ref"], ctx["kernels"], ctx["clock"]
    sess, hs = rc.of(name)
    log_mgr = sess.index_manager._managers(name)[0]
    path = rc.index_path(name)
    committed = point == "after_end_log"
    before = rc_data_files(path)
    faults.reset()
    faults.set_crash(point, spec)
    crash_s, crash_launches, err = rc_timed(kernels, f"{label}, crashed",
                                            lambda: rc_run(rc, name, op, *args))
    if not isinstance(err, faults.SimulatedCrash) or faults.stats() != {f"crash.{point}": 1}:
        raise AssertionError(f"{label}: expected one crash at {point}, got {err!r}, "
                             f"{faults.stats()}")
    tip = log_mgr.get_latest_log()
    if (tip.state in ("ACTIVE", "DELETED", "DOESNOTEXIST")) != committed:
        raise AssertionError(f"{label}: the tip after the crash is {tip.state}")
    landed = rc_data_files(path) - before
    expires = rc_wait_lease(log_mgr)
    n_calls = len(clock.calls)
    rep = hs.recover(name)
    recover_s = time.time() - expires
    timed = {n: s for n, s, _r in clock.calls[n_calls:]}
    if rep["rolled_back"] == committed or rep["healed_pointer"] != committed:
        raise AssertionError(f"{label}: recover reported {rep}")
    after = rc_data_files(path)
    if committed:
        before = before | landed
    if not (after <= before if op == "vacuum_index" else after == before):
        raise AssertionError(f"{label}: data files after recovery differ from before: "
                             f"{sorted(after ^ before)[:8]}")
    if recovery.find_orphans(path):
        raise AssertionError(f"{label}: orphans left after recovery")
    gc2 = recovery.gc_orphans(path, 0)
    if gc2["quarantined_files"] or gc2["quarantined_dirs"]:
        raise AssertionError(f"{label}: a second GC moved files: {gc2}")
    queries = ctx["queries"](name, label)
    retry_s, retry_launches, retry_err = rc_timed(kernels, f"{label}, retried",
                                                  lambda: rc_run(rc, name, op, *args))
    if retry_err is not None and not (committed and isinstance(retry_err, HyperspaceException)):
        raise retry_err
    if op != "vacuum_index" and not committed:
        missing = [k for k in rc_kernels(name) if not retry_launches.get(k)]
        if missing:
            raise AssertionError(f"{label}: the retried action launched no {missing}")
    if point == "mid_data_write" and ";at=" in spec:
        # the crash fired in the pipelined writer's thread: every bucket
        # queued behind the crashed file still landed, as in the reference
        wrote = len(rc_data_files(path) - before)
        if len(landed) != wrote - 1:
            raise AssertionError(f"{label}: {len(landed)} files landed before the crash, "
                                 f"not the {wrote - 1} of the reference's pipelined writer")
    ref_s = None
    if ref_op:
        ref_s, _l, err = rc_timed(kernels, f"{label}, crash-free", lambda: rc_run(ref, name, op, *args))
        if err is not None:
            raise err
    files = rc_same(rc, ref, name, label)
    kernels.settle()
    out = {"cell": label, "point": point, "spec": spec, "crash_s": crash_s,
           "crashed_files": len(landed), "tip": tip.state,
           "report": {k: rep[k] for k in ("rolled_back", "healed_pointer", "live_writer",
                                          "latest_state")},
           "gc": rep["gc"], "recover_s_after_lease": recover_s,
           "ensure_recovered_ms": timed.get("ensure_recovered", 0.0) * 1e3,
           "gc_ms": timed.get("gc_orphans", 0.0) * 1e3, "queries": queries,
           "retry_s": retry_s, "crash_free_s": ref_s,
           "retry_outcome": type(retry_err).__name__ if retry_err else "ran",
           "retry_launches": retry_launches, "crash_launches": crash_launches,
           "files_equal_crash_free": files}
    log(f"recovery path [{card}]: {label}: crashed at {point} ({spec}) after {crash_s:.3f}s, "
        f"{len(landed)} new data files, tip {tip.state}; recover {recover_s:.3f}s after the "
        f"lease (ensure_recovered {out['ensure_recovered_ms']:.1f} ms, gc {out['gc_ms']:.1f} ms, "
        f"{rep['gc']['quarantined_files']} files / {rep['gc']['quarantined_dirs']} dirs "
        f"quarantined); {queries['queries']} queries "
        f"{'served, equal to the unindexed plan' if queries['served'] else 'not served by it'}; "
        f"retried in {retry_s:.3f}s ({out['retry_outcome']}, launches "
        f"{retry_launches}; the crash-free run "
        f"{'at the phase start' if ref_s is None else f'{ref_s:.3f}s'}); {files} files and the "
        f"entries equal the crash-free run's")
    return out


RC_CHILD = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
from hyperspace_tpu_torch.testing import faults

s = HyperspaceSession()
s.conf.set("hyperspace.system.path", {sys_path!r})
s.conf.set("hyperspace.index.lineage.enabled", True)
s.conf.set("hyperspace.recovery.leaseMs", {lease!r})
hs = Hyperspace(s)
faults.set_crash("mid_data_write", "exit;at=101")
hs.create_index(s.read.parquet({src!r}), chip_smoke.lc_config("rc_idx"))
raise SystemExit(7)  # never reached: the crash point exits first
"""


def rc_child_death(card, ctx: dict) -> dict:
    """A fresh interpreter on the card creates rc_idx and dies at its 101st
    bucket file (``os._exit``, no CUDA teardown, no heartbeat stop). Before
    its lease expires ``recover`` reports a live writer and changes nothing;
    after, it rolls back and quarantines the child's 100 files; the create
    then runs in this process, equal to the crash-free run's."""
    rc, ref, kernels, clock = ctx["rc"], ctx["ref"], ctx["kernels"], ctx["clock"]
    sess, hs = rc.of("rc_idx")
    log_mgr = sess.index_manager._managers("rc_idx")[0]
    path = rc.index_path("rc_idx")
    code = RC_CHILD.format(root=ROOT, sys_path=sess.conf.get("hyperspace.system.path"),
                           lease=RC_LEASE_MS, src=ctx["rc_src"])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    child_s = time.perf_counter() - t0
    if proc.returncode != 86:
        raise AssertionError(f"the child exited {proc.returncode}: {proc.stderr[-3000:]}")
    files, last = rc_data_files(path), log_mgr.get_latest_id()
    live = hs.recover("rc_idx")
    if not (live["live_writer"] and live["gc"]["skipped_live_writer"]) or \
            rc_data_files(path) != files or log_mgr.get_latest_id() != last:
        raise AssertionError(f"recover before the child's lease expired: {live}")
    if len(files) != 100:
        raise AssertionError(f"the child left {len(files)} files, not 100")
    expires = rc_wait_lease(log_mgr)
    n_calls = len(clock.calls)
    rep = hs.recover("rc_idx")
    recover_s = time.time() - expires
    timed = {n: s for n, s, _r in clock.calls[n_calls:]}
    if not rep["rolled_back"] or rep["gc"]["quarantined_dirs"] != 1 or rc_data_files(path):
        raise AssertionError(f"recover after the child's lease: {rep}")
    retry_s, launches, err = rc_timed(kernels, "child death, retried",
                                      lambda: rc_run(rc, "rc_idx", "create_index", ctx["rc_src"]))
    if err is not None:
        raise err
    files_equal = rc_same(rc, ref, "rc_idx", "child death")
    kernels.settle()
    out = {"cell": "rc_idx create, a child killed at mid_data_write (exit;at=101)",
           "child_s": child_s, "exit_code": proc.returncode, "child_files": len(files),
           "live_report": {k: live[k] for k in ("live_writer", "rolled_back")},
           "report": {k: rep[k] for k in ("rolled_back", "healed_pointer", "latest_state")},
           "gc": rep["gc"], "recover_s_after_lease": recover_s,
           "gc_ms": timed.get("gc_orphans", 0.0) * 1e3, "retry_s": retry_s,
           "retry_launches": launches, "files_equal_crash_free": files_equal}
    log(f"recovery path [{card}]: the child exited 86 after {child_s:.1f}s leaving "
        f"{len(files)} bucket files; recover before its lease: live writer, nothing changed; "
        f"after: rolled back, {rep['gc']['quarantined_dirs']} dir of 100 files quarantined "
        f"(gc {out['gc_ms']:.1f} ms), {recover_s:.3f}s after the lease; the create then ran in "
        f"{retry_s:.3f}s, equal to the crash-free run's")
    return out


def rc_live_writer(card, ctx: dict) -> dict:
    """While a full refresh of rc_idx runs on the card in a thread, a second
    session (its attach sweep, then ``recover``) reports the live writer and
    touches nothing; the refresh then commits. Its heartbeat's renewals and
    longest gap are logged, and the gap must stay below the lease."""
    import threading

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession

    rc, kernels, clock = ctx["rc"], ctx["kernels"], ctx["clock"]
    sess, hs = rc.of("rc_idx")
    log_mgr = sess.index_manager._managers("rc_idx")[0]
    path = rc.index_path("rc_idx")
    lc_batch(os.path.join(ctx["rc_src"], "rc_rf1_live.parquet"), ctx["next_key"], RF1_ORDERS,
             SEED + 40)
    ctx["next_key"] += RF1_ORDERS
    ctx["queries"].state = "live"
    first = log_mgr.get_latest_id()
    beats = len(clock.beats)
    box = {}

    def refresh():
        box["s"], box["launches"], box["err"] = rc_timed(
            kernels, "live writer refresh", lambda: hs.refresh_index("rc_idx", "full"))

    t = threading.Thread(target=refresh)
    t.start()
    deadline = time.time() + 60
    while log_mgr.get_latest_id() == first and time.time() < deadline:
        time.sleep(0.005)
    if log_mgr.get_latest_log().state != "REFRESHING":
        raise AssertionError("the refresh's begin entry did not appear")
    s2 = HyperspaceSession()
    s2.conf.set("hyperspace.system.path", sess.conf.get("hyperspace.system.path"))
    s2.conf.set("hyperspace.recovery.leaseMs", RC_LEASE_MS)
    s2.conf.set("hyperspace.recovery.orphanGraceMs", 0)
    hs2 = Hyperspace(s2)  # the attach sweep
    rep = hs2.recover("rc_idx")
    tip_id = log_mgr.get_latest_id()
    quarantine = os.path.isdir(os.path.join(path, "_hyperspace_quarantine"))
    t.join(120)
    if t.is_alive():
        raise AssertionError("the live writer's refresh did not end in 120 s")
    if box["err"] is not None:
        raise box["err"]
    if not (rep["live_writer"] and rep["gc"]["skipped_live_writer"]) or quarantine or \
            tip_id != first + 1:
        raise AssertionError(f"the second session touched the live writer's index: {rep}")
    if log_mgr.get_latest_log().state != "ACTIVE" or log_mgr.get_latest_id() != first + 2:
        raise AssertionError("the refresh did not commit after the second session's recover")
    gaps = clock.gaps(clock.beats[beats:])
    if gaps["longest_gap_ms"] >= RC_LEASE_MS:
        raise AssertionError(f"a heartbeat gap of {gaps['longest_gap_ms']:.1f} ms reached the lease")
    queries = ctx["queries"]("rc_idx", "live writer")
    kernels.settle()
    out = {"refresh_s": box["s"], "launches": box["launches"], "second_session": {
        k: rep[k] for k in ("live_writer", "rolled_back", "healed_pointer")},
        "skipped_live_writer": rep["gc"]["skipped_live_writer"], "heartbeat": gaps,
        "queries": queries}
    log(f"recovery path [{card}]: live writer: a full refresh of rc_idx ({box['s']:.3f}s) while "
        f"a second session attached and recovered: live_writer {rep['live_writer']}, "
        f"skipped_live_writer {rep['gc']['skipped_live_writer']}, nothing touched; heartbeat "
        f"{gaps['renewals']} renewals, longest gap {gaps['longest_gap_ms']:.1f} ms (lease "
        f"{RC_LEASE_MS} ms)")
    return out


def rc_overhead(card, ctx: dict) -> dict:
    """RF1's incremental refresh of rc_idx with recovery on and off, in
    turns (on, off), each over a batch of its own."""
    rc, kernels = ctx["rc"], ctx["kernels"]
    sess, hs = rc.of("rc_idx")
    secs = {True: [], False: []}
    for i in range(2):
        on = i % 2 == 0
        lc_batch(os.path.join(ctx["rc_src"], f"rc_rf1_{i}.parquet"), ctx["next_key"], RF1_ORDERS,
                 SEED + 50 + i)
        ctx["next_key"] += RF1_ORDERS
        sess.conf.set("hyperspace.recovery.enabled", on)
        s, _launches, err = rc_timed(kernels, f"overhead refresh, recovery {on}",
                                     lambda: hs.refresh_index("rc_idx", "incremental"))
        if err is not None:
            raise err
        secs[on].append(s)
    sess.conf.set("hyperspace.recovery.enabled", True)
    kernels.settle()
    out = {"on_s": secs[True], "off_s": secs[False],
           "median_on_s": float(np.median(secs[True])), "median_off_s": float(np.median(secs[False]))}
    log(f"recovery path [{card}]: RF1's refresh of rc_idx, recovery on {secs[True]} s, off "
        f"{secs[False]} s (in turns); medians {out['median_on_s']:.3f} / {out['median_off_s']:.3f}")
    return out


def recovery_path(work: str, ctx: dict, kernels: KernelCalls, card: str) -> dict:
    """Phase 13: crash recovery. Over a copy of the first RC_FILES of phase
    4's 8 lineitem files (a depth cut, for the script's time), lineage on, the lease at RC_LEASE_MS and the orphan
    grace 0: rc_idx (li_idx's config), rc_z (z_idx's) and rc_ds (ds_idx's,
    a system path of its own), and beside them a crash-free run (``ref``) of
    every action in system paths of their own. In-process crash cells
    (``rc_cell``): rc_idx's create at after_begin_log, mid_data_write
    (at=101: 100 of its 200 bucket files landed), after_data_write,
    mid_sidecar_publish and after_end_log; a real death (``rc_child_death``);
    an incremental refresh of a day's file at mid_data_write (at=101);
    optimize full at mid_data_write (at=101); RF2's rewrite (source file 0
    deleted) at after_data_write; a vacuum of the outdated versions at
    mid_vacuum_delete (at=2); rc_z's create at mid_data_write; rc_ds's at
    after_data_write. Then a live writer (``rc_live_writer``), the cost of
    ``ensure_recovered`` on a clean tip, and recovery's overhead on RF1's
    refresh (``rc_overhead``). Every B1, B6, B7 and B5f call is recorded in
    ``kernels`` and held to its plain version after each action. Launch
    counts read from 0 at its start."""
    import shutil as _shutil

    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.metadata import recovery

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    t_phase = time.perf_counter()
    src = os.path.join(work, "rc_lineitem")
    os.makedirs(src)
    for i in range(RC_FILES):
        _shutil.copy(os.path.join(ctx["src"], f"part{i}.parquet"), src)
    # system paths of one depth, so the entries' directory names normalize
    # alike; each rc_idx create cell takes a fresh rc side (``fresh``)
    ref = RcSide(None, os.path.join(work, "rc_refm"), os.path.join(work, "rc_refd"))
    clock = RcClock()
    c = {"ref": ref, "kernels": kernels, "clock": clock, "rc_src": src,
         "queries": RcQueries(None, src, kernels), "next_key": N_ORDERS + 1_000_000}
    ops.reset_launch_counts()
    cells = []
    ref_s, _l, err = rc_timed(kernels, "rc_idx create, crash-free",
                              lambda: rc_run(ref, "rc_idx", "create_index", src))
    if err is not None:
        raise err

    def fresh(k: int) -> None:
        """rc_idx's next create cell in a system path of its own: a hard
        vacuum would leave the earlier versions' file names in the log's
        stable entries, which the orphan GC reads as referenced
        (ROADMAP C.12)."""
        c["rc"] = c["queries"].rc = RcSide(None, os.path.join(work, f"rc_c{k}"),
                                           os.path.join(work, "rc_dsys"))

    for k, (point, spec) in enumerate((("after_begin_log", "raise"),
                                       ("mid_data_write", "raise;at=101"),
                                       ("after_data_write", "raise"),
                                       ("mid_sidecar_publish", "raise"),
                                       ("after_end_log", "raise"))):
        fresh(k)
        cells.append(rc_cell(card, c, "rc_idx", f"rc_idx create at {point}", point, spec,
                             "create_index", src, ref_op=False))
    fresh(len(cells))
    child = rc_child_death(card, c)
    rc = c["rc"]
    # a day's file, refreshed incrementally: two files a bucket after it
    lc_batch(os.path.join(src, "rc_day.parquet"), N_ORDERS, FILE_ROWS // 4, SEED + 31,
             rows=DAY_ROWS)
    c["queries"].state = "day"
    cells.append(rc_cell(card, c, "rc_idx", "rc_idx refresh incremental (a day's file) at "
                         "mid_data_write", "mid_data_write", "raise;at=101",
                         "refresh_index", "incremental"))
    cells.append(rc_cell(card, c, "rc_idx", "rc_idx optimize full at mid_data_write",
                         "mid_data_write", "raise;at=101", "optimize_index", "full"))
    os.remove(os.path.join(src, "part0.parquet"))
    c["queries"].state = "rf2"
    cells.append(rc_cell(card, c, "rc_idx", "rc_idx refresh incremental (RF2, file 0 deleted) "
                         "at after_data_write", "after_data_write", "raise",
                         "refresh_index", "incremental"))
    versions = lc_versions(rc, "rc_idx")
    cells.append(rc_cell(card, c, "rc_idx", "rc_idx vacuum outdated at mid_vacuum_delete",
                         "mid_vacuum_delete", "raise;at=2", "vacuum_index"))
    log(f"recovery path [{card}]: rc_idx versions before the vacuum {versions}, after "
        f"{lc_versions(rc, 'rc_idx')}")
    cells.append(rc_cell(card, c, "rc_z", "rc_z create at mid_data_write", "mid_data_write",
                         "raise", "create_index", src))
    cells.append(rc_cell(card, c, "rc_ds", "rc_ds create at after_data_write",
                         "after_data_write", "raise", "create_index", src))
    live = rc_live_writer(card, c)
    clean_log = rc.main.index_manager._managers("rc_idx")[0]
    clean_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        recovery.ensure_recovered(clean_log, RC_LEASE_MS)
        clean_ms.append((time.perf_counter() - t0) * 1e3)
    overhead = rc_overhead(card, c)
    launches = ops.launch_counts()
    held = kernels.summary("phase 13")
    for k in ("b1", "b6", "b7", "b5f"):
        if not held.get(k):
            raise AssertionError(f"phase 13 held no {k} call")
    gaps = clock.gaps()
    secs = time.perf_counter() - t_phase
    log(f"recovery path [{card}]: ensure_recovered on a clean tip p50 "
        f"{float(np.median(clean_ms)):.3f} ms (20 calls); every heartbeat of the phase: "
        f"{gaps['heartbeats']} heartbeats, {gaps['renewals']} renewals, longest gap "
        f"{gaps['longest_gap_ms']:.1f} ms; crash-free rc_idx create {ref_s:.3f}s; launches "
        f"{launches}; {secs:.1f}s in all")
    return {"launches": launches, "cells": cells, "child": child, "live_writer": live,
            "clean_tip_ensure_recovered_ms": float(np.median(clean_ms)), "overhead": overhead,
            "heartbeats": gaps, "held": held, "crash_free_create_s": ref_s,
            "seconds": secs}



# ---------------------------------------------------------------------------
# Phase 14: Hybrid Scan, the quick refresh's serve and the approximate plane
# ---------------------------------------------------------------------------

#: bench.py's hybrid file (bench.py:939-955): n_items // 32 appended rows
HY_EXTRA = N_ROWS // 32
HYBRID = "hyperspace.index.hybridscan.enabled"


def hy_append(path: str) -> int:
    """bench.py's hybrid file, as one parquet file: random order keys over
    the orders, one ship date, l_quantity 7, l_extendedprice 1.0."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = HY_EXTRA
    pq.write_table(pa.table({
        "l_orderkey": np.random.default_rng(9).integers(0, N_ORDERS, n),
        "l_shipdate": pa.array(np.full(n, np.datetime64("1998-01-01"))),
        "l_quantity": np.full(n, 7, dtype=np.int64),
        "l_extendedprice": np.full(n, 1.0),
    }), path)
    return n


def hy_filters(df):
    """Phase 4's 32 point and 4 IN-list filters."""
    point_keys, in_lists = phase4_keys()
    key = df["l_orderkey"]
    cols = ("l_orderkey", "l_shipdate", "l_quantity")
    return ([df.filter(key == k).select(*cols) for k in point_keys]
            + [df.filter(key.isin(keys)).select(*cols) for keys in in_lists])


def hy_shape(sess, df) -> dict:
    """What the rewrite made of ``df``'s plan: its Unions, its scans of
    appended files (``hybridDelta``), its index scans with a lineage NOT-IN
    (``excluded_file_ids``) and the indexes it reads."""
    from hyperspace_tpu_torch.plan.nodes import Scan, Union

    sess.enable_hyperspace()
    try:
        plan = sess.optimize(df.logical_plan)
    finally:
        sess.disable_hyperspace()
    out = {"unions": 0, "delta_scans": 0, "excluded": 0, "indexes": set()}

    def walk(node):
        if isinstance(node, Union):
            out["unions"] += 1
        if isinstance(node, Scan):
            rel = node.relation
            out["delta_scans"] += ("hybridDelta", "1") in rel.options
            out["excluded"] += bool(rel.excluded_file_ids)
            if rel.index_info:
                out["indexes"].add(rel.index_info[0])
        for child in node.children:
            walk(child)

    walk(plan)
    return out


def hy_expect(shape: dict, want: dict, indexes, label: str) -> None:
    got = {"unions": shape["unions"], "delta_scans": shape["delta_scans"],
           "excluded": shape["excluded"]}
    if got != want or shape["indexes"] != set(indexes):
        raise AssertionError(f"{label}: plan {shape}, expected {want} over {set(indexes)}")


def explain_with_indexes(hs, df) -> str:
    """The "Plan with indexes" part of ``hs.explain(df)``, Hyperspace on."""
    sess = hs.session
    sess.enable_hyperspace()
    try:
        return hs.explain(df).split("Plan without indexes:")[0]
    finally:
        sess.disable_hyperspace()


#: phase 15's depth (PERF.md section 4): its Union state, its time travel
#: and the read after the vacuum run 8 point filters and the 4 IN-lists
HY_SHORT = tuple(range(8)) + tuple(range(32, 36))
#: phase 14's depth: a filter over the Union reads every index file's
#: matching row groups and the appended file (about 0.4-0.7 s on the card,
#: as long in the cpu session), and one no index serves reads the source,
#: so each such state runs 4 point filters and 2 IN-lists
HY_LEAN = tuple(range(4)) + tuple(range(32, 34))


def hy_filter_set(c: dict, step: str, want: dict, indexes=("hs_idx",), run=None, read=None,
                  log_version=None, in_order: bool = False, pruned: bool = False) -> dict:
    """Phase 4's filters (``run``: the indices of those to run, all by
    default) over ``read(session)`` (phase 14's source by default) in one
    source state (``c["state"]``): each plan's shape as ``want`` (Unions,
    delta scans, NOT-INs) over ``indexes``, its explain naming
    ``log_version`` when given; one warm-up, one timed run a query on the
    card (with ``pruned``, every one bucket-pruned); rows equal to the plan
    without Hyperspace (computed once a source state; the point filters in
    order with ``in_order``, else as a multiset) and in order to the cpu
    session's, which serves the same plans over the same system path."""
    cs, ps, hs = c["card_s"], c["cpu_s"], c["card_hs"]
    read = read or (lambda s: s.read.parquet(c["src"]))
    plans, cpu_plans = hy_filters(read(cs)), hy_filters(read(ps))
    run = list(range(len(plans)) if run is None else run)
    where = f"{c['path']} {step}"
    t_set = time.perf_counter()
    for i in run:
        hy_expect(hy_shape(cs, plans[i]), want, indexes, f"{where} filter {i}")
        if log_version is not None:
            text = explain_with_indexes(hs, plans[i])
            if f"LogVersion: {log_version})" not in text:
                raise AssertionError(f"{where} filter {i}: LogVersion {log_version} not "
                                     f"served:\n{text}")
    c["kernels"].label = f"{where} filters"
    cs.enable_hyperspace()
    try:
        plans[run[0]].collect()  # warm-up
        cs.exec_stats.reset()
        times, got = [], {}
        for i in run:
            t0 = time.perf_counter()
            got[i] = plans[i].collect()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        cs.disable_hyperspace()
        c["kernels"].label = None
    stats = cs.exec_stats.as_dict()
    if pruned and stats["bucket_pruned_scans"] != len(run):
        raise AssertionError(f"{where}: {stats['bucket_pruned_scans']} of {len(run)} filters "
                             f"bucket-pruned")
    ps.enable_hyperspace()
    try:
        for i in run:
            if not got[i].equals(cpu_plans[i].collect()):
                raise AssertionError(f"{where} filter {i}: rows differ from the cpu session's")
    finally:
        ps.disable_hyperspace()
    rows = 0
    for i in run:
        key = (c["state"], i)
        if key not in c["unindexed"]:
            c["unindexed"][key] = plans[i].collect()
        want_rows = c["unindexed"][key]
        if in_order and i < 32:
            same = got[i].equals(want_rows)
        else:
            same = sorted_rows(got[i]).equals(sorted_rows(want_rows))
        if not same:
            raise AssertionError(f"{where} filter {i}: rows differ from the plan without "
                                 f"Hyperspace")
        rows += got[i].num_rows
    c["kernels"].settle()
    p50, p99 = np.percentile(times, [50, 99])
    out = {"p50_ms": float(p50), "p99_ms": float(p99), "queries": len(run), "rows": rows,
           "shape": want, "indexes": sorted(indexes), "log_version": log_version,
           "bucket_pruned": stats["bucket_pruned_scans"],
           "fused_range_masks": stats["fused_range_masks"],
           "seconds": time.perf_counter() - t_set}
    log(f"{c['path']} path [{c['card']}]: {step}: {len(run)} filters p50_ms {p50:.3f} p99_ms "
        f"{p99:.3f} (phase 4 on the exact index: {c['p4_p50']:.3f} / {c['p4_p99']:.3f}), "
        f"{rows} rows; plans {want} over {sorted(indexes)}"
        + (f" at LogVersion {log_version}" if log_version is not None else "")
        + f"; bucket-pruned {stats['bucket_pruned_scans']}, B3a masks "
        f"{stats['fused_range_masks']}; equal to the plan without Hyperspace"
        + (" (point filters in order)" if in_order else "")
        + f" and in order to the cpu session's; {out['seconds']:.1f}s with the checks")
    return out


#: phase 14's join rounds a state (PERF.md section 4), each a run of both
#: routes
HY_JOIN_ROUNDS = 2


def hy_join(c: dict, step: str, want: dict) -> dict:
    """Phase 5's ``orders ⋈ lineitem`` in one source state: both sides
    index-served, the lineitem side's plan as ``want``; one warm-up, then
    2 interleaved rounds of the sequential and pipelined routes (rows equal
    in order across all runs), each run's ``join_stats``; rows equal as a
    multiset to the unindexed plan and in order to the cpu session's."""
    cs, ps, hs = c["card_s"], c["cpu_s"], c["card_hs"]
    pipe = "hyperspace.serve.pipeline.enabled"

    def q(sess):
        orders, items = sess.read.parquet(c["osrc"]), sess.read.parquet(c["src"])
        return orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
            "o_orderkey", "o_custkey", "l_quantity")

    index_served(hs, q(cs), ("ho_idx", "hs_idx"))
    hy_expect(hy_shape(cs, q(cs)), want, ("ho_idx", "hs_idx"), f"{step} join")
    times, stages, got = {True: [], False: []}, {True: [], False: []}, None
    c["kernels"].label = f"hybrid {step} join"
    cs.enable_hyperspace()
    cs.exec_stats.reset()
    try:
        q(cs).collect()  # warm-up, the default (sequential) route
        for rnd in range(HY_JOIN_ROUNDS):
            for on in ((True, False) if rnd % 2 == 0 else (False, True)):
                cs.conf.set(pipe, on)
                t0 = time.perf_counter()
                out = q(cs).collect()
                times[on].append((time.perf_counter() - t0) * 1e3)
                stages[on].append(dict(cs.join_stats))
                if got is None:
                    got = out
                elif not out.equals(got):
                    raise AssertionError(f"{step}: join rows differ in order with {pipe}={on}")
    finally:
        cs.conf.set(pipe, False)
        cs.disable_hyperspace()
        c["kernels"].label = None
    if cs.exec_stats.co_bucketed_joins != 1 + 2 * HY_JOIN_ROUNDS:
        raise AssertionError(f"{step}: the join did not run co-bucketed: "
                             f"{cs.exec_stats.as_dict()}")
    ps.enable_hyperspace()
    if not got.equals(q(ps).collect()):
        raise AssertionError(f"{step}: join rows differ from the cpu session's")
    ps.disable_hyperspace()
    t0 = time.perf_counter()
    want_rows = q(cs).collect()
    unindexed_ms = (time.perf_counter() - t0) * 1e3
    if not sorted_rows(got).equals(sorted_rows(want_rows)):
        raise AssertionError(f"{step}: join rows differ from the unindexed plan")
    c["kernels"].settle()
    out = {"rows": got.num_rows, "unindexed_ms": unindexed_ms}
    for on, route in ((False, "sequential"), (True, "pipelined")):
        p50, p99 = np.percentile(times[on], [50, 99])
        stage_p50 = {k: float(np.median([st.get(k, 0.0) for st in stages[on]]))
                     for k in stages[on][0]}
        out[route] = {"p50_ms": float(p50), "p99_ms": float(p99), "stages_s": stage_p50}
        log(f"hybrid path [{c['card']}]: {step}: join, {route} x{HY_JOIN_ROUNDS} (interleaved) p50_ms "
            f"{p50:.3f} p99_ms {p99:.3f} (phase 5 on the exact indexes: "
            f"{c['p5'][route]:.3f}), {got.num_rows} rows, stage p50 s "
            f"{ {k: round(v, 4) for k, v in stage_p50.items()} }")
    fallback = (" (under delete compensation the pipelined route runs the sequential one, "
                "as in the reference)" if want["excluded"] else "")
    log(f"hybrid path [{c['card']}]: {step}: join rows equal across routes, to the unindexed "
        f"plan ({unindexed_ms:.1f} ms) and in order to the cpu session's{fallback}")
    return out


def hy_approx(c: dict, work: str) -> dict:
    """Step 5, the approximate plane: ha_idx with li_rg_idx's layout (8
    buckets, about 12 row groups a file, 128 sample rows a row group) and
    l_extendedprice included, over the source as step 4 left it. An
    ungrouped COUNT and SUM(l_extendedprice) over a 10 % l_orderkey window
    and the same grouped by l_quantity, each at the first budget of a
    ladder at which it answers, equal bit for bit between the card and
    the cpu session; the ungrouped one at max_rel_error 0.001 and over a
    hybrid state raises ApproximationError on both. collect_approx p50
    beside the exact collect() p50 (5 runs each); the share of groups
    whose interval holds the exact answer."""
    from hyperspace_tpu_torch import CoveringIndexConfig
    from hyperspace_tpu_torch import functions as F
    from hyperspace_tpu_torch.exceptions import ApproximationError
    from torch_b5_cases import same_rows

    cs, ps, hs = c["card_s"], c["cpu_s"], c["card_hs"]
    cs.conf.set("hyperspace.index.num_buckets", 8)
    t0 = time.perf_counter()
    c["kernels"].label = "hybrid create ha_idx"
    try:
        hs.create_index(cs.read.parquet(c["src"]), CoveringIndexConfig(
            "ha_idx", ["l_orderkey"], ["l_quantity", "l_extendedprice"]))
    finally:
        c["kernels"].label = None
        cs.conf.set("hyperspace.index.num_buckets", N_BUCKETS)
    create_s = time.perf_counter() - t0
    c["kernels"].settle()
    ps.index_manager.clear_cache()
    a = int(np.random.default_rng(SEED + 60).integers(0, N_ORDERS - N_ORDERS // 10))
    w = N_ORDERS // 10

    def window(df):
        k = df["l_orderkey"]
        return df.filter((k >= a) & (k < a + w))

    queries = {
        "ungrouped": lambda df: window(df).agg(
            F.count().alias("n"), F.sum("l_extendedprice").alias("s")),
        "by l_quantity": lambda df: window(df).group_by("l_quantity").agg(
            F.count().alias("n"), F.sum("l_extendedprice").alias("s")),
    }
    ladder = (None, 0.2, 1.0, 1e9)
    for sess in (cs, ps):
        sess.conf.set("hyperspace.serve.approx.enabled", True)
        sess.enable_hyperspace()
    out = {"create_s": create_s}
    try:
        for label, q in queries.items():
            tables, budget = {}, None
            for b in ladder:
                try:
                    tables["card"] = q(cs.read.parquet(c["src"])).collect_approx(b)
                except ApproximationError:
                    continue
                budget = b
                break
            if budget is None and "card" not in tables:
                raise AssertionError(f"approx {label}: no budget of {ladder} answered")
            tables["cpu"] = q(ps.read.parquet(c["src"])).collect_approx(budget)
            if not same_rows(tables["card"], tables["cpu"]):
                raise AssertionError(f"approx {label}: the card's table differs from the cpu's")
            approx_ms, exact_ms = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                q(cs.read.parquet(c["src"])).collect_approx(budget)
                approx_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                exact = q(cs.read.parquet(c["src"])).collect()
                exact_ms.append((time.perf_counter() - t0) * 1e3)
            est = tables["card"].to_pydict()
            truth = exact.to_pydict()
            if label == "ungrouped":
                pairs = [(0, 0)]
            else:
                pos = {v: i for i, v in enumerate(truth["l_quantity"])}
                pairs = [(i, pos[v]) for i, v in enumerate(est["l_quantity"]) if v in pos]
            held = {m: sum(est[m + "_lo"][i] <= truth[m][j] <= est[m + "_hi"][i]
                           for i, j in pairs) / max(len(pairs), 1) for m in ("n", "s")}
            out[label] = {"budget": budget, "groups": len(pairs),
                          "approx_p50_ms": float(np.median(approx_ms)),
                          "exact_p50_ms": float(np.median(exact_ms)), "held": held}
            log(f"hybrid path [{c['card']}]: approx {label}: answered at max_rel_error "
                f"{budget} ({len(pairs)} groups), equal bit for bit to the cpu session's; "
                f"collect_approx p50_ms {out[label]['approx_p50_ms']:.3f} against exact "
                f"collect() {out[label]['exact_p50_ms']:.3f}; intervals holding the exact "
                f"answer: COUNT {held['n']:.1%}, SUM {held['s']:.1%}")
        raised = {}
        for side, sess in (("card", cs), ("cpu", ps)):
            try:
                queries["ungrouped"](sess.read.parquet(c["src"])).collect_approx(0.001)
            except ApproximationError:
                raised[side] = True
        extra = os.path.join(c["src"], "hy_approx_batch.parquet")
        lc_batch(extra, N_ORDERS + 5_000_000, RF1_ORDERS, SEED + 61)
        for sess in (cs, ps):
            sess.conf.set(HYBRID, True)
            sess.index_manager.clear_cache()
        for side, sess in (("card", cs), ("cpu", ps)):
            try:
                queries["ungrouped"](sess.read.parquet(c["src"])).collect_approx(1e9)
            except ApproximationError:
                raised[side + " hybrid"] = True
        os.remove(extra)
    finally:
        for sess in (cs, ps):
            sess.conf.set("hyperspace.serve.approx.enabled", False)
            sess.conf.set(HYBRID, False)
            sess.disable_hyperspace()
    if len(raised) != 4:
        raise AssertionError(f"approx: ApproximationError expected on both sessions at 0.001 "
                             f"and over the hybrid state, raised {raised}")
    out["raised"] = sorted(raised)
    log(f"hybrid path [{c['card']}]: approx: ha_idx created in {create_s:.3f}s; "
        f"ApproximationError at max_rel_error 0.001 and over a hybrid state on both sessions")
    return out


def hybrid_path(work: str, ctx: dict, kernels: KernelCalls, card: str) -> dict:
    """Phase 14: Hybrid Scan at SF1 (module docstring, item 14). Launch
    counts read from 0 at its start."""
    import shutil as _shutil

    import torch

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch.rules import candidate, tags

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    t_phase = time.perf_counter()
    src, osrc = os.path.join(work, "hy_lineitem"), os.path.join(work, "hy_orders")
    _shutil.copytree(ctx["src"], src)
    _shutil.copytree(ctx["orders_src"], osrc)
    sys_path = os.path.join(work, "hy_indexes")
    card_s, cpu_s = HyperspaceSession(), HyperspaceSession(device="cpu")
    for s in (card_s, cpu_s):  # one index lake, served by both sessions
        s.conf.set("hyperspace.system.path", sys_path)
        s.conf.set("hyperspace.index.lineage.enabled", True)
        s.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    card_hs = Hyperspace(card_s)
    c = {"card_s": card_s, "cpu_s": cpu_s, "card_hs": card_hs, "src": src, "osrc": osrc,
         "kernels": kernels, "card": card, "p4_p50": ctx["p50_ms"], "p4_p99": ctx["p99_ms"],
         "p5": ctx["join_p50_ms"], "state": "append", "unindexed": {}, "path": "hybrid"}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kernels.label = "hybrid create hs_idx"
    card_hs.create_index(card_s.read.parquet(src), CoveringIndexConfig(
        "hs_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"]))
    kernels.label = "hybrid create ho_idx"
    card_hs.create_index(card_s.read.parquet(osrc), CoveringIndexConfig(
        "ho_idx", ["o_orderkey"], ["o_custkey", "o_totalprice"]))
    kernels.label = None
    torch.cuda.synchronize()
    kernels.settle()
    out = {"create_s": time.perf_counter() - t0, "steps": {}}
    log(f"hybrid path [{card}]: hs_idx and ho_idx created in {out['create_s']:.3f}s")

    def step(name, *, filters=None, join=None, indexes=("hs_idx",), run=None):
        res = {}
        if filters is not None:
            res["filters"] = hy_filter_set(c, name, filters, indexes, run)
        if join is not None:
            res["join"] = hy_join(c, name, join)
        out["steps"][name] = res

    # (1) bench.py's hybrid file appended, Hybrid Scan on
    n_extra = hy_append(os.path.join(src, "appended.parquet"))
    for s in (card_s, cpu_s):
        s.conf.set(HYBRID, True)
    log(f"hybrid path [{card}]: step 1: appended {n_extra} rows in one file")
    union = {"unions": 1, "delta_scans": 1, "excluded": 0}
    step("append", filters=union, join=union, run=HY_LEAN)
    # (2) source file 0 deleted: the lineage NOT-IN joins the Union
    os.remove(os.path.join(src, "part0.parquet"))
    c["state"] = "append and delete"
    log(f"hybrid path [{card}]: step 2: deleted source file part0.parquet")
    both = {"unions": 1, "delta_scans": 1, "excluded": 1}
    step("append and delete", filters=both, join=both, run=HY_LEAN)
    # (3) appends past the 0.3 appended ratio: the index is refused
    copies = []
    for i in range(1, 5):
        copies.append(os.path.join(src, f"big{i}.parquet"))
        _shutil.copyfile(os.path.join(src, f"part{i}.parquet"), copies[-1])
    entry = card_s.index_manager.get_index_log_entry("hs_idx")
    entry.set_tag(None, tags.INDEX_PLAN_ANALYSIS_ENABLED, True)
    scan = card_s.read.parquet(src).logical_plan.collect_leaves()[0]
    kept = candidate.file_signature_filter(card_s, scan, [entry])
    reasons = [(r.code, dict(r.args)) for r in entry.get_tag(scan, tags.FILTER_REASONS) or []]
    if kept or [code for code, _a in reasons] != ["TOO_MUCH_APPENDED"]:
        raise AssertionError(f"too much appended: kept {kept}, reasons {reasons}")
    entry.set_tag(None, tags.INDEX_PLAN_ANALYSIS_ENABLED, None)
    log(f"hybrid path [{card}]: step 3: 4 more files appended; hs_idx refused: {reasons}")
    c["state"] = "too much appended"
    step("too much appended", filters={"unions": 0, "delta_scans": 0, "excluded": 0},
         indexes=(), run=HY_LEAN)
    for f in copies:
        os.remove(f)
    c["state"] = "append and delete"
    # (4) Hybrid Scan off; a quick refresh serves in exact mode through the
    # recorded delta; an incremental refresh indexes it
    for s in (card_s, cpu_s):
        s.conf.set(HYBRID, False)
    refresh = {}
    for mode, want in (("quick", both), ("incremental", {"unions": 0, "delta_scans": 0,
                                                         "excluded": 0})):
        kernels.label = f"hybrid refresh {mode} hs_idx"
        card_s.build_stats.clear()
        t0 = time.perf_counter()
        card_hs.refresh_index("hs_idx", mode)
        torch.cuda.synchronize()
        kernels.label = None
        refresh[mode] = {"seconds": time.perf_counter() - t0,
                         "stages": dict(card_s.build_stats)}
        kernels.settle()
        cpu_s.index_manager.clear_cache()
        log(f"hybrid path [{card}]: step 4: refresh {mode} of hs_idx in "
            f"{refresh[mode]['seconds']:.3f}s, stages "
            f"{ {k: round(v, 4) for k, v in refresh[mode]['stages'].items()} }")
        step(f"after the {mode} refresh", filters=want,
             run=HY_LEAN if mode == "quick" else None)
    out["refresh"] = refresh
    # (5) the approximate plane
    out["approx"] = hy_approx(c, work)
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    held = kernels.summary("phase 14", (("b1", "hybrid append join"),
                                        ("b1", "hybrid append and delete join"),
                                        ("b1", "hybrid refresh incremental hs_idx")))
    out["held"] = held
    out["seconds"] = time.perf_counter() - t_phase
    log(f"hybrid path [{card}]: all steps ran; launches {out['launches']}; "
        f"{out['seconds']:.1f}s in all")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the lake sources (Delta Lake with time travel, Iceberg, the
# plain formats) with B1, B3a, B5f, B6 and B7 over them
# ---------------------------------------------------------------------------

#: phase 15's cut of file 1 for json lines, avro and text (PERF.md section 4):
#: the avro codec is pure Python, and the script's time is bounded
LK_CUT = 100_000
#: the plain formats of phase 15, and whether each takes file 1 whole
LK_FORMATS = (("csv", True), ("orc", True), ("json", False), ("avro", False),
              ("text", False))


def lk_median_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def lk_create(c: dict, label: str, df, config, rows: int) -> dict:
    """One create on the card, its seconds, rows/s and stages; its kernel
    calls held against their plain versions."""
    import torch

    cs, hs = c["card_s"], c["card_hs"]
    cs.build_stats.clear()
    c["kernels"].label = f"lake create {label}"
    t0 = time.perf_counter()
    try:
        hs.create_index(df, config)
        torch.cuda.synchronize()
    finally:
        c["kernels"].label = None
    seconds = time.perf_counter() - t0
    c["kernels"].settle()
    c["cpu_s"].index_manager.clear_cache()
    stages = {k: v for k, v in cs.build_stats.items() if isinstance(v, float)}
    out = {"seconds": seconds, "rows": rows, "rows_per_s": rows / seconds, "stages_s": stages}
    log(f"lake path [{c['card']}]: created {label} over {rows} rows in {seconds:.3f}s "
        f"({rows / seconds:,.0f} rows/s), stages { {k: round(v, 4) for k, v in stages.items()} }")
    return out


def lk_bucket_files(index_dir: str) -> dict:
    """Bucket file name -> sha256 of a version dir's bucket files."""
    return {f: file_sha(os.path.join(index_dir, f)) for f in sorted(os.listdir(index_dir))
            if "-bucket_" in f and f.endswith(".parquet")}


def lk_formats(c: dict, lake: str, part1: str) -> dict:
    """Step 6: file 1 of the table as csv and orc, its first ``LK_CUT``
    rows as json lines, avro (the port's writer) and text (l_orderkey a
    line); for each a covering index and 4 point filters on keys of the
    cut, served bucket-pruned, equal to the plan without Hyperspace and to
    the same rows read from the parquet file (dates compared as dates)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch_lake as L

    from hyperspace_tpu_torch import CoveringIndexConfig

    cs, hs = c["card_s"], c["card_hs"]
    whole = pq.read_table(part1)
    cut = whole.slice(0, LK_CUT)
    keys = [int(cut.column("l_orderkey")[i].as_py()) for i in (0, LK_CUT // 3,
                                                                 2 * LK_CUT // 3, LK_CUT - 1)]
    cols = ("l_orderkey", "l_shipdate", "l_quantity")
    out = {}
    for fmt, full in LK_FORMATS:
        d = os.path.join(lake, "formats", fmt)
        os.makedirs(d)
        src = whole if full else cut
        t0 = time.perf_counter()
        if fmt == "text":
            L.write_text_lines([str(k) for k in src.column("l_orderkey").to_pylist()],
                               os.path.join(d, "part1.txt"))
        else:
            {"csv": L.write_csv, "orc": L.write_orc, "json": L.write_json_lines,
             "avro": L.write_avro_table}[fmt](src, os.path.join(d, f"part1.{fmt}"))
        write_s = time.perf_counter() - t0
        name = f"{fmt}_idx"
        df = getattr(cs.read, fmt)(d)
        config = (CoveringIndexConfig(name, ["value"], []) if fmt == "text" else
                  CoveringIndexConfig(name, ["l_orderkey"], ["l_shipdate", "l_quantity"]))
        rec = {"rows": src.num_rows, "write_s": write_s,
               "create": lk_create(c, name, df, config, src.num_rows)}
        times, n = [], 0
        for k in keys:
            if fmt == "text":
                q = df.filter(df["value"] == str(k))
            else:
                q = df.filter(df["l_orderkey"] == k).select(*cols)
            text = explain_with_indexes(hs, q)
            if f"Name: {name}," not in text:
                raise AssertionError(f"lake {fmt}: {name} not used:\n{text}")
            c["kernels"].label = f"lake {fmt} filters"
            cs.enable_hyperspace()
            cs.exec_stats.reset()
            try:
                t0 = time.perf_counter()
                got = q.collect()
                times.append((time.perf_counter() - t0) * 1e3)
            finally:
                cs.disable_hyperspace()
                c["kernels"].label = None
            if cs.exec_stats.bucket_pruned_scans != 1:
                raise AssertionError(f"lake {fmt}: the filter on {k} was not bucket-pruned")
            unindexed = q.collect()
            if got.schema != unindexed.schema:
                # json's timestamp[s] comes back from the index's parquet
                # as timestamp[ms], in both packages (ROADMAP C.16)
                rec["served_types"] = [f"{f.name}:{f.type}" for f in got.schema]
                got = got.cast(unindexed.schema)
            if not got.equals(unindexed):
                raise AssertionError(f"lake {fmt}: rows on {k} differ from the plan without "
                                     f"Hyperspace")
            want = src.filter(pc.equal(src.column("l_orderkey"), k))
            if fmt == "text":
                same = got.column("value").to_pylist() == [str(k)] * want.num_rows
            else:
                same = (got.column("l_orderkey").equals(want.column("l_orderkey"))
                        and got.column("l_quantity").equals(want.column("l_quantity"))
                        and got.column("l_shipdate").cast(pa.date32()).equals(
                            want.column("l_shipdate")))
            if not same or want.num_rows == 0:
                raise AssertionError(f"lake {fmt}: rows on {k} differ from the parquet file's")
            n += got.num_rows
        c["kernels"].settle()
        rec.update(p50_ms=float(np.median(times)), p99_ms=float(np.percentile(times, 99)),
                   rows_served=n, schema=[f"{f.name}:{f.type}" for f in
                                          pa.schema(list(df.logical_plan.collect_leaves()[0]
                                                         .relation.schema_fields))])
        out[fmt] = rec
        log(f"lake path [{c['card']}]: {fmt}: {src.num_rows} rows written in {write_s:.3f}s; "
            f"4 point filters over {name} p50_ms {rec['p50_ms']:.3f} p99_ms {rec['p99_ms']:.3f}, "
            f"{n} rows, each bucket-pruned and equal to the plan without Hyperspace and to the "
            f"parquet file's rows; schema {rec['schema']}"
            + (f", served as {rec['served_types']}" if "served_types" in rec else ""))
    return out


def lake_path(work: str, ctx: dict, kernels: KernelCalls, card: str) -> dict:
    """Phase 15: the lake sources at SF1 (module docstring, item 15).
    Launch counts read from 0 at its start."""
    import pyarrow.parquet as pq
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_lake as L

    from hyperspace_tpu_torch import (
        CoveringIndexConfig,
        DataSkippingIndexConfig,
        Hyperspace,
        HyperspaceSession,
        ZOrderCoveringIndexConfig,
        ops,
    )
    from hyperspace_tpu_torch.indexes.sketches import BloomFilterSketch, MinMaxSketch
    from hyperspace_tpu_torch.sources import delta_log, iceberg_meta

    t_phase = time.perf_counter()
    lake = os.path.join(work, "lake")
    ld = os.path.join(lake, "ld")
    files = [L.link_or_copy(os.path.join(ctx["src"], f"part{i}.parquet"),
                            os.path.join(ld, f"part{i}.parquet")) for i in range(N_FILES)]
    schema = pq.read_schema(files[0])
    schema_string = L.delta_schema_string(schema)
    L.write_commit(ld, 0, L.delta_metadata(schema_string)
                   + [{"add": L.add_action(ld, f)} for f in files])
    snapshot_ms = {"delta v0, json": lk_median_ms(lambda: delta_log.read_snapshot(ld))}
    card_s, cpu_s = HyperspaceSession(), HyperspaceSession(device="cpu")
    for s in (card_s, cpu_s):  # one index lake, served by both sessions
        s.conf.set("hyperspace.system.path", os.path.join(work, "lake_indexes"))
        s.conf.set("hyperspace.index.lineage.enabled", True)
        s.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    card_hs = Hyperspace(card_s)
    c = {"card_s": card_s, "cpu_s": cpu_s, "card_hs": card_hs, "kernels": kernels,
         "card": card, "p4_p50": ctx["p50_ms"], "p4_p99": ctx["p99_ms"], "path": "lake",
         "state": "v0", "unindexed": {}}
    ops.reset_launch_counts()
    kernels.record_b3a(True)
    out = {"creates": {}, "filters": {}, "snapshot_ms": snapshot_ms}
    try:
        # (1) the Delta table ld and its covering index
        delta = lambda s, v=None: s.read.delta(ld, version_as_of=v)  # noqa: E731
        out["creates"]["ld_idx"] = lk_create(c, "ld_idx", delta(card_s), CoveringIndexConfig(
            "ld_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"]), N_ROWS)
        ld_dir = os.path.join(work, "lake_indexes", "ld_idx", "v__=1")
        hs_dir = os.path.join(work, "hy_indexes", "hs_idx", "v__=1")
        mine, theirs = lk_bucket_files(ld_dir), lk_bucket_files(hs_dir)
        if len(mine) != N_BUCKETS or mine != theirs:
            raise AssertionError(f"ld_idx's {len(mine)} bucket files differ from phase 14's "
                                 f"hs_idx ({len(theirs)})")
        out["bucket_files_equal_hs_idx"] = len(mine)
        log(f"lake path [{card}]: ld_idx's {len(mine)} bucket files equal phase 14's hs_idx "
            f"(li_idx's config with lineage, over the same 8 files in the same order) byte "
            f"for byte")
        exact = {"unions": 0, "delta_scans": 0, "excluded": 0}
        out["filters"]["v0"] = hy_filter_set(c, "v0", exact, ("ld_idx",), read=delta,
                                             log_version=2, in_order=True, pruned=True)
        # (2) commit 1 appends bench.py's hybrid file, commit 2 removes file 0;
        # a classic checkpoint at version 2
        appended = os.path.join(ld, "appended.parquet")
        n_extra = hy_append(appended)
        L.write_commit(ld, 1, [{"add": L.add_action(ld, appended)}])
        L.write_commit(ld, 2, [{"remove": L.remove_action(ld, files[0])}])
        snapshot_ms["delta v2, json"] = lk_median_ms(lambda: delta_log.read_snapshot(ld))
        L.write_checkpoint(ld, schema_string, version=2)
        snapshot_ms["delta v2, checkpoint"] = lk_median_ms(lambda: delta_log.read_snapshot(ld))
        snap = delta_log.read_snapshot(ld)
        if snap.version != 2 or len(snap.files) != N_FILES:
            raise AssertionError(f"version {snap.version} with {len(snap.files)} files")
        log(f"lake path [{card}]: commit 1 appended {n_extra} rows, commit 2 removed "
            f"part0.parquet, checkpoint at version 2; read_snapshot ms "
            f"{ {k: round(v, 3) for k, v in snapshot_ms.items()} }")
        for s in (card_s, cpu_s):
            s.conf.set(HYBRID, True)
            s.index_manager.clear_cache()
        both = {"unions": 1, "delta_scans": 1, "excluded": 1}
        c["state"] = "v2"
        out["filters"]["v2 hybrid"] = hy_filter_set(c, "v2 hybrid", both, ("ld_idx",),
                                                    HY_SHORT, delta)
        for s in (card_s, cpu_s):
            s.conf.set(HYBRID, False)
        card_s.build_stats.clear()
        kernels.label = "lake refresh incremental ld_idx"
        t0 = time.perf_counter()
        try:
            card_hs.refresh_index("ld_idx", "incremental")
            torch.cuda.synchronize()
        finally:
            kernels.label = None
        out["refresh"] = {"seconds": time.perf_counter() - t0,
                          "stages_s": {k: v for k, v in card_s.build_stats.items()
                                       if isinstance(v, float)}}
        kernels.settle()
        cpu_s.index_manager.clear_cache()
        history = card_s.index_manager.get_index_log_entry("ld_idx").derived_dataset.properties[
            "deltaVersions"]
        if history != "2:0,4:2":
            raise AssertionError(f"deltaVersions {history!r} after the refresh")
        log(f"lake path [{card}]: refresh incremental of ld_idx in "
            f"{out['refresh']['seconds']:.3f}s, stages "
            f"{ {k: round(v, 4) for k, v in out['refresh']['stages_s'].items()} }; "
            f"deltaVersions {history}")
        out["filters"]["v2 refreshed"] = hy_filter_set(c, "v2 refreshed", exact, ("ld_idx",),
                                                       read=delta, log_version=4, pruned=True)
        # (3) time travel
        travel = {"history": history}
        latest = hy_filters(delta(card_s))[0].logical_plan
        pinned = hy_filters(delta(card_s, 0))[0].logical_plan
        card_s.enable_hyperspace()
        try:
            travel["rewrite_ms"] = {"latest": lk_median_ms(lambda: card_s.optimize(latest)),
                                    "version_as_of 0": lk_median_ms(
                                        lambda: card_s.optimize(pinned))}
        finally:
            card_s.disable_hyperspace()
        c["state"] = "v0"
        out["filters"]["v0 travel"] = hy_filter_set(
            c, "v0 travel", exact, ("ld_idx",), HY_SHORT, lambda s: delta(s, 0), log_version=2,
            in_order=True, pruned=True)
        entry = card_s.index_manager.get_index_log_entry("ld_idx")
        rel = delta(card_s, 1).logical_plan.collect_leaves()[0].relation
        travel["v1 closest log"] = card_s.source_manager.get_relation(rel).closest_index(entry).id
        if travel["v1 closest log"] != 4:
            raise AssertionError(f"version 1: closest_index picked log {travel['v1 closest log']}")
        c["state"] = "v1"
        out["filters"]["v1 travel"] = hy_filter_set(c, "v1 travel", exact, (), HY_SHORT,
                                                    lambda s: delta(s, 1))
        kernels.label = "lake vacuum ld_idx"
        t0 = time.perf_counter()
        try:
            card_hs.vacuum_index("ld_idx")
        finally:
            kernels.label = None
        travel["vacuum_s"] = time.perf_counter() - t0
        for s in (card_s, cpu_s):
            s.index_manager.clear_cache()
        travel["history after vacuum"] = card_s.index_manager.get_index_log_entry(
            "ld_idx").derived_dataset.properties["deltaVersions"]
        if travel["history after vacuum"] != "4:2":
            raise AssertionError(f"deltaVersions {travel['history after vacuum']!r} after vacuum")
        c["state"] = "v0"
        out["filters"]["v0 after vacuum"] = hy_filter_set(c, "v0 after vacuum", exact, (),
                                                          HY_SHORT, lambda s: delta(s, 0))
        travel["v0 served after vacuum"] = False
        out["time_travel"] = travel
        log(f"lake path [{card}]: time travel: version 0 served by ld_idx's LogVersion 2; "
            f"version 1 ties (|delta| 1 to delta 0 and 2) and closest_index picks log "
            f"{travel['v1 closest log']}, whose signature is version 2's: the source serves; "
            f"vacuum in {travel['vacuum_s']:.3f}s resets deltaVersions to "
            f"{travel['history after vacuum']}, and version 0 is no longer index-served; "
            f"rewrite ms {travel['rewrite_ms']}")
        # (4) a z-order index over ld
        out["creates"]["ld_z"] = lk_create(c, "ld_z", delta(card_s), ZOrderCoveringIndexConfig(
            "ld_z", ["l_orderkey", "l_shipdate"], ["l_quantity"]), N_ROWS - N_ROWS // N_FILES
            + n_extra)
        out["zrange"] = lk_query_pair(c, "ld_z q_zrange", lambda s: zorder_queries(
            delta(s))["q_zrange"][0], "ld_z", "ZOCI")
        # (5) the Iceberg table li_ice over the same 8 files
        ice = os.path.join(lake, "li_ice")
        b = L.IcebergBuilder(ice, schema=L.iceberg_schema(schema))
        for i in range(N_FILES):
            b.add_existing(L.link_or_copy(files[i], os.path.join(ice, "data",
                                                                   f"part{i}.parquet")))
        b.commit()
        snapshot_ms["iceberg"] = lk_median_ms(lambda: iceberg_meta.read_snapshot(ice))
        counts = ops.launch_counts()
        builds0 = counts["bloom_bits.build_binned"]
        out["creates"]["ice_ds"] = lk_create(c, "ice_ds", card_s.read.iceberg(ice),
                                             DataSkippingIndexConfig(
            "ice_ds", MinMaxSketch("l_shipdate"),
            BloomFilterSketch("l_orderkey", DS_FPP, DS_EXPECTED)), N_ROWS)
        builds = ops.launch_counts()["bloom_bits.build_binned"] - builds0
        if builds != N_FILES:
            raise AssertionError(f"ice_ds made {builds} binned B7 builds")
        out["creates"]["ice_ds"]["b7_builds"] = builds
        ds = {}
        for label in ("d1", "d2", "d3"):
            ds[label] = lk_query_pair(c, f"ice_ds {label}", lambda s, label=label: ds_queries(
                s.read.iceberg(ice))[label], "ice_ds", "DS")
        out["iceberg"] = ds
        b.add_existing(L.link_or_copy(appended, os.path.join(ice, "data", "appended.parquet")))
        b.commit()
        for s in (card_s, cpu_s):
            s.index_manager.clear_cache()
        d1 = lambda s, sid=None: ds_queries(s.read.iceberg(ice, snapshot_id=sid))["d1"][0]  # noqa
        current = explain_with_indexes(card_hs, d1(card_s))
        pinned_text = explain_with_indexes(card_hs, d1(card_s, 1))
        if "Hyperspace" in current or "Type: DS, Name: ice_ds" not in pinned_text:
            raise AssertionError(f"snapshot 2 served {('Hyperspace' in current)}, snapshot 1 "
                                 f"not served:\n{pinned_text}")
        out["iceberg"]["pinned"] = lk_query_pair(c, "ice_ds d1 at snapshot 1",
                                                 lambda s: d1(s, 1), "ice_ds", "DS")
        log(f"lake path [{card}]: li_ice's second snapshot (one file appended) is not served, "
            f"the read pinned to snapshot 1 is")
        # (6) the other formats
        out["formats"] = lk_formats(c, lake, files[1])
    finally:
        kernels.record_b3a(False)
        kernels.label = None
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["held"] = kernels.summary("phase 15", (("b1", "lake create ld_idx"),
                                               ("b1", "lake v0 filters"),
                                               ("b3a", "lake v0 filters"),
                                               ("b6", "lake create ld_z"),
                                               ("b7", "lake create ice_ds")))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lake path [{card}]: all steps ran; launches {out['launches']}; "
        f"{out['seconds']:.1f}s in all")
    return out


def lk_query_pair(c: dict, label: str, build, index: str, kind: str) -> dict:
    """One query (or a list) over ``build(session)``: the explain names
    ``index`` (``Type: kind``); a warm-up, then 3 runs (a list: 1 a query)
    with Hyperspace on and off in turns; rows equal as a multiset to the plan without
    Hyperspace and in order to the cpu session's."""
    cs, ps, hs = c["card_s"], c["cpu_s"], c["card_hs"]
    plans = build(cs)
    cpu_plans = build(ps)
    if not isinstance(plans, list):
        plans, cpu_plans = [plans], [cpu_plans]
    for q in plans:
        text = explain_with_indexes(hs, q)
        if f"Type: {kind}, Name: {index}" not in text:
            raise AssertionError(f"lake {label}: {index} not used:\n{text}")
    c["kernels"].label = f"lake {label}"
    on_ms, off_ms, got = [], [], [None] * len(plans)
    rounds = 3 if len(plans) == 1 else 1
    try:
        cs.enable_hyperspace()
        plans[0].collect()  # warm-up
        for _ in range(rounds):
            for i, q in enumerate(plans):
                for enabled in (True, False):
                    (cs.enable_hyperspace if enabled else cs.disable_hyperspace)()
                    t0 = time.perf_counter()
                    rows = q.collect()
                    (on_ms if enabled else off_ms).append((time.perf_counter() - t0) * 1e3)
                    if enabled:
                        got[i] = rows
                    elif not sorted_rows(got[i]).equals(sorted_rows(rows)):
                        raise AssertionError(f"lake {label}[{i}]: rows differ from the plan "
                                             f"without Hyperspace")
    finally:
        cs.disable_hyperspace()
        c["kernels"].label = None
    ps.enable_hyperspace()
    try:
        for i, q in enumerate(cpu_plans):
            if not got[i].equals(q.collect()):
                raise AssertionError(f"lake {label}[{i}]: rows differ from the cpu session's")
    finally:
        ps.disable_hyperspace()
    c["kernels"].settle()
    rows = sum(g.num_rows for g in got)
    if rows == 0:
        raise AssertionError(f"lake {label}: no row matched")
    out = {"queries": len(plans), "rows": rows, "p50_ms": float(np.percentile(on_ms, 50)),
           "p99_ms": float(np.percentile(on_ms, 99)),
           "off_p50_ms": float(np.percentile(off_ms, 50))}
    log(f"lake path [{c['card']}]: {label} ({len(plans)} quer{'y' if len(plans) == 1 else 'ies'})"
        f" over {index}: p50_ms {out['p50_ms']:.3f} p99_ms {out['p99_ms']:.3f} with Hyperspace, "
        f"{out['off_p50_ms']:.3f} without ({rounds} round{'s' if rounds > 1 else ''} in turns); {rows} rows, equal as a multiset "
        f"to the plan without Hyperspace and in order to the cpu session's")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the out-of-core build (budgeted waves, per-bucket spill and
# merge, the streamed z-order two-pass write, the streamed refresh) and plan
# analysis (why_not, explain's modes, the min/max analysis)
# ---------------------------------------------------------------------------

#: the build memory budget of phase 16, in units of the first source file's
#: estimated materialized bytes: 2 files a wave, 4 waves over phase 4's 8
OC_BUDGET_FILES = 2.5
OC_MODES = ("plaintext", "console", "html")


def write_peak(fn) -> tuple:
    """``(fn(), bytes)``: the peak device bytes allocated over an index's
    data write, from the reset just before ``fn`` (a create: the scan, then
    the write) to the return of the index's ``write``, before the captures,
    less the bytes allocated at the reset. ``write`` is wrapped for the
    call (covering and z-order indexes)."""
    import torch

    from hyperspace_tpu_torch.indexes.covering import CoveringIndex
    from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndex

    seen = []
    reals = {cls: cls.write for cls in (CoveringIndex, ZOrderCoveringIndex)}

    def wrap(real):
        def write(index, ctx, data):
            real(index, ctx, data)
            torch.cuda.synchronize()
            seen.append(torch.cuda.max_memory_allocated())

        return write

    for cls, real in reals.items():
        cls.write = wrap(real)
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
    finally:
        for cls, real in reals.items():
            cls.write = real
    if len(seen) != 1:
        raise AssertionError(f"the create wrote {len(seen)} times")
    return out, seen[0] - base


def oc_create(c: dict, name: str, df, config) -> dict:
    """One budgeted create on the card: its seconds, rows/s, stages, waves
    and spill files, and its data write's peak device bytes; its kernel
    calls held after it."""
    hs, sess, kernels = c["hs"], c["sess"], c["kernels"]
    kernels.label = f"outofcore create {name}"
    t0 = time.perf_counter()
    try:
        _, peak = write_peak(lambda: hs.create_index(df, config))
    finally:
        kernels.label = None
    seconds = time.perf_counter() - t0
    kernels.settle()
    stats = dict(sess.build_stats)
    out = {"seconds": seconds, "rows_per_s": N_ROWS / seconds, "write_peak_bytes": peak,
           "stages_s": {k: v for k, v in stats.items() if isinstance(v, float)},
           "counts": {k: v for k, v in stats.items() if isinstance(v, int)}}
    log(f"outofcore path [{c['card']}]: {name} streamed in {seconds:.3f}s, "
        f"{N_ROWS / seconds:,.0f} rows/s; {out['counts']}; stages s "
        f"{ {k: round(v, 4) for k, v in out['stages_s'].items()} }; data write's peak device "
        f"bytes {peak:,}")
    if stats.get("waves") != 4:
        raise AssertionError(f"{name}: {stats.get('waves')} waves, not 4")
    return out


def oc_hold_buckets(st_files, li_files) -> dict:
    """Each of st_idx's bucket files against li_idx's of the same name: the
    same rows after sorting by every column, key-sorted; how many also
    match in order."""
    import pyarrow.parquet as pq

    names = sorted(os.path.basename(f) for f in st_files)
    if names != sorted(os.path.basename(f) for f in li_files) or len(names) != N_BUCKETS:
        raise AssertionError("st_idx's bucket files are not li_idx's")
    by_name = {os.path.basename(f): f for f in li_files}
    in_order, rows = 0, 0
    for f in st_files:
        # ParquetFile reads the file alone: no partition column inferred
        # from a key=value directory name
        mine, theirs = pq.ParquetFile(f).read(), pq.ParquetFile(by_name[os.path.basename(f)]).read()
        if mine.schema != theirs.schema:
            raise AssertionError(f"{os.path.basename(f)}: schema {mine.schema} against "
                                 f"li_idx's {theirs.schema}")
        keys = mine.column("l_orderkey").to_numpy()
        if not (np.diff(keys) >= 0).all():
            raise AssertionError(f"{os.path.basename(f)} is not key-sorted")
        if not sorted_rows(mine).equals(sorted_rows(theirs)):
            raise AssertionError(f"{os.path.basename(f)}: rows differ from li_idx's")
        in_order += mine.equals(theirs)
        rows += mine.num_rows
    if rows != N_ROWS:
        raise AssertionError(f"st_idx holds {rows} rows")
    return {"files": len(names), "rows": rows, "in_order": in_order}


def oc_filters(c: dict, df) -> dict:
    """Phase 4's 36 filters over st_idx: each names st_idx, bucket-pruned;
    rows equal the plan without Hyperspace (point filters in order)."""
    sess, hs, kernels = c["sess"], c["hs"], c["kernels"]
    plans = hy_filters(df)
    sess.enable_hyperspace()
    kernels.record_b3a(True)
    kernels.label = "outofcore filters"
    try:
        for q in plans:
            if "Name: st_idx" not in hs.explain(q).split("Plan without indexes:")[0]:
                raise AssertionError("a filter not served by st_idx")
        plans[0].collect()  # warm-up
        sess.exec_stats.reset()
        times, got = [], []
        for q in plans:
            t0 = time.perf_counter()
            got.append(q.collect())
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        kernels.label = None
        kernels.record_b3a(False)
        sess.disable_hyperspace()
    pruned = sess.exec_stats.as_dict()["bucket_pruned_scans"]
    if pruned != len(plans):
        raise AssertionError(f"{pruned} of {len(plans)} filters bucket-pruned")
    rows = 0
    for i, (q, rows_got) in enumerate(zip(plans, got)):
        want = q.collect()
        same = rows_got.equals(want) if i < 32 else sorted_rows(rows_got).equals(sorted_rows(want))
        if not same:
            raise AssertionError(f"st_idx filter {i}: rows differ from the plan without "
                                 f"Hyperspace")
        rows += rows_got.num_rows
    kernels.settle()
    p50, p99 = np.percentile(times, [50, 99])
    out = {"queries": len(plans), "rows": rows, "p50_ms": float(p50), "p99_ms": float(p99)}
    log(f"outofcore path [{c['card']}]: 36 filters over st_idx p50_ms {p50:.3f} p99_ms "
        f"{p99:.3f} (li_idx in phase 4: {c['p4_p50']:.3f} / {c['p4_p99']:.3f}), {rows} rows, "
        f"bucket-pruned, equal to the plan without Hyperspace (point filters in order)")
    return out


def oc_zrange(c: dict, src: str, step: str) -> dict:
    """q_zrange over the copy: served by sz_idx (one warm-up, 3 timed runs,
    the files and row groups its z-spans kept), rows equal as a multiset to
    the plan without Hyperspace."""
    from hyperspace_tpu_torch.indexes import zonemaps

    sess, hs = c["sess"], c["hs"]
    q = zorder_queries(sess.read.parquet(src))["q_zrange"][0]
    sess.enable_hyperspace()
    c["kernels"].label = f"outofcore q_zrange {step}"
    try:
        text = hs.explain(q).split("Plan without indexes:")[0]
        if "Type: ZOCI, Name: sz_idx" not in text:
            raise AssertionError(f"q_zrange {step}: sz_idx not used:\n{text}")
        q.collect()  # warm-up
        times = []
        for _ in range(3):
            zonemaps.last_prune_stats = {}
            t0 = time.perf_counter()
            got = q.collect()
            times.append((time.perf_counter() - t0) * 1e3)
        prune = dict(zonemaps.last_prune_stats)
    finally:
        c["kernels"].label = None
        sess.disable_hyperspace()
    t0 = time.perf_counter()
    want = q.collect()
    off_ms = (time.perf_counter() - t0) * 1e3
    if got.num_rows == 0 or not sorted_rows(got).equals(sorted_rows(want)):
        raise AssertionError(f"q_zrange {step}: rows differ from the plan without Hyperspace")
    c["kernels"].settle()
    out = {"p50_ms": float(np.median(times)), "unindexed_ms": off_ms, "rows": got.num_rows,
           "prune": prune}
    log(f"outofcore path [{c['card']}]: q_zrange over sz_idx {step}: p50_ms "
        f"{out['p50_ms']:.3f} (3 runs; the plan without Hyperspace {off_ms:.3f}), "
        f"{got.num_rows} rows, equal to the plan without Hyperspace as a multiset; "
        f"pruning {prune}")
    return out


def oc_analysis(c: dict, src: str, copy: str, z_dir: str) -> dict:
    """why_not (plain and extended) and explain (verbose, each display
    mode) for one point filter over st_idx's source and q_zrange over
    sz_idx's, each naming the index applied and a reason for every other
    ACTIVE index; then the min/max analysis of l_orderkey and l_shipdate
    over li_idx's and z_idx's files."""
    from hyperspace_tpu_torch.plananalysis.minmax_analysis import analyze_min_max_string

    sess, hs = c["sess"], c["hs"]
    point = hy_filters(sess.read.parquet(src))[0]
    zrange = zorder_queries(sess.read.parquet(copy))["q_zrange"][0]
    out = {"why_not_ms": {}, "explain_ms": {}}
    for label, q, applied, other in (("point", point, "st_idx", "sz_idx"),
                                     ("q_zrange", zrange, "sz_idx", "st_idx")):
        for extended in (False, True):
            t0 = time.perf_counter()
            text = hs.why_not(q, extended=extended)
            out["why_not_ms"][f"{label} {'extended' if extended else 'plain'}"] = (
                time.perf_counter() - t0) * 1e3
            reasons = text.split("Non-applicable indexes:")[1].split(f"{other} (")[1]
            if (f"{applied}: applied by the optimizer" not in text
                    or not reasons.split("\n")[1].startswith("  - [")):
                raise AssertionError(f"why_not {label}: {applied} not applied or no reason "
                                     f"for {other}:\n{text}")
            log(f"outofcore path: hs.why_not({label}, extended={extended}):\n{text}")
        for mode in OC_MODES:
            t0 = time.perf_counter()
            text = hs.explain(q, verbose=True, mode=mode)
            out["explain_ms"][f"{label} {mode}"] = (time.perf_counter() - t0) * 1e3
            if f"Name: {applied}" not in text or "Operator diff:" not in text:
                raise AssertionError(f"explain {label} ({mode}): {applied} not named:\n{text}")
            log(f"outofcore path: hs.explain({label}, verbose=True, mode={mode!r}):\n{text}")
    li_dir = os.path.dirname(c["li_files"][0])
    for label, d in (("li_idx", li_dir), ("z_idx", z_dir)):
        t0 = time.perf_counter()
        text = analyze_min_max_string(sess.read.parquet(d), ["l_orderkey", "l_shipdate"])
        out[f"minmax_ms {label}"] = (time.perf_counter() - t0) * 1e3
        if "Max files for a point lookup" not in text:
            raise AssertionError(f"min/max analysis over {label}:\n{text}")
        log(f"outofcore path: analyze_min_max_string over {label}'s files "
            f"(l_orderkey, l_shipdate):\n{text}")
    return out


def outofcore_path(work: str, ctx: dict, kernels: KernelCalls, card: str) -> dict:
    """Phase 16: the out-of-core build and plan analysis (module docstring,
    item 16). Launch counts read from 0 at its start."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_lake as L

    from hyperspace_tpu_torch import (
        CoveringIndexConfig,
        Hyperspace,
        HyperspaceSession,
        ZOrderCoveringIndexConfig,
        ops,
    )
    from hyperspace_tpu_torch.indexes import covering_build as CB

    t_phase = time.perf_counter()
    src = ctx["src"]
    per_file = CB.per_file_materialized_bytes([os.path.join(src, "part0.parquet")], "parquet")[0]
    budget = ctx["oc_budget"] = int(OC_BUDGET_FILES * per_file)
    sess = HyperspaceSession()
    sess.conf.set("hyperspace.system.path", os.path.join(work, "oc_indexes"))
    sess.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    sess.conf.set("hyperspace.index.build.memoryBudgetBytes", budget)
    hs = Hyperspace(sess)
    c = {"sess": sess, "hs": hs, "kernels": kernels, "card": card, "p4_p50": ctx["p50_ms"],
         "p4_p99": ctx["p99_ms"], "li_files": ctx["hs"].get_index("li_idx").content.files}
    out = {"budget_bytes": budget, "first_file_bytes": per_file,
           "li_idx_write_peak_bytes": ctx["li_write_peak"]}
    kernels.on_host = True  # recorded tensors must not hold device memory
    settle0 = kernels.settle_s
    ops.reset_launch_counts()
    try:
        # (1) st_idx: li_idx's configuration, streamed
        items = sess.read.parquet(src)
        out["st_idx"] = oc_create(c, "st_idx", items, CoveringIndexConfig(
            "st_idx", ["l_orderkey"], ["l_shipdate", "l_quantity"]))
        t0 = time.perf_counter()
        out["st_idx"]["held_to_li_idx"] = oc_hold_buckets(
            hs.get_index("st_idx").content.files, c["li_files"])
        peak, li_peak = out["st_idx"]["write_peak_bytes"], ctx["li_write_peak"]
        log(f"outofcore path [{card}]: st_idx's {N_BUCKETS} bucket files hold li_idx's rows "
            f"(sorted by every column; {out['st_idx']['held_to_li_idx']['in_order']} in order "
            f"too), key-sorted ({time.perf_counter() - t0:.1f}s); data write's peak device "
            f"bytes {peak:,} streamed against li_idx's {li_peak:,} in memory "
            f"({100.0 * peak / li_peak:.1f} %)")
        if not peak < li_peak:
            raise AssertionError("the streamed write's peak device bytes are not below the "
                                 "in-memory write's")
        out["filters"] = oc_filters(c, items)
        # (2) sz_idx: phase 10's z_idx, streamed, lineage on, over a copy
        copy = os.path.join(work, "oc_src")
        for i in range(N_FILES):
            L.link_or_copy(os.path.join(src, f"part{i}.parquet"),
                           os.path.join(copy, f"part{i}.parquet"))
        sess.conf.set("hyperspace.index.lineage.enabled", True)
        indexed, included = Z_INDEXES["z_idx"]
        out["sz_idx"] = oc_create(c, "sz_idx", sess.read.parquet(copy),
                                  ZOrderCoveringIndexConfig("sz_idx", indexed, included))
        z_dir = os.path.join(work, "zindexes", "z_idx", "v__=1")
        cols = indexed + included
        mine = pa.concat_tables([pq.ParquetFile(f).read(columns=cols) for f in sorted(
            hs.get_index("sz_idx").content.files)])
        theirs = pa.concat_tables([pq.ParquetFile(os.path.join(z_dir, f)).read(columns=cols)
                                   for f in sorted(os.listdir(z_dir)) if f.endswith(".parquet")
                                   and f.startswith("part-")])
        if not mine.equals(theirs):
            raise AssertionError("sz_idx's rows in file order differ from z_idx's")
        log(f"outofcore path [{card}]: sz_idx's {mine.num_rows} rows in file order equal "
            f"phase 10's z_idx's (the same min/max spec)")
        out["zrange"] = {"before": oc_zrange(c, copy, "before")}
        # (3) file 0 deleted, phase 14's file appended, refreshed incrementally
        os.remove(os.path.join(copy, "part0.parquet"))
        n_extra = hy_append(os.path.join(copy, "appended.parquet"))
        sess.index_manager.clear_cache()
        sess.build_stats.clear()
        kernels.label = "outofcore refresh sz_idx"
        t0 = time.perf_counter()
        try:
            hs.refresh_index("sz_idx", "incremental")
            torch.cuda.synchronize()
        finally:
            kernels.label = None
        stats = dict(sess.build_stats)
        out["refresh"] = {"seconds": time.perf_counter() - t0, "appended_rows": n_extra,
                          "stages_s": {k: v for k, v in stats.items() if isinstance(v, float)},
                          "counts": {k: v for k, v in stats.items() if isinstance(v, int)}}
        kernels.settle()
        log(f"outofcore path [{card}]: sz_idx refreshed incrementally (part0 deleted, "
            f"{n_extra} rows appended; the previous data streamed) in "
            f"{out['refresh']['seconds']:.3f}s; {out['refresh']['counts']}; stages s "
            f"{ {k: round(v, 4) for k, v in out['refresh']['stages_s'].items()} }")
        if stats.get("waves", 0) < 2 or "stats" not in stats:
            raise AssertionError(f"the refresh did not stream: {stats}")
        out["zrange"]["after"] = oc_zrange(c, copy, "after")
        # (4) plan analysis
        out["analysis"] = oc_analysis(c, src, copy, z_dir)
    finally:
        kernels.label = None
        kernels.on_host = False
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["settle_s"] = kernels.settle_s - settle0
    out["held"] = kernels.summary("phase 16", (("b1", "outofcore create st_idx"),
                                               ("b1", "outofcore filters"),
                                               ("b5f", "outofcore create st_idx"),
                                               ("b6", "outofcore create sz_idx"),
                                               ("b6", "outofcore refresh sz_idx")))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"outofcore path [{card}]: all steps ran; launches {out['launches']}; "
        f"{out['seconds']:.1f}s in all")
    return out


#: phase 17's timed runs a route (after a warm-up where the route has one)
OS_RUNS = 3
#: phase 17's streamed join: about this many waves at its small budget
OS_WAVES = 8


def os_join_plan(sess, ctx):
    """Phase 5's orders ⋈ lineitem over ``sess``."""
    orders, items = sess.read.parquet(ctx["orders_src"]), sess.read.parquet(ctx["src"])
    return orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
        "o_orderkey", "o_custkey", "l_quantity")


def os_timed(c: dict, label: str, fn, runs: int = OS_RUNS) -> tuple:
    """``fn()`` ``runs`` times under kernel label ``label``: (the rows of
    the first run, each later run's rows equal in order to it, ms a run);
    the kept kernel calls held after the runs."""
    import torch

    kernels = c["kernels"]
    kernels.label = label
    times, got = [], None
    try:
        for _ in range(runs):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if got is None:
                got = out
            elif not out.equals(got):
                raise AssertionError(f"{label}: rows differ between runs")
    finally:
        kernels.label = None
    kernels.settle()
    return got, times


def os_join_peak(c: dict, label: str) -> tuple:
    """One run of the join under ``label``: (rows, its peak device bytes less
    the bytes allocated at the reset just before it, seconds, B4 calls
    held)."""
    import torch

    kernels = c["kernels"]
    kernels.label = label
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = os_join_plan(c["sess"], c["ctx"]).collect()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        kernels.label = None
    held = kernels.settle()
    return got, peak, secs, sum(1 for call in held if call[0] == "b4")


def os_keys_h2d_ms(cache) -> float:
    """The host-to-device copy of both cached join sides' combined keys,
    as a warm join makes it (``torch.from_numpy(...).to("cuda")``): the
    median ms of 5, host clock around a synchronised copy."""
    import torch

    keys = [v.combined for k, (v, _nb) in cache._entries.items() if k[0] == "joinside"]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in keys:
            torch.from_numpy(k).to("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def os_stream(c: dict, want, budget: int, mmap: bool, label: str) -> dict:
    """The streamed join at wave budget ``budget``: rows equal in order to
    the materializing route's ``want``; its waves, buckets, stage seconds,
    B4 launches and peak device bytes."""
    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.execution import executor as X

    sess = c["sess"]
    sess.conf.set("hyperspace.serve.stream.enabled", True)
    sess.conf.set("hyperspace.serve.stream.maxBytes", budget)
    sess.conf.set("hyperspace.io.mmap.enabled", mmap)
    try:
        before = ops.launch_counts()["bucket_match_pairs"]
        got, peak, secs, b4_calls = os_join_peak(c, label)
        b4 = ops.launch_counts()["bucket_match_pairs"] - before
        stats, stages = dict(X.last_stream_stats), dict(sess.join_stats)
    finally:
        sess.conf.set("hyperspace.serve.stream.enabled", False)
        sess.conf.set("hyperspace.io.mmap.enabled", False)
    if not got.equals(want):
        raise AssertionError(f"{label}: rows differ from the materializing route's")
    if b4_calls != stats["stream_waves"] or b4 < b4_calls:
        raise AssertionError(f"{label}: {b4_calls} B4 calls ({b4} launches) for "
                             f"{stats['stream_waves']} waves")
    out = {"budget_bytes": budget, "mmap": mmap, "seconds": secs, "peak_device_bytes": peak,
           "waves": stats["stream_waves"], "buckets": stats["stream_buckets"],
           "b4_calls": b4_calls, "b4_launches": b4, "stages_s": stages}
    log(f"ooserve path [{c['card']}]: {label}: {stats['stream_waves']} waves over "
        f"{stats['stream_buckets']} buckets (budget {budget:,} bytes, mmap {mmap}) in "
        f"{secs:.3f}s, B4 calls {b4_calls} (launches {b4}: count, scan and emit passes), "
        f"peak device bytes {peak:,}; stages s "
        f"{ {k: round(v, 4) for k, v in stages.items()} }; rows equal in order to the "
        f"materializing route's")
    return out


def os_filters(c: dict) -> dict:
    """Phase 4's 36 filters over li_idx with the cache off, then on (cold,
    warm): each cache-on run's rows equal the cache-off route's in order;
    p50s and the cache's counters."""
    sess, cache_key = c["sess"], "hyperspace.serve.cache.enabled"
    plans = hy_filters(sess.read.parquet(c["ctx"]["src"]))
    for q in plans:
        if "Name: li_idx" not in c["hs"].explain(q).split("Plan without indexes:")[0]:
            raise AssertionError("a filter not served by li_idx")
    out = {}
    got = {}
    for step, on in (("off", False), ("cold", True), ("warm", True)):
        sess.conf.set(cache_key, on)
        sess.exec_stats.reset()
        times, rows = [], []
        c["kernels"].label = f"ooserve filters {step}"
        try:
            for q in plans:
                t0 = time.perf_counter()
                rows.append(q.collect())
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            c["kernels"].label = None
        c["kernels"].settle()
        got[step] = rows
        st = sess.exec_stats.as_dict()
        out[step] = {"p50_ms": float(np.median(times)), "p99_ms": float(np.percentile(times, 99)),
                     "fused_range_masks": st["fused_range_masks"],
                     "device_filter_evals": st["device_filter_evals"]}
    for step in ("cold", "warm"):
        for i, (a, b) in enumerate(zip(got[step], got["off"])):
            if not a.equals(b):
                raise AssertionError(f"filter {i} ({step} cache): rows differ from the "
                                     f"cache-off route's")
    out["stats"] = c["sess"].serve_cache.stats()
    if (out["stats"]["hits"] < len(plans)
            or not out["warm"]["fused_range_masks"] > 0):
        raise AssertionError(f"warm filters did not hit the cache through B3a: {out}")
    log(f"ooserve path [{c['card']}]: 36 filters over li_idx, p50_ms cache off "
        f"{out['off']['p50_ms']:.3f}, cold {out['cold']['p50_ms']:.3f}, warm "
        f"{out['warm']['p50_ms']:.3f} (p99 {out['off']['p99_ms']:.3f} / "
        f"{out['cold']['p99_ms']:.3f} / {out['warm']['p99_ms']:.3f}); warm fused range masks "
        f"(B3a) {out['warm']['fused_range_masks']}, general device masks "
        f"{out['warm']['device_filter_evals']}; rows equal in order to the cache-off route's; "
        f"cache {out['stats']}")
    return out


def ooserve_path(work: str, ctx: dict, kernels: KernelCalls, card: str) -> dict:
    """Phase 17: the out-of-core serve and the serve cache (module
    docstring, item 17). Launch counts read from 0 at its start."""
    import torch

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch import functions as F

    t_phase = time.perf_counter()
    sess = HyperspaceSession()
    sess.conf.set("hyperspace.system.path", ctx["session"].conf.get("hyperspace.system.path"))
    sess.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
    hs = Hyperspace(sess)
    names = set(hs.indexes().column("name").to_pylist())
    for name, src, config in (
            ("li_idx", ctx["src"], ("l_orderkey", "l_shipdate", "l_quantity")),
            ("o_idx", ctx["orders_src"], ("o_orderkey", "o_custkey", "o_totalprice"))):
        if name not in names:  # an earlier phase took it away: build it again
            hs.create_index(sess.read.parquet(src),
                            CoveringIndexConfig(name, [config[0]], list(config[1:])))
            log(f"ooserve path [{card}]: built {name} again")
    sess.enable_hyperspace()
    index_served(hs, os_join_plan(sess, ctx), ("o_idx", "li_idx"))
    c = {"sess": sess, "hs": hs, "kernels": kernels, "card": card, "ctx": ctx}
    out = {}
    kernels.on_host = True  # recorded tensors must not hold device memory
    kernels.record_b3a(True)
    kernels.record_b4(True)
    settle0 = kernels.settle_s
    ops.reset_launch_counts()
    try:
        # (1) the streamed join against the materializing route
        want, mat_peak, mat_s, _ = os_join_peak(c, "ooserve join materializing")
        est = (N_ROWS + N_ORDERS) * 2 * 8  # footer rows x 2 columns x 8 bytes, both sides
        small = est // OS_WAVES + 1
        out["materializing"] = {"seconds": mat_s, "peak_device_bytes": mat_peak,
                                "stages_s": dict(sess.join_stats)}
        out["stream_small"] = os_stream(c, want, small, False, "ooserve join streamed")
        out["stream_default"] = os_stream(c, want, 256 << 20, False,
                                          "ooserve join streamed default")
        out["stream_mmap"] = os_stream(c, want, small, True, "ooserve join streamed mmap")
        if out["stream_small"]["waves"] < 4 or out["stream_mmap"]["waves"] < 4:
            raise AssertionError(f"the streamed join ran in fewer than 4 waves: {out}")
        log(f"ooserve path [{card}]: join peak device bytes: materializing {mat_peak:,} "
            f"({mat_s:.3f}s), {out['stream_small']['waves']} waves "
            f"{out['stream_small']['peak_device_bytes']:,}, one wave "
            f"{out['stream_default']['peak_device_bytes']:,}")
        # (2) the serve cache: filters, the join, f1
        out["filters"] = os_filters(c)
        sess.conf.set("hyperspace.serve.cache.enabled", False)
        _, off_ms = os_timed(c, "ooserve join cache off", lambda: os_join_plan(sess, ctx).collect())
        sess.conf.set("hyperspace.serve.cache.enabled", True)
        cold, cold_ms = os_timed(c, "ooserve join cold", lambda: os_join_plan(sess, ctx).collect(),
                                 runs=1)
        hits0 = sess.serve_cache.hits
        warm, warm_ms = os_timed(c, "ooserve join warm", lambda: os_join_plan(sess, ctx).collect())
        warm_stages = dict(sess.join_stats)
        if not (cold.equals(want) and warm.equals(want)):
            raise AssertionError("the cached join's rows differ from the cache-off route's")
        if sess.serve_cache.hits - hits0 != 2 * OS_RUNS:
            raise AssertionError("the warm joins did not take both sides from the cache")
        out["join"] = {"off_p50_ms": float(np.median(off_ms)), "cold_ms": cold_ms[0],
                       "warm_p50_ms": float(np.median(warm_ms)), "warm_stages_s": warm_stages,
                       "joinside_bytes": sess.serve_cache.bytes_by_kind().get("joinside"),
                       "keys_h2d_ms": os_keys_h2d_ms(sess.serve_cache)}
        log(f"ooserve path [{card}]: join p50_ms cache off {out['join']['off_p50_ms']:.3f}, "
            f"cold {cold_ms[0]:.3f}, warm {out['join']['warm_p50_ms']:.3f}; warm stages s "
            f"{ {k: round(v, 4) for k, v in warm_stages.items()} }; joinside bytes "
            f"{out['join']['joinside_bytes']:,}; the cached sides' combined keys to the card "
            f"{out['join']['keys_h2d_ms']:.3f} ms (median of 5); rows equal in order")
        f1 = aggregate_queries(F, sess.read.parquet(ctx["src"]))["a"]
        sess.conf.set("hyperspace.serve.cache.enabled", False)
        f_off, f_off_ms = os_timed(c, "ooserve f1 cache off", f1.collect)
        sess.conf.set("hyperspace.serve.cache.enabled", True)
        sess.exec_stats.reset()
        f_cold, f_cold_ms = os_timed(c, "ooserve f1 cold", f1.collect, runs=1)
        f_warm, f_warm_ms = os_timed(c, "ooserve f1 warm", f1.collect)
        if not (f_cold.equals(f_off) and f_warm.equals(f_off)):
            raise AssertionError("f1 over the cached scan differs from the cache-off route")
        if sess.exec_stats.fused_aggregates != 1 + OS_RUNS:
            raise AssertionError(f"f1 did not take the fused pass: {sess.exec_stats.as_dict()}")
        from hyperspace_tpu_torch.execution import pipeline_compiler as PC

        out["f1"] = {"off_p50_ms": float(np.median(f_off_ms)), "cold_ms": f_cold_ms[0],
                     "warm_p50_ms": float(np.median(f_warm_ms)),
                     "warm_agg_stats_s": dict(sess.agg_stats),
                     "warm_fused_stats": dict(PC.last_fused_stats),
                     "stats": sess.serve_cache.stats()}
        log(f"ooserve path [{card}]: f1 over the cached scan (B5f) p50_ms cache off "
            f"{out['f1']['off_p50_ms']:.3f}, cold {f_cold_ms[0]:.3f}, warm "
            f"{out['f1']['warm_p50_ms']:.3f}; the last warm run's stages s "
            f"{ {k: round(v, 4) for k, v in out['f1']['warm_agg_stats_s'].items()} } and fused "
            f"pass {out['f1']['warm_fused_stats']}; rows equal; cache {out['f1']['stats']}")
        # (3) the spill tier: room for the larger join side only
        side_bytes = {"+".join(k[2]): nb for k, (_v, nb) in sess.serve_cache._entries.items()
                      if k[0] == "joinside"}
        # above the larger side, below both together
        cap = max(side_bytes.values()) + min(side_bytes.values()) // 2
        sess.conf.set("hyperspace.serve.cache.maxBytes", cap)
        sess.conf.set("hyperspace.serve.spill.maxBytes", 4 << 30)
        sess.conf.set("hyperspace.serve.spill.orphanTtlMs", 1)
        cache = sess.serve_cache  # a new, empty cache with a spill tier
        spilled, report = [], None
        for step in ("first", "second"):
            got, ms = os_timed(c, f"ooserve join spill {step}",
                               lambda: os_join_plan(sess, ctx).collect(), runs=1)
            if not got.equals(want):
                raise AssertionError(f"the spill tier's {step} join differs from the "
                                     f"cache-off route")
            spilled.append({"ms": ms[0], **cache.stats()})
            if report is None:
                # recover with the cache alive: its spill files stay (the
                # second join restores from them), with a 1 ms orphan TTL
                time.sleep(0.01)
                live = len(cache.spill_paths())
                report = hs.recover("li_idx")["spill_gc"]
                if report["kept_live"] != live or live < 1:
                    raise AssertionError(f"recover did not keep the live spill files: {report}")
        if spilled[0]["spill_demotes"] < 1 or spilled[1]["spill_restores"] < 1:
            raise AssertionError(f"the spill tier did not demote and restore: {spilled}")
        out["spill"] = {"side_bytes": side_bytes, "max_bytes": cache.max_bytes, "runs": spilled,
                        "recover_spill_gc": report}
        log(f"ooserve path [{card}]: spill tier (cache cap {cache.max_bytes:,} bytes, sides "
            f"{side_bytes}): first join {spilled[0]['ms']:.1f} ms, demotes "
            f"{spilled[0]['spill_demotes']}; second {spilled[1]['ms']:.1f} ms, restores "
            f"{spilled[1]['spill_restores']}, demotes {spilled[1]['spill_demotes']}; rows equal; "
            f"recover's spill_gc {report}")
        sess.clear_serve_cache()
    finally:
        kernels.label = None
        kernels.record_b3a(False)
        kernels.record_b4(False)
        kernels.on_host = False
        sess.conf.set("hyperspace.serve.cache.enabled", False)
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["settle_s"] = kernels.settle_s - settle0
    out["held"] = kernels.summary("phase 17", (("b4", "ooserve join streamed"),
                                               ("b4", "ooserve join warm"),
                                               ("b3a", "ooserve filters warm"),
                                               ("b5f", "ooserve f1 warm")))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"ooserve path [{card}]: all steps ran; launches {out['launches']}; "
        f"{out['seconds']:.1f}s in all")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the sharded build and serve (kernels B8a and B8b, B4 a shard)
# ---------------------------------------------------------------------------

#: phase 18's shards on the one card, and its builds of li_idx: (exchange
#: strategy, sharded tail on)
SH_SHARDS = 4
SH_DEVICE = "cuda:0"
SH_BUILDS = (("flat", True), ("compact", True), ("host", True), ("twostage", True),
             ("flat", False))


def b8_bits(t):
    """A tensor's raw bits (floats as integers: NaN equals itself)."""
    import torch

    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def b8_same(a, b) -> bool:
    """B8 outputs equal bit for bit: nested lists and tuples of tensors."""
    import torch

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(b8_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(b8_bits(a), b8_bits(b))


def b8_bound(kind: str, args) -> dict:
    """Least time of a B8 call: each distinct input read once, each output
    written once, over HBM bandwidth (a few integer operations a row: far
    under the bytes). B8a writes [D, cap] a column and D counts; B8b
    writes its columns and one count."""
    bucket, valid = args[0], args[1]
    cols = args[4] if kind == "b8a" else args[3]
    seen, nbytes = set(), 0
    for t in (bucket, valid, *cols):
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * t.element_size()
    if kind == "b8a":
        D, cap = args[2], args[3]
        nbytes += D * cap * sum(c.element_size() for c in cols) + 8 * D
    else:
        nbytes += sum(c.numel() * c.element_size() for c in cols) + 8
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": bytes_ms, "bound_by": "bytes"}


def b8_timing(kind: str, args, flush, launches: int, calls_held: int) -> dict:
    """Time one main-path call of B8a or B8b cold (256 MiB read before
    each run, median of 30): the whole call with its read of the error
    word (``ms``, as PR 20 timed it) and its launches alone, CUDA events
    around them (``device_ms``), beside its byte bound, its plain version
    and, as the library yardstick, ``torch.sort(..., stable=True)`` of the
    same keys (the destination digits, or the bucket with invalid slots
    last)."""
    import torch

    from hyperspace_tpu_torch.ops import exchange as X

    if kind == "b8a":
        kernel, launch, plain = X.pack_kernel, X.pack_launch, X.pack_torch
        keys = torch.where(args[1], args[0].to(torch.int64) % args[2], args[2])
        plan = X.plan(args[0].shape[0], args[2] + 1, args[2], args[3])
    else:
        kernel, launch, plain = X.order_kernel, X.order_launch, X.order_torch
        keys = torch.where(args[1], args[0], args[2])
        plan = X.plan(args[0].shape[0], args[2] + 1)
    ms = float(np.median(time_cold(lambda: kernel(*args), flush)))
    device_ms = float(np.median(time_cold(lambda: launch(*args), flush)))
    plain_ms = float(np.median(time_cold(lambda: plain(*args), flush, warmup=1, iters=5)))
    library_ms = float(np.median(time_cold(lambda: torch.sort(keys, stable=True), flush)))
    b = b8_bound(kind, args)
    names = {"b8a": ("bucket_exchange_pack", "hs_exchange_pack_count / _move"),
             "b8b": ("bucket_exchange_order", "hs_exchange_order_count / _move")}
    log(f"kernels: {kind.upper()} ({names[kind][1]}, PR 21's design, {plan.route} route) cold at "
        f"{args[0].shape[0]} rows: ms {ms:.4f} with the error word's read ({b['bound_ms'] / ms:.1%} "
        f"of bound_ms {b['bound_ms']:.4f}; {b['bytes']} bytes), launches alone {device_ms:.4f} "
        f"({b['bound_ms'] / device_ms:.1%}); plain_ms {plain_ms:.4f}; torch.sort(stable) of the "
        f"same keys {library_ms:.4f} ms; {calls_held} main-path calls bit-equal to the plain version")
    return {
        "name": names[kind][0],
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/bucket_exchange.cu",
        "replaces": "hyperspace_tpu/parallel/shuffle.py:306",
        "launches": launches,
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": library_ms,
        "library_call": "torch.sort(keys, stable=True)",
        "device_ms": device_ms,
        "digit_route": plan.route,
        "design": "PR 21",
        "rows": int(args[0].shape[0]),
        "bytes": b["bytes"],
        "cases": calls_held,
        "timing": "cold: 256 MiB read before each run, median of 30 (plain: of 5); ms is the "
                  "call with the read of its error word, device_ms its launches alone",
        "phase_18_launches": launches,
    }


def sh_session(root: str, shards: int, **conf):
    """A session of ``shards`` shards on the one card (``devices=[SH_DEVICE]
    * shards``), the aggregate sidecars off (phase 9 times them)."""
    from hyperspace_tpu_torch import HyperspaceSession

    sess = HyperspaceSession(devices=[SH_DEVICE] * shards)
    sess.conf.set("hyperspace.system.path", root)
    sess.conf.set(AGG_SWITCH, False)
    for key, value in conf.items():
        sess.conf.set(key, value)
    return sess


def sh_same_files(files, want: dict, label: str) -> int:
    """``files`` against ``want`` (basename -> sha256): the same names,
    byte for byte the same contents."""
    got = {os.path.basename(f): f for f in files}
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: other bucket files than the one-shard build's")
    for name, path in got.items():
        if file_sha(path) != want[name]:
            raise AssertionError(f"{label}: {name} differs from the one-shard build's")
    return len(got)


def sharded_path(work: str, ctx: dict, kernels: KernelCalls, card: str) -> dict:
    """Phase 18: the sharded build and serve at SH_SHARDS shards on the one
    card (module docstring, item 18). Launch counts read from 0 at its
    start."""
    import torch

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops

    t_phase = time.perf_counter()
    # (6) two processes on the card, in the background while the rest runs:
    # NCCL refuses two ranks on one GPU, so the job takes gloo, whose
    # collectives stage the CUDA tensors through host memory
    dryrun = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_dryrun_multihost.py"),
         "--device", torch.device(SH_DEVICE).type, "--timeout", "240"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
    )
    config = lambda name: CoveringIndexConfig(name, ["l_orderkey"], ["l_shipdate", "l_quantity"])
    li_sha = {os.path.basename(f): file_sha(f) for f in ctx["hs"].get_index("li_idx").content.files}
    out = {"shards": SH_SHARDS, "builds": {}}
    keep = {}
    kernels.record_b8(True)
    kernels.record_b4(True)
    ops.reset_launch_counts()
    try:
        # (1) li_idx built at SH_SHARDS shards through every strategy
        for strategy, tail in SH_BUILDS:
            name = f"sh_{strategy}" + ("" if tail else "_onetail")
            root = os.path.join(work, "sh_indexes", name)
            sess = sh_session(root, SH_SHARDS, **{
                "hyperspace.build.exchange.strategy": strategy,
                "hyperspace.build.exchange.twostageHosts": 2,
                "hyperspace.build.shardedTail.enabled": tail})
            hs = Hyperspace(sess)
            kernels.label = f"sharded create {name}"
            t0 = time.perf_counter()
            try:
                hs.create_index(sess.read.parquet(ctx["src"]), config(name))
            finally:
                kernels.label = None
            seconds = time.perf_counter() - t0
            if strategy == "flat" and tail:
                for kind in ("b8a", "b8b"):
                    keep[kind] = next(c[2] for c in kernels.calls if c[0] == kind)
            kernels.settle()
            n = sh_same_files(hs.get_index(name).content.files, li_sha, name)
            tele = dict(sess.build_telemetry)
            stats = {k: round(v, 4) for k, v in sess.build_stats.items()}
            out["builds"][name] = {"seconds": seconds, "files_equal": n, "telemetry": tele,
                                   "stages_s": stats}
            log(f"sharded path [{card}]: {name} at {SH_SHARDS} shards on one card in "
                f"{seconds:.3f}s; all {n} bucket files byte-equal to phase 4's one-shard li_idx; "
                f"last_shuffle_stats {tele}; stages {stats}")
            if tele.get("shuffle_strategy") != strategy or (tail and stats.get("tail_shards") != SH_SHARDS):
                raise AssertionError(f"{name}: strategy {tele.get('shuffle_strategy')}, "
                                     f"tail shards {stats.get('tail_shards')}")
            if name != "sh_flat":
                shutil.rmtree(root, ignore_errors=True)
        # (3) the sharded join: o_idx and li_idx (built at one shard) served
        # at SH_SHARDS, sequential and streamed, against phase 5's plan at 1
        def join(s):
            orders, items = s.read.parquet(ctx["orders_src"]), s.read.parquet(ctx["src"])
            return orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
                "o_orderkey", "o_custkey", "l_quantity")

        one = ctx["session"]
        one.enable_hyperspace()
        want = join(one).collect()
        serve = sh_session(one.conf.get("hyperspace.system.path"), SH_SHARDS)
        serve.enable_hyperspace()
        index_served(Hyperspace(serve), join(serve), ("o_idx", "li_idx"))
        joins = {}
        for label, stream in (("sequential", False), ("streamed", True)):
            serve.conf.set("hyperspace.serve.stream.enabled", stream)
            before = ops.launch_counts()
            kernels.label = f"sharded join {label}"
            t0 = time.perf_counter()
            try:
                got = join(serve).collect()
            finally:
                kernels.label = None
            seconds = time.perf_counter() - t0
            after = ops.launch_counts()
            held = len([c for c in kernels.settle() if c[0] == "b4"])
            shard = after["bucket_match_pairs.shard"] - before["bucket_match_pairs.shard"]
            if not got.equals(want):
                raise AssertionError(f"the {label} join at {SH_SHARDS} shards differs from phase "
                                     "5's rows in order")
            if shard <= 0 or shard != after["bucket_match_pairs"] - before["bucket_match_pairs"]:
                raise AssertionError(f"the {label} join did not match a shard block at a time")
            joins[label] = {"seconds": seconds, "rows": got.num_rows, "b4_shard_launches": shard,
                            "b4_calls_held": held, "stages_s": dict(serve.join_stats)}
            log(f"sharded path [{card}]: o_idx join li_idx at {SH_SHARDS} shards, {label}: "
                f"{got.num_rows} rows equal to phase 5's plan in order, {seconds:.3f}s; "
                f"B4 launches a shard block {shard}, {held} B4 calls bit-equal to the plain "
                f"version; stages {serve.join_stats}")
        out["join"] = joins
        # (4) phase 16's budgeted st_idx build at SH_SHARDS shards, the
        # concurrent per-shard merges on
        oc = HyperspaceSession(device=SH_DEVICE)
        oc.conf.set("hyperspace.system.path", os.path.join(work, "oc_indexes"))
        st_sha = {os.path.basename(f): file_sha(f)
                  for f in Hyperspace(oc).get_index("st_idx").content.files}
        st = sh_session(os.path.join(work, "sh_oc"), SH_SHARDS,
                        **{"hyperspace.index.build.memoryBudgetBytes": ctx["oc_budget"]})
        kernels.label = "sharded streamed create sh_st"
        t0 = time.perf_counter()
        try:
            Hyperspace(st).create_index(st.read.parquet(ctx["src"]), config("sh_st"))
        finally:
            kernels.label = None
        seconds = time.perf_counter() - t0
        kernels.settle()
        n = sh_same_files(Hyperspace(st).get_index("sh_st").content.files, st_sha, "sh_st")
        stats = dict(st.build_stats)
        out["streamed_build"] = {"seconds": seconds, "files_equal": n,
                                 "stages_s": {k: round(v, 4) for k, v in stats.items()}}
        log(f"sharded path [{card}]: phase 16's st_idx streamed at {SH_SHARDS} shards in "
            f"{seconds:.3f}s: {stats.get('waves')} waves, {stats.get('merge_workers')} concurrent "
            f"merge workers, all {n} bucket files byte-equal to phase 16's")
        if stats.get("waves") != 4 or stats.get("merge_workers") != SH_SHARDS:
            raise AssertionError(f"sh_st: {stats.get('waves')} waves, "
                                 f"{stats.get('merge_workers')} merge workers")
        shutil.rmtree(os.path.join(work, "sh_oc"), ignore_errors=True)
        # (5) cross-mesh serve: sh_flat (built at SH_SHARDS) served at one
        # shard, li_idx (built at one) at SH_SHARDS: phase 4's point filters
        point_keys, in_lists = phase4_keys()
        cross = {}
        for label, sess, name in (
                ("built at 4, served at 1", HyperspaceSession(device=SH_DEVICE), "sh_flat"),
                ("built at 1, served at 4", sh_session("", SH_SHARDS), "li_idx")):
            root = (os.path.join(work, "sh_indexes", "sh_flat") if name == "sh_flat"
                    else one.conf.get("hyperspace.system.path"))
            sess.conf.set("hyperspace.system.path", root)
            sess.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
            items = sess.read.parquet(ctx["src"])
            conds = [items["l_orderkey"] == k for k in point_keys[:8]] + [
                items["l_orderkey"].isin(in_lists[0])]
            base = one.read.parquet(ctx["src"])
            one_conds = [base["l_orderkey"] == k for k in point_keys[:8]] + [
                base["l_orderkey"].isin(in_lists[0])]
            sess.enable_hyperspace()
            rows = 0
            for cond, one_cond in zip(conds, one_conds):
                plan = items.filter(cond).select("l_orderkey", "l_shipdate", "l_quantity")
                text = Hyperspace(sess).explain(plan).split("Plan without indexes:")[0]
                if f"Name: {name}" not in text:
                    raise AssertionError(f"{label}: a filter not served by {name}")
                got = sorted_rows(plan.collect())
                ref = sorted_rows(base.filter(one_cond).select(
                    "l_orderkey", "l_shipdate", "l_quantity").collect())
                if not got.equals(ref):
                    raise AssertionError(f"{label}: filter rows differ from phase 4's session")
                rows += got.num_rows
            cross[label] = {"queries": len(conds), "rows": rows}
            log(f"sharded path [{card}]: {name} {label}: {len(conds)} filters equal to phase 4's "
                f"session's rows ({rows} rows)")
        out["cross_mesh"] = cross
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        # (6) the two-process dryrun
        t0 = time.perf_counter()
        text, _ = dryrun.communicate(timeout=300)
        hashes = re.findall(r"create_content=(\w+)", text)
        log(f"sharded path [{card}]: two processes on the one card over gloo (NCCL refuses two "
            f"ranks on one GPU; gloo stages CUDA tensors through host memory): exit "
            f"{dryrun.returncode}, waited {time.perf_counter() - t0:.1f}s at the end\n"
            + text.strip())
        if dryrun.returncode != 0 or text.count("DRYRUN-OK") != 2 or len(set(hashes)) != 1:
            raise AssertionError("the two-process dryrun on the card failed")
        out["two_process"] = {"exit": dryrun.returncode, "content": hashes[0],
                              "ok_lines": text.count("DRYRUN-OK")}
    finally:
        kernels.label = None
        kernels.record_b4(False)
        kernels.record_b8(False)
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()
        shutil.rmtree(os.path.join(work, "sh_indexes"), ignore_errors=True)
    for kernel in ("bucket_exchange_pack", "bucket_exchange_order", "murmur3_bucket_ids",
                   "bucket_match_pairs"):
        if launches[kernel] <= 0:
            raise AssertionError(f"phase 18 launched no {kernel}")
    out["held"] = kernels.summary("phase 18", (
        ("b8a", "sharded create sh_flat"), ("b8b", "sharded create sh_flat"),
        ("b1", "sharded create sh_flat"), ("b4", "sharded join sequential"),
        ("b4", "sharded join streamed")))
    out["launches"] = launches
    out["keep"] = keep
    out["seconds"] = time.perf_counter() - t_phase
    log(f"sharded path [{card}]: phase launches {launches}; {out['seconds']:.1f}s in all")
    return out


# -- phase 19: SQL, tracing, the query log and the profiler ---------------------

#: phase 19's timed rounds a mode (tracing off, then on, in turns)
OBS_ROUNDS = 5
#: phase 19's queries that read a column no index covers (phase 8 serves
#: them from the source too)
SQL_SOURCE_SERVED = ("b", "c", "e_top", "e_stream")


def sql_queries(F, items, orders) -> list:
    """Phase 19's queries: ``(label, kind, SQL, DataFrame)``, the
    DataFrame the same query through the DataFrame API over ``items``
    (lineitem) and ``orders``: phase 4's 32 point and 4 IN filters, phase
    5's join and phase 8's queries a-e (TPC-H Q18's shape; a projection
    where the SQL's select list names a group column, which the SQL
    surface writes as one)."""
    point_keys, in_lists = phase4_keys()
    cols = ("l_orderkey", "l_shipdate", "l_quantity")
    sel = ", ".join(cols)
    key, qty, ship = items["l_orderkey"], items["l_quantity"], items["l_shipdate"]
    out = []
    for i, k in enumerate(point_keys):
        out.append((f"point {i}", "filter", f"SELECT {sel} FROM lineitem WHERE l_orderkey = {k}",
                    items.filter(key == k).select(*cols)))
    for i, keys in enumerate(in_lists):
        out.append((f"in {i}", "filter",
                    f"SELECT {sel} FROM lineitem WHERE l_orderkey IN ({', '.join(map(str, keys))})",
                    items.filter(key.isin(keys)).select(*cols)))
    out.append(("join", "join",
                "SELECT o_orderkey, o_custkey, l_quantity FROM orders "
                "JOIN lineitem ON o_orderkey = l_orderkey",
                orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"]).select(
                    "o_orderkey", "o_custkey", "l_quantity")))
    window = items.filter((key >= AGG_LO) & (key < AGG_HI))
    where = f"WHERE l_orderkey >= {AGG_LO} AND l_orderkey < {AGG_HI}"
    b_aggs = [F.count(), F.sum("l_extendedprice")]
    out += [
        ("a", "agg", "SELECT COUNT(*), SUM(l_quantity), AVG(l_quantity), MIN(l_shipdate), "
         f"MAX(l_shipdate) FROM lineitem {where}",
         window.agg(F.count(), F.sum("l_quantity"), F.avg("l_quantity"), F.min("l_shipdate"),
                    F.max("l_shipdate"))),
        ("b", "agg", f"SELECT l_quantity, COUNT(*), SUM(l_extendedprice) FROM lineitem {where} "
         "GROUP BY l_quantity",
         window.group_by("l_quantity").agg(*b_aggs).select(
             "l_quantity", *[s.name for s in b_aggs])),
        ("c", "agg", "SELECT SUM(l_extendedprice), MIN(l_extendedprice), MAX(l_extendedprice) "
         "FROM lineitem",
         items.agg(F.sum("l_extendedprice"), F.min("l_extendedprice"),
                   F.max("l_extendedprice"))),
        ("d", "agg", "SELECT l_orderkey, SUM(l_quantity) AS q FROM lineitem GROUP BY l_orderkey "
         "ORDER BY q DESC, l_orderkey LIMIT 100",
         items.group_by("l_orderkey").agg(F.sum("l_quantity").alias("q"))
         .select("l_orderkey", "q").sort(("q", False), "l_orderkey").limit(100)),
        ("e_top", "agg", f"SELECT * FROM lineitem WHERE l_shipdate < DATE '{E_SHIP_CUTOFF}' "
         "ORDER BY l_extendedprice DESC LIMIT 10",
         items.filter(ship < np.datetime64(E_SHIP_CUTOFF)).sort(("l_extendedprice", False))
         .limit(10)),
        ("e_stream", "agg", "SELECT * FROM lineitem WHERE l_quantity = 7 LIMIT 1000",
         items.filter(qty == 7).limit(1000)),
    ]
    return out


def profile_check(sess, sql_texts, trace_dir: str) -> dict:
    """Phase 19's profiler leg, in this process after every phase before
    it: ``hyperspace.profile.traceDir`` set on ``sess``, each SQL query in
    ``sql_texts`` once, one Chrome trace a query. On a CUDA session the
    traces' kernel events must name B1 (``murmur3_bucket_kernel``) and B4
    (``count_kernel``, ``emit_kernel``), every kernel launch of the queries
    must have its device event (``session.launches_without_kernels``,
    which leaves out the session's pads) and the session must have
    warned of none. Returns the files, seconds, the kernel names found, the
    launches without a kernel event, the warnings and the events'
    categories."""
    import collections
    import warnings

    from hyperspace_tpu_torch.session import launches_without_kernels

    sess.conf.set("hyperspace.profile.traceDir", trace_dir)
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for text in sql_texts:
                sess.sql(text).collect()
    finally:
        sess.conf.set("hyperspace.profile.traceDir", "")
    profile_s = time.perf_counter() - t0
    warned = [str(w.message) for w in seen if "torch.profiler kept no device event" in
              str(w.message)]
    names, cats, missing = set(), collections.Counter(), {}
    files = sorted(os.listdir(trace_dir))
    for name in files:
        path = os.path.join(trace_dir, name)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        cats.update(e.get("cat") for e in events)
        names |= {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        missing[name] = launches_without_kernels(path)
    want = {"B1": ("murmur3_bucket_kernel",), "B4": ("count_kernel", "emit_kernel")}
    found = {k: sorted(n for n in names if any(x in n for x in subs)) for k, subs in want.items()}
    out = {"files": len(files), "s": round(profile_s, 3), "kernels": found,
           "launches_without_kernel": missing, "warnings": warned,
           "categories": {str(k): v for k, v in cats.items()}}
    log(f"obs path: profiler traces {files} ({profile_s:.2f}s, in this process): kernel "
        f"events naming B1 {found['B1']} and B4 {found['B4']}; launches without a kernel "
        f"event {missing}; warnings {warned}; event categories {out['categories']}")
    cuda = sess.device.type == "cuda"
    if len(files) != len(sql_texts) or (cuda and (
            not (found["B1"] and len(found["B4"]) >= 2) or any(missing.values()) or warned)):
        raise AssertionError(f"profiler trace: {files}, kernel events {found}, launches "
                             f"without a kernel event {missing}, warnings {warned}")
    return out


def obs_sql_path(work: str, ctx: dict, kernels: KernelCalls, b5_inputs: B5Inputs,
                 card: str) -> dict:
    """Phase 19: the SQL surface, tracing, the query log, an action's root
    span and the profiler over phases 4 and 5's session (li_idx, li_rg_idx,
    o_idx; lineitem and orders registered as views). Launch counts read
    from 0 at its start."""
    import math

    import torch

    from hyperspace_tpu_torch import CoveringIndexConfig, functions as F
    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.obs import metrics, querylog, trace
    from hyperspace_tpu_torch.testing import replay

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5_cases import same_rows

    t_phase = time.perf_counter()
    sess, hs, items = ctx["session"], ctx["hs"], ctx["items"]
    orders = sess.read.parquet(ctx["orders_src"])
    items.create_or_replace_temp_view("lineitem")
    orders.create_or_replace_temp_view("orders")
    sess.enable_hyperspace()
    ops.reset_launch_counts()
    queries = sql_queries(F, items, orders)
    out = {"card": card}

    # 1. SQL against the DataFrame API: the same plans, the same rows
    cuda = sess.device.type == "cuda"
    kernels.record_b3a(True)
    kernels.record_b4(True)
    sql_rows, plans = {}, {}
    before = ops.launch_counts()
    for label, kind, text, df in queries:
        sdf = sess.sql(text)
        if sdf.logical_plan.pretty() != df.logical_plan.pretty():
            raise AssertionError(f"sql {label}: the plan differs from the DataFrame API's:\n"
                                 f"{sdf.logical_plan.pretty()}\n{df.logical_plan.pretty()}")
        opt = sess.optimize(sdf.logical_plan)
        if opt.pretty() != sess.optimize(df.logical_plan).pretty():
            raise AssertionError(f"sql {label}: the optimized plan differs from the DataFrame "
                                 f"API's")
        plans[label] = querylog.indexes_in_plan(opt)
        # b, c and e read l_extendedprice, which no index of the session
        # covers: they read the source through either API, as in phase 8
        if not plans[label] and label not in SQL_SOURCE_SERVED:
            raise AssertionError(f"sql {label}: not index-served:\n{opt.pretty()}")
        kernels.label = f"sql {kind}"
        b5_inputs.label = f"sql {label}" if kind == "agg" else None
        sql_rows[label] = sdf.collect()
        kernels.label = b5_inputs.label = None
    after = ops.launch_counts()
    sql_launches = {k: after[k] - before[k] for k in after}
    kernels.record_b3a(False)
    kernels.record_b4(False)
    for label, kind, _text, df in queries:
        want = df.collect()
        # a point key may match no row (phase 4's keys are drawn at random)
        if (kind != "filter" and sql_rows[label].num_rows == 0) or not same_rows(
                sql_rows[label], want):
            raise AssertionError(f"sql {label}: rows differ from the DataFrame API's")
    if not sum(sql_rows[lab].num_rows for lab, kind, _t, _d in queries if kind == "filter"):
        raise AssertionError("no SQL filter matched a row")
    need = ("murmur3_bucket_ids", "range_mask", "bucket_match_pairs", "segment_reduce")
    if cuda and not all(sql_launches[k] > 0 for k in need):
        raise AssertionError(f"SQL did not launch B1, B3a, B4 and B5: {sql_launches}")
    kernels.settle()
    held = kernels.summary("phase 19 (SQL)", required=(
        [("b1", "sql filter"), ("b3a", "sql filter"), ("b4", "sql join")] if cuda else ()))
    sql_b5 = {k: b5_inputs.calls.pop(k) for k in list(b5_inputs.calls) if k.startswith("sql ")}
    b5_calls = check_b5_main_path(sql_b5, "phase 19's SQL")[0] if cuda else 0
    if cuda and not b5_calls:
        raise AssertionError("phase 19's SQL aggregates made no B5 call")
    held["b5"] = b5_calls
    out["sql"] = {"queries": len(queries), "launches": {k: sql_launches[k] for k in need},
                  "held": held, "indexes": {k: v for k, v in plans.items()
                                            if not k.startswith(("point", "in "))}}
    log(f"obs path: {len(queries)} SQL queries (36 filters, the join, a-e) equal to the "
        f"DataFrame API's in plan, optimized plan and rows (floats bit for bit); indexes "
        f"{ {k: v for k, v in plans.items() if not k.startswith(('point', 'in '))} }; SQL launches B1 {sql_launches['murmur3_bucket_ids']}, B3a "
        f"{sql_launches['range_mask']}, B4 {sql_launches['bucket_match_pairs']}, B5 "
        f"{sql_launches['segment_reduce']}; calls held {held}")

    # 2. tracing off and on, in turns, through the session's serve frontend
    # (made with tracing on, so it opens the query log); the log's replay
    sess.conf.set("hyperspace.obs.enabled", True)
    sess.conf.set("hyperspace.obs.querylog.recordPlans", True)
    fe = sess.serve_frontend
    obs_dir = querylog.obs_root(sess.conf)
    filters = [(lab, df) for lab, kind, _t, df in queries if kind == "filter"]
    join_df = next(df for lab, _k, _t, df in queries if lab == "join")
    times = {False: {"filter": [], "join": []}, True: {"filter": [], "join": []}}
    traced, checked = [], 0
    frontend_stages = ("queue_wait", "pin", "rewrite", "execute", "agg")
    for rnd in range(OBS_ROUNDS * 2):
        on = rnd % 4 in (1, 2)  # off, on, on, off, off, on, ...
        sess.conf.set("hyperspace.obs.enabled", on)
        trace.configure(sess.conf)
        for kind, runs in (("filter", filters), ("join", [("join", join_df)])):
            for label, df in runs:
                # one client: the session's breakdown is this query's alone
                sess.join_stats = {}
                t0 = time.perf_counter()
                got = fe.serve(df)
                times[on][kind].append((time.perf_counter() - t0) * 1e3)
                if not same_rows(got, sql_rows[label]):
                    raise AssertionError(f"{label}: rows differ with tracing {on}")
                if on:
                    root = trace.finished("serve.query")[-1]
                    spans = {k: v for k, v in root.stage_seconds().items()
                             if k not in frontend_stages}
                    stats = sess.join_stats
                    if set(spans) != set(stats) or any(
                            not math.isclose(spans[k], v, rel_tol=1e-9, abs_tol=1e-12)
                            for k, v in stats.items()):
                        raise AssertionError(f"{label}: stage spans {spans} differ from the "
                                             f"session's breakdown {stats}")
                    if not {"queue_wait", "pin", "rewrite", "execute"} <= set(
                            root.stage_seconds()) or root.attrs.get("status") != "ok":
                        raise AssertionError(f"{label}: the frontend's root {root.to_dict()}")
                    traced.append(label)
                    checked += len(stats)
    sess.conf.set("hyperspace.obs.enabled", False)
    trace.configure(sess.conf)
    fe_stats = fe.stats()
    if fe_stats["failed"] or fe_stats["completed"] != len(traced) * 2:
        raise AssertionError(f"phase 19's frontend: {fe_stats}")
    turns = {}
    for on in (False, True):
        fp = np.percentile(times[on]["filter"], [50, 99])
        turns["on" if on else "off"] = {
            "filter_p50_ms": float(fp[0]), "filter_p99_ms": float(fp[1]),
            "join_p50_ms": float(np.median(times[on]["join"])),
            "runs": {k: len(v) for k, v in times[on].items()}}
    records = querylog.read_valid_records(obs_dir)
    bad = [querylog.validate_record(r) for r in records if querylog.validate_record(r)]
    if len(records) != len(traced) or bad:
        raise AssertionError(f"query log: {len(records)} records for {len(traced)} traced "
                             f"queries, invalid: {bad[:3]}")
    t0 = time.perf_counter()
    res = replay.replay_records(sess, records, keep_results=True)
    replay_s = time.perf_counter() - t0
    if res.completed != len(records) or res.failed or res.skipped:
        raise AssertionError(f"replay: {res.to_dict()}")
    for label, got in zip(traced, res.tables):
        if not same_rows(got, sql_rows[label]):
            raise AssertionError(f"replayed {label}: rows differ from the original query's")
    out["turns"] = turns
    out["querylog"] = {"records": len(records), "replayed": res.completed,
                       "replay_s": round(replay_s, 3), "stage_keys_checked": checked,
                       "frontend": {k: fe_stats[k] for k in ("admitted", "completed", "deduped",
                                                             "failed")}}
    log(f"obs path: tracing off / on in turns x{OBS_ROUNDS}: filters p50 "
        f"{turns['off']['filter_p50_ms']:.3f} / {turns['on']['filter_p50_ms']:.3f} ms, p99 "
        f"{turns['off']['filter_p99_ms']:.3f} / {turns['on']['filter_p99_ms']:.3f} ms, join "
        f"p50 {turns['off']['join_p50_ms']:.3f} / {turns['on']['join_p50_ms']:.3f} ms; every "
        f"traced query's stage spans equal the session's join breakdown ({checked} stage "
        f"values); {len(records)} query-log records valid, all replayed with the original "
        f"rows in {replay_s:.2f}s; {card}")

    # 3. one action's root span and its event
    events = os.path.join(work, "obs_events.jsonl")
    sess.conf.set("hyperspace.eventLoggerClass", "hyperspace_tpu_torch.telemetry.JsonlEventLogger")
    sess.conf.set("hyperspace.obs.eventlog.path", events)
    sess.conf.set("hyperspace.obs.enabled", True)
    trace.reset()
    t0 = time.perf_counter()
    hs.create_index(orders, CoveringIndexConfig("obs_idx", ["o_custkey"], ["o_totalprice"]))
    create_s = time.perf_counter() - t0
    sess.conf.set("hyperspace.obs.enabled", False)
    sess.conf.set("hyperspace.eventLoggerClass", "")
    trace.configure(sess.conf)
    (root,) = trace.finished("action.CreateAction")
    spans = root.stage_seconds()
    timed = {k: v for k, v in sess.build_stats.items()
             if not k.startswith("sidecar_capture_") and k not in ("tail_wall", "tail_shards")}
    if root.attrs.get("status") != "ok" or "log_commit" not in spans or any(
            not math.isclose(spans.get(k, -1.0), v, rel_tol=1e-9, abs_tol=1e-12)
            for k, v in timed.items()) or set(spans) - {"log_commit", "pack", "exchange",
                                                         "unpack"} != set(timed):
        raise AssertionError(f"obs_idx: spans {spans} differ from build_stats {timed}")
    evs = [r for r in metrics.read_jsonl(events) if r.get("event") == "CreateActionEvent"]
    if [r["index_name"] for r in evs] != ["obs_idx"]:
        raise AssertionError(f"obs_idx: event log {evs}")
    out["action"] = {"create_s": round(create_s, 3),
                     "spans_s": {k: round(v, 4) for k, v in spans.items()}}
    log(f"obs path: obs_idx created in {create_s:.3f}s under one root span; its stage spans "
        f"equal build_stats, log_commit {spans['log_commit']:.4f}s; CreateActionEvent in the "
        f"JSONL event log")

    # 4. the profiler trace: B1's and B4's CUDA symbols as kernel events
    out["profile"] = profile_check(
        sess, [queries[0][2], next(t for lab, _k, t, _d in queries if lab == "join")],
        os.path.join(work, "profile"))
    out["launches"] = ops.launch_counts()
    out["seconds"] = round(time.perf_counter() - t_phase, 1)
    torch.cuda.synchronize() if cuda else None
    return out


# -- phase 20: the serve tier ---------------------------------------------------

#: phase 20's client counts through the serve frontend
SERVE_CLIENTS = (1, 8, 64)
#: timed rounds of the 36 filters served directly (the frontend off)
SERVE_DIRECT_ROUNDS = 3
#: rows of the fleet harness's lake (its two worker processes on the card)
FLEET_ROWS = 1_000_000
#: the name prefix of the serve frontend's worker threads: the recorders
#: count a kernel call as the frontend's where its thread's name has it
SERVE_THREADS = "hs-serve"
#: the kernels phase 20 must see called from those threads and from the fleet
#: harness's worker processes: (recorder kind, launch counter)
SERVE_KERNELS = (("b1", "murmur3_bucket_ids"), ("b3a", "range_mask"),
                 ("b4", "bucket_match_pairs"), ("b5f", "fused_filter_agg"),
                 ("b5", "segment_reduce"))
#: the filters each client serves after the lifecycle writer ends (phase 20's
#: snapshot-pin window), and a client's pause between two of them there (the
#: writer's refresh shares the host's interpreter with the clients)
SERVE_AFTER_WRITER = 4
SERVE_THINK_S = 0.2


def sv_filters(items) -> list:
    """Phase 4's 32 point and 4 IN-list filters over ``items``."""
    point_keys, in_lists = phase4_keys()
    key = items["l_orderkey"]
    cols = ("l_orderkey", "l_shipdate", "l_quantity")
    return ([items.filter(key == k).select(*cols) for k in point_keys]
            + [items.filter(key.isin(keys)).select(*cols) for keys in in_lists])


def sv_joins(items, orders) -> list:
    """Phase 5's join with four projections (distinct plans, so they do
    not coalesce)."""
    j = orders.join(items, on=orders["o_orderkey"] == items["l_orderkey"])
    return [j.select(*cols) for cols in (("o_orderkey", "o_custkey", "l_quantity"),
                                         ("o_orderkey", "l_quantity"),
                                         ("o_custkey", "l_quantity"),
                                         ("o_orderkey", "o_custkey"))]


def sv_clients(fn, n_clients: int, per_client: int, name: str = "sv-client") -> tuple:
    """``fn(client, j)`` for ``j`` in ``range(per_client)`` on ``n_clients``
    threads released from one barrier; returns (each call's ms, the wall
    seconds from the release to the last return). The first exception a
    client raises is raised here."""
    barrier = threading.Barrier(n_clients + 1)
    lock, lat, errors = threading.Lock(), [], []

    def client(c):
        barrier.wait()
        try:
            for j in range(per_client):
                t0 = time.perf_counter()
                fn(c, j)
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    lat.append(dt)
        except BaseException as e:  # reported by the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), name=f"{name}-{c}")
               for c in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return lat, wall


def sv_latency(lat: list, wall: float) -> dict:
    p50, p99 = np.percentile(lat, [50, 99])
    return {"queries": len(lat), "p50_ms": float(p50), "p99_ms": float(p99),
            "qps": len(lat) / wall, "wall_s": wall}


def sv_delta(fe, before: dict) -> dict:
    """The frontend's counters moved since ``before``."""
    now = fe.stats()
    return {k: now[k] - before[k] for k in ("admitted", "completed", "deduped", "shed", "retries",
                                            "degraded", "failed")}


def sv_batch(path: str, order_keys, seed: int) -> int:
    """An RF1-sized lineitem batch written outside ``path``'s directory and
    renamed in (a listing never sees it torn): 1-7 lines for each of
    ``order_keys``, the other columns drawn as ``lc_batch`` draws them."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    keys = np.repeat(np.asarray(order_keys, dtype=np.int64), rng.integers(1, 8, len(order_keys)))
    n = len(keys)
    ship = np.datetime64("1994-01-01") + rng.integers(0, 2400, n).astype("timedelta64[D]")
    tmp = os.path.join(os.path.dirname(os.path.dirname(path)), "." + os.path.basename(path))
    pq.write_table(pa.table({
        "l_orderkey": keys,
        "l_shipdate": pa.array(ship.astype("datetime64[D]")),
        "l_quantity": rng.integers(1, 51, n, dtype=np.int64),
        "l_extendedprice": rng.normal(30000, 8000, n),
    }), tmp)
    os.rename(tmp, path)
    return n


def serve_path(work: str, ctx: dict, kernels: KernelCalls, b5_inputs: B5Inputs,
               card: str) -> dict:
    """Phase 20: the serve tier over phase 4's li_idx and phase 5's o_idx
    (the session of phases 4-19, on the card). (1) Phase 4's 36 filters
    served directly (``collect()``, the frontend off, one client,
    SERVE_DIRECT_ROUNDS rounds), then through ``session.serve_frontend``
    from 1, 8 and 64 client threads, each client every filter once from its
    own starting point: p50, p99 and queries a second; every answer equal
    in order to the direct one. (2) Single-flight: 8 submits of phase 5's
    join released from one barrier onto a fresh frontend whose execution
    is gated until all 8 are in: one execution, ``deduped`` 7, 8 equal
    answers. (3) Phase 8's a-d from 8 clients. (4) SLO classes: a frontend
    with ``hyperspace.fleet.class.batch.maxConcurrency`` 1 and
    ``.maxQueueDepth`` 2; four distinct joins submitted as ``batch`` (the
    first gated) while 8 clients serve the filters unclassed: two admitted
    and answered, two shed with ``ServeOverloadedError`` naming the class.
    (5) Snapshot pins: 8 clients serve the filters (pausing SERVE_THINK_S
    between two), while a writer appends an RF1-sized batch holding phase
    4's keys, refreshes li_idx incrementally and vacuums it; a client serves
    the listing it started from until the refresh commits, then lists the
    lake anew: every answer equals the direct answer over the file list it
    read, before or after, never a mix. (6) Faults:
    a transient ``parquet_read`` (retried), a persistent one on the index
    files (degraded to the source), a ``KernelLaunchError`` from B1
    (failed, neither retried nor degraded). (7) Two ``FleetFrontend``
    sessions over phase 4's system path, the fast plane off: one claim and
    one spool hit for one plan; a refresh from the first reaches the second
    over the bus. (8) ``fleet_harness.run_fleet`` on the card: 2 processes
    over a lake of FLEET_ROWS rows with bucket-pruned filters, owner
    routing off (the claim/spool single-flight), then the kill -9 rung with
    the fast plane's probes; each rung's workers must have launched B1.
    Every B1, B3a, B4 and B5f call under the frontend is recorded in
    ``kernels`` and held to its plain version after its window, every B5
    call through ``b5_inputs``; the calls from the frontend's ``hs-serve-*``
    threads are counted apart. Launch counts read from 0 at its start."""
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch import functions as F
    from hyperspace_tpu_torch.exceptions import ServeOverloadedError
    from hyperspace_tpu_torch.kernels import KernelLaunchError
    from hyperspace_tpu_torch.ops import hash as H
    from hyperspace_tpu_torch.serve import ServeFrontend
    from hyperspace_tpu_torch.testing import faults, fleet_harness

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_b5_cases import same_rows

    t_phase = time.perf_counter()
    sess, hs, src = ctx["session"], ctx["hs"], ctx["src"]
    items = sess.read.parquet(src)
    orders = sess.read.parquet(ctx["orders_src"])
    sess.enable_hyperspace()
    cuda = sess.device.type == "cuda"
    sess.serve_frontend.close()  # phase 19's: this phase's counters start at 0
    ops.reset_launch_counts()
    out = {"card": card}
    window_launches = {}
    kernels.serve_calls, b5_inputs.serve_calls = {}, 0

    def frontend_window(label, fn):
        """``fn()`` with the kernels' calls recorded under ``label``, then
        held to their plain versions. Its launches, from every thread of
        the process (the snapshot-pin window's writer too), add to
        ``window_launches``; the recorders count the calls from the
        frontend's threads."""
        before = ops.launch_counts()
        kernels.label = b5_inputs.label = label
        try:
            res = fn()
            if cuda:
                torch.cuda.synchronize()
        finally:
            kernels.label = b5_inputs.label = None
        after = ops.launch_counts()
        for k in after:
            window_launches[k] = window_launches.get(k, 0) + after[k] - before[k]
        kernels.settle()
        return res

    kernels.record_b3a(True)
    kernels.record_b4(True)
    try:
        # 1. the 36 filters, direct and through the frontend at 1, 8, 64 clients
        filters = sv_filters(items)
        truth = [q.collect() for q in filters]
        lat = []
        t0 = time.perf_counter()
        for _ in range(SERVE_DIRECT_ROUNDS):
            for i, q in enumerate(filters):
                t1 = time.perf_counter()
                got = q.collect()
                lat.append((time.perf_counter() - t1) * 1e3)
                if not same_rows(got, truth[i]):
                    raise AssertionError(f"filter {i}: a direct run's rows differ")
        direct = sv_latency(lat, time.perf_counter() - t0)
        if not sum(t.num_rows for t in truth):
            raise AssertionError("no filter matched a row")
        fe = sess.serve_frontend
        if not isinstance(fe, ServeFrontend) or fe.closed:
            raise AssertionError(f"session.serve_frontend is {fe!r}")
        rounds = {}
        for n in SERVE_CLIENTS:
            before = fe.stats()

            def serve_filter(c, j):
                i = (c * 5 + j) % len(filters)
                if not same_rows(fe.serve(filters[i]), truth[i]):
                    raise AssertionError(f"filter {i}: the frontend's rows differ ({n} clients)")

            lat, wall = frontend_window(f"serve filters, {n} clients",
                                        lambda: sv_clients(serve_filter, n, len(filters)))
            rounds[n] = {**sv_latency(lat, wall), **sv_delta(fe, before)}
            log(f"serve path [{card}]: {n} clients x 36 filters through the frontend: p50 "
                f"{rounds[n]['p50_ms']:.3f} ms, p99 {rounds[n]['p99_ms']:.3f} ms, "
                f"{rounds[n]['qps']:.1f} queries/s; counters {sv_delta(fe, before)}")
        log(f"serve path [{card}]: the 36 filters served directly ({SERVE_DIRECT_ROUNDS} "
            f"rounds, one client, the frontend off): p50 {direct['p50_ms']:.3f} ms, p99 "
            f"{direct['p99_ms']:.3f} ms, {direct['qps']:.1f} queries/s")
        out["filters"] = {"direct": direct, "clients": rounds}

        # 2. single-flight: 8 submits of the join from one barrier
        join_df = sv_joins(items, orders)[0]
        index_served(hs, join_df, ("o_idx", "li_idx"))
        join_truth = join_df.collect()
        import hyperspace_tpu_torch.execution as X

        real_execute, gate, runs = X.execute, threading.Event(), []

        def gated(plan, session=None):
            runs.append(1)
            gate.wait(60)
            return real_execute(plan, session)

        fe_sf = ServeFrontend(sess)
        futs, lock = [], threading.Lock()

        def submit(c, j):
            f = fe_sf.submit(join_df)
            with lock:
                futs.append(f)

        X.execute = gated
        try:
            def single_flight():
                sv_clients(submit, 8, 1, "sv-submit")
                gate.set()
                return [f.result(120) for f in futs]

            joined = frontend_window("serve join, single-flight", single_flight)
        finally:
            X.execute = real_execute
            gate.set()
        sf = fe_sf.stats()
        fe_sf.close()
        if sf["deduped"] != 7 or sf["admitted"] != 1 or len(runs) != 1 or sf["failed"] or \
                len({id(f) for f in futs}) != 1 or not all(same_rows(t, join_truth) for t in joined):
            raise AssertionError(f"single-flight: {sf}, executions {len(runs)}")
        out["single_flight"] = {k: sf[k] for k in ("admitted", "completed", "deduped", "failed")}
        log(f"serve path [{card}]: 8 submits of the join from one barrier: 1 execution, "
            f"deduped {sf['deduped']}, 8 answers equal to the direct join's {join_truth.num_rows} "
            f"rows")

        # 3. phase 8's aggregates a-d from 8 clients
        aggs = {k: v for k, v in aggregate_queries(F, items).items() if k in ("a", "b", "c", "d")}
        labels = sorted(aggs)
        agg_truth = {k: aggs[k].collect() for k in labels}
        before = fe.stats()

        def serve_agg(c, j):
            k = labels[(c + j) % len(labels)]
            if not same_rows(fe.serve(aggs[k]), agg_truth[k]):
                raise AssertionError(f"aggregate {k}: the frontend's rows differ")

        lat, wall = frontend_window("serve aggregates", lambda: sv_clients(serve_agg, 8, 4))
        out["aggregates"] = {**sv_latency(lat, wall), **sv_delta(fe, before)}
        b5_recorded = {"serve aggregates": b5_inputs.calls.pop("serve aggregates", [])}
        b5_calls = check_b5_main_path(b5_recorded, "phase 20's aggregates")[0] if cuda else 0
        del b5_recorded
        if cuda and not b5_calls:
            raise AssertionError("phase 20's aggregates made no B5 call")
        out["aggregates"]["b5_calls_held"] = b5_calls
        log(f"serve path [{card}]: a-d from 8 clients: p50 {out['aggregates']['p50_ms']:.3f} ms, "
            f"{out['aggregates']['qps']:.1f} queries/s; rows equal to direct; B5 calls held "
            f"{b5_calls}")

        # 4. SLO classes: batch joins beside unclassed filters
        prefix = C.FLEET_CLASS_KEY_PREFIX + "batch."
        sess.conf.set(prefix + "maxConcurrency", 1)
        sess.conf.set(prefix + "maxQueueDepth", 2)
        fe_slo = ServeFrontend(sess)
        sess.conf.set(prefix + "maxConcurrency", 0)
        sess.conf.set(prefix + "maxQueueDepth", 0)
        joins = sv_joins(items, orders)
        slo_gate = threading.Event()
        gated_plan = joins[0].logical_plan
        real_pinned = fe_slo._execute_pinned

        def slo_pinned(plan, pin):
            if plan is gated_plan:
                slo_gate.wait(60)
            return real_pinned(plan, pin)

        fe_slo._execute_pinned = slo_pinned
        shed, stop = [], threading.Event()

        def slo_window():
            def filter_client(c, j):
                i = (c * 7 + j) % len(filters)
                if not same_rows(fe_slo.serve(filters[i]), truth[i]):
                    raise AssertionError(f"filter {i}: rows differ beside the batch class")

            box = {}
            clients = threading.Thread(target=lambda: box.update(
                r=sv_clients(filter_client, 8, len(filters), "sv-slo")))
            clients.start()
            admitted = [fe_slo.submit(joins[0], slo_class="batch"),
                        fe_slo.submit(joins[1], slo_class="batch")]
            for q in joins[2:]:
                try:
                    fe_slo.submit(q, slo_class="batch")
                except ServeOverloadedError as e:
                    shed.append(str(e))
            slo_gate.set()
            answers = [f.result(120) for f in admitted]
            clients.join()
            return answers, box["r"]

        try:
            answers, (lat, wall) = frontend_window("serve SLO classes", slo_window)
        finally:
            slo_gate.set()
        slo = fe_slo.stats()
        fe_slo.close()
        batch = slo["slo_classes"]["batch"]
        if len(shed) != 2 or not all("'batch'" in m for m in shed) or batch["shed"] != 2 or \
                batch["admitted"] != 2 or slo["failed"]:
            raise AssertionError(f"SLO classes: shed {shed}, stats {slo}")
        for got, q in zip(answers, joins[:2]):
            if not same_rows(got, q.collect()):
                raise AssertionError("an admitted batch join's rows differ from the direct join's")
        out["slo"] = {"batch": batch, "shed_messages": shed[:1], "filters": sv_latency(lat, wall),
                      "failed": slo["failed"]}
        log(f"serve path [{card}]: SLO class batch (maxConcurrency 1, maxQueueDepth 2): 2 joins "
            f"admitted and equal to direct, 2 shed ({shed[0]!r}); 8 unclassed filter clients "
            f"beside it p50 {out['slo']['filters']['p50_ms']:.3f} ms")

        # 5. snapshot pins: append, refresh, vacuum while 8 clients serve
        point_keys, in_lists = phase4_keys()
        batch_keys = sorted(set(point_keys) | {k for ks in in_lists for k in ks})
        batch_keys += list(range(N_ORDERS + 5_000_000,
                                 N_ORDERS + 5_000_000 + RF1_ORDERS - len(batch_keys)))
        files0 = tuple(items.logical_plan.relation.files)
        served, served_lock, writer_done = [], threading.Lock(), threading.Event()
        refreshed, listing = threading.Event(), {}
        after_writer = {}
        before = fe.stats()

        def pin_client(c, j):
            while True:
                # a client lists the lake anew once the refresh has committed
                # (its view advances with the index); before, it serves the
                # listing it started from
                df = listing["after"] if refreshed.is_set() else items
                i = (c * 3 + j) % len(filters)
                q = sv_filters(df)[i]
                got = fe.serve(q)
                with served_lock:
                    served.append((tuple(df.logical_plan.relation.files), i, got))
                    if writer_done.is_set():
                        after_writer[c] = after_writer.get(c, 0) + 1
                        if after_writer[c] >= SERVE_AFTER_WRITER:
                            return
                j += 1
                time.sleep(SERVE_THINK_S)

        def writer():
            t0 = time.perf_counter()
            rows = sv_batch(os.path.join(src, "rf1_serve.parquet"), batch_keys, SEED + 60)
            sess.index_manager.clear_cache()
            hs.refresh_index("li_idx", "incremental")
            listing["after"] = sess.read.parquet(src)
            refreshed.set()
            hs.vacuum_index("li_idx")
            writer_done.set()
            return rows, time.perf_counter() - t0

        def pins_window():
            box = {}
            w = threading.Thread(target=lambda: box.update(r=writer()))
            clients = threading.Thread(target=lambda: box.update(
                c=sv_clients(pin_client, 8, 1, "sv-pin")))
            clients.start()
            time.sleep(0.2)  # the clients are serving when the batch lands
            w.start()
            w.join()
            clients.join()
            if "r" not in box or "c" not in box:
                raise AssertionError("the snapshot-pin window's writer or clients failed")
            return box["r"]

        (batch_rows, writer_s) = frontend_window("serve snapshot pins", pins_window)
        pins = sv_delta(fe, before)
        items1 = sess.read.parquet(src)
        files1 = tuple(items1.logical_plan.relation.files)
        truth1 = [q.collect() for q in sv_filters(items1)]
        counts = {"before": 0, "after": 0}
        for files, i, got in served:
            if files == files0:
                want, kind = truth[i], "before"
            elif files == files1:
                want, kind = truth1[i], "after"
            else:
                raise AssertionError(f"a served query read an unexpected file list ({len(files)})")
            # as a multiset: between the append and the refresh's commit the
            # new file list is served from the source, in its own row order
            if not same_rows(sorted_rows(got), sorted_rows(want)):
                raise AssertionError(f"filter {i}: the answer is neither the truth before the "
                                     f"refresh nor after it ({kind})")
            counts[kind] += 1
        changed = sum(not same_rows(sorted_rows(a), sorted_rows(b)) for a, b in zip(truth, truth1))
        if not changed or pins["failed"]:
            raise AssertionError(f"snapshot pins: {changed} filters changed, counters {pins}")
        out["pins"] = {"answers": counts, "filters_changed": changed, "batch_rows": batch_rows,
                       "writer_s": writer_s, **pins}
        log(f"serve path [{card}]: an RF1-sized batch ({batch_rows} rows over phase 4's keys and "
            f"new ones), li_idx's incremental refresh and vacuum ({writer_s:.2f}s) while 8 "
            f"clients served: {counts['before']} answers equal to the truth before, "
            f"{counts['after']} after ({changed} of 36 filters changed), none mixed; retries "
            f"{pins['retries']}, degraded {pins['degraded']}, failed {pins['failed']}")
        truth, filters, items = truth1, sv_filters(items1), items1

        # 6. faults
        fault = {}
        before = fe.stats()
        faults.set_fault("parquet_read", "transient:1")
        try:
            got = frontend_window("serve fault transient", lambda: fe.serve(filters[0]))
        finally:
            faults.reset()
        fault["transient"] = sv_delta(fe, before)
        if fault["transient"]["retries"] < 1 or not same_rows(got, truth[0]):
            raise AssertionError(f"transient parquet_read: {fault['transient']}")
        before = fe.stats()
        faults.set_fault("parquet_read", "persistent;match=v__=")
        try:
            got = frontend_window("serve fault persistent", lambda: fe.serve(filters[1]))
        finally:
            faults.reset()
        fault["persistent"] = sv_delta(fe, before)
        sess.disable_hyperspace()
        unindexed = filters[1].collect()
        sess.enable_hyperspace()
        if fault["persistent"]["degraded"] < 1 or not same_rows(got, unindexed):
            raise AssertionError(f"persistent parquet_read: {fault['persistent']}")
        before = fe.stats()
        # B1's C entry returns CUDA error 700 (as tests/test_torch_cuda.py
        # injects it); a cpu session has no C entry, so there the wrapper the
        # bucket-pruned filter calls raises what the kernel's would
        from hyperspace_tpu_torch.execution import executor as EX

        def raising(*_a, **_k):
            raise KernelLaunchError("murmur3 bucket kernel launch failed: CUDA error 700")

        site, attr = (H, "_kernel_fn") if cuda else (EX, "bucket_ids")
        real_fn = getattr(site, attr)
        setattr(site, attr, (lambda: (lambda *a: 700)) if cuda else raising)
        try:
            fe.serve(filters[2])
            raise AssertionError("B1's launch error did not fail the query")
        except KernelLaunchError as e:
            fault["kernel_error"] = str(e)
        finally:
            setattr(site, attr, real_fn)
        fault["kernel"] = sv_delta(fe, before)
        if fault["kernel"]["failed"] != 1 or fault["kernel"]["retries"] or \
                fault["kernel"]["degraded"]:
            raise AssertionError(f"B1's launch error: {fault['kernel']}")
        if not same_rows(fe.serve(filters[2]), truth[2]):
            raise AssertionError("the filter after the kernel fault differs")
        out["faults"] = fault
        log(f"serve path [{card}]: faults: transient parquet_read retried "
            f"({fault['transient']['retries']}), persistent on the index files degraded to the "
            f"source ({fault['persistent']['degraded']}), B1's KernelLaunchError failed the "
            f"query (failed +{fault['kernel']['failed']}, retries +0, degraded +0)")
        stats = fe.stats()
        if stats["failed"] != 1:
            raise AssertionError(f"the frontend failed other queries than the faulted one: {stats}")
        out["stats"] = {k: v for k, v in stats.items() if k != "slo_classes"}

        # 7. two fleet frontends in this process over phase 4's system path
        def fleet_session():
            s = HyperspaceSession(device=sess.device)
            for key in ("hyperspace.system.path", "hyperspace.index.filterRule.useBucketSpec"):
                s.conf.set(key, sess.conf.get(key))
            s.conf.set(C.FLEET_ENABLED, True)
            s.conf.set(C.FLEET_FAST_ENABLED, False)
            s.conf.set(C.FLEET_BUS_POLL_MS, 20)
            s.enable_hyperspace()
            return s

        s1, s2 = fleet_session(), fleet_session()
        fe1, fe2 = s1.serve_frontend, s2.serve_frontend
        try:
            def fleet_window():
                a = fe1.serve(sv_filters(s1.read.parquet(src))[3])
                b = fe2.serve(sv_filters(s2.read.parquet(src))[3])
                return a, b

            a, b = frontend_window("serve fleet in one process", fleet_window)
            st1, st2 = fe1.stats()["fleet"], fe2.stats()["fleet"]
            if st1["claims_won"] + st2["claims_won"] != 1 or \
                    st1["spool_hits"] + st2["spool_hits"] != 1 or \
                    not (same_rows(a, truth[3]) and same_rows(b, truth[3])):
                raise AssertionError(f"fleet single-flight: {st1}, {st2}")
            sv_batch(os.path.join(src, "rf1_fleet.parquet"),
                     range(N_ORDERS + 7_000_000, N_ORDERS + 7_000_000 + RF1_ORDERS), SEED + 61)
            t0 = time.perf_counter()
            Hyperspace(s1).refresh_index("li_idx", "incremental")
            refresh_s = time.perf_counter() - t0
            deadline = time.time() + 60
            while fe2.stats()["fleet"]["bus_installed"] < 1 and time.time() < deadline:
                time.sleep(0.02)
            reach_s = time.perf_counter() - t0 - refresh_s
            st2 = fe2.stats()["fleet"]
            if st2["bus_installed"] < 1:
                raise AssertionError(f"the refresh did not reach the second session: {st2}")
        finally:
            fe1.close()
            fe2.close()
        out["fleet_one_process"] = {
            "claims_won": st1["claims_won"] + fe2.stats()["fleet"]["claims_won"],
            "spool_hits": st1["spool_hits"] + st2["spool_hits"],
            "bus_events": st2["bus_events"], "bus_installed": st2["bus_installed"],
            "refresh_s": refresh_s, "bus_after_refresh_s": reach_s}
        log(f"serve path [{card}]: two FleetFrontend sessions over phase 4's system path: one "
            f"claim won, one spool hit, answers equal; a refresh from session 1 ({refresh_s:.2f}s) "
            f"reached session 2 {reach_s:.3f}s after it (bus_installed {st2['bus_installed']})")
    finally:
        kernels.record_b3a(False)
        kernels.record_b4(False)
        faults.reset()
    launches_in_process = ops.launch_counts()

    # 8. the fleet harness: processes on the card
    device = "cuda" if cuda else "cpu"
    root1 = os.path.join(work, "fleet")
    t0 = time.perf_counter()
    # bucket-pruned point filters, as phase 4 serves them: the workers'
    # schedule then launches B1 beside B3a and B5
    pruned = {C.INDEX_FILTER_RULE_USE_BUCKET_SPEC: True}
    rung = fleet_harness.run_fleet(root1, n_procs=2, iters=3, rows=FLEET_ROWS, device=device,
                                   conf={**pruned, C.FLEET_FAST_ROUTING_ENABLED: False})
    rung_s = time.perf_counter() - t0
    if rung["wrong_answers"] or rung["leaked_pin_files"] or rung["cross_process_dedup"] < 1 or \
            rung["device"] != device:
        raise AssertionError(f"fleet rung: {rung}")
    t0 = time.perf_counter()
    kill = fleet_harness.run_fleet(
        os.path.join(work, "fleet_kill"), n_procs=2, iters=3, rows=FLEET_ROWS, device=device,
        kill_one=True, fastpath_phase=True, conf=pruned,
        reuse_lake=(os.path.join(root1, "source"), os.path.join(root1, "indexes")))
    kill_s = time.perf_counter() - t0
    if kill["wrong_answers"] or kill["leaked_pin_files"] or not kill["killed"] or \
            kill["device"] != device:
        raise AssertionError(f"fleet kill rung: {kill}")
    # each rung's worker processes launched B1 on the card: the schedule's
    # bucket-pruned point filters (and the kill rung's survivor's probe,
    # which it runs itself once its owner is dead)
    if cuda and not (rung["launches"].get("murmur3_bucket_ids", 0) > 0
                     and kill["launches"].get("murmur3_bucket_ids", 0) > 0):
        raise AssertionError(f"a fleet rung's workers launched no B1: {rung['launches']}, "
                             f"{kill['launches']}")
    keep = ("processes", "workers_reporting", "queries", "wrong_answers", "qps", "p50_ms",
            "p99_ms", "cross_process_dedup", "claims_won", "bus_events", "fast_frontends",
            "fast_handoffs", "fast_fallbacks", "fast_result_hits", "probes", "probe_mismatches",
            "leaked_pin_files", "leaked_fast_members")
    fleet_names = [name for _kind, name in SERVE_KERNELS]
    out["fleet_processes"] = {
        "rows": FLEET_ROWS,
        "rung": {**{k: rung[k] for k in keep}, "seconds": rung_s,
                 "worker_launches": {k: rung["launches"].get(k, 0) for k in fleet_names}},
        "kill": {**{k: kill[k] for k in keep}, "seconds": kill_s,
                 "worker_launches": {k: kill["launches"].get(k, 0) for k in fleet_names}}}
    log(f"serve path [{card}]: fleet_harness on {device}, {FLEET_ROWS} rows: 2 processes "
        f"{rung['queries']} queries, wrong {rung['wrong_answers']}, cross-process dedup "
        f"{rung['cross_process_dedup']}, leaked pins {rung['leaked_pin_files']} ({rung_s:.1f}s); "
        f"kill -9 rung: wrong {kill['wrong_answers']}, fast fallbacks {kill['fast_fallbacks']}, "
        f"leaked pins {kill['leaked_pin_files']} ({kill_s:.1f}s); the workers' launches "
        f"{out['fleet_processes']['rung']['worker_launches']} and "
        f"{out['fleet_processes']['kill']['worker_launches']}")
    frontend_calls = {name: kernels.serve_calls.get(kind, 0) for kind, name in SERVE_KERNELS}
    frontend_calls["segment_reduce"] = b5_inputs.serve_calls
    need = ("murmur3_bucket_ids", "range_mask", "bucket_match_pairs", "fused_filter_agg")
    if cuda and not all(frontend_calls[k] > 0 for k in need):
        raise AssertionError(f"the frontend's threads did not call B1, B3a, B4 and B5f: "
                             f"{frontend_calls}")
    held = kernels.summary("phase 20", required=(
        [("b1", "serve filters, 64 clients"), ("b3a", "serve filters, 64 clients"),
         ("b4", "serve join, single-flight"), ("b5f", "serve aggregates")] if cuda else ()))
    held["b5"] = out["aggregates"]["b5_calls_held"]
    out["launches"] = launches_in_process
    out["window_launches"] = {k: window_launches.get(k, 0) for k in fleet_names}
    out["frontend_calls"] = frontend_calls
    out["held"] = held
    out["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"serve path [{card}]: kernel calls from the frontend's {SERVE_THREADS}-* threads "
        f"{frontend_calls}; launches in the frontend's windows from every thread (the "
        f"snapshot-pin writer's refresh too) {out['window_launches']}; calls held {held}; "
        f"{out['seconds']:.1f}s in all")
    return out


class PhaseClock:
    """Logs the seconds since the last call (or ``start``) under a phase's
    name, and the script's seconds so far."""

    def __init__(self, start: float):
        self.start = self.last = start

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - self.last:.1f}s (the script so far {now - self.start:.1f}s)")
        self.last = now


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--baseline-src",
        help="an earlier csrc/murmur3_bucket.cu (the seven-argument C interface) "
        "to build, hold against the plain version and time in turns with the "
        "current kernel: baseline, current, current, baseline",
    )
    parser.add_argument(
        "--only-b4", action="store_true",
        help="for iterating on kernel B4: run phases 1-3, then time B4 on device "
        "tensors shaped like phase 5's indexed and unindexed calls (built from the "
        "same keys without writing the tables) and print the records under "
        "only_b4 with null launches; no main path, no final ok line",
    )
    parser.add_argument(
        "--only-b5f", action="store_true",
        help="for iterating on kernels B5f and B3b: run phases 1-3, then time them on "
        "device inputs shaped like phase 9's (li_idx's rows of l_orderkey, l_shipdate and "
        "l_quantity as one chunk, f1's and f2's plans, s1's batch; built without writing "
        "the tables) and print the records under only_b5f with null launches; no main "
        "path, no final ok line",
    )
    parser.add_argument(
        "--only-serve", action="store_true",
        help="for iterating on the serve tier: build the kernels, run phases 4 and 5, then "
        "phase 20, and print its record under only_serve; no kernel cases, no other phase, "
        "no final ok line",
    )
    parser.add_argument(
        "--only-b5", action="store_true",
        help="for iterating on kernel B5: run phases 1-3, then time B5 on device "
        "tensors shaped like phase 8's calls (built from the same columns without "
        "writing the tables) and print the records under only_b5 with null "
        "launches; no main path, no final ok line",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch import kernels

    started = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}"
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}"
    )

    t0 = time.perf_counter()
    pending = build_baseline(args.baseline_src) if args.baseline_src else None
    probe = None if args.only_b4 or args.only_b5f else build_chain_probe()
    out_dir = kernels.build_all()
    log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.2f}s -> {out_dir}")
    for name in os.listdir(out_dir):
        if name.endswith(".log"):
            with open(os.path.join(out_dir, name)) as fh:
                log(f"build: {name}: {fh.read().strip()}")
    baseline = load_baseline(*pending) if pending else None

    dev = torch.device("cuda")
    if args.only_serve:
        work = os.path.join(ROOT, "build", "chip_smoke")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            phase = PhaseClock(started)
            ctx = filter_path(work, None)
            join_path(work, ctx, B4Inputs())
            phase("4-5")
            svpath = serve_path(work, ctx, KernelCalls(), B5Inputs(), card)
            phase("20")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(card, flush=True)
        print(json.dumps({"only_serve": svpath}, default=str), flush=True)
        return 0
    b1 = check_kernels(dev, baseline)
    b4_cases_run, b4_case_err = check_b4_cases(dev)
    b3a_cases_run, b3a_case_err = check_b3a_cases(dev)
    b5_cases_run, b5_case_err = check_b5_cases(dev)
    fused_cases_run, _ = check_b3b_b5f_cases(dev)
    b6_cases_run, b6_case_err = check_b6_cases(dev)
    b7_cases_run, b7_case_err = check_b7_cases(dev)
    if args.only_b4:  # no main path: its launches stay null
        b4 = b4_timings(dev, b4_replica(dev))
        b4.update(max_abs_err=b4_case_err, cases=b4_cases_run)
        print(card, flush=True)
        print(json.dumps({"only_b4": [b1, b4]}), flush=True)
        return 0
    if args.only_b5f:
        b3b, b5f = fused_timings(dev, *b5f_replica(dev))
        b5f.update(cases=fused_cases_run)
        print(card, flush=True)
        print(json.dumps({"only_b5f": [b3b, b5f]}), flush=True)
        return 0
    if args.only_b5:
        recorded, hosts = b5_replica(dev)
        b5_calls, b5_err = check_b5_main_path(recorded, "the replica of phase 8")
        b5 = b5_timings(dev, recorded, hosts, add_latency_ns(*probe))
        b5.update(max_abs_err=max(b5_case_err, b5_err), cases=b5_cases_run + b5_calls)
        print(card, flush=True)
        print(json.dumps({"only_b5": [b5]}), flush=True)
        return 0

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    b6 = b6_timings(dev)
    b7 = b7_timings(dev)
    b4_inputs, b3a_inputs, b5_inputs = B4Inputs(), B3aInputs(), B5Inputs()
    b3b_inputs, kernels = B3bInputs(), KernelCalls()
    chain_ns = add_latency_ns(*probe)
    try:
        # the default session device is cuda; the paths run it as a user would
        phase = PhaseClock(started)
        ctx = filter_path(work, None)
        b1["launches"] = ctx["launches"]
        phase("4")
        b4_launches = join_path(work, ctx, b4_inputs)["launches"]["bucket_match_pairs"]
        phase("5")
        b3a_launches = (ctx["all_launches"]["range_mask"]
                        + range_path(work, ctx, b3a_inputs)["launches"]["range_mask"])
        phase("7")
        b5_launches = aggregate_path(work, ctx, b5_inputs)["launches"]["segment_reduce"]
        phase("8")
        fused_launches = aggplane_path(work, ctx, b3b_inputs)["launches"]
        f_in = f_inputs(dev, ctx)
        phase("9")
        zpath = zorder_path(work, ctx, kernels)
        z_calls = [c for c in kernels.settle() if c[0] == "b6"]
        phase("10")
        dspath = dataskipping_path(work, ctx, kernels)
        ds_calls = kernels.settle()
        kernels.totals()  # phases 10 and 11 count their calls themselves
        phase("11")
        lcpath = lifecycle_path(work, ctx, kernels, card)
        phase("12")
        rcpath = recovery_path(work, ctx, kernels, card)
        phase("13")
        hypath = hybrid_path(work, ctx, kernels, card)
        phase("14")
        lkpath = lake_path(work, ctx, kernels, card)
        phase("15")
        ocpath = outofcore_path(work, ctx, kernels, card)
        phase("16")
        ospath = ooserve_path(work, ctx, kernels, card)
        phase("17")
        shpath = sharded_path(work, ctx, kernels, card)
        phase("18")
        obpath = obs_sql_path(work, ctx, kernels, b5_inputs, card)
        phase("19")
        svpath = serve_path(work, ctx, kernels, b5_inputs, card)
        phase("20")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    main_err = check_b4_main_path(dev, b4_inputs.calls)
    b4 = b4_timings(dev, {k: b4_inputs.calls[k] for k in ("indexed", "unindexed")})
    b4.update(launches=b4_launches, max_abs_err=max(b4_case_err, main_err),
              cases=b4_cases_run + 4)
    b3a_err = check_b3a_main_path(dev, b3a_inputs.calls)
    b3a = b3a_timings(dev, b3a_inputs.calls, ("li_idx date cut-off", "li_rg_idx 10.0%",
                                              "li_idx 1.0%"))
    b3a.update(launches=b3a_launches, max_abs_err=max(b3a_case_err, b3a_err),
               cases=b3a_cases_run + len(b3a_inputs.calls))
    b5_calls, b5_err = check_b5_main_path(b5_inputs.calls)
    b5 = b5_timings(dev, b5_inputs.calls, b5_inputs.host, chain_ns)
    b5.update(launches=b5_launches, max_abs_err=max(b5_case_err, b5_err),
              cases=b5_cases_run + b5_calls)
    b3b, b5f = fused_timings(dev, f_in, b3b_inputs.calls)
    b3b.update(launches=fused_launches["fused_select"])
    b5f.update(launches=fused_launches["fused_filter_agg"], cases=fused_cases_run)
    b6_calls = check_b6_main_path(z_calls)
    b6.update(launches=zpath["launches"]["zorder_interleave"], max_abs_err=b6_case_err,
              cases=b6_cases_run + b6_calls, lexsort=lexsort_timings(z_calls),
              creates=zpath["creates"], queries=zpath["queries"])
    b7_calls = check_b7_main_path(ds_calls)
    b7.update(launches=dspath["launches"]["bloom_bits"], max_abs_err=b7_case_err,
              cases=b7_cases_run + b7_calls, create=dspath["create"], queries=dspath["queries"],
              real_reps=b7_real_timing(dev, ds_calls),
              launches_by_route={r: dspath["launches"][f"bloom_bits.build_{r}"]
                                 for r in ("block", "binned", "global")})

    lc_held, rc_held, hy_held = lcpath["held"], rcpath["held"], hypath["held"]
    lk_held, oc_held, os_held = lkpath["held"], ocpath["held"], ospath["held"]
    late = (lcpath["launches"], rcpath["launches"], hypath["launches"], lkpath["launches"],
            ocpath["launches"], ospath["launches"], shpath["launches"], obpath["launches"],
            svpath["launches"])
    for record, kernel in ((b1, "murmur3_bucket_ids"), (b4, "bucket_match_pairs"),
                           (b3a, "range_mask"), (b5, "segment_reduce"), (b3b, "fused_select"),
                           (b5f, "fused_filter_agg"), (b6, "zorder_interleave"),
                           (b7, "bloom_bits")):
        record["launches"] += sum(counts[kernel] for counts in late)
    for r in ("block", "binned", "global"):
        b7["launches_by_route"][r] += sum(counts[f"bloom_bits.build_{r}"] for counts in late)
    for record, key in ((b1, "b1"), (b6, "b6"), (b7, "b7")):
        record["cases"] = (record.get("cases", 0) + lc_held[key] + rc_held[key]
                           + hy_held.get(key, 0) + lk_held.get(key, 0)
                           + oc_held.get(key, 0) + os_held.get(key, 0))
    b3a["cases"] += lk_held.get("b3a", 0) + oc_held.get("b3a", 0) + os_held.get("b3a", 0)
    b4["cases"] += os_held.get("b4", 0)
    b5f["cases"] += os_held.get("b5f", 0)
    for record, kernel in ((b1, "murmur3_bucket_ids"), (b4, "bucket_match_pairs"),
                           (b3a, "range_mask"), (b5f, "fused_filter_agg")):
        record["phase_17_launches"] = ospath["launches"][kernel]
    b1["phase_14_launches"] = hypath["launches"]["murmur3_bucket_ids"]
    for record, kernel in ((b1, "murmur3_bucket_ids"), (b3a, "range_mask"),
                           (b5f, "fused_filter_agg"), (b6, "zorder_interleave"),
                           (b7, "bloom_bits")):
        record["phase_15_launches"] = lkpath["launches"][kernel]
        record["phase_16_launches"] = ocpath["launches"][kernel]
    sh_held = shpath["held"]
    for record, kernel in ((b1, "murmur3_bucket_ids"), (b4, "bucket_match_pairs"),
                           (b3a, "range_mask"), (b5, "segment_reduce"), (b3b, "fused_select"),
                           (b5f, "fused_filter_agg"), (b6, "zorder_interleave"),
                           (b7, "bloom_bits")):
        record["phase_18_launches"] = shpath["launches"][kernel]
    b4["phase_18_shard_launches"] = shpath["launches"]["bucket_match_pairs.shard"]
    ob_held, ob_sql = obpath["sql"]["held"], obpath["sql"]["launches"]
    for record, kernel, key in ((b1, "murmur3_bucket_ids", "b1"), (b4, "bucket_match_pairs", "b4"),
                                (b3a, "range_mask", "b3a"), (b5, "segment_reduce", "b5")):
        record["phase_19_launches"] = obpath["launches"][kernel]
        record["phase_19_sql_launches"] = ob_sql[kernel]
        record["cases"] += ob_held.get(key, 0)
    b1["cases"] += sh_held.get("b1", 0)
    b4["cases"] += sh_held.get("b4", 0)
    sv_held = svpath["held"]
    for record, kernel, key in ((b1, "murmur3_bucket_ids", "b1"), (b4, "bucket_match_pairs", "b4"),
                                (b3a, "range_mask", "b3a"), (b5, "segment_reduce", "b5"),
                                (b5f, "fused_filter_agg", "b5f")):
        record["phase_20_launches"] = svpath["launches"][kernel]
        record["phase_20_frontend_calls"] = svpath["frontend_calls"][kernel]
        record["phase_20_fleet_worker_launches"] = sum(
            svpath["fleet_processes"][r]["worker_launches"][kernel] for r in ("rung", "kill"))
        record["cases"] = record.get("cases", 0) + sv_held.get(key, 0)
    # 256 MiB read before every cold run: five times the L2
    flush = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    b8a = b8_timing("b8a", shpath["keep"]["b8a"], flush,
                    shpath["launches"]["bucket_exchange_pack"], sh_held.get("b8a", 0))
    b8b = b8_timing("b8b", shpath["keep"]["b8b"], flush,
                    shpath["launches"]["bucket_exchange_order"], sh_held.get("b8b", 0))
    del flush
    b5f["lake_calls"] = lk_held.get("b5f", 0)
    b5f["outofcore_calls"] = oc_held.get("b5f", 0)
    b1["phase_4_launches"] = ctx["launches"]
    b5f["lifecycle_capture_calls"] = lc_held["b5f"]
    b5f["recovery_calls"] = rc_held["b5f"]
    log(json.dumps({"lifecycle": {k: lcpath[k] for k in (
        "seconds", "actions", "checks", "quick_state", "after_step_5", "buckets",
        "files_compared", "launches")}}, default=str))
    log(json.dumps({"recovery": {k: rcpath[k] for k in (
        "seconds", "cells", "child", "live_writer", "clean_tip_ensure_recovered_ms",
        "overhead", "heartbeats", "held", "crash_free_create_s", "launches")},
        "card": card}, default=str))
    log(json.dumps({"hybrid": {k: hypath[k] for k in (
        "seconds", "create_s", "steps", "refresh", "approx", "held", "launches")},
        "legacy_build": ctx["legacy_build"], "card": card}, default=str))
    log(json.dumps({"sources": {k: lkpath[k] for k in (
        "seconds", "creates", "filters", "snapshot_ms", "refresh", "time_travel", "zrange",
        "iceberg", "formats", "bucket_files_equal_hs_idx", "held", "launches")},
        "card": card}, default=str))
    log(json.dumps({"outofcore": {k: ocpath[k] for k in (
        "seconds", "budget_bytes", "first_file_bytes", "li_idx_write_peak_bytes", "st_idx",
        "filters", "sz_idx", "zrange", "refresh", "analysis", "settle_s", "held",
        "launches")},
        "card": card}, default=str))
    log(json.dumps({"ooserve": {k: ospath[k] for k in (
        "seconds", "materializing", "stream_small", "stream_default", "stream_mmap", "filters",
        "join", "f1", "spill", "settle_s", "held", "launches")},
        "card": card}, default=str))
    log(json.dumps({"sharded": {k: shpath[k] for k in (
        "seconds", "shards", "builds", "join", "streamed_build", "cross_mesh", "two_process",
        "held", "launches")},
        "card": card}, default=str))
    log(json.dumps({"obs": {k: obpath[k] for k in (
        "seconds", "sql", "turns", "querylog", "action", "profile", "launches")}},
        default=str))
    log(json.dumps({"serve": {k: svpath[k] for k in (
        "seconds", "filters", "single_flight", "aggregates", "slo", "pins", "faults", "stats",
        "fleet_one_process", "fleet_processes", "frontend_calls", "window_launches", "held",
        "launches")},
        "card": card}, default=str))
    log(f"chip_smoke: {time.perf_counter() - started:.1f}s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": [b1, b4, b3a, b5, b3b, b5f, b6, b7, b8a, b8b]}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
