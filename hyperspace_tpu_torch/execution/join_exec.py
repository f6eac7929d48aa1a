"""Equi-join execution over key reps, matched on the session's device.

Counterpart of ``hyperspace_tpu/execution/join_exec.py``. Indexed joins
match each co-bucketed bucket pair with no shuffle — the payoff the
reference gets from bucketed indexes + SMJ
(``covering/JoinIndexRule.scala:619-634``); unindexed joins run the same
match over one segment.

Matching combines each row's keys into one int64 (identity for a single
key, splitmix64 mix for composites, ``ops/join.combine_reps``), moves the
keys to the session's device, and runs kernel B4 (``ops/join.match_pairs``)
over the bucket segments, which writes the (left row, right row) pairs
in the reference's order: bucket ascending, then left in the stable
per-bucket key order, then right sorted position. Single-key matching is
rep-exact; composite combines can collide and null sentinels can equal
real keys, so those joins re-verify the numeric key columns, and string
key columns are always re-verified via dictionary remapping (murmur3-64
rep collisions), all O(matches) on the host.

The co-bucketed path is split into *prepare* (concat buckets, key reps,
combine, per-bucket sortedness — all query-independent) and *serve*
(match, pairs to the host, verify, assemble). Each stage's wall seconds
accumulate in the ``stats`` dict the executor passes (the session's
``join_stats``, reset per join): ``prepare``, ``match`` (keys to the
device, per-bucket sorts where needed, B4's count pass, scan and emit
pass — the emit pass is the reference's separate ``expand`` stage),
``to_host`` (the pairs back to host memory), ``verify`` and ``assemble``.

The pipelined prepare (:func:`prepare_join_side_pipelined`) consumes a
side's buckets as the executor's scan pool reads them; the waits for
those reads count as ``scan``, as the reads do on the sequential route.
A bucket with a Hybrid Scan tail (appended rows after the index's
key-sorted rows) is unsorted, so its side takes the device re-sort route
(``ops/join.segment_sort``, B2, then B4), as the reference re-sorts such
buckets (``join_exec.py:252``, ``:658``); the pairs come out in its order.

The prepared side is what the serve cache (``execution/serve_cache.py``)
keeps between queries, so a warm join pays only the match and the
assembly; the streaming join serve builds one from each wave's
contiguous read (:func:`prepare_join_side_contiguous`). A cached side
that is not key-sorted keeps its per-bucket sort permutation on the host
(:meth:`PreparedJoinSide.bucket_sort_perm`), so later joins gather
instead of sorting again.

On a shard mesh (the session's ``runtime``, more than one shard, with
``hyperspace.build.shardedTail.enabled`` on) the match is the reference's
mesh route (``_device_match``, ``join_exec.py:760-803``): the buckets
padded to a multiple of the shard count, each shard's contiguous block
matched by B4 on the shard's device (``ops/join.match_pairs_sharded``),
and the pipelined prepare runs a worker a shard over the buckets the shard
owns (``bucket % D``, ``parallel/mesh.bucket_owner_groups``). The rows and
their order are the same at every shard count.

Not ported: the reference's host/device dispatch knobs
(``deviceJoinMinRows`` and the native presorted fast path with its
thresholds), which choose between its host twin and its device program.
A CUDA session always matches with B4, a CPU session with its plain
version; the outputs are identical on every one of the reference's
routes, so the port keeps one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.io.columnar import ColumnarBatch, remap_codes
from hyperspace_tpu_torch.obs import trace as _obs_trace
from hyperspace_tpu_torch.ops.join import (
    combine_reps,
    match_pairs,
    match_pairs_sharded,
    segment_sort,
)
from hyperspace_tpu_torch.ops.sort import sort_permutation

_SENTINEL_BASE = np.int64(-0x4000000000000000)


def _stage_add(stats: Optional[Dict[str, float]], stage: str, t0: float) -> None:
    """Add ``[t0, now]`` to a join stage of ``stats`` and, under an active
    trace, record a stage span of exactly those seconds (the reference's
    one serve stage hook): the breakdown and the trace are one
    measurement. Tracing off costs one bool check and no device sync."""
    if stats is not None:
        dt = time.perf_counter() - t0
        stats[stage] = stats.get(stage, 0.0) + dt
        _obs_trace.stage(stage, t0, seconds=dt)


def _stats_add(stats: Optional[Dict[str, float]], stage: str, t0: float) -> None:
    """Add ``[t0, now]`` to a stage of ``stats`` with no span: the
    aggregate, sort and limit stages (``session.agg_stats``), which the
    reference traces as one ``agg`` span (``executor._exec``)."""
    if stats is not None:
        stats[stage] = stats.get(stage, 0.0) + time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    """Wait for the device, so a stage's wall seconds hold its device
    work (launches return before the kernels finish)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pairs_to_host(li: torch.Tensor, ri: torch.Tensor, stats) -> Tuple[np.ndarray, np.ndarray]:
    t0 = time.perf_counter()
    out = li.cpu().numpy(), ri.cpu().numpy()
    _stage_add(stats, "to_host", t0)
    return out


def _verify_keys(
    left: ColumnarBatch,
    right: ColumnarBatch,
    on: List[Tuple[str, str]],
    li: np.ndarray,
    ri: np.ndarray,
    l_reps: np.ndarray,
    r_reps: np.ndarray,
    verify_numeric: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact re-verification of every key column at the matched pairs:
    string columns via dictionary remap (murmur collision guard), numeric
    columns via rep equality (combine-hash / null-sentinel collision
    guard) when ``verify_numeric``. ``l_reps``/``r_reps`` are the per-side
    [k, n] rep matrices, rows in ``on`` order."""
    keep = np.ones(len(li), dtype=bool)
    for j, (lname, rname) in enumerate(on):
        lc, rc = left.column(lname), right.column(rname)
        if lc.kind == "string" and rc.kind == "string":
            rcodes = remap_codes(lc.dictionary, rc)
            keep &= lc.codes[li] == rcodes[ri]
        elif verify_numeric:
            keep &= l_reps[j][li] == r_reps[j][ri]
    if keep.all():
        return li, ri
    return li[keep], ri[keep]


def _assemble(
    left: ColumnarBatch,
    right: ColumnarBatch,
    li: np.ndarray,
    ri: np.ndarray,
) -> ColumnarBatch:
    """Join output contract: left columns then right columns at the pairs."""
    out = {}
    for name, col in left.columns.items():
        out[name] = col.take(li)
    for name, col in right.columns.items():
        out[name] = col.take(ri)
    return ColumnarBatch(out)


def _verify_and_assemble(left, right, on, li, ri, l_reps, r_reps, verify_numeric, stats):
    t0 = time.perf_counter()
    li, ri = _verify_keys(left, right, on, li, ri, l_reps, r_reps, verify_numeric)
    _stage_add(stats, "verify", t0)
    t0 = time.perf_counter()
    out = _assemble(left, right, li, ri)
    _stage_add(stats, "assemble", t0)
    return out


def merge_join_indices(
    l_reps: np.ndarray,
    r_reps: np.ndarray,
    device: torch.device,
    l_map: Optional[np.ndarray] = None,
    r_map: Optional[np.ndarray] = None,
    stats: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """[k, n] and [k, m] int64 reps -> (left_idx, right_idx) of matching
    pairs, ordered by left row, then by the right side's stable key order;
    ``l_map``/``r_map`` map positions to row ids (None = identity).

    Matches on the COMBINED per-row key as one B4 segment: the right side
    stably sorted on the device, the left in row order. For k > 1 the
    combine can collide, so pairs are superset-exact and the caller MUST
    re-verify key columns (``inner_join`` does)."""
    n, m = l_reps.shape[1], r_reps.shape[1]
    if n == 0 or m == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    t0 = time.perf_counter()
    lk = torch.from_numpy(combine_reps(l_reps)).to(device)
    rk = torch.from_numpy(combine_reps(r_reps)).to(device)
    order_r = sort_permutation(rk[None])
    r_row = order_r
    if r_map is not None:
        r_row = torch.from_numpy(r_map).to(device)[order_r]
    l_row = None if l_map is None else torch.from_numpy(l_map).to(device)
    li, ri = match_pairs(lk, [0, n], rk[order_r], [0, m], l_row, r_row)
    _sync(device)
    _stage_add(stats, "match", t0)
    return _pairs_to_host(li, ri, stats)


def inner_join(
    left: ColumnarBatch,
    right: ColumnarBatch,
    on: List[Tuple[str, str]],
    device: torch.device,
    stats: Optional[Dict[str, float]] = None,
) -> ColumnarBatch:
    """Inner equi-join; output = left columns then right columns (join keys
    from both sides kept, as in the logical Join's output contract)."""
    l_keys = [l for l, _ in on]
    r_keys = [r for _, r in on]
    l_reps = left.key_reps(l_keys)
    r_reps = right.key_reps(r_keys)
    # Null keys never match (SQL semantics): reps encode null as an in-band
    # value which would match null-to-null (and could equal a real key), so
    # exclude null rows via the explicit masks.
    l_ok = ~left.null_any(l_keys)
    r_ok = ~right.null_any(r_keys)
    li, ri = merge_join_indices(
        l_reps[:, l_ok],
        r_reps[:, r_ok],
        device,
        np.nonzero(l_ok)[0],
        np.nonzero(r_ok)[0],
        stats,
    )
    # k == 1 matching is rep-exact (identity combine): only the string
    # hash-collision guard is needed; k > 1 combines can collide, so the
    # numeric columns are re-verified too
    return _verify_and_assemble(
        left, right, on, li, ri, l_reps, r_reps, len(on) > 1, stats
    )


@dataclasses.dataclass
class PreparedJoinSide:
    """Query-independent serve state of one co-bucketed join side.

    Everything here is derived from the per-bucket batches alone: bucket
    order, concatenated batch, per-bucket offsets, [k, n] key reps,
    the combined int64 key, the null-key mask, and whether every bucket's
    combined keys are already monotonic (true for clean single-version
    covering-index scans, whose bucket files are key-sorted on disk). The
    serve cache keeps these keyed by the immutable index file set."""

    buckets: Tuple[int, ...]
    batch: ColumnarBatch
    offs: np.ndarray  # [B + 1] int64 segment offsets into batch
    reps: np.ndarray  # [k, n] int64
    combined: np.ndarray  # [n] int64 (no null sentinels applied)
    nulls: Optional[np.ndarray]  # [n] bool, None when no null keys
    sorted_buckets: bool
    # The per-bucket stable sort permutation of the SENTINELED combined key
    # a sentinel parity, as a host int64 array. A pure function of
    # (combined, nulls, parity), so a serve-cached side that is not
    # key-sorted (Hybrid Scan tails, null keys) sorts once, not a query.
    # None (the default) keeps no memo: the executor gives the side a dict
    # when the serve cache takes it. Racing fills write equal values.
    sort_perms: Optional[Dict[int, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def sizes(self) -> np.ndarray:
        """[B] int64 rows a bucket."""
        return np.diff(self.offs)

    @property
    def nbytes(self) -> int:
        """What the serve cache charges for this side: the batch, reps,
        combined keys, offsets and null mask, plus the sort-permutation
        memo at its worst case (both sentinel parities, 8 bytes a row),
        charged up front when the side can fill it (sizes are fixed at
        ``put``)."""
        from hyperspace_tpu_torch.execution.serve_cache import batch_nbytes

        n = batch_nbytes(self.batch)
        n += self.reps.nbytes + self.combined.nbytes + self.offs.nbytes
        if self.nulls is not None:
            n += self.nulls.nbytes
        if not self.sorted_buckets or self.nulls is not None:
            n += 2 * self.combined.nbytes
        return n

    def bucket_sort_perm(
        self, parity: int, keys: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``keys`` (this side's sentineled combined keys on the device)
        stably sorted within each bucket, and the permutation (sorted
        position -> row): ``ops/join.segment_sort``, or with a memo filled
        the gather through the kept permutation, which is the same."""
        perm = None if self.sort_perms is None else self.sort_perms.get(parity)
        if perm is not None:
            perm_t = torch.from_numpy(perm).to(keys.device)
            return keys[perm_t], perm_t
        sorted_keys, perm_t = segment_sort(keys, self.offs)
        if self.sort_perms is not None:
            self.sort_perms[parity] = perm_t.cpu().numpy()
        return sorted_keys, perm_t

    def subset(self, buckets: Tuple[int, ...]) -> "PreparedJoinSide":
        """Restrict to a bucket subset (sides with mismatched bucket sets,
        e.g. empty buckets on one side). Rebuilds contiguous arrays."""
        if buckets == self.buckets:
            return self
        pos = {b: i for i, b in enumerate(self.buckets)}
        bounds = [(int(self.offs[pos[b]]), int(self.offs[pos[b] + 1])) for b in buckets]
        idx = np.concatenate(
            [np.arange(a, z, dtype=np.int64) for a, z in bounds]
            + [np.zeros(0, dtype=np.int64)]
        )
        offs = np.concatenate([[0], np.cumsum([z - a for a, z in bounds])]).astype(np.int64)
        nulls = None if self.nulls is None else self.nulls[idx]
        if nulls is not None and not nulls.any():
            nulls = None
        return PreparedJoinSide(
            buckets=tuple(buckets),
            batch=self.batch.take(idx),
            offs=offs,
            reps=self.reps[:, idx],
            combined=self.combined[idx],
            nulls=nulls,
            sorted_buckets=self.sorted_buckets,
        )


def prepare_join_side(
    bucket_batches: Dict[int, ColumnarBatch],
    key_cols: List[str],
    stats: Optional[Dict[str, float]] = None,
) -> PreparedJoinSide:
    """Build the serve state of one side from its per-bucket batches."""
    t0 = time.perf_counter()
    buckets = tuple(sorted(bucket_batches))
    batch = ColumnarBatch.concat([bucket_batches[b] for b in buckets])
    sizes = [bucket_batches[b].num_rows for b in buckets]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    reps = batch.key_reps(key_cols)
    nulls_m = batch.null_any(key_cols)
    nulls = nulls_m if nulls_m.any() else None
    combined = combine_reps(reps)
    n = combined.shape[0]
    if n <= 1:
        sorted_buckets = True
    else:
        ge = combined[1:] >= combined[:-1]
        # bucket boundaries need not be ordered relative to each other;
        # a start of 0 means every earlier bucket is empty (no boundary)
        # and a start of n means this and all later buckets are empty
        # (boundary index n-1 would run past the length-(n-1) ge array)
        starts = offs[1:-1]
        cross_idx = starts[(starts > 0) & (starts < n)] - 1
        if len(cross_idx):
            ge[cross_idx] = True
        sorted_buckets = bool(np.all(ge))
    _stage_add(stats, "prepare", t0)
    return PreparedJoinSide(
        buckets=buckets,
        batch=batch,
        offs=offs,
        reps=reps,
        combined=combined,
        nulls=nulls,
        sorted_buckets=sorted_buckets,
    )


def prepare_join_side_contiguous(
    batch: ColumnarBatch,
    wave_buckets: Tuple[int, ...],
    sizes,
    key_cols: List[str],
    stats: Optional[Dict[str, float]] = None,
) -> Optional[PreparedJoinSide]:
    """Serve state from an already contiguous batch whose rows are ordered
    by ascending bucket (``sizes[i]`` rows belong to ``wave_buckets[i]``):
    the streaming wave's twin of :func:`prepare_join_side`. A wave's one
    decoded read IS the concatenation the materializing route builds
    bucket by bucket, so no concatenation is copied and only the per-row
    passes remain: key reps, null mask, combine and the same
    boundary-exempt sortedness test. Equal field by field to
    ``prepare_join_side`` over the equivalent per-bucket slices. None for
    an empty wave."""
    if not wave_buckets:
        return None
    t0 = time.perf_counter()
    offs = np.concatenate([[0], np.cumsum(np.asarray(sizes, dtype=np.int64))]).astype(np.int64)
    reps = batch.key_reps(key_cols)
    nulls_m = batch.null_any(key_cols)
    nulls = nulls_m if nulls_m.any() else None
    combined = combine_reps(reps)
    n = combined.shape[0]
    if n <= 1:
        sorted_buckets = True
    else:
        ge = combined[1:] >= combined[:-1]
        # the same cross-bucket boundary exemption as prepare_join_side
        starts = offs[1:-1]
        cross_idx = starts[(starts > 0) & (starts < n)] - 1
        if len(cross_idx):
            ge[cross_idx] = True
        sorted_buckets = bool(np.all(ge))
    _stage_add(stats, "prepare", t0)
    return PreparedJoinSide(
        buckets=tuple(wave_buckets),
        batch=batch,
        offs=offs,
        reps=reps,
        combined=combined,
        nulls=nulls,
        sorted_buckets=sorted_buckets,
    )


def prepare_join_side_pipelined(
    items: Iterable[Tuple[int, Callable[[], ColumnarBatch]]],
    key_cols: List[str],
    stats: Optional[Dict[str, float]] = None,
    num_shards: int = 1,
) -> Optional[PreparedJoinSide]:
    """Streaming twin of :func:`prepare_join_side`: consumes ``(bucket,
    fetch)`` pairs in ascending bucket order and computes each bucket's
    key reps, combined key, null mask and sortedness as soon as its
    ``fetch()`` returns, while the scan pool still reads later buckets.
    Equal field by field to ``prepare_join_side`` over the same batches:
    reps, combined keys and nulls are per-row functions, and the
    sortedness test ignores bucket boundaries in both. Returns None for
    an empty stream (the executor's empty-side contract). The time each
    ``fetch()`` takes (the wait for a read the prepare did not hide, and
    the decode) counts as ``scan``, the rest as ``prepare``.

    ``num_shards > 1`` prepares shard-locally (reference ``join_exec.py:
    449-490``): a worker a shard, each taking the buckets its shard owns
    (``bucket % num_shards``), the per-bucket states put back in bucket
    order at the edge; the same side either way."""
    import threading

    lock = threading.Lock()

    def add(stage: str, t0: float) -> None:
        with lock:
            _stage_add(stats, stage, t0)

    def prep_one(item):
        b, fetch = item
        t0 = time.perf_counter()
        batch = fetch()
        add("scan", t0)
        t0 = time.perf_counter()
        reps = batch.key_reps(key_cols)
        nulls_m = batch.null_any(key_cols)
        combined = combine_reps(reps)
        sorted_b = len(combined) <= 1 or bool(np.all(combined[1:] >= combined[:-1]))
        add("prepare", t0)
        return b, batch, reps, nulls_m, combined, sorted_b

    items = list(items)
    if num_shards > 1 and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor

        from hyperspace_tpu_torch.parallel.mesh import bucket_owner_groups

        groups = bucket_owner_groups([b for b, _ in items], num_shards)
        rows = [None] * len(items)

        def prep_group(group):
            for i in group:
                rows[i] = prep_one(items[i])

        with ThreadPoolExecutor(max_workers=len(groups), thread_name_prefix="hs-shardprep") as pool:
            list(pool.map(_obs_trace.carry(prep_group), groups))
    else:
        rows = [prep_one(item) for item in items]
    if not rows:
        return None
    t0 = time.perf_counter()
    batches = [r[1] for r in rows]
    sizes = [b.num_rows for b in batches]
    any_nulls = any(bool(r[3].any()) for r in rows)
    out = PreparedJoinSide(
        buckets=tuple(r[0] for r in rows),
        batch=ColumnarBatch.concat(batches),
        offs=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        reps=np.concatenate([r[2] for r in rows], axis=1),
        combined=np.concatenate([r[4] for r in rows]),
        nulls=np.concatenate([r[3] for r in rows]) if any_nulls else None,
        sorted_buckets=all(r[5] for r in rows),
    )
    _stage_add(stats, "prepare", t0)
    return out


def _sentineled(prep: PreparedJoinSide, parity: int) -> np.ndarray:
    """Combined keys with null rows overwritten by unique sentinels so a
    null key can never match anything (SQL: null != null). Left uses even
    offsets and right odd, so the two sides' sentinels never collide with
    each other; a real key CAN equal a sentinel, which the caller guards
    by numeric re-verification."""
    if prep.nulls is None:
        return prep.combined
    combined = prep.combined.copy()
    bad = np.nonzero(prep.nulls)[0]
    combined[bad] = _SENTINEL_BASE - 2 * np.arange(len(bad)) - parity
    return combined


def _side_on_device(prep: PreparedJoinSide, comb: np.ndarray, parity: int, device):
    """One side's B4 inputs: its keys on the device in emission order and
    the row map (None when the buckets are key-sorted already and carry
    no sentinels, so every row is its own position; else the stable
    per-bucket sort permutation of the sentineled keys)."""
    keys = torch.from_numpy(comb).to(device)
    if prep.sorted_buckets and prep.nulls is None:
        return keys, None
    return prep.bucket_sort_perm(parity, keys)


def _match(
    lp: PreparedJoinSide,
    rp: PreparedJoinSide,
    l_comb: np.ndarray,
    r_comb: np.ndarray,
    device: torch.device,
    stats: Optional[Dict[str, float]],
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-bucket match of two sides over the same buckets -> global
    (li, ri) into the sides' batches, in the reference's pair order; on a
    mesh each shard matches its block of buckets on its own device."""
    t0 = time.perf_counter()
    lk, l_row = _side_on_device(lp, l_comb, 0, device)
    rk, r_row = _side_on_device(rp, r_comb, 1, device)
    if mesh is not None:
        li, ri = match_pairs_sharded(mesh.local_devices, lk, lp.offs, rk, rp.offs, l_row, r_row)
        for dev in set(mesh.local_devices):
            _sync(dev)
    else:
        li, ri = match_pairs(lk, lp.offs, rk, rp.offs, l_row, r_row)
    _sync(device)
    _stage_add(stats, "match", t0)
    return _pairs_to_host(li, ri, stats)


def co_bucketed_join_prepared(
    lp: PreparedJoinSide,
    rp: PreparedJoinSide,
    on: List[Tuple[str, str]],
    device: torch.device,
    stats: Optional[Dict[str, float]] = None,
    mesh=None,
) -> Optional[ColumnarBatch]:
    """Shuffle-free join of two prepared co-bucketed sides: each bucket
    pair is matched independently by B4, no exchange ever happens. With a
    ``mesh`` the buckets are matched a block of them a local shard, on the
    shards' devices (the same rows in the same order).

    Returns the joined batch, or None when the sides share no bucket (the
    caller builds the schema-correct empty result)."""
    common = tuple(sorted(set(lp.buckets) & set(rp.buckets)))
    if not common:
        return None
    lp = lp.subset(common)
    rp = rp.subset(common)
    l_comb = _sentineled(lp, 0)
    r_comb = _sentineled(rp, 1)
    li, ri = _match(lp, rp, l_comb, r_comb, device, stats, mesh)
    # Single-key matching on the raw combined reps is exact (identity
    # combine, no sentinels in play when no side has null keys): only the
    # string hash-collision guard is needed. Multi-key combines can
    # collide, and sentinels can equal real keys — both require the
    # numeric re-verification.
    sentinels_used = lp.nulls is not None or rp.nulls is not None
    verify_numeric = len(on) > 1 or sentinels_used
    return _verify_and_assemble(
        lp.batch, rp.batch, on, li, ri, lp.reps, rp.reps, verify_numeric, stats
    )



def co_bucketed_join(
    lbs: Dict[int, ColumnarBatch],
    rbs: Dict[int, ColumnarBatch],
    on: List[Tuple[str, str]],
    mesh=None,
    device=None,
) -> Optional[ColumnarBatch]:
    """Prepare both sides then serve (``co_bucketed_join_prepared``) on
    ``device`` (None is cuda, raising without a card; with a ``mesh``,
    its shards' devices): the entry point for callers without a serve
    cache. The reference's ``device_min_rows`` picks its host twin below a
    row count; the port always matches with B4, so it takes no such
    argument."""
    if not lbs or not rbs:
        return None
    from hyperspace_tpu_torch.session import resolve_device

    lp = prepare_join_side(lbs, [l for l, _ in on])
    rp = prepare_join_side(rbs, [r for _, r in on])
    return co_bucketed_join_prepared(lp, rp, on, resolve_device(device), mesh=mesh)
