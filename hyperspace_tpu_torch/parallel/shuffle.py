"""Exchange strategies: the build's bucket shuffle over the shard mesh.

Counterpart of ``hyperspace_tpu/parallel/shuffle.py`` (reference:
``index/covering/CoveringIndex.scala:58-61`` ``repartition(numBuckets,
indexedCols)``), a library of strategies behind one entry,
:func:`bucket_shuffle`, chosen by ``hyperspace.build.exchange.strategy``
(default ``auto``, :func:`resolve_strategy`):

``flat``
    Each source shard's bucket ids come from kernel B1 on its device,
    kernel B8a packs every column into ``[D, cap]`` slots (cap the
    power-of-two-padded largest per-(shard, peer) count), the slots cross
    to their destination shards (a copy of ``[D, cap]`` blocks: a
    transposition on one card, ``Tensor.to(peer)`` across cards), and
    kernel B8b orders each destination's ``D * cap`` received slots by
    bucket with the invalid slots last (``ops/exchange.py``).
``compact``
    A host pack over exact extents (a slot a (source, peer) pair, cap the
    exact largest count rounded to 3 significant bits), one exchange a
    payload, and the unpack from each row's closed-form receive position.
``host``
    No device leg: the canonical permutation applied in host memory with
    threaded gathers.
``twostage``
    The host-memory intra-host leg, then the cross-host leg: in one
    process over ``twostageHosts`` simulated hosts (one copy a peer host
    a round, a round's slot sized from the count matrix); on a job of
    several processes over ``torch.distributed``
    (:func:`_twostage_exchange_mp`: an ``all_gather`` of the count
    matrices, then one ``all_to_all_single`` a payload with exact split
    sizes).

Every strategy gives the same output, the flat order: the valid rows
stably sorted by ``(bucket % D, bucket)``, ties in original row order
(:func:`canonical_order` computes it from the bucket ids alone). The
exchanges that cross a process boundary are registered in
``COLLECTIVE_SITES`` (``parallel/collectives.py``).
"""

from __future__ import annotations

import logging
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.ops.exchange import order as _b8_order
from hyperspace_tpu_torch.ops.exchange import pack as _b8_pack
from hyperspace_tpu_torch.ops.hash import bucket_ids

_log = logging.getLogger("hyperspace_tpu_torch.shuffle")

#: telemetry of the latest :func:`bucket_shuffle`: strategy, pack /
#: exchange / unpack seconds, cap and the per-(shard, peer) skew. Rebound
#: whole, never cleared and refilled, so a reader sees one snapshot.
last_shuffle_stats: Dict[str, float] = {}

#: once-a-build latch of the skew warning (a streamed build exchanges once
#: a wave); ``covering_build`` rearms it at every data operation
_skew_warned = False

STRATEGY_AUTO = "auto"
STRATEGY_FLAT = "flat"
STRATEGY_COMPACT = "compact"
STRATEGY_HOST = "host"
STRATEGY_TWOSTAGE = "twostage"
STRATEGIES = (STRATEGY_FLAT, STRATEGY_COMPACT, STRATEGY_HOST, STRATEGY_TWOSTAGE)

_BITS = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def reset_skew_warning() -> None:
    """Rearm the once-a-build skew warning."""
    global _skew_warned
    _skew_warned = False


# ---------------------------------------------------------------------------
# Host-side planning: bucket ids, counts, the canonical order
# ---------------------------------------------------------------------------


def pad_len(n: int, minimum: int = 8) -> int:
    """Next power of two >= max(n, minimum): the reference's padded row
    count (``hyperspace_tpu/ops/__init__.py:90``), which sizes the flat
    strategy's rows and slots."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def _bucket_ids_host(mesh, key_reps: np.ndarray, num_buckets: int, seed: int) -> np.ndarray:
    """The rows' bucket ids on the host, computed once an exchange on the
    mesh's first local device (kernel B1 on a CUDA device, its plain
    version on the CPU): bit-equal to the reference's host murmur3."""
    if key_reps.shape[1] == 0:
        return np.zeros(0, dtype=np.int32)
    reps = torch.from_numpy(np.ascontiguousarray(key_reps, dtype=np.int64))
    return bucket_ids(reps.to(mesh.local_devices[0]), num_buckets, seed).cpu().numpy()


def partition_by_bucket(ids: np.ndarray, num_buckets: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, offsets)``: the stable permutation grouping rows by id and
    the ``[num_buckets + 1]`` run offsets (the reference's
    ``ops/sort.partition_by_bucket``, a counting scatter)."""
    order = np.argsort(ids, kind="stable").astype(np.int64)
    counts = np.bincount(ids, minlength=num_buckets)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return order, offsets


def _peer_counts(owner: np.ndarray, valid: Optional[np.ndarray], n_local: int, D: int) -> np.ndarray:
    """``[D, D]`` count of valid rows each source shard (contiguous
    ``n_local``-row blocks) sends each owner shard."""
    src = (np.arange(len(owner)) // n_local).astype(np.int64)
    if valid is not None:
        src, owner = src[valid], owner[valid]
    return np.bincount(src * D + owner, minlength=D * D).reshape(D, D)


def _publish_stats(strategy: str, D: int, cap: int, counts: np.ndarray, extra: Dict) -> None:
    """Publish the telemetry snapshot (one rebind) and warn once a build
    when the hottest (shard, peer) slot carries more than the ratio times
    the mean."""
    from hyperspace_tpu_torch.constants import (
        BUILD_SHUFFLE_SKEW_WARN_MIN_ROWS,
        BUILD_SHUFFLE_SKEW_WARN_RATIO,
    )

    global last_shuffle_stats, _skew_warned
    max_count = int(counts.max()) if counts.size else 0
    mean_count = float(counts.mean()) if counts.size else 0.0
    skew = max_count / mean_count if mean_count > 0 else 1.0
    stats: Dict = {
        "strategy": strategy,
        "devices": float(D),
        "cap": float(cap),
        "max_peer_count": float(max_count),
        "mean_peer_count": round(mean_count, 1),
        "skew_ratio": round(skew, 2),
    }
    stats.update(extra)
    last_shuffle_stats = stats
    # stage spans from the exchange's own measured seconds
    from hyperspace_tpu_torch.obs import trace as _obs_trace

    for _stage_name in ("pack", "exchange", "unpack"):
        _sec = extra.get(f"{_stage_name}_s")
        if _sec:
            _obs_trace.stage(_stage_name, seconds=float(_sec))
    if (
        skew > BUILD_SHUFFLE_SKEW_WARN_RATIO
        and max_count >= BUILD_SHUFFLE_SKEW_WARN_MIN_ROWS
        and not _skew_warned
    ):
        _skew_warned = True
        _log.warning(
            "bucket shuffle skew: hottest (shard, peer) slot carries %.1fx the mean "
            "row count (max=%d, mean=%.0f, D=%d, strategy=%s); padded exchange slots "
            "grow with it; consider more buckets or less skewed key columns (warned "
            "once a build; telemetry records every wave)",
            skew, max_count, mean_count, D, strategy,
        )


def canonical_order(bucket_ids: np.ndarray, num_buckets: int, D: int) -> Tuple[np.ndarray, np.ndarray]:
    """The post-exchange row order on the host: the stable permutation
    sorting rows by ``(owner = bucket % D, bucket)`` (ties keep original
    row order), and the ``[D + 1]`` row extents of each owner shard. It is
    the flat exchange's output order: shard s holds its buckets ascending,
    a bucket's rows source-shard-major, each source's in local order."""
    b = np.arange(num_buckets, dtype=np.int64)
    owner_rank = np.lexsort((b, b % D))
    remap = np.empty(num_buckets, dtype=np.int32)
    remap[owner_rank] = np.arange(num_buckets, dtype=np.int32)
    order, offsets = partition_by_bucket(remap[bucket_ids], num_buckets)
    per_owner = np.bincount(owner_rank % D, weights=np.diff(offsets), minlength=D).astype(np.int64)
    return order, np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(per_owner)])


def _shape_cap(exact: int) -> int:
    """Slot capacity rounded up to 3 significant bits (padding under 25 %,
    four shapes an octave), as the reference sizes its compact and
    two-stage slots; the unpack reads exact extents either way."""
    exact = max(int(exact), 1)
    if exact <= 8:
        return exact
    step = 1 << (exact.bit_length() - 3)
    return -(-exact // step) * step


def _pair_ranks(slot_ids: np.ndarray, num_slots: int) -> np.ndarray:
    """Rank of each row within its (source, destination) slot, in original
    row order."""
    order, offsets = partition_by_bucket(slot_ids, num_slots)
    within = np.arange(len(order), dtype=np.int64) - np.repeat(offsets[:-1], np.diff(offsets))
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = within
    return rank


def _threaded_gather(arrays: Sequence[np.ndarray], idx: np.ndarray) -> List[np.ndarray]:
    """``[a[idx] for a in arrays]``, a column a thread past 2^16 rows."""
    workers = min(len(arrays), 8)
    if workers <= 1 or len(idx) < (1 << 16):
        return [a[idx] for a in arrays]
    with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="hs-exchange") as pool:
        return list(pool.map(lambda a: a[idx], arrays))


def _timing(pack_s: float, exchange_s: float, unpack_s: float) -> Dict:
    return {
        "pack_s": round(pack_s, 4),
        "exchange_s": round(exchange_s, 4),
        "unpack_s": round(unpack_s, 4),
    }


def _bits(a: np.ndarray) -> torch.Tensor:
    """A payload's raw bits as a torch integer tensor of its element size
    (every dtype crosses the exchange, bool included)."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize not in _BITS or a.dtype.kind not in "biufcmM":
        raise ValueError(f"exchange payload of dtype {a.dtype} has no fixed-width bits")
    return torch.from_numpy(a.view(_BITS[a.dtype.itemsize]))


def _unbits(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    return t.cpu().numpy().view(like.dtype)


def _exchange_blocks(mesh, blocks: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """The exchange between the shards of one process: ``blocks[s][t]``
    (on shard s's device) is what shard s sends shard t; shard t receives
    their concatenation over s, source-major, on its own device. On one
    card it is a transposition of ``[D, cap]`` blocks; across cards each
    block is a ``Tensor.to(peer)``."""
    D = len(blocks)
    return [
        torch.cat([blocks[s][t].to(mesh.device(t), non_blocking=True) for s in range(D)])
        for t in range(D)
    ]


# ---------------------------------------------------------------------------
# Strategy: flat (kernels B1, B8a, B8b)
# ---------------------------------------------------------------------------


def _flat_exchange(mesh, key_reps, payloads, num_buckets, seed):
    """Strategy ``flat``: the reference's ``_flat_program`` with its two
    sorts as kernels B8a and B8b and its ``all_to_all`` as block copies.
    Rows are padded to the reference's padded length (a power of two,
    then a multiple of D) and split into D contiguous shard slices; pad
    rows are invalid and never take a slot."""
    D = mesh.size
    n = key_reps.shape[1]
    t0 = _time.perf_counter()
    target = pad_len(n)
    target += (-target) % D
    pad = target - n
    valid = np.ones(target, dtype=bool)
    if pad:
        key_reps = np.pad(key_reps, ((0, 0), (0, pad)))
        payloads = [np.pad(p, (0, pad)) for p in payloads]
        valid[n:] = False
    n_local = target // D
    shards = []
    for s in range(D):
        dev, sl = mesh.device(s), slice(s * n_local, (s + 1) * n_local)
        reps = torch.from_numpy(np.ascontiguousarray(key_reps[:, sl], dtype=np.int64)).to(dev)
        ids = bucket_ids(reps, num_buckets, seed)  # B1
        vld = torch.from_numpy(valid[sl]).to(dev)
        cols = [_bits(p[sl]).to(dev) for p in payloads]
        dest = torch.where(vld, ids.to(torch.int64) % D, D)
        shards.append((ids, vld, cols, torch.bincount(dest, minlength=D + 1)[:D]))
    counts = np.stack([sh[3].cpu().numpy() for sh in shards])
    cap = min(pad_len(max(int(counts.max()), 1)), n_local)
    packed = [_b8_pack(ids, vld, D, cap, [ids, vld, *cols])[1] for ids, vld, cols, _ in shards]
    pack_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    recv = [_exchange_blocks(mesh, [p[c] for p in packed]) for c in range(len(packed[0]))]
    ordered = [
        _b8_order(recv[0][t], recv[1][t], num_buckets, [recv[0][t]] + [r[t] for r in recv[2:]])
        for t in range(D)
    ]
    per_shard = np.array([int(cnt.item()) for _, cnt in ordered], dtype=np.int64)
    exchange_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    if int(per_shard.sum()) != n:
        raise RuntimeError(
            f"bucket shuffle lost rows: sent {n}, received {int(per_shard.sum())} (cap={cap})"
        )
    out_bucket = np.concatenate(
        [cols[0][:k].cpu().numpy() for (cols, _), k in zip(ordered, per_shard)]
    )
    out_cols = [
        np.concatenate([_unbits(cols[1 + j][:k], p) for (cols, _), k in zip(ordered, per_shard)])
        for j, p in enumerate(payloads)
    ]
    offsets = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(per_shard)])
    unpack_s = _time.perf_counter() - t0
    _publish_stats(STRATEGY_FLAT, D, cap, counts, _timing(pack_s, exchange_s, unpack_s))
    return out_bucket, out_cols, offsets


# ---------------------------------------------------------------------------
# Strategy: host (no device leg)
# ---------------------------------------------------------------------------


def _host_exchange(mesh, key_reps, payloads, num_buckets, seed):
    """Strategy ``host``: the canonical permutation computed once from the
    bucket ids and applied in host memory with threaded gathers."""
    D = mesh.size
    n = key_reps.shape[1]
    t0 = _time.perf_counter()
    ids = _bucket_ids_host(mesh, key_reps, num_buckets, seed)
    n_local = -(-n // D) if n else 1
    counts = _peer_counts(ids % D, None, n_local, D)
    perm, shard_offsets = canonical_order(ids, num_buckets, D)
    pack_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    out_cols = _threaded_gather(payloads, perm)
    out_bucket = ids[perm]
    exchange_s = _time.perf_counter() - t0
    _publish_stats(
        STRATEGY_HOST, D, int(counts.max()) if counts.size else 0, counts,
        _timing(pack_s, exchange_s, 0.0),
    )
    return out_bucket, out_cols, shard_offsets


# ---------------------------------------------------------------------------
# Strategy: compact (host pack over exact extents)
# ---------------------------------------------------------------------------


def _compact_exchange(mesh, key_reps, payloads, num_buckets, seed):
    """Strategy ``compact``: the bucket ids drive a counting pack into
    ``[D * D, cap]`` send buffers (a slot a (source, peer) pair), each
    payload crosses in one block exchange, and the unpack gathers each row
    from its closed-form receive position ``(owner * D + source) * cap +
    rank`` straight into canonical order."""
    D = mesh.size
    n = key_reps.shape[1]
    t0 = _time.perf_counter()
    ids = _bucket_ids_host(mesh, key_reps, num_buckets, seed)
    owner = ids.astype(np.int64) % D
    n_local = -(-n // D) if n else 1
    src = np.arange(n, dtype=np.int64) // n_local
    counts = _peer_counts(owner, None, n_local, D)
    cap = _shape_cap(counts.max())
    slot = (src * D + owner).astype(np.int32)
    rank = _pair_ranks(slot, D * D)
    send_pos = slot.astype(np.int64) * cap + rank
    recv_pos = (owner * D + src) * cap + rank
    sends = []
    for p in payloads:
        buf = np.zeros(D * D * cap, dtype=p.dtype)
        buf[send_pos] = p
        sends.append(buf.reshape(D, D, cap))
    pack_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    flats = []
    for p, buf in zip(payloads, sends):
        blocks = [_bits(buf[s]).to(mesh.device(s)) for s in range(D)]
        recv = _exchange_blocks(mesh, blocks)
        flats.append(np.concatenate([_unbits(r, p) for r in recv]).reshape(-1))
    exchange_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    perm, shard_offsets = canonical_order(ids, num_buckets, D)
    out_cols = _threaded_gather(flats, recv_pos[perm])
    out_bucket = ids[perm]
    unpack_s = _time.perf_counter() - t0
    _publish_stats(STRATEGY_COMPACT, D, cap, counts, _timing(pack_s, exchange_s, unpack_s))
    return out_bucket, out_cols, shard_offsets


# ---------------------------------------------------------------------------
# Strategy: twostage (intra-host leg in host memory, then cross-host)
# ---------------------------------------------------------------------------


def _twostage_exchange(mesh, key_reps, payloads, num_buckets, seed, hosts):
    """Strategy ``twostage`` in one process: the mesh carved into ``hosts``
    groups of contiguous shards. The intra-host leg packs each host's rows
    in host memory into per-(peer host, destination lane) slots; the
    cross-host leg moves round r's segment of shard (h, l) to shard
    ((h + r) % H, l), a round's slot sized to its own largest count. A job
    of several processes takes :func:`_twostage_exchange_mp`."""
    if mesh.processes > 1:
        return _twostage_exchange_mp(mesh, key_reps, payloads, num_buckets, seed)
    D = mesh.size
    H = int(hosts) if hosts and hosts > 0 else 1
    H = min(H, D)
    while D % H:
        H -= 1
    L = D // H
    n = key_reps.shape[1]
    t0 = _time.perf_counter()
    ids = _bucket_ids_host(mesh, key_reps, num_buckets, seed)
    owner = ids.astype(np.int64) % D
    n_local = -(-n // D) if n else 1
    counts = _peer_counts(owner, None, n_local, D)
    src_dev = np.arange(n, dtype=np.int64) // n_local
    src_h = src_dev // L
    dst_h = owner // L
    lane = owner % L
    rnd = (dst_h - src_h) % H
    hl_counts = np.bincount((src_h * H + dst_h) * L + lane, minlength=H * H * L).reshape(H, H, L)
    caps = tuple(
        _shape_cap(hl_counts[np.arange(H), (np.arange(H) + r) % H, :].max()) for r in range(H)
    )
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    B = int(offs[-1])
    slot = ((src_h * H + dst_h) * L + lane).astype(np.int32)
    rank = _pair_ranks(slot, H * H * L)
    send_pos = (src_h * L + lane) * B + offs[rnd] + rank
    recv_pos = (dst_h * L + lane) * B + offs[rnd] + rank
    sends = []
    for p in payloads:
        buf = np.zeros(D * B, dtype=p.dtype)
        buf[send_pos] = p
        sends.append(buf.reshape(D, B))
    pack_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    flats = []
    for p, buf in zip(payloads, sends):
        blocks = [_bits(buf[q]).to(mesh.device(q)) for q in range(D)]
        recv = []
        for q in range(D):
            h, l = divmod(q, L)
            recv.append(torch.cat([
                blocks[((h - r) % H) * L + l][offs[r] : offs[r + 1]].to(mesh.device(q))
                for r in range(H)
            ]))
        flats.append(np.concatenate([_unbits(r, p) for r in recv]))
    exchange_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    perm, shard_offsets = canonical_order(ids, num_buckets, D)
    out_cols = _threaded_gather(flats, recv_pos[perm])
    out_bucket = ids[perm]
    unpack_s = _time.perf_counter() - t0
    _publish_stats(
        STRATEGY_TWOSTAGE, D, int(max(caps)), counts,
        {
            "hosts": float(H),
            "round_cap_max": float(max(caps)),
            "round_cap_min": float(min(caps)),
            **_timing(pack_s, exchange_s, unpack_s),
        },
    )
    return out_bucket, out_cols, shard_offsets


def _all_to_all_bytes(out: torch.Tensor, inp: torch.Tensor, out_splits, in_splits) -> torch.Tensor:
    """``all_to_all_single`` of uint8 tensors with byte split sizes.
    Under gloo a CUDA tensor is staged through pinned host memory when
    the backend refuses it (logged); NCCL takes it as it is."""
    import torch.distributed as dist

    try:
        dist.all_to_all_single(out, inp, out_splits, in_splits)
        return out
    except RuntimeError:
        if not inp.is_cuda or dist.get_backend() != "gloo":
            raise
    _log.info("gloo refused CUDA tensors in all_to_all_single: staging through pinned host memory")
    host_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
    host_in.copy_(inp)
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    dist.all_to_all_single(host_out, host_in, out_splits, in_splits)
    out.copy_(host_out)
    return out


def _twostage_exchange_mp(mesh, key_reps, payloads, num_buckets, seed):
    """The multi-process leg of ``twostage``: every process passes only
    its own rows (global row order is process-major) and gets back the
    rows of the buckets its shards own, in canonical order, with ``[D +
    1]`` shard extents in which the other processes' shards are empty.

    The count matrix of every process comes from one ``all_gather`` (every
    process learns every split size), the bucket ids cross as one more
    int32 payload, and each payload crosses in one ``all_to_all_single``
    with exact byte split sizes, on the mesh's device (CUDA tensors on a
    CUDA mesh, which gloo stages through host memory). Received rows
    arrive source-process-major, each process's in its local order, so
    the canonical order of the received ids is the global one restricted
    to this process's shards. Zero local rows still issue every
    collective. Registered in ``COLLECTIVE_SITES``."""
    import torch.distributed as dist

    from hyperspace_tpu_torch.parallel.mesh import comm_device

    H, pid, L = mesh.processes, mesh.process_index, mesh.local_size
    D = H * L
    t0 = _time.perf_counter()
    ids = _bucket_ids_host(mesh, key_reps, num_buckets, seed)
    owner = ids.astype(np.int64) % D
    dst_h = owner // L
    hl_local = np.bincount(owner, minlength=D).reshape(H, L).astype(np.int64)
    gathered = [torch.zeros((H, L), dtype=torch.int64, device=comm_device()) for _ in range(H)]
    dist.all_gather(gathered, torch.from_numpy(hl_local).to(comm_device()))
    hl_all = np.stack([g.cpu().numpy() for g in gathered])  # [src H, dst H, L]
    order = np.argsort(dst_h, kind="stable")
    send_rows = hl_local.sum(axis=1)
    recv_rows = hl_all[:, pid, :].sum(axis=1)
    pack_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    dev = mesh.local_devices[0]
    received = []
    for p in [ids] + list(payloads):
        width = p.dtype.itemsize
        inp = torch.from_numpy(np.ascontiguousarray(p[order]).view(np.uint8)).to(dev)
        out = torch.empty(int(recv_rows.sum()) * width, dtype=torch.uint8, device=dev)
        _all_to_all_bytes(
            out, inp, [int(r) * width for r in recv_rows], [int(r) * width for r in send_rows]
        )
        received.append(out.cpu().numpy().view(p.dtype))
    exchange_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    recv_ids, recv_cols = received[0], received[1:]
    expect = int(hl_all[:, pid, :].sum())
    if len(recv_ids) != expect:
        raise RuntimeError(
            f"multi-process bucket shuffle lost rows on process {pid}: expected {expect}, "
            f"received {len(recv_ids)}"
        )
    perm, shard_offsets = canonical_order(recv_ids, num_buckets, D)
    out_cols = _threaded_gather(recv_cols, perm)
    out_bucket = recv_ids[perm]
    unpack_s = _time.perf_counter() - t0
    peers = hl_all[pid].sum(axis=1)
    _publish_stats(
        STRATEGY_TWOSTAGE, D, int(peers.max()), hl_all[pid],
        {
            "hosts": float(H),
            "process_local": 1.0,
            "round_cap_max": float(peers.max()),
            "round_cap_min": float(peers.min()),
            **_timing(pack_s, exchange_s, unpack_s),
        },
    )
    return out_bucket, out_cols, shard_offsets


# ---------------------------------------------------------------------------
# Resolution and the entry
# ---------------------------------------------------------------------------


def resolve_strategy(strategy: str, mesh, n_rows: int) -> str:
    """The configured strategy (``hyperspace.build.exchange.strategy``) as
    a concrete one. ``auto``: a multi-process job takes ``twostage`` (only
    it crosses the process boundary; any other name is coerced to it
    there), a CPU mesh ``host`` (the copies between shards of one CPU
    would only cost), a CUDA mesh ``flat``. The reference's accelerator
    default is ``compact`` above a per-machine calibrated row count, else
    ``flat``; the port has no calibration probe yet (ROADMAP A.10), and
    with no measured threshold the reference takes ``flat`` too
    (``shuffle.py:903-908``; the uncalibrated threshold is 0)."""
    s = (strategy or STRATEGY_AUTO).strip().lower()
    if s != STRATEGY_AUTO and s not in STRATEGIES:
        raise ValueError(
            f"unknown exchange strategy {strategy!r}; expected one of "
            f"{(STRATEGY_AUTO,) + STRATEGIES}"
        )
    if mesh.processes > 1:
        return STRATEGY_TWOSTAGE
    if s != STRATEGY_AUTO:
        return s
    if mesh.platform == "cpu":
        return STRATEGY_HOST
    return STRATEGY_FLAT


def bucket_shuffle(
    mesh,
    key_reps: np.ndarray,
    payloads: Sequence[np.ndarray],
    num_buckets: int,
    seed: int = 42,
    with_shard_offsets: bool = False,
    strategy: str = STRATEGY_AUTO,
    twostage_hosts: int = 0,
):
    """Shuffle rows into bucket-contiguous order across the mesh by the
    selected strategy. Returns ``(bucket_ids, payload_cols)``: the buckets
    shard 0 owns, then shard 1's, ..., a shard's buckets ascending, a
    bucket's rows in original row order; every strategy gives the same
    arrays with the same dtypes. ``with_shard_offsets`` adds the ``[D +
    1]`` row extents of each shard's slice (rows ``offsets[s]:offsets[s +
    1]`` hold exactly the buckets ``b % D == s``; a shard owning no rows
    has an empty extent). The caller sorts within each bucket by key."""
    payloads = list(payloads)
    key_reps = np.asarray(key_reps)
    name = resolve_strategy(strategy, mesh, key_reps.shape[1])
    if name == STRATEGY_FLAT:
        out = _flat_exchange(mesh, key_reps, payloads, num_buckets, seed)
    elif name == STRATEGY_HOST:
        out = _host_exchange(mesh, key_reps, payloads, num_buckets, seed)
    elif name == STRATEGY_COMPACT:
        out = _compact_exchange(mesh, key_reps, payloads, num_buckets, seed)
    else:
        out = _twostage_exchange(mesh, key_reps, payloads, num_buckets, seed, twostage_hosts)
    return out if with_shard_offsets else out[:2]
