"""The fused filter→aggregate over one chunk (kernel B5f).

Counterpart of the JAX package's host kernel ``hs_fused_filter_agg``
(``hyperspace_tpu/native/hs_native.cpp:632``) as
``execution/pipeline_compiler._AggState.accumulate`` drives it: a chunk's
rows pass or fail a conjunction of range terms (B3a's predicate), each
passing row joins the group of its canonical key tuple (``Column.key_rep``
per key: NULL -> ``NULL_KEY_REP`` with a null flag, NaN -> the canonical
NaN, -0.0 -> 0), new groups are numbered after the carried ones in order
of their first passing row, and every aggregate folds the chunk's rows
into the carried accumulators:

* op 0 COUNT(*) counts passing rows, op 1 COUNT(col) valid rows;
* op 2 int SUM wraps mod 2^64; op 3 float SUM is a left fold in row
  order, carried across chunks, adding +0.0 for a null row;
* ops 4/5 int MIN/MAX keep ``acc < v ? acc : v`` (replace on equal);
* ops 6/7 float MIN/MAX fold clean (valid, not NaN) values only, with
  ``acc_aux`` counting clean rows (MIN) or NaN rows (MAX);
* identities: int64 max/min, +inf/-inf, 0.

The same chunks in the same order give the reference kernel's
``AggPartials``: the same groups in the same first-occurrence order, the
same first key values, accumulators and ``rows_passed``.

On CUDA tensors a chunk takes one of two routes, chosen from the plan
before any launch (:func:`route`):

* **one pass** (``csrc/fused_agg.cu``, ``hs_agg_one_pass``), for plans
  whose aggregates are exact in any order of combination: COUNT(*),
  COUNT(col), int SUM (wrapping) and int MIN/MAX. Kernel B5f's block
  pass tests the terms and folds each block of :data:`BLOCK_ROWS` rows
  into a shared-memory table of its groups (first row, accumulators);
  the blocks' groups merge into a global table with the carried groups;
  one read back of four counters (passing rows, block groups, overflow,
  new groups); the new groups numbered by first row (ranked in the last
  kernel, or one ``torch.sort`` past :data:`RANK_MAX` of them); one
  launch writes the next state. A block whose groups overflow its
  table sends the chunk to the ordered route (the two give equal bits),
  counted in ``FusedAggState.overflowed``.
  :func:`fused_filter_agg_blocked_torch` is its plain model, block by
  block.
* **ordered**, for plans with a float SUM, MIN or MAX (a left fold in row
  order; ties between -0.0 and 0.0 keep the later row), in three steps:

  1. group ids: the passing rows (ascending), each one's group, and the
     chunk's new groups' first rows, ascending. Kernel B3b
     (``ops/filter.select_kernel``) compacts the passing rows, then
     B5f's group pass (``hs_fused_group``: an open-addressing table sized
     from the passing count, claimed with atomicCAS, each new key's slot
     naming its least row) and a pass over the passing rows that numbers
     the rows their slots name; the plain version
     (:func:`group_ids_torch`) finds the distinct tuples by a stable sort
     of the rep planes.
  2. the new groups' reps, null flags, raw key bits and validity,
     gathered at their first rows.
  3. the reductions: the passing rows sorted stably by group, then
     kernel B5 (``ops/aggregate.py``) per aggregate, combined with the
     carried state by the accumulators' rules above, which are exact for
     COUNT, int SUM and MIN/MAX (a chunk's replace-on-equal extreme
     combined with the carried one equals the row sweep, ±0 ties
     included). The float SUM folds from the carried sums (B5's start),
     never a chunk sum added afterwards, which would reassociate.

:func:`fused_filter_agg_kernel` runs either route on CUDA tensors;
:func:`fused_filter_agg_torch`, the plain version, steps 1-3 with
:func:`group_ids_torch` and B5's plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from hyperspace_tpu_torch.kernels import KernelLaunchError
from hyperspace_tpu_torch.ops import aggregate as AG
from hyperspace_tpu_torch.ops import filter as F
from hyperspace_tpu_torch.ops.sort import sort_permutation

#: B5f kernel launches: on the one-pass route the block pass, the merge
#: table's fill, the insert of the carried groups (when there are some),
#: the merge and, when a row passed, the write of the next state; on the
#: ordered route the group pass and the carried insert
#: (:func:`group_ids_kernel`; none for a chunk without keys or without a
#: passing row)
launches = 0

OP_COUNT_STAR = 0
OP_COUNT_COL = 1
OP_SUM_I64 = 2
OP_SUM_F64 = 3
OP_MIN_I64 = 4
OP_MAX_I64 = 5
OP_MIN_F64 = 6
OP_MAX_F64 = 7

MAX_KEYS = 16  # kMaxKeys in csrc/fused_agg.cu
MAX_PLANES = 32  # kMaxPlanes: count planes and value planes, each
ONE_PASS_OPS = frozenset({OP_COUNT_STAR, OP_COUNT_COL, OP_SUM_I64, OP_MIN_I64, OP_MAX_I64})
#: rows a block of the one-pass route owns (a multiple of 64, at most
#: kMaxBlockRows = 16,384); the kernel sizes each keyed block's table
BLOCK_ROWS = 2048
RANK_MAX = 1024  # kRankMax: new groups of a chunk the finish kernel ranks itself
NULL_REP = -0x7FFF_FFFF_FFFF_FF13  # io/columnar.NULL_KEY_REP
NAN_REP = 0x7FF8_0000_0000_0000
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


@dataclasses.dataclass
class FusedChunk:
    """One chunk's device inputs: ``n`` rows; ``terms`` (B3a's
    :class:`~hyperspace_tpu_torch.ops.filter.RangeArgs`, None when every
    row passes); per key its ``[n]`` int64 bits (int64 and temporal
    values, or float64 bits), validity (``[n]`` bool or None) and whether
    it is float64; per aggregate its op, values (``[n]`` int64 or float64,
    None for the counts) and validity; the device they lie on."""

    n: int
    terms: Optional[F.RangeArgs]
    keys: List[Tuple[torch.Tensor, Optional[torch.Tensor], bool]]
    aggs: List[Tuple[int, Optional[torch.Tensor], Optional[torch.Tensor]]]
    device: torch.device


@dataclasses.dataclass
class FusedAggState:
    """The carried state of one fused aggregation, on one device: per
    group (``G`` = ``n_groups``) the key identity ``g_reps``/``g_nulls``
    and the first passing row's raw key bits and validity
    (``g_kvals``/``g_kvalid``), all ``[nk, G]``; per aggregate slot the
    accumulators ``acc_i``/``acc_f``/``acc_cnt``/``acc_aux``, ``[na, G]``,
    as the reference kernel's. An ungrouped aggregation has exactly one
    group from the start."""

    ops: Tuple[int, ...]
    n_groups: int
    g_reps: torch.Tensor
    g_nulls: torch.Tensor
    g_kvals: torch.Tensor
    g_kvalid: torch.Tensor
    acc_i: torch.Tensor
    acc_f: torch.Tensor
    acc_cnt: torch.Tensor
    acc_aux: torch.Tensor
    rows_passed: int = 0
    #: chunks of a one-pass plan folded by the ordered route because a
    #: block's table overflowed
    overflowed: int = 0

    @staticmethod
    def empty(nk: int, ops, device) -> "FusedAggState":
        dev = torch.device(device)
        G = 0 if nk else 1
        return FusedAggState(
            tuple(ops), G,
            torch.zeros((nk, G), dtype=torch.int64, device=dev),
            torch.zeros((nk, G), dtype=torch.uint8, device=dev),
            torch.zeros((nk, G), dtype=torch.int64, device=dev),
            torch.ones((nk, G), dtype=torch.uint8, device=dev),
            *_identity(ops, G, dev),
        )

    @property
    def device(self) -> torch.device:
        return self.acc_cnt.device


def _identity(ops, G: int, dev):
    """Identity-filled accumulators of ``G`` groups."""
    na = len(ops)
    acc_i = torch.zeros((na, G), dtype=torch.int64, device=dev)
    acc_f = torch.zeros((na, G), dtype=torch.float64, device=dev)
    for a, op in enumerate(ops):
        if op == OP_MIN_I64:
            acc_i[a] = _I64_MAX
        elif op == OP_MAX_I64:
            acc_i[a] = _I64_MIN
        elif op == OP_MIN_F64:
            acc_f[a] = float("inf")
        elif op == OP_MAX_F64:
            acc_f[a] = float("-inf")
    return (acc_i, acc_f, torch.zeros((na, G), dtype=torch.int64, device=dev),
            torch.zeros((na, G), dtype=torch.int64, device=dev))


def route(ops) -> str:
    """The route a plan's chunks take on the card: ``"one_pass"`` when
    every aggregate is exact in any order of combination (COUNT(*),
    COUNT(col), int SUM, int MIN/MAX) and the aggregates fit the kernel's
    planes, else ``"ordered"``."""
    ok = len(ops) < MAX_PLANES and all(op in ONE_PASS_OPS for op in ops)
    return "one_pass" if ok else "ordered"


def block_slots(ncnt: int, nval: int) -> int:
    """Slots of a keyed block's table on the card for ``ncnt`` count
    planes and ``nval`` value planes, as the kernel sizes it
    (``hs_agg_block_slots``)."""
    return int(_lib().hs_agg_block_slots(ncnt, nval))


def chunk_slots(chunk: FusedChunk) -> int:
    """:func:`block_slots` of the chunk's planes."""
    pl = _planes(chunk)
    return block_slots(len(pl.cnt_valid), len(pl.vals))


def fill_limit(slots: int) -> int:
    """Groups a block's table of ``slots`` slots holds before the chunk
    overflows: 3/4 of them, rounded up."""
    return slots - slots // 4


def key_rep_torch(bits: torch.Tensor, valid: Optional[torch.Tensor], f64: bool):
    """(canonical int64 rep, uint8 null flag) of key bits, as
    ``Column.key_rep`` and the reference kernel compute them."""
    rep = bits
    if f64:
        v = bits.view(torch.float64)
        rep = torch.where(torch.isnan(v), torch.tensor(NAN_REP, dtype=torch.int64, device=bits.device),
                          torch.where(v == 0.0, torch.zeros((), dtype=torch.int64, device=bits.device),
                                      bits))
    if valid is None:
        return rep, torch.zeros(bits.shape, dtype=torch.uint8, device=bits.device)
    rep = torch.where(valid, rep, torch.tensor(NULL_REP, dtype=torch.int64, device=bits.device))
    return rep, (~valid).to(torch.uint8)


def _passing(chunk: FusedChunk, mask_fn) -> torch.Tensor:
    if chunk.terms is None:
        return torch.ones(chunk.n, dtype=torch.bool, device=chunk.device)
    return mask_fn(chunk.terms)


# -- step 1: group ids ------------------------------------------------------------


def _tuple_ids(allp: torch.Tensor):
    """(id of each column's tuple, number of distinct tuples) of ``[k, m]``
    planes, m >= 1: a stable sort of the planes, then the runs of equal
    columns (torch.unique(dim=1) gives the same, far slower on the CPU)."""
    order = sort_permutation(allp)
    srt = allp[:, order]
    run_start = torch.ones(srt.shape[1], dtype=torch.int64, device=allp.device)
    run_start[1:] = (srt[:, 1:] != srt[:, :-1]).any(dim=0).to(torch.int64)
    sorted_uid = torch.cumsum(run_start, 0) - 1
    inv = torch.empty_like(sorted_uid)
    inv[order] = sorted_uid
    return inv, int(sorted_uid[-1]) + 1


def group_ids_torch(state: FusedAggState, chunk: FusedChunk):
    """Plain version of step 1: (the passing rows, ascending; the group id
    of each; the chunk's new groups' first rows, ascending). The distinct
    (rep, null) tuples of the carried groups and the passing rows by a
    stable sort of their planes; first rows by a ``scatter_reduce`` amin
    of positions."""
    n = chunk.n
    mask = _passing(chunk, F.range_mask_torch)
    dev = mask.device
    rows = torch.nonzero(mask).flatten()
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    if not chunk.keys or rows.numel() == 0:
        return rows, torch.zeros(rows.numel(), dtype=torch.int64, device=dev), none
    G = state.n_groups
    planes = []
    for j, (bits, valid, f64) in enumerate(chunk.keys):
        rep, nul = key_rep_torch(bits[rows], None if valid is None else valid[rows], f64)
        planes.append(torch.cat([state.g_reps[j], rep]))
        planes.append(torch.cat([state.g_nulls[j].to(torch.int64), nul.to(torch.int64)]))
    inv, U = _tuple_ids(torch.stack(planes))
    uid_gid = torch.full((U,), -1, dtype=torch.int64, device=dev)
    uid_gid[inv[:G]] = torch.arange(G, dtype=torch.int64, device=dev)
    row_uid = inv[G:]
    first = torch.full((U,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, row_uid, rows, "amin")
    new_uids = torch.nonzero(uid_gid < 0).flatten()
    new_first, order = torch.sort(first[new_uids])
    uid_gid[new_uids[order]] = G + torch.arange(new_uids.numel(), dtype=torch.int64, device=dev)
    return rows, uid_gid[row_uid], new_first


@functools.cache
def _lib():
    from hyperspace_tpu_torch import kernels

    lib = kernels.load("fused_agg")
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hs_fused_group.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), c_int, c_int,
        p, p, i64, p, i64, p, i64, p, p,
    ]
    lib.hs_fused_group.restype = c_int
    pp = ctypes.POINTER(ctypes.c_void_p)
    pi = ctypes.POINTER(ctypes.c_int)
    lib.hs_agg_one_pass.argtypes = [
        pp, pp, c_int, pi, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), pi, c_int,
        pp, pp, c_int, c_int, c_int, pp, c_int, pp, pp, pi, i64, c_int,
        p, p, i64, p, p, i64, p, i64, p, p, p,
    ]
    lib.hs_agg_one_pass.restype = c_int
    lib.hs_agg_block_slots.argtypes = [c_int, c_int]
    lib.hs_agg_block_slots.restype = c_int
    lib.hs_agg_finish.argtypes = [
        pp, pp, c_int, c_int, c_int, c_int, pi, pi, pi, p, i64, p, p, p, i64, i64, pp, pp, p,
    ]
    lib.hs_agg_finish.restype = c_int
    return lib


def table_size(n_groups: int, n: int) -> int:
    """The group pass's table size for a chunk: a power of two of at least
    twice the carried groups plus the ``n`` rows it groups (the passing
    rows)."""
    want = max(2 * (n_groups + n), 2)
    return 1 << (want - 1).bit_length()


def _check_chunk(state: FusedAggState, chunk: FusedChunk, dev) -> None:
    if chunk.device != dev:
        raise ValueError(f"the chunk lies on {chunk.device}, the state on {dev}")
    if len(chunk.keys) > MAX_KEYS:
        raise ValueError(f"B5f takes at most {MAX_KEYS} keys")
    if state.g_reps.shape[0] != len(chunk.keys) or state.acc_cnt.shape[0] != len(chunk.aggs):
        raise ValueError("the chunk's keys and aggregates must match the state's")
    for bits, valid, _f in chunk.keys:
        if (bits.device != dev or bits.dtype != torch.int64 or bits.shape != (chunk.n,)
                or not bits.is_contiguous()):
            raise ValueError("key columns must be contiguous [n] int64 tensors on one device")
        if valid is not None and (valid.device != dev or valid.dtype != torch.bool
                                  or valid.shape != (chunk.n,) or not valid.is_contiguous()):
            raise ValueError("key validity must be a contiguous [n] bool tensor")
    if chunk.terms is not None:
        F._check_args(chunk.terms)
        if chunk.terms.n != chunk.n or chunk.terms.cols[0].device != dev:
            raise ValueError("the terms' columns must hold the chunk's rows on its device")


def group_ids_kernel(state: FusedAggState, chunk: FusedChunk):
    """Step 1 on CUDA tensors: the passing rows by B3b, B5f's group pass
    (``csrc/fused_agg.cu``) over them, then the new groups numbered in
    order of first row (torch ops over the passing rows: a row is its
    group's first when its slot names it, and the rows are ascending).
    Returns what :func:`group_ids_torch` returns."""
    global launches
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"group_ids_kernel needs CUDA tensors, got {dev}")
    _check_chunk(state, chunk, dev)
    n, nk, G = chunk.n, len(chunk.keys), state.n_groups
    if chunk.terms is not None:
        rows = F.select_kernel(chunk.terms)
    else:
        rows = torch.arange(n, dtype=torch.int64, device=dev)
    m = rows.numel()
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    if not nk or m == 0:
        return rows, torch.zeros(m, dtype=torch.int64, device=dev), none
    T = table_size(G, m)
    table = torch.empty(T, dtype=torch.int64, device=dev)
    slot = torch.empty(m, dtype=torch.int64, device=dev)
    reps = state.g_reps.contiguous()
    nulls = state.g_nulls.contiguous()
    key_f64 = sum(1 << j for j, (_b, _v, f64) in enumerate(chunk.keys) if f64)
    with torch.cuda.device(dev):
        err = _lib().hs_fused_group(
            (ctypes.c_void_p * nk)(*[b.data_ptr() for b, _v, _f in chunk.keys]),
            (ctypes.c_void_p * nk)(*[None if v is None else v.data_ptr() for _b, v, _f in chunk.keys]),
            key_f64, nk, reps.data_ptr() if G else None, nulls.data_ptr() if G else None, G,
            rows.data_ptr() if chunk.terms is not None else None, m,
            table.data_ptr(), T, slot.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"B5f group pass failed: CUDA error {err}")
    launches += 1 + int(G > 0)
    held = table[slot]
    new_pos = torch.nonzero(held == -2 - rows).flatten()
    slot_gid = torch.empty(T, dtype=torch.int64, device=dev)  # read only where written
    slot_gid[slot[new_pos]] = G + torch.arange(new_pos.numel(), dtype=torch.int64, device=dev)
    return rows, torch.where(held >= 0, held, slot_gid[slot]), rows[new_pos]


# -- steps 2 and 3 ------------------------------------------------------------------


def _with_new_groups(state: FusedAggState, chunk: FusedChunk, new_first: torch.Tensor):
    """The state's group arrays and identity-filled accumulators extended
    by the new groups (step 2)."""
    G_new = int(new_first.numel())
    if G_new == 0:
        return state
    dev = state.device
    reps, nulls, kvals, kvalid = [], [], [], []
    for bits, valid, f64 in chunk.keys:
        b = bits[new_first]
        v = None if valid is None else valid[new_first]
        rep, nul = key_rep_torch(b, v, f64)
        reps.append(rep)
        nulls.append(nul)
        kvals.append(b)
        kvalid.append(torch.ones(G_new, dtype=torch.uint8, device=dev) if v is None
                      else v.to(torch.uint8))
    ident = _identity(state.ops, G_new, dev)
    cat = lambda old, new: torch.cat([old, new], dim=1)  # noqa: E731
    return dataclasses.replace(
        state,
        n_groups=state.n_groups + G_new,
        g_reps=cat(state.g_reps, torch.stack(reps)),
        g_nulls=cat(state.g_nulls, torch.stack(nulls)),
        g_kvals=cat(state.g_kvals, torch.stack(kvals)),
        g_kvalid=cat(state.g_kvalid, torch.stack(kvalid)),
        acc_i=cat(state.acc_i, ident[0]),
        acc_f=cat(state.acc_f, ident[1]),
        acc_cnt=cat(state.acc_cnt, ident[2]),
        acc_aux=cat(state.acc_aux, ident[3]),
    )


class _B5:
    """B5's functions: the kernels' wrappers or, for the plain version,
    their plain versions."""

    def __init__(self, plain: bool):
        if plain:
            self.sum_count = AG.segment_sum_count_torch
            self.minmax = AG.segment_minmax_torch
            self._count = AG.segment_count_torch
        else:
            self.sum_count = AG.segment_sum_count_kernel
            self.minmax = AG.segment_minmax_kernel
            self._count = AG.segment_count_kernel

    def count(self, perm, offs, valid):
        if valid is None:
            return offs[1:] - offs[:-1]
        return self._count(perm, offs, valid)


def _reduce(state: FusedAggState, chunk: FusedChunk, passing: torch.Tensor,
            gids: torch.Tensor, b5: _B5):
    """Step 3: fold the chunk's passing rows (ascending, with their group
    ids) into the state."""
    dev = state.device
    G = state.n_groups
    if passing.numel() == 0:  # no row passed: no group and no accumulator changes
        return state
    if chunk.keys:
        srt, order = torch.sort(gids, stable=True)
        perm = passing[order].contiguous()
        # each group's first position in the sorted ids (no read back)
        offs = torch.searchsorted(srt, torch.arange(G + 1, dtype=torch.int64, device=dev))
        sizes = offs[1:] - offs[:-1]
    else:  # one group: the passing rows in row order
        perm = passing
        offs = torch.zeros(2, dtype=torch.int64, device=dev)
        offs[1] = passing.numel()
        sizes = offs[1:] - offs[:-1]
    acc_i, acc_f = state.acc_i.clone(), state.acc_f.clone()
    acc_cnt, acc_aux = state.acc_cnt.clone(), state.acc_aux.clone()
    for a, (op, vals, valid) in enumerate(chunk.aggs):
        if op == OP_COUNT_STAR:
            acc_cnt[a] += sizes
            continue
        if op == OP_COUNT_COL:
            acc_cnt[a] += b5.count(perm, offs, valid)
            continue
        if op == OP_SUM_I64:
            sums, cnt = b5.sum_count(perm, offs, vals, valid)
            acc_i[a] += sums
            acc_cnt[a] += cnt
        elif op == OP_SUM_F64:
            sums, cnt = b5.sum_count(perm, offs, vals, valid, acc_f[a].contiguous())
            acc_f[a] = sums
            acc_cnt[a] += cnt
        elif op in (OP_MIN_I64, OP_MAX_I64):
            mode = "min" if op == OP_MIN_I64 else "max"
            fill = _I64_MAX if mode == "min" else _I64_MIN
            m = b5.minmax(perm, offs, vals, valid, mode, fill)
            acc_i[a] = (torch.where(acc_i[a] < m, acc_i[a], m) if mode == "min"
                        else torch.where(acc_i[a] > m, acc_i[a], m))
            acc_cnt[a] += b5.count(perm, offs, valid)
        else:  # OP_MIN_F64 / OP_MAX_F64 over clean rows
            clean = ~torch.isnan(vals)
            if valid is not None:
                clean &= valid
            mode = "min" if op == OP_MIN_F64 else "max"
            m = b5.minmax(perm, offs, vals, clean, mode)
            n_clean = b5.count(perm, offs, clean)
            n_valid = b5.count(perm, offs, valid)
            acc = acc_f[a]
            better = (acc < m) if mode == "min" else (acc > m)
            acc_f[a] = torch.where((n_clean > 0) & ~better, m, acc)
            acc_aux[a] += n_clean if mode == "min" else n_valid - n_clean
            acc_cnt[a] += n_valid
    return dataclasses.replace(
        state, acc_i=acc_i, acc_f=acc_f, acc_cnt=acc_cnt, acc_aux=acc_aux,
        rows_passed=state.rows_passed + int(passing.numel()))


def _fold(state: FusedAggState, chunk: FusedChunk, group_ids, plain: bool) -> FusedAggState:
    if chunk.n == 0:
        return state
    passing, gids, new_first = group_ids(state, chunk)
    return _reduce(_with_new_groups(state, chunk, new_first), chunk, passing, gids, _B5(plain))


def fused_filter_agg_torch(state: FusedAggState, chunk: FusedChunk) -> FusedAggState:
    """Plain version: the chunk folded into a new state with
    :func:`group_ids_torch` and B5's plain versions (CPU tensors: the
    float fold's plain version is bit-exact only there)."""
    return _fold(state, chunk, group_ids_torch, plain=True)


# -- the one-pass route ---------------------------------------------------------


@dataclasses.dataclass
class _Planes:
    """A chunk's accumulator planes (``Planes`` in csrc/fused_agg.cu):
    count plane 0 counts passing rows, each other one the rows valid in
    one validity; a value plane is one (column, validity, op). Aggregates
    over the same validity share a count plane, equal (column, validity,
    op) share a value plane (AVG's SUM and SUM, say). ``agg_cnt`` and
    ``agg_val`` give each aggregate's planes (-1: no value)."""

    cnt_valid: List[Optional[torch.Tensor]]
    vals: List[Tuple[torch.Tensor, Optional[torch.Tensor], int]]
    agg_cnt: List[int]
    agg_val: List[int]


def _planes(chunk: FusedChunk) -> _Planes:
    cnt_valid: List[Optional[torch.Tensor]] = [None]
    vals: List[Tuple[torch.Tensor, Optional[torch.Tensor], int]] = []
    cnt_of, val_of = {}, {}
    agg_cnt, agg_val = [], []
    for op, v, valid in chunk.aggs:
        c = 0
        if valid is not None and op != OP_COUNT_STAR:
            c = cnt_of.setdefault(valid.data_ptr(), len(cnt_valid))
            if c == len(cnt_valid):
                cnt_valid.append(valid)
        agg_cnt.append(c)
        q = -1
        if op in (OP_SUM_I64, OP_MIN_I64, OP_MAX_I64):
            key = (v.data_ptr(), None if valid is None else valid.data_ptr(), op)
            q = val_of.setdefault(key, len(vals))
            if q == len(vals):
                vals.append((v, valid, op))
        agg_val.append(q)
    return _Planes(cnt_valid, vals, agg_cnt, agg_val)


def _check_aggs(chunk: FusedChunk, dev) -> None:
    for op, v, valid in chunk.aggs:
        for t, dtype in ((v, torch.int64), (valid, torch.bool)):
            if t is not None and (t.device != dev or t.dtype != dtype or t.shape != (chunk.n,)
                                  or not t.is_contiguous()):
                raise ValueError("aggregate values and validity must be contiguous [n] int64 "
                                 "and bool tensors on the chunk's device")


def _pow2_at_least(x: int) -> int:
    return 1 << (max(x, 1) - 1).bit_length()


def _one_pass(state: FusedAggState, chunk: FusedChunk) -> FusedAggState:
    """One chunk by the one-pass route: ``hs_agg_one_pass`` (block pass,
    merge), one read back of its counters, ``hs_agg_finish`` (which
    numbers the new groups by first row, given their order by one
    ``torch.sort`` past :data:`RANK_MAX` of them). A block's overflow
    sends the chunk to the ordered route. The record and merge-table
    buffers are sized from upper bounds (the caching allocator hands them
    out without touching them); the kernels fill what the counts need."""
    global launches
    dev = state.device
    _check_chunk(state, chunk, dev)
    _check_aggs(chunk, dev)
    n, nk, G, na = chunk.n, len(chunk.keys), state.n_groups, len(chunk.aggs)
    pl = _planes(chunk)
    ncnt, nval = len(pl.cnt_valid), len(pl.vals)
    lib = _lib()
    blocks = -(-n // BLOCK_ROWS)
    cap = min(n, blocks * fill_limit(block_slots(ncnt, nval))) if nk else blocks
    width = 1 + ncnt + nval
    tcap = _pow2_at_least(2 * (G + cap))
    i64 = dict(dtype=torch.int64, device=dev)
    counters = torch.empty(4, **i64)
    rec = torch.empty(cap * width, **i64)
    table = torch.empty(tcap * width, **i64)
    carried_slot = torch.empty(max(G, 1), **i64)
    new_slot = torch.empty(cap, **i64)
    reps, nulls = state.g_reps.contiguous(), state.g_nulls.contiguous()
    terms = F.term_arrays(chunk.terms) if chunk.terms is not None else (
        None, None, 0, None, None, None, None, None, None, 0)
    vp = ctypes.c_void_p
    key_cols = (vp * MAX_KEYS)(*[b.data_ptr() for b, _v, _f in chunk.keys])
    key_valids = (vp * MAX_KEYS)(*[None if v is None else v.data_ptr() for _b, v, _f in chunk.keys])
    key_f64 = sum(1 << j for j, (_b, _v, f64) in enumerate(chunk.keys) if f64)
    cnt_valids = (vp * MAX_PLANES)(*[None if v is None else v.data_ptr() for v in pl.cnt_valid])
    val_cols = (vp * MAX_PLANES)(*[v.data_ptr() for v, _ok, _op in pl.vals])
    val_valids = (vp * MAX_PLANES)(*[None if ok is None else ok.data_ptr()
                                     for _v, ok, _op in pl.vals])
    val_ops = (ctypes.c_int * MAX_PLANES)(*[op for _v, _ok, op in pl.vals])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hs_agg_one_pass(
            *terms, key_cols, key_valids, key_f64, nk, ncnt, cnt_valids, nval, val_cols,
            val_valids, val_ops, n, BLOCK_ROWS,
            reps.data_ptr() if G and nk else None, nulls.data_ptr() if G and nk else None, G,
            counters.data_ptr(), rec.data_ptr(), cap, table.data_ptr(), tcap,
            carried_slot.data_ptr(), new_slot.data_ptr(), stream)
        if err != 0:
            raise KernelLaunchError(f"B5f one-pass launch failed: CUDA error {err}")
        launches += 3 + int(G > 0)
        passing, _records, overflow, g_new = counters.tolist()  # the chunk's one read back
        if overflow:
            folded = _fold(state, chunk, group_ids_kernel, plain=False)
            return dataclasses.replace(folded, overflowed=state.overflowed + 1)
        if passing == 0:
            return state
        G2 = G + g_new
        order = None  # up to RANK_MAX new groups: hs_agg_finish ranks them by first row
        if g_new > RANK_MAX:  # the slot refs are -2 - first row
            order = torch.sort(table[new_slot[:g_new]], descending=True).indices
        new = FusedAggState(
            state.ops, G2,
            torch.empty((nk, G2), **i64), torch.empty((nk, G2), dtype=torch.uint8, device=dev),
            torch.empty((nk, G2), **i64), torch.empty((nk, G2), dtype=torch.uint8, device=dev),
            torch.empty((na, G2), **i64), torch.empty((na, G2), dtype=torch.float64, device=dev),
            torch.empty((na, G2), **i64), torch.empty((na, G2), **i64),
            rows_passed=state.rows_passed + passing, overflowed=state.overflowed)

        def ptrs(st):  # the State struct's order; the state's arrays are contiguous
            arrs = (st.g_reps, st.g_nulls, st.g_kvals, st.g_kvalid, st.acc_i, st.acc_f,
                    st.acc_cnt, st.acc_aux)
            return (vp * 8)(*[a.data_ptr() if a.numel() else None for a in arrs])

        ci = ctypes.c_int * max(na, 1)
        err = lib.hs_agg_finish(
            key_cols, key_valids, key_f64, nk, ncnt, na, ci(*state.ops), ci(*pl.agg_cnt),
            ci(*pl.agg_val), table.data_ptr(), tcap, carried_slot.data_ptr() if G else None,
            new_slot.data_ptr(), None if order is None else order.data_ptr(), G, g_new,
            ptrs(state), ptrs(new), stream)
        if err != 0:
            raise KernelLaunchError(f"B5f finish launch failed: CUDA error {err}")
        launches += 1
    return new


def fused_filter_agg_kernel(state: FusedAggState, chunk: FusedChunk) -> FusedAggState:
    """The chunk folded into a new state on CUDA tensors, by the plan's
    route (:func:`route`): kernel B5f's one pass, or B3b's compaction,
    B5f's group pass and B5's kernels."""
    if state.device.type != "cuda":
        raise ValueError(f"fused_filter_agg_kernel needs CUDA tensors, got {state.device}")
    if chunk.n and route(state.ops) == "one_pass":
        return _one_pass(state, chunk)
    return _fold(state, chunk, group_ids_kernel, plain=False)


def fused_filter_agg_blocked_torch(state: FusedAggState, chunk: FusedChunk, block_rows: int,
                                   slots: int, seed: int = 0) -> FusedAggState:
    """Plain model of the one-pass route on any tensors, block by block:
    the chunk cut into blocks of ``block_rows`` rows; each block's groups
    (first row, accumulators) over its passing rows, its table of
    ``slots`` slots (the card's: :func:`chunk_slots`) overflowing past
    :func:`fill_limit` groups, which sends the chunk to
    :func:`fused_filter_agg_torch` (``overflowed`` + 1); the blocks'
    groups merged in an order drawn from ``seed``; new groups numbered by
    their least first row. A plan with a float aggregate takes
    :func:`fused_filter_agg_torch` (the ordered route)."""
    if route(state.ops) != "one_pass":
        return fused_filter_agg_torch(state, chunk)
    if chunk.n == 0:
        return state
    rows = torch.nonzero(_passing(chunk, F.range_mask_torch)).flatten()
    m = rows.numel()
    if m == 0:
        return state
    dev, n, nk, G = rows.device, chunk.n, len(chunk.keys), state.n_groups
    i64 = dict(dtype=torch.int64, device=dev)
    # tuple ids of the carried groups and the passing rows (as group_ids_torch)
    if nk:
        planes = []
        for j, (bits, valid, f64) in enumerate(chunk.keys):
            rep, nul = key_rep_torch(bits[rows], None if valid is None else valid[rows], f64)
            planes.append(torch.cat([state.g_reps[j], rep]))
            planes.append(torch.cat([state.g_nulls[j].to(torch.int64), nul.to(torch.int64)]))
        inv, U = _tuple_ids(torch.stack(planes))
        carried_uid, row_uid = inv[:G], inv[G:]
    else:  # one group, carried
        U, carried_uid, row_uid = 1, torch.zeros(1, **i64), torch.zeros(m, **i64)
    # the blocks' groups: one record a (block, tuple)
    rec_key, rec_of_row = torch.unique((rows // block_rows) * U + row_uid, return_inverse=True)
    if nk:
        per_block = torch.bincount(rec_key // U)
        if int(per_block.max()) > fill_limit(slots):
            folded = fused_filter_agg_torch(state, chunk)
            return dataclasses.replace(folded, overflowed=state.overflowed + 1)
    R = rec_key.numel()
    rec_uid = rec_key % U
    rec_first = torch.full((R,), n, **i64).scatter_reduce_(0, rec_of_row, rows, "amin")
    # numbering: new tuples by their least first row
    uid_gid = torch.full((U,), -1, **i64)
    uid_gid[carried_uid] = torch.arange(G, **i64)
    t_first = torch.full((U,), n, **i64).scatter_reduce_(0, rec_uid, rec_first, "amin")
    present = torch.unique(rec_uid)
    new_u = present[uid_gid[present] < 0]
    new_first, o = torch.sort(t_first[new_u])
    uid_gid[new_u[o]] = G + torch.arange(new_u.numel(), **i64)
    st = _with_new_groups(state, chunk, new_first)
    gids = uid_gid[present]
    # the merge: the records in a drawn order, folded per tuple
    perm = torch.randperm(R, generator=torch.Generator().manual_seed(seed)).to(dev)
    ru = rec_uid[perm]
    acc_i, acc_cnt = st.acc_i.clone(), st.acc_cnt.clone()
    for a, (op, vals, valid) in enumerate(chunk.aggs):
        ok = (torch.ones(m, dtype=torch.bool, device=dev)
              if valid is None or op == OP_COUNT_STAR else valid[rows])
        rec_cnt = torch.zeros(R, **i64).index_add_(0, rec_of_row, ok.to(torch.int64))
        acc_cnt[a, gids] += torch.zeros(U, **i64).index_add_(0, ru, rec_cnt[perm])[present]
        if op in (OP_SUM_I64, OP_MIN_I64, OP_MAX_I64):
            if op == OP_SUM_I64:
                v = torch.where(ok, vals[rows], 0)
                rec_v = torch.zeros(R, **i64).index_add_(0, rec_of_row, v)
                t_v = torch.zeros(U, **i64).index_add_(0, ru, rec_v[perm])[present]
                acc_i[a, gids] += t_v
            else:
                fill, how = (_I64_MAX, "amin") if op == OP_MIN_I64 else (_I64_MIN, "amax")
                v = torch.where(ok, vals[rows], fill)
                rec_v = torch.full((R,), fill, **i64).scatter_reduce_(0, rec_of_row, v, how)
                t_v = torch.full((U,), fill, **i64).scatter_reduce_(0, ru, rec_v[perm], how)
                pick = torch.minimum if op == OP_MIN_I64 else torch.maximum
                acc_i[a, gids] = pick(acc_i[a, gids], t_v[present])
    return dataclasses.replace(st, acc_i=acc_i, acc_cnt=acc_cnt, rows_passed=state.rows_passed + m)


def fused_filter_agg(state: FusedAggState, chunk: FusedChunk) -> FusedAggState:
    """One chunk folded into the state on its device: the plain version
    for CPU tensors, kernel B5f (by the plan's route, with B3b and B5 on
    the ordered one) for CUDA tensors (no fallback)."""
    dev = state.device
    if dev.type == "cpu":
        return fused_filter_agg_torch(state, chunk)
    if dev.type == "cuda":
        return fused_filter_agg_kernel(state, chunk)
    raise ValueError(f"fused_filter_agg: unsupported device {dev}")
