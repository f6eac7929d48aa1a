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

Three steps a chunk:

1. group ids: the passing rows (ascending), each one's group, and the
   chunk's new groups' first rows, ascending. On the card kernel B3b
   (``ops/filter.select_kernel``) compacts the passing rows, then kernel
   B5f's group pass (``csrc/fused_agg.cu``: an open-addressing table
   sized from the passing count, claimed with atomicCAS, each new key's
   slot naming its least row) and a pass over the passing rows that
   numbers the rows their slots name; the plain version
   (:func:`group_ids_torch`) finds the distinct tuples by a stable sort
   of the rep planes.
2. the new groups' reps, null flags, raw key bits and validity, gathered
   at their first rows.
3. the reductions: the passing rows sorted stably by group, then kernel
   B5 (``ops/aggregate.py``) per aggregate, combined with the carried
   state by the accumulators' rules above, which are exact for COUNT, int
   SUM and MIN/MAX (a chunk's replace-on-equal extreme combined with the
   carried one equals the row sweep, ±0 ties included). The float SUM
   folds from the carried sums (B5's start), never a chunk sum added
   afterwards, which would reassociate.

:func:`fused_filter_agg_kernel` runs these with B3b, B5f and B5 on CUDA
tensors; :func:`fused_filter_agg_torch`, the plain version, with
:func:`group_ids_torch` and B5's plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from hyperspace_tpu_torch.ops import aggregate as AG
from hyperspace_tpu_torch.ops import filter as F
from hyperspace_tpu_torch.ops.sort import sort_permutation

#: B5f kernel launches made by :func:`group_ids_kernel`: the group pass,
#: and the insert of the carried groups when there are some (none for a
#: chunk without keys or without a passing row)
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
    # distinct tuples: a stable sort of the planes, then the runs of equal
    # columns (torch.unique(dim=1) gives the same, far slower on the CPU)
    allp = torch.stack(planes)
    order = sort_permutation(allp)
    srt = allp[:, order]
    run_start = torch.ones(srt.shape[1], dtype=torch.int64, device=dev)
    run_start[1:] = (srt[:, 1:] != srt[:, :-1]).any(dim=0).to(torch.int64)
    sorted_uid = torch.cumsum(run_start, 0) - 1
    inv = torch.empty_like(sorted_uid)
    inv[order] = sorted_uid
    U = int(sorted_uid[-1]) + 1
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
        raise RuntimeError(f"B5f group pass failed: CUDA error {err}")
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


def fused_filter_agg_kernel(state: FusedAggState, chunk: FusedChunk) -> FusedAggState:
    """The chunk folded into a new state on CUDA tensors: B3b's compaction,
    B5f's group pass and B5's kernels."""
    if state.device.type != "cuda":
        raise ValueError(f"fused_filter_agg_kernel needs CUDA tensors, got {state.device}")
    return _fold(state, chunk, group_ids_kernel, plain=False)


def fused_filter_agg(state: FusedAggState, chunk: FusedChunk) -> FusedAggState:
    """One chunk folded into the state on its device: the plain version
    for CPU tensors, kernels B3b, B5f and B5 for CUDA tensors (no
    fallback)."""
    dev = state.device
    if dev.type == "cpu":
        return fused_filter_agg_torch(state, chunk)
    if dev.type == "cuda":
        return fused_filter_agg_kernel(state, chunk)
    raise ValueError(f"fused_filter_agg: unsupported device {dev}")
