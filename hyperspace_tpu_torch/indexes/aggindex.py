"""Aggregate index plane: persisted partial-aggregate state and samples.

Counterpart of ``hyperspace_tpu/indexes/aggindex.py``; both packages read
and write the same sidecars.

* capture: at create, refresh and optimize, the action writes
  ``_aggstate.json`` into the new version directory (covering only its
  own files; a merge refresh leaves earlier directories' sidecars as they
  are): per file and row group the partial-aggregate
  state of every column (valid counts, wrapped int64 sums, float sums,
  replace-on-equal min/max with clean/NaN counts), plus single-key grouped
  partials for every fusable column whose distinct count in a row group
  stays under ``hyperspace.index.agg.maxGroupsPerRowGroup``. A seeded
  per-row-group row sample goes to ``_aggsample.parquet`` beside it. The
  partials come from ``pipeline_compiler.partials_from_batch`` on the
  session's device (kernel B5f on the card), the same layer the serve
  path folds, so capture and serve share one state layout.
* vacuum: ``prune_missing`` drops the entries and sample rows of files
  deleted from a retained version directory.
* lazy backfill: an index without a fresh sidecar entry (by size and
  mtime_ns) computes the same per-file doc by reading the file once,
  memoized per file identity; a rewritten file never serves stale
  partials.
* serve assembly: ``agg_data_for`` assembles one file set's decoded state
  (module LRU); ``classify_row_groups`` splits a strictly lowered
  conjunction (``zonemaps.predicate_intervals_complete``) into FULL /
  EMPTY / PARTIAL row groups, and ``rg_partials`` turns a FULL row
  group's stored state back into ``AggPartials`` for the ordered fold.

Soundness: a row group is FULL only when every row provably satisfies the
whole conjunction: exact per-column min/max from the data itself, no
nulls and no NaN in any conjunct column, interval bounds compared with
inward rounding (which can only demote full to partial). EMPTY needs
provable non-overlap (outward rounding). Everything else is scanned.

* samples: ``sample_data_for`` assembles a file set's stratified sample
  for the approximate plane (``execution/approx_exec.py``), strata by
  (file, row group); a file whose sidecar entry is stale samples from its
  backfill, never from the directory's old sample rows.

With serve-server mode on, ``agg_data_for`` keeps the assembled state in
the session's serve cache (``("aggstate", fp)``), and ``fanout_payload`` /
``install_fanout_payload`` carry a committed file set's state to another
process's caches over the fleet bus (``serve/bus.py``, ``serve/fleet.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pa_compute
import pyarrow.parquet as pq

from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.execution import pipeline_compiler as PC
from hyperspace_tpu_torch.indexes.zonemaps import f64_down, f64_up, file_fingerprint
from hyperspace_tpu_torch.io import parquet as pio
from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.testing import faults
from hyperspace_tpu_torch.utils.files import fsync_dir
from hyperspace_tpu_torch.utils.hashing import murmur3_64_bytes

_log = logging.getLogger("hyperspace_tpu_torch.aggindex")

#: the last capture (:func:`capture_index_dir`): seconds spent reading
#: and decoding row groups ("read") and folding them into partials on the
#: device ("fold": B5f's passes and the copies of their partials back);
#: its fused passes ("passes") and the chunks of them that a block's
#: table overflow sent from B5f's one pass to its ordered route
#: ("overflowed")
capture_stats: Dict[str, float] = {"read": 0.0, "fold": 0.0, "passes": 0, "overflowed": 0}

SIDECAR_NAME = "_aggstate.json"
SAMPLE_NAME = "_aggsample.parquet"
_SIDECAR_VERSION = 1

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


# ---------------------------------------------------------------------------
# Scalar codec: every stored scalar is an int (an int64 value, or the int64
# bit view of a float64: exact for -0.0, NaN payloads and infinities) or
# None (no valid value).
# ---------------------------------------------------------------------------


def _enc_f64(v: float) -> int:
    return int(np.float64(v).view(np.int64))


def _dec_f64_arr(vals: List[Optional[int]], identity: float) -> np.ndarray:
    bits = np.array(
        [(_enc_f64(identity) if v is None else v) for v in vals],
        dtype=np.int64,
    )
    return bits.view(np.float64)


def _dec_i64_arr(vals: List[Optional[int]], identity: int) -> np.ndarray:
    return np.array([identity if v is None else v for v in vals], dtype=np.int64)


# ---------------------------------------------------------------------------
# Per-file doc (shared by capture and lazy backfill)
# ---------------------------------------------------------------------------


def _capture_spec(schema: pa.Schema):
    """(count-only columns, numeric columns with their float64 flag) of one
    index file's schema, by the fused pipeline's own type lowering."""
    count_only: List[str] = []
    numeric: List[Tuple[str, bool]] = []
    for name in schema.names:
        f64 = PC._fusable_f64(schema.field(name).type)
        if f64 is None:
            count_only.append(name)
        else:
            numeric.append((name, f64))
    return count_only, numeric


# A plan-shaped object for ``partials_from_batch``: ``group_by`` and
# ``agg_ops`` only (the capture has no AggSpecs and no filter).
_CaptureSpec = PC._PartialsSpec


def _capture_ops(count_only, numeric):
    """The agg-op list capturing every column's partial state, and per
    column its slots in it."""
    ops: List[Tuple[int, Optional[str]]] = [(PC._OP_COUNT_STAR, None)]
    slots: Dict[str, Dict[str, int]] = {}
    for c in count_only:
        slots[c] = {"cnt": len(ops)}
        ops.append((PC._OP_COUNT_COL, c))
    for c, f64 in numeric:
        slots[c] = {
            "sum": len(ops),
            "min": len(ops) + 1,
            "max": len(ops) + 2,
            "f64": 1 if f64 else 0,
        }
        if f64:
            ops.extend([(PC._OP_SUM_F64, c), (PC._OP_MIN_F64, c), (PC._OP_MAX_F64, c)])
        else:
            ops.extend([(PC._OP_SUM_I64, c), (PC._OP_MIN_I64, c), (PC._OP_MAX_I64, c)])
    return ops, slots


def _partials_to_cols(pt, slots) -> Dict[str, Dict[str, list]]:
    """Per-column stored lists (one cell a group) from one partials
    snapshot: the inverse of :func:`rg_partials`' mapping."""
    G = pt.n_groups
    cols: Dict[str, Dict[str, list]] = {}
    for name, sl in slots.items():
        if "sum" not in sl:  # count-only column
            a = sl["cnt"]
            cols[name] = {"cnt": [int(pt.acc_cnt[a, g]) for g in range(G)]}
            continue
        a_sum, a_min, a_max = sl["sum"], sl["min"], sl["max"]
        cnt = [int(pt.acc_cnt[a_sum, g]) for g in range(G)]
        if sl["f64"]:
            clean = [int(pt.acc_aux[a_min, g]) for g in range(G)]
            nan = [int(pt.acc_aux[a_max, g]) for g in range(G)]
            cols[name] = {
                "cnt": cnt,
                "f64": 1,
                "sum": [_enc_f64(pt.acc_f[a_sum, g]) for g in range(G)],
                "min": [_enc_f64(pt.acc_f[a_min, g]) if clean[g] else None for g in range(G)],
                "max": [_enc_f64(pt.acc_f[a_max, g]) if clean[g] else None for g in range(G)],
                "clean": clean,
                "nan": nan,
            }
        else:
            cols[name] = {
                "cnt": cnt,
                "f64": 0,
                "sum": [int(pt.acc_i[a_sum, g]) for g in range(G)],
                "min": [int(pt.acc_i[a_min, g]) if cnt[g] else None for g in range(G)],
                "max": [int(pt.acc_i[a_max, g]) if cnt[g] else None for g in range(G)],
            }
    return cols


def _sample_rng(basename: str, rg: int):
    """Deterministic generator per (file, row group), so capture and lazy
    backfill draw the same sample rows."""
    seed = murmur3_64_bytes(f"hs-aggsample:{basename}:{rg}".encode("utf-8"))
    return np.random.default_rng(np.uint64(np.int64(seed)))


#: the faults of the data that the capture and the backfill absorb (the
#: sidecars are a precomputed optimization): unreadable or malformed
#: files, columns the capture cannot fold. A kernel that fails to build or
#: launch (``KernelBuildError``, ``RuntimeError``) is not among them.
_DATA_FAULTS = (OSError, ValueError, pa.ArrowException)


def file_agg_doc(
    path: str,
    max_groups: int = C.INDEX_AGG_MAX_GROUPS_DEFAULT,
    sample_rows: int = C.INDEX_AGG_SAMPLE_ROWS_DEFAULT,
    group_keys: Optional[Tuple[str, ...]] = None,
    device=None,
) -> Tuple[dict, Optional[pa.Table]]:
    """(sidecar entry, stratified sample table) of ONE index data file,
    computed from the file itself: the one definition of capture and
    lazy backfill (:func:`file_agg_docs` of one file).

    ``group_keys`` restricts the grouped capture to those columns
    (lowercase match): the serve path's backfill passes the one key its
    query groups by; capture leaves it None (every fusable column)."""
    return file_agg_docs([path], max_groups, sample_rows, group_keys, device)[0]


def file_agg_docs(
    paths,
    max_groups: int = C.INDEX_AGG_MAX_GROUPS_DEFAULT,
    sample_rows: int = C.INDEX_AGG_SAMPLE_ROWS_DEFAULT,
    group_keys: Optional[Tuple[str, ...]] = None,
    device=None,
) -> List[Tuple[dict, Optional[pa.Table]]]:
    """:func:`file_agg_doc` of each file of ``paths``, in order. Per row
    group the entry holds the partials of every column, and for each
    fusable key candidate the grouped partials when the row group has at
    most ``max_groups`` distinct keys (a prefix of 4 x cap rows rejects
    high-cardinality columns cheaply: a prefix can only under-count, so it
    never rejects an eligible column). The partials come from
    ``pipeline_compiler.partials_from_batch``'s route on ``device`` (None
    is cuda), the row groups of files that share a schema taken together
    through ``pipeline_compiler.partials_per_chunk``, so a row group's
    partials are those of a pass over it alone (the reference passes each
    row group apart). A run of files holds at most a fold's rows on the
    host at once."""
    device = PC._resolve(device)
    out: List[Tuple[dict, Optional[pa.Table]]] = []
    run: list = []  # consecutive files of one schema, up to a fold's rows
    rows = 0
    for path in paths:
        pf = pq.ParquetFile(path)
        if run and (not pf.schema_arrow.equals(run[0][1].schema_arrow)
                    or rows + pf.metadata.num_rows > PC._FUSED_FOLD_ROWS):
            out.extend(_run_docs(run, max_groups, sample_rows, group_keys, device))
            run, rows = [], 0
        run.append((path, pf))
        rows += pf.metadata.num_rows
    if run:
        out.extend(_run_docs(run, max_groups, sample_rows, group_keys, device))
    return out


@dataclasses.dataclass
class _Cell:
    """One row group of a capture run: its file's position, its table
    and decoded batch."""

    file: int
    table: pa.Table
    batch: object


def _run_docs(run, max_groups, sample_rows, group_keys, device):
    count_only, numeric = _capture_spec(run[0][1].schema_arrow)
    ops, slots = _capture_ops(count_only, numeric)
    key_candidates = [c for c, _f in numeric]
    if group_keys is not None:
        wanted = {k.lower() for k in group_keys}
        key_candidates = [c for c in key_candidates if c.lower() in wanted]
    entries, samples, cells = [], [], []
    t_read = time.perf_counter()
    for fi, (path, pf) in enumerate(run):
        entry: dict = {"rg_rows": [], "cols": {c: {"cnt": []} for c in count_only},
                       "groups": {c: [] for c in key_candidates}}
        for c, f64 in numeric:
            keys = ("cnt", "f64", "sum", "min", "max") + (("clean", "nan") if f64 else ())
            entry["cols"][c] = {k: [] for k in keys}
        entries.append(entry)
        base = os.path.basename(path)
        file_samples = []
        for gi in range(pf.metadata.num_row_groups):
            table = pf.read_row_group(gi)
            n = table.num_rows
            entry["rg_rows"].append(n)
            cells.append(_Cell(fi, table, ColumnarBatch.from_arrow(table)))
            if sample_rows > 0 and n > 0:
                k = min(sample_rows, n)
                idx = np.sort(_sample_rng(base, gi).choice(n, size=k, replace=False))
                sampled = table.take(idx)
                sampled = sampled.add_column(0, "__rg", pa.array(np.full(k, gi, dtype=np.int32)))
                sampled = sampled.add_column(0, "__file", pa.array([base] * k, type=pa.string()))
                file_samples.append(sampled)
        samples.append(pa.concat_tables(file_samples, promote_options="permissive")
                       if file_samples else None)
    t_fold = time.perf_counter()
    capture_stats["read"] += t_fold - t_read
    parts = _cell_partials(cells, None, ops, device)
    capture_stats["fold"] += time.perf_counter() - t_fold
    for cell, pt in zip(cells, parts):
        dst = entries[cell.file]["cols"]
        for c, cell_cols in _partials_to_cols(pt, slots).items():
            for k, vals in cell_cols.items():
                if k == "f64":
                    dst[c]["f64"] = vals
                else:
                    dst[c][k].append(vals[0] if vals else None)
    for kc in key_candidates:
        eligible = []
        for cell in cells:
            n = cell.table.num_rows
            if n == 0 or max_groups <= 0:
                continue
            probe = cell.batch.column(kc).take(np.arange(min(n, 4 * max_groups))).key_rep()
            if len(np.unique(probe)) <= max_groups:
                eligible.append(cell)
        t_fold = time.perf_counter()
        grouped = dict(zip(map(id, eligible), _cell_partials(eligible, kc, ops, device)))
        capture_stats["fold"] += time.perf_counter() - t_fold
        for cell in cells:
            gpt = grouped.get(id(cell))
            if gpt is None or gpt.n_groups > max_groups:
                entries[cell.file]["groups"][kc].append(None)
                continue
            gentry: dict = {
                "kv": [int(v) for v in gpt.g_kvals[0]],
                "n": [int(v) for v in gpt.acc_cnt[0]],
                "cols": _partials_to_cols(gpt, slots),
            }
            if gpt.key_has_validity[0]:
                gentry["kn"] = [int(v) for v in gpt.g_kvalid[0]]
            entries[cell.file]["groups"][kc].append(gentry)
    for entry in entries:  # drop grouped candidates over the cap everywhere
        entry["groups"] = {k: v for k, v in entry["groups"].items()
                           if any(e is not None for e in v)}
    return list(zip(entries, samples))


def _cell_partials(cells, key: Optional[str], ops, device) -> list:
    """Each cell's partials, ungrouped (``key`` None) or grouped by
    ``key`` with its groups in ``_factorize``'s order, as
    ``partials_from_batch`` gives them over the cell alone. An empty cell
    takes ``partials_from_batch`` itself (an ungrouped one still has its
    one group)."""
    spec = _CaptureSpec(() if key is None else (key,), ops)
    full = [c for c in cells if c.table.num_rows]
    parts = PC.partials_per_chunk(spec, [c.table for c in full], device, group_order=True,
                                  stats=capture_stats)
    if parts is None:
        raise ValueError("uncapturable column set")
    got = dict(zip(map(id, full), parts))
    return [got[id(c)] if c.table.num_rows else
            PC.partials_from_batch(spec, c.batch, device=device) for c in cells]


# ---------------------------------------------------------------------------
# Capture (create, refresh and optimize time) and vacuum
# ---------------------------------------------------------------------------


def capture_index_dir(dir_path: str, index, conf=None, device=None) -> bool:
    """Write ``_aggstate.json`` and ``_aggsample.parquet`` for one freshly
    written index version directory (covering and z-order covering
    indexes, as the zone maps), each through a
    temporary file and an atomic replace, the partials computed on
    ``device`` (None is cuda). Returns True when written."""
    capture_stats.update(read=0.0, fold=0.0, passes=0, overflowed=0)
    kind = getattr(index, "kind", "")
    if kind not in ("CoveringIndex", "ZOrderCoveringIndex"):
        return False
    if conf is not None and not conf.index_agg_enabled:
        return False
    max_groups = conf.index_agg_max_groups if conf is not None else C.INDEX_AGG_MAX_GROUPS_DEFAULT
    sample_rows = (
        conf.index_agg_sample_rows if conf is not None else C.INDEX_AGG_SAMPLE_ROWS_DEFAULT
    )
    try:
        files = pio.list_format_files(dir_path, "parquet")
    except (OSError, KeyError):
        return False
    if not files:
        return False
    doc: dict = {"version": _SIDECAR_VERSION, "files": {}}
    sample_tables: List[pa.Table] = []
    for f, (entry, sample) in zip(files, file_agg_docs(files, max_groups, sample_rows,
                                                         device=device)):
        st = os.stat(f)
        entry["size"] = st.st_size
        entry["mtime_ns"] = st.st_mtime_ns
        doc["files"][os.path.basename(f)] = entry
        if sample is not None:
            sample_tables.append(sample)
    side_path = os.path.join(dir_path, SIDECAR_NAME)
    tmp = os.path.join(dir_path, f".{SIDECAR_NAME}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        # crash seam: a publish that dies here leaves the sidecar absent,
        # never torn (SimulatedCrash is no OSError and fails the action)
        faults.crash("mid_sidecar_publish", side_path)
        os.replace(tmp, side_path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    if sample_tables:
        sample_path = os.path.join(dir_path, SAMPLE_NAME)
        stmp = os.path.join(dir_path, f".{SAMPLE_NAME}.tmp.{os.getpid()}")
        try:
            pq.write_table(pa.concat_tables(sample_tables, promote_options="permissive"), stmp)
            faults.crash("mid_sidecar_publish", sample_path)
            os.replace(stmp, sample_path)
        except OSError:
            try:
                os.unlink(stmp)
            except OSError:
                pass
    fsync_dir(dir_path)
    return True


def capture_safely(dir_path: str, index, conf=None, device=None) -> None:
    """The lifecycle actions' capture entry on ``device`` (None is cuda): the
    sidecars are a precomputed optimization (the serve path backfills
    without them), so a fault of the data (``_DATA_FAULTS``) logs and
    writes none. A kernel that fails to build or launch fails the build,
    as it fails any device work (the reference, with no device in its
    capture, absorbs every exception)."""
    try:
        capture_index_dir(dir_path, index, conf, device)
    except _DATA_FAULTS as exc:
        _log.warning("aggstate capture failed for %s: %s", dir_path, exc)


def prune_missing(dir_path: str) -> None:
    """Vacuum support: rewrite the sidecars of a RETAINED version dir to
    drop the entries and sample rows of files that no longer exist (the
    sidecar travels with the files it describes; a whole dir's sidecars
    go with the dir). Best effort: a stale entry is also defused by the
    per-file (size, mtime_ns) check at assembly. The rewrite is the
    reference's, byte for byte (indented, sorted keys, temp file, fsync,
    atomic replace)."""
    side_path = os.path.join(dir_path, SIDECAR_NAME)
    try:
        with open(side_path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        kept = {
            base: entry
            for base, entry in doc.get("files", {}).items()
            if os.path.exists(os.path.join(dir_path, base))
        }
        if len(kept) != len(doc.get("files", {})):
            if kept:
                doc["files"] = kept
                tmp = f"{side_path}.tmp.{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(doc, fh, indent=2, sort_keys=True)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, side_path)
            else:
                os.unlink(side_path)
    except (OSError, ValueError):
        pass
    sample_path = os.path.join(dir_path, SAMPLE_NAME)
    try:
        if os.path.exists(sample_path):
            table = pq.read_table(sample_path)
            bases = table.column("__file").to_pylist()
            keep = np.array([os.path.exists(os.path.join(dir_path, b)) for b in bases])
            if not keep.all():
                if keep.any():
                    tmp = sample_path + f".tmp.{os.getpid()}"
                    pq.write_table(table.filter(pa.array(keep)), tmp)
                    os.replace(tmp, sample_path)
                else:
                    os.unlink(sample_path)
    except (OSError, ValueError, KeyError, pa.ArrowInvalid):
        pass


# ---------------------------------------------------------------------------
# Sidecar read and lazy backfill (memoized per file identity)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _sidecar_cached(path: str, _size: int, _mtime_ns: int) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    if data.get("version") != _SIDECAR_VERSION:
        return None
    return data


def _sidecar_for_dir(dirpath: str) -> Optional[dict]:
    path = os.path.join(dirpath, SIDECAR_NAME)
    try:
        st = os.stat(path)
    except OSError:
        return None
    return _sidecar_cached(path, st.st_size, st.st_mtime_ns)


@functools.lru_cache(maxsize=16)
def _backfill_cached(
    path: str,
    _size: int,
    _mtime_ns: int,
    keys: Optional[Tuple[str, ...]],
    max_groups: int,
    sample_rows: int,
    device: str,
):
    """Lazy backfill for a file without a fresh sidecar entry: the same
    doc, computed on ``device`` by reading the file once. Keyed by file
    identity (a rewritten file gets a fresh computation), the grouped-key
    restriction, the capture knobs and the device."""
    return file_agg_doc(path, max_groups, sample_rows, keys, device)


def _entry_for_file(
    path: str,
    side: Optional[dict],
    keys: Optional[Tuple[str, ...]],
    max_groups: int,
    sample_rows: int,
    device: str,
):
    """(entry, from_sidecar): this file's sidecar entry when present and
    stat-fresh, else the lazy backfill on ``device``; (None, False) when
    the file cannot be read or folded (a fault of the data: the caller
    scans it). A kernel that fails to build or launch raises."""
    try:
        st = os.stat(path)
    except OSError:
        return None, False
    if side is not None:
        entry = side.get("files", {}).get(os.path.basename(path))
        if (
            entry is not None
            and entry.get("size") == st.st_size
            and entry.get("mtime_ns") == st.st_mtime_ns
        ):
            return entry, True
    try:
        entry, _sample = _backfill_cached(
            path, st.st_size, st.st_mtime_ns, keys, max_groups, sample_rows, device
        )
        return entry, False
    except _DATA_FAULTS as exc:  # backfill only costs the metadata answer
        _log.warning("aggstate backfill failed for %s: %s", path, exc)
        return None, False


# ---------------------------------------------------------------------------
# Serve-side assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AggData:
    """Decoded aggregate state of one file set, assembled once and cached
    in the module LRU. ``backfill_keys``: the grouped keys any backfilled
    part was restricted to (lowercase; None = unrestricted), so a hit
    serves only a query whose key it covers."""

    files: Tuple[str, ...]
    per_file: list  # decoded per-file dict, or None (unreadable)
    sidecar_files: int
    backfill_files: int
    nbytes: int
    backfill_keys: Optional[frozenset] = None
    per_file_sidecar: Tuple[bool, ...] = ()

    def covers_key(self, group_key: Optional[str]) -> bool:
        if self.backfill_files == 0 or group_key is None:
            return True
        if self.backfill_keys is None:
            return True
        return group_key.lower() in self.backfill_keys


def _decode_cols(stored: dict) -> Tuple[Dict[str, dict], int]:
    cols: Dict[str, dict] = {}
    scalars = 0
    for name, st in stored.items():
        cnt = _dec_i64_arr(st.get("cnt", []), 0)
        scalars += 6 * len(cnt)
        if "sum" not in st:
            cols[name] = {"cnt": cnt}
        elif st.get("f64"):
            cols[name] = {
                "cnt": cnt,
                "is_f64": True,
                "sum": _dec_f64_arr(st["sum"], 0.0),
                "min": _dec_f64_arr(st["min"], np.inf),
                "max": _dec_f64_arr(st["max"], -np.inf),
                "clean": _dec_i64_arr(st.get("clean", []), 0),
                "nan": _dec_i64_arr(st.get("nan", []), 0),
            }
        else:
            cols[name] = {
                "cnt": cnt,
                "is_f64": False,
                "sum": _dec_i64_arr(st["sum"], 0),
                "min": _dec_i64_arr(st["min"], _I64_MAX),
                "max": _dec_i64_arr(st["max"], _I64_MIN),
            }
    return cols, scalars


def _decode_entry(entry: dict) -> Tuple[dict, int]:
    """Runtime (numpy) form of one stored file entry, and its byte
    estimate."""
    rg_rows = [int(r) for r in entry.get("rg_rows", [])]
    cols, scalars = _decode_cols(entry.get("cols", {}))
    groups: Dict[str, list] = {}
    for kc, per_rg in entry.get("groups", {}).items():
        decoded = []
        for g in per_rg:
            if g is None:
                decoded.append(None)
                continue
            gcols, n = _decode_cols(g.get("cols", {}))
            scalars += n + 2 * len(g.get("kv", []))
            decoded.append(
                {
                    "kv": np.array(g["kv"], dtype=np.int64),
                    "kvalid": np.array(g["kn"], dtype=np.uint8) if "kn" in g else None,
                    "n": np.array(g["n"], dtype=np.int64),
                    "cols": gcols,
                }
            )
        groups[kc.lower()] = decoded
    return {"rg_rows": rg_rows, "cols": cols, "groups": groups}, 64 + 8 * scalars


# Module LRU of assembled agg data, keyed by the file fingerprint (so a
# changed file set is a new key), bounded in entries and in bytes. Every
# access under _local_lock.
_local_lock = threading.Lock()
_local_cache: "OrderedDict[tuple, AggData]" = OrderedDict()
_local_bytes = 0
_LOCAL_CACHE_ENTRIES = 32
_LOCAL_CACHE_MAX_BYTES = 128 << 20


def _local_put(key, data: AggData) -> None:
    """Insert into the module LRU, evicting oldest-first until both caps
    hold. The caller must not hold _local_lock."""
    global _local_bytes
    nbytes = int(data.nbytes)
    if nbytes > _LOCAL_CACHE_MAX_BYTES:
        return
    with _local_lock:
        old = _local_cache.pop(key, None)
        if old is not None:
            _local_bytes -= int(old.nbytes)
        while _local_cache and (
            len(_local_cache) >= _LOCAL_CACHE_ENTRIES
            or _local_bytes + nbytes > _LOCAL_CACHE_MAX_BYTES
        ):
            _, victim = _local_cache.popitem(last=False)
            _local_bytes -= int(victim.nbytes)
        _local_cache[key] = data
        _local_bytes += nbytes


def agg_data_for(
    rel, conf=None, group_key: Optional[str] = None, device=None, cache=None
) -> Optional[AggData]:
    """Assembled aggregate state of a relation's file set, from the serve
    ``cache`` (``("aggstate", fp)``), the module LRU, the sidecars or the
    lazy backfill (on ``device``; None is cuda, resolved before any file).
    ``conf`` gives the capture knobs for a backfill; ``group_key``
    restricts its grouped pass to the one key the query needs. None when
    the files cannot be fingerprinted (the caller skips the plane)."""
    fp = file_fingerprint(rel.files)
    if fp is None:
        return None
    key = ("aggstate", fp)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None and hit.covers_key(group_key):
            return hit
    with _local_lock:
        hit = _local_cache.get(key)
        if hit is not None and hit.covers_key(group_key):
            _local_cache.move_to_end(key)
            return hit
    max_groups = conf.index_agg_max_groups if conf is not None else C.INDEX_AGG_MAX_GROUPS_DEFAULT
    sample_rows = (
        conf.index_agg_sample_rows if conf is not None else C.INDEX_AGG_SAMPLE_ROWS_DEFAULT
    )
    bf_keys: Tuple[str, ...] = () if group_key is None else (group_key.lower(),)
    if not bf_keys:
        max_groups = 0  # no grouped capture wanted: one memo for ungrouped backfills
    dev = str(PC._resolve(device))
    side_by_dir: Dict[str, Optional[dict]] = {}
    per_file: list = []
    provenance: list = []
    nbytes = 256
    sidecar_n = backfill_n = 0
    for path in rel.files:
        d = os.path.dirname(path)
        if d not in side_by_dir:
            side_by_dir[d] = _sidecar_for_dir(d)
        entry, from_sidecar = _entry_for_file(
            path, side_by_dir[d], bf_keys, max_groups, sample_rows, dev
        )
        provenance.append(bool(from_sidecar))
        if entry is None:
            per_file.append(None)
            continue
        decoded, nb = _decode_entry(entry)
        per_file.append(decoded)
        nbytes += nb
        if from_sidecar:
            sidecar_n += 1
        else:
            backfill_n += 1
    data = AggData(
        files=tuple(rel.files),
        per_file=per_file,
        sidecar_files=sidecar_n,
        backfill_files=backfill_n,
        nbytes=nbytes,
        backfill_keys=frozenset(bf_keys) if backfill_n else None,
        per_file_sidecar=tuple(provenance),
    )
    if cache is not None:
        cache.put(key, data, data.nbytes)
    _local_put(key, data)
    return data


def invalidate_local_cache() -> None:
    """Drop the module's assembled cache (the sidecar and backfill memos
    are keyed by file identity and never serve stale)."""
    global _local_bytes
    with _local_lock:
        _local_cache.clear()
        _local_bytes = 0


def invalidate_paths_under(root: str) -> int:
    """Drop only the LRU entries whose fingerprint names a file under
    ``root``; returns how many went."""
    prefix = root.replace("\\", "/").rstrip("/") + "/"

    def _mentions(obj) -> bool:
        if isinstance(obj, str):
            return obj.replace("\\", "/").startswith(prefix)
        if isinstance(obj, tuple):
            return any(_mentions(x) for x in obj)
        return False

    global _local_bytes
    with _local_lock:
        victims = [k for k in _local_cache if _mentions(k)]
        for k in victims:
            victim = _local_cache.pop(k)
            _local_bytes -= int(victim.nbytes)
        return len(victims)


# ---------------------------------------------------------------------------
# Classification: FULL / EMPTY / PARTIAL per selected row group
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Fan-out payloads: a committed file set's aggregate state, pushed to peer
# serve processes instead of invalidated (``serve/bus.py`` carries the
# payload, ``serve/fleet.py`` installs it)
# ---------------------------------------------------------------------------


def fanout_payload(files) -> Optional[dict]:
    """JSON-safe push payload of one committed file set: the raw per-file
    sidecar entries and the file fingerprint the receivers key by. None
    unless EVERY file has a stat-fresh sidecar entry (a partial push would
    make the receiver's assembly lie about coverage)."""
    files = tuple(files)
    if not files:
        return None
    fp = file_fingerprint(files)
    if fp is None:
        return None
    side_by_dir: Dict[str, Optional[dict]] = {}
    entries: Dict[str, dict] = {}
    for path in files:
        d = os.path.dirname(path)
        if d not in side_by_dir:
            side_by_dir[d] = _sidecar_for_dir(d)
        side = side_by_dir[d]
        if side is None:
            return None
        entry = side.get("files", {}).get(os.path.basename(path))
        try:
            st = os.stat(path)
        except OSError:
            return None
        if (
            entry is None
            or entry.get("size") != st.st_size
            or entry.get("mtime_ns") != st.st_mtime_ns
        ):
            return None
        entries[path] = entry
    return {"files": list(files), "fp": [[p, s, m] for p, s, m in fp], "entries": entries}


def install_fanout_payload(payload: dict, cache=None) -> bool:
    """Install a pushed payload into this process's caches under
    ``("aggstate", fp)``, after checking the fingerprint against the files
    on disk now (a stale push would sit under an unreachable key, so it is
    dropped). Returns whether the install happened."""
    try:
        files = tuple(str(f) for f in payload["files"])
        fp = tuple((str(p), int(s), int(m)) for p, s, m in payload["fp"])
        raw_entries = payload["entries"]
    except (KeyError, TypeError, ValueError):
        return False
    if not files or file_fingerprint(files) != fp:
        return False
    per_file: list = []
    nbytes = 256
    try:
        for path in files:
            decoded, nb = _decode_entry(raw_entries[path])
            per_file.append(decoded)
            nbytes += nb
    except (KeyError, TypeError, ValueError):
        return False
    data = AggData(
        files=files,
        per_file=per_file,
        sidecar_files=len(files),
        backfill_files=0,
        nbytes=nbytes,
        backfill_keys=None,
        per_file_sidecar=(True,) * len(files),
    )
    key = ("aggstate", fp)
    if cache is not None:
        cache.put(key, data, data.nbytes)
    _local_put(key, data)
    return True


def _zone_verdict(st: Optional[dict], gi: int, iv, rows: int) -> str:
    """One conjunct column's verdict for one row group: "empty" (no row
    can satisfy it), "full" (every row provably does) or "partial".
    Rounding is outward for the empty test and inward for the full test,
    so it can only demote toward "partial"."""
    if iv.empty:
        return "empty"
    if st is None or "sum" not in st and "min" not in st:
        return "partial"  # count-only column (string/bool/narrow): abstain
    cnt = int(st["cnt"][gi]) if gi < len(st["cnt"]) else None
    if cnt is None:
        return "partial"
    if cnt == 0:
        return "empty"  # all-null group: no row satisfies a comparison
    is_f64 = bool(st.get("is_f64"))
    if is_f64:
        clean = int(st["clean"][gi])
        if clean == 0:
            return "empty"  # every valid value is NaN: all rows fail
    lo_v = st["min"][gi]
    hi_v = st["max"][gi]
    lo_r = f64_down(lo_v.item() if isinstance(lo_v, np.generic) else lo_v)
    hi_r = f64_up(hi_v.item() if isinstance(hi_v, np.generic) else hi_v)
    if iv.lo is not None:
        b = f64_down(iv.lo)
        keep = hi_r > b if iv.lo_strict else hi_r >= b
        if not keep:
            return "empty"
    if iv.hi is not None:
        b = f64_up(iv.hi)
        keep = lo_r < b if iv.hi_strict else lo_r <= b
        if not keep:
            return "empty"
    full = cnt == rows and (not is_f64 or int(st["nan"][gi]) == 0)
    if full and iv.lo is not None:
        b = f64_up(iv.lo)
        full = lo_r > b if iv.lo_strict else lo_r >= b
    if full and iv.hi is not None:
        b = f64_down(iv.hi)
        full = hi_r < b if iv.hi_strict else hi_r <= b
    return "full" if full else "partial"


def _op_available(op: int, cname: Optional[str], cols: Dict[str, dict]) -> bool:
    if op == PC._OP_COUNT_STAR:
        return True
    st = cols.get(cname)
    if st is None or "cnt" not in st:
        return False
    if op == PC._OP_COUNT_COL:
        return True
    return "sum" in st


def classify_row_groups(
    data: AggData, rel, ivs, key: Optional[str], fplan
) -> Optional[List[Tuple[int, Optional[int], str]]]:
    """Per selected (file, row group): "full" | "empty" | "partial", in the
    interpreted chain's read order. FULL also needs the stored partials
    the lowering reads (the grouped entry for ``key``, each aggregate
    input's state); without them it demotes to "partial". A file without
    usable state is one whole-file "partial" cell."""
    key_lower = key.lower() if key is not None else None
    cells: List[Tuple[int, Optional[int], str]] = []
    groups_sel = rel.file_row_groups or (None,) * len(rel.files)
    for fi, _path in enumerate(rel.files):
        pf = data.per_file[fi]
        if pf is None:
            cells.append((fi, None, "partial"))
            continue
        n_rg = len(pf["rg_rows"])
        sel = groups_sel[fi]
        rgs = sel if sel is not None else range(n_rg)
        for gi in rgs:
            if gi >= n_rg:
                cells.append((fi, gi, "partial"))
                continue
            rows = pf["rg_rows"][gi]
            if rows == 0:
                cells.append((fi, gi, "empty"))
                continue
            kind = "full"
            for col, iv in ivs.items():
                v = _zone_verdict(pf["cols"].get(col), gi, iv, rows)
                if v == "empty":
                    kind = "empty"
                    break
                if v == "partial":
                    kind = "partial"
            if kind == "full":
                if key_lower is not None:
                    glist = pf["groups"].get(key_lower)
                    g = glist[gi] if glist is not None and gi < len(glist) else None
                    if g is None or not all(
                        _op_available(op, c, g["cols"]) for op, c in fplan.agg_ops
                    ):
                        kind = "partial"
                elif not all(_op_available(op, c, pf["cols"]) for op, c in fplan.agg_ops):
                    kind = "partial"
            cells.append((fi, gi, kind))
    return cells


# ---------------------------------------------------------------------------
# Stored state -> AggPartials (the fold input of a FULL row group)
# ---------------------------------------------------------------------------


def rg_partials(data: AggData, fi: int, gi: int, fplan, key: Optional[str]):
    """One FULL row group's stored partials as ``AggPartials``: every row
    passes, so the stored unfiltered state is the chunk state the sweep
    would have produced."""
    pf = data.per_file[fi]
    rows = pf["rg_rows"][gi]
    na = len(fplan.agg_ops)
    if key is None:
        G = 1
        g_reps = np.zeros((0, G), dtype=np.int64)
        g_nulls = np.zeros((0, G), dtype=np.uint8)
        g_kvals = np.zeros((0, G), dtype=np.int64)
        g_kvalid = np.ones((0, G), dtype=np.uint8)
        khv: Tuple[bool, ...] = ()

        def cell(col, field):
            return pf["cols"][col][field][gi : gi + 1]

        count_star = np.array([rows], dtype=np.int64)
    else:
        g = pf["groups"][key.lower()][gi]
        G = len(g["n"])
        kvals = g["kv"]
        kvalid = g["kvalid"]
        col = Column(
            "numeric",
            fplan.key_types[0],
            values=kvals.view(np.float64) if fplan.key_f64[0] else kvals,
            validity=None if kvalid is None else kvalid.astype(bool),
        )
        reps = col.key_rep()
        nm = col.null_mask
        g_reps = reps.reshape(1, G)
        g_nulls = (nm.astype(np.uint8) if nm is not None else np.zeros(G, np.uint8)).reshape(1, G)
        g_kvals = kvals.reshape(1, G)
        g_kvalid = (kvalid if kvalid is not None else np.ones(G, dtype=np.uint8)).reshape(1, G)
        khv = (kvalid is not None,)

        def cell(colname, field):
            return g["cols"][colname][field]

        count_star = g["n"]
    acc_i = np.zeros((na, G), dtype=np.int64)
    acc_f = np.zeros((na, G), dtype=np.float64)
    acc_cnt = np.zeros((na, G), dtype=np.int64)
    acc_aux = np.zeros((na, G), dtype=np.int64)
    for a, (op, c) in enumerate(fplan.agg_ops):
        if op == PC._OP_COUNT_STAR:
            acc_cnt[a] = count_star
            continue
        acc_cnt[a] = cell(c, "cnt")
        if op == PC._OP_COUNT_COL:
            continue
        if op == PC._OP_SUM_I64:
            acc_i[a] = cell(c, "sum")
        elif op == PC._OP_MIN_I64:
            acc_i[a] = cell(c, "min")
        elif op == PC._OP_MAX_I64:
            acc_i[a] = cell(c, "max")
        elif op == PC._OP_MIN_F64:
            acc_f[a] = cell(c, "min")
            acc_aux[a] = cell(c, "clean")
        elif op == PC._OP_MAX_F64:
            acc_f[a] = cell(c, "max")
            acc_aux[a] = cell(c, "nan")
        else:  # float SUM never reaches here: the lowering declined it
            return None
    return PC.AggPartials(
        n_groups=G,
        rows_scanned=0,
        rows_passed=int(rows),
        g_reps=g_reps,
        g_nulls=g_nulls,
        g_kvals=g_kvals,
        g_kvalid=g_kvalid,
        key_has_validity=khv,
        acc_i=acc_i,
        acc_f=acc_f,
        acc_cnt=acc_cnt,
        acc_aux=acc_aux,
    )


# ---------------------------------------------------------------------------
# Stratified samples for the approximate plane
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _sample_table_cached(path: str, _size: int, _mtime_ns: int) -> Optional[pa.Table]:
    try:
        return pq.read_table(path)
    except (OSError, pa.ArrowInvalid):
        return None


def _sample_table_for_dir(dirpath: str) -> Optional[pa.Table]:
    path = os.path.join(dirpath, SAMPLE_NAME)
    try:
        st = os.stat(path)
    except OSError:
        return None
    return _sample_table_cached(path, st.st_size, st.st_mtime_ns)


def sample_data_for(rel, conf=None, device=None) -> Optional[dict]:
    """Stratified sample over a relation's file set for the approximate
    plane: ``{"table": pa.Table (sample rows, file order), "stratum":
    int array a sample row, "N": rows a stratum, "n": sampled rows a
    stratum}``. Strata are (file, row group). None when a file has
    neither a sample sidecar nor a computable backfill (a backfill runs
    on ``device``, None being cuda)."""
    data = agg_data_for(rel, conf, None, device)
    if data is None:
        return None
    sample_rows = (
        conf.index_agg_sample_rows if conf is not None else C.INDEX_AGG_SAMPLE_ROWS_DEFAULT
    )
    dev = str(PC._resolve(device))
    tables: List[pa.Table] = []
    stratum_ids: List[np.ndarray] = []
    N: List[int] = []
    n: List[int] = []
    sample_by_dir: Dict[str, Optional[pa.Table]] = {}
    for fi, path in enumerate(rel.files):
        pf = data.per_file[fi]
        if pf is None:
            return None
        d = os.path.dirname(path)
        base = os.path.basename(path)
        if d not in sample_by_dir:
            sample_by_dir[d] = _sample_table_for_dir(d)
        stable = sample_by_dir[d]
        ftable = None
        # the directory's sample serves only files whose aggstate entry
        # was stat-fresh: a rewritten file samples from its backfill
        fresh = fi < len(data.per_file_sidecar) and data.per_file_sidecar[fi]
        if fresh and stable is not None and "__file" in stable.column_names:
            ftable = stable.filter(pa_compute.equal(stable.column("__file"), base))
        if ftable is None or ftable.num_rows == 0:
            try:
                st = os.stat(path)
                _entry, ftable = _backfill_cached(
                    path, st.st_size, st.st_mtime_ns, (), 0, sample_rows, dev
                )
            except _DATA_FAULTS:
                ftable = None
        rg_rows = pf["rg_rows"]
        if ftable is None:
            if sum(rg_rows) == 0:
                continue  # an empty file contributes no strata
            return None
        rgs = np.asarray(ftable.column("__rg"))
        for gi, rows in enumerate(rg_rows):
            if rows == 0:
                continue
            sel = np.nonzero(rgs == gi)[0]
            sid = len(N)
            N.append(int(rows))
            n.append(int(len(sel)))
            if len(sel):
                tables.append(ftable.take(sel).drop_columns(["__file", "__rg"]))
                stratum_ids.append(np.full(len(sel), sid, dtype=np.int64))
    if not N:
        return None
    if any(v == 0 for v in n):
        return None  # a stratum with rows but no sample: not estimable
    return {
        "table": pa.concat_tables(tables, promote_options="permissive"),
        "stratum": np.concatenate(stratum_ids),
        "N": np.asarray(N, dtype=np.int64),
        "n": np.asarray(n, dtype=np.int64),
    }
