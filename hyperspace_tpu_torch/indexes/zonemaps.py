"""Zone maps: per-file and per-row-group min/max (and null counts) of
index data files, and the serve-side pruning pass built on them.

Counterpart of ``hyperspace_tpu/indexes/zonemaps.py`` for covering and
z-order covering indexes; both packages write and read one sidecar
format, so an index built by either is pruned the same way by the other:

* **capture** — at create time ``actions/create.py`` writes a
  ``_zonemaps.json`` sidecar into the version directory (underscore
  prefix: invisible to the log's content scan) holding per-file,
  per-row-group min/max and null counts; a z-order index's sidecar also
  holds each row group's z-address span (``rg_zspans``) under an encoder
  spec frozen over the directory's own data (``zorder``), its planes
  interleaved on the session's device (kernel B6);
* **lazy backfill** — an index without a sidecar (or a file whose entry
  is stale) reads the same statistics from the parquet footers,
  memoized per file identity (path, size, mtime_ns), so a rewritten file
  can never serve stale zone maps;
* **pruning** — ``prune_scan_relation`` intersects per-column intervals
  from the predicate's range/Eq/In conjuncts with the zone maps in one
  vectorized pass on the host, drops dead files, and narrows kept files
  to matching row groups (``Relation.file_row_groups``; read by
  ``io/parquet.read_table_row_groups``); over a z-order index the query
  box also decomposes into z-address ranges (``ops/zorder.z_box_ranges``)
  and a row group whose captured span misses every range is dropped.

Soundness contract: every decision is SUPERSET-safe — a file or row
group is dropped only when no row in it can satisfy the conjunction
(nulls and NaN rows never satisfy a comparison conjunct, so all-null
groups prune and NaN-poisoned statistics abstain). Statistics are
converted to a float64 comparable domain with OUTWARD directed rounding,
so rounding can only over-keep. The executor re-applies the full mask on
whatever survives.

With serve-server mode on, the assembled zone maps are also kept in the
session's serve cache (``("zonemap", fp)``, ``execution/serve_cache.py``);
:func:`invalidate_paths_under` drops one index's assembled maps when a fleet
peer changes it (``serve/fleet.py``). The pruning pass accumulates its
pruned rows onto the query's root span (``obs/trace.accumulate``).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import functools
import json
import logging
import math
import os
import threading
from bisect import bisect_left
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from hyperspace_tpu_torch.execution.serve_cache import file_fingerprint
from hyperspace_tpu_torch.obs import trace as _obs_trace
from hyperspace_tpu_torch.plan import expressions as E

_log = logging.getLogger("hyperspace_tpu_torch.zonemaps")

SIDECAR_NAME = "_zonemaps.json"
_SIDECAR_VERSION = 1

# ---------------------------------------------------------------------------
# Predicate → per-column intervals
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColInterval:
    """One column's interval under the conjunction, in ENGINE domain
    (temporal literals lowered to int64 ticks with the same op-aware
    snapping the mask uses; strings as python str). ``None`` bound =
    unbounded; ``empty`` = the conjuncts contradict (or a literal can
    never match), so no row anywhere satisfies them."""

    lo: Any = None
    hi: Any = None
    lo_strict: bool = False
    hi_strict: bool = False
    empty: bool = False


def _is_string_type(t: pa.DataType) -> bool:
    if pa.types.is_dictionary(t):
        t = t.value_type
    return pa.types.is_string(t) or pa.types.is_large_string(t)


def _plain_number(lit):
    """Literal as a plain int/float comparable against numeric statistics,
    or None to abstain (the mask path may still match it; never prune)."""
    if isinstance(lit, (np.integer, np.floating)):
        lit = lit.item()
    if isinstance(lit, bool):
        return int(lit)
    if isinstance(lit, float) and math.isnan(lit):
        # NaN comparisons are never true — but "=" against NaN is handled
        # by the empty interval below only for floats; abstaining is
        # always sound and keeps this helper single-purpose
        return None
    if isinstance(lit, (int, float)):
        return lit
    return None


def interval_for(op: str, lit, t: pa.DataType) -> Optional[ColInterval]:
    """Interval of one ``col <op> lit`` conjunct, or None to abstain."""
    if _is_string_type(t):
        # the engine str-casts literals for string columns
        # (plan/expressions._cmp), so mirror it
        val: Any = str(lit)
    elif pa.types.is_temporal(t):
        val = E.lower_literal(lit, t, op)
        if val is None:
            # op-aware lowering says the comparison can never hold (e.g.
            # equality against a between-tick instant, or an
            # unparseable literal) — exactly the engine's all-False mask
            return ColInterval(empty=True)
    else:
        val = _plain_number(lit)
        if val is None:
            return None
    if op == "=":
        return ColInterval(lo=val, hi=val)
    if op == "<":
        return ColInterval(hi=val, hi_strict=True)
    if op == "<=":
        return ColInterval(hi=val)
    if op == ">":
        return ColInterval(lo=val, lo_strict=True)
    if op == ">=":
        return ColInterval(lo=val)
    return None


def _in_interval(values, t: pa.DataType) -> Optional[ColInterval]:
    """[min, max] hull of an IN list's matchable literals (a superset of
    the point set, which is all pruning needs); empty when no literal can
    match — mirroring the engine's all-False IN mask."""
    if _is_string_type(t):
        vs = [v for v in values if isinstance(v, str)]
        if not vs:
            return ColInterval(empty=True)
        return ColInterval(lo=min(vs), hi=max(vs))
    lits = E.lower_in_literals([v for v in values if v is not None], t)
    lits = [int(v) if isinstance(v, bool) else v for v in lits]
    if not lits:
        return ColInterval(empty=True)
    return ColInterval(lo=min(lits), hi=max(lits))


def _merge(a: ColInterval, b: ColInterval) -> ColInterval:
    if a.empty or b.empty:
        return ColInterval(empty=True)
    lo, los = a.lo, a.lo_strict
    if b.lo is not None and (
        lo is None or b.lo > lo or (b.lo == lo and b.lo_strict)
    ):
        lo, los = b.lo, b.lo_strict
    hi, his = a.hi, a.hi_strict
    if b.hi is not None and (
        hi is None or b.hi < hi or (b.hi == hi and b.hi_strict)
    ):
        hi, his = b.hi, b.hi_strict
    out = ColInterval(lo=lo, hi=hi, lo_strict=los, hi_strict=his)
    if lo is not None and hi is not None:
        if lo > hi or (lo == hi and (los or his)):
            out.empty = True
    return out


def predicate_intervals(
    cond: E.Expr, schema: Dict[str, pa.DataType]
) -> Dict[str, ColInterval]:
    """Per-column intervals from the predicate's top-level range/Eq/In
    conjuncts (``!=``, OR trees, IS NULL and anything non-lowerable
    abstain). Keys are the ACTUAL schema column names."""
    cols = {c.lower(): c for c in schema}
    out: Dict[str, ColInterval] = {}
    for cj in E.split_conjuncts(cond):
        norm = E.normalize_comparison(cj)
        col = None
        iv = None
        if norm is not None:
            op, name, lit = norm
            if op == "!=":
                continue
            col = cols.get(name.lower())
            if col is None:
                continue
            iv = interval_for(op, lit, schema[col])
        elif isinstance(cj, E.In) and isinstance(cj.child, E.Col):
            col = cols.get(cj.child.name.lower())
            if col is None:
                continue
            iv = _in_interval(cj.values, schema[col])
        if iv is None or col is None:
            continue
        out[col] = _merge(out[col], iv) if col in out else iv
    return out


def predicate_intervals_complete(
    cond: E.Expr, schema: Dict[str, pa.DataType]
) -> Optional[Dict[str, ColInterval]]:
    """:func:`predicate_intervals`, but None unless EVERY top-level
    conjunct lowered into an interval on a known column — for consumers
    whose soundness needs the intervals to BE the predicate, not merely
    bound it (a row group whose rows all provably satisfy the whole
    conjunction).

    Deliberately stricter than the pruning lowering: ``IN`` lists abstain
    here even though pruning accepts their [min, max] hull — the hull is
    a superset of the point set, sound for keep/drop decisions but NOT
    for "every row matches". Same for ``!=``, OR trees, IS NULL and any
    non-lowerable conjunct."""
    cols = {c.lower(): c for c in schema}
    out: Dict[str, ColInterval] = {}
    for cj in E.split_conjuncts(cond):
        norm = E.normalize_comparison(cj)
        if norm is None:
            return None
        op, name, lit = norm
        if op == "!=":
            return None
        col = cols.get(name.lower())
        if col is None:
            return None
        iv = interval_for(op, lit, schema[col])
        if iv is None:
            return None
        out[col] = _merge(out[col], iv) if col in out else iv
    return out


# ---------------------------------------------------------------------------
# Comparable-domain conversion (directed rounding — see module docstring)
# ---------------------------------------------------------------------------


def f64_down(v) -> float:
    """Largest float64 <= v. The comparison is between a Python float and
    ``v`` (a Python int or float), which Python makes exact at any
    precision; an ``np.float64`` on the left would round an int beyond
    2^53 to float64 first (the JAX package's copy does, and so rounds
    2^53 + 1 up to 2^53: ROADMAP C.3)."""
    if isinstance(v, np.generic):
        v = v.item()  # temporal literals lower to np.int64 ticks
    f = float(np.float64(v))
    if f > v:
        f = float(np.nextafter(f, -np.inf))
    return f


def f64_up(v) -> float:
    """Least float64 >= v (exact, as :func:`f64_down`)."""
    if isinstance(v, np.generic):
        v = v.item()
    f = float(np.float64(v))
    if f < v:
        f = float(np.nextafter(f, np.inf))
    return f


def _stat_engine_value(v, t: pa.DataType):
    """A statistics cell (python value out of a parquet footer or sidecar)
    in the engine's comparable domain for arrow type ``t``: str for
    string columns, int ticks for temporals, int/float otherwise. None =
    unusable (abstain; the group stays unpruned)."""
    if v is None:
        return None
    if isinstance(v, np.generic):
        v = v.item()
    if _is_string_type(t):
        return v if isinstance(v, str) else None
    if pa.types.is_temporal(t):
        from hyperspace_tpu_torch.io.columnar import Column

        try:
            arr = pa.array([v], type=t)
        except (pa.ArrowInvalid, pa.ArrowTypeError, TypeError, OverflowError):
            return None
        col = Column.from_arrow(arr)
        if col.null_mask is not None:
            return None
        return int(col.values[0])
    if pa.types.is_boolean(t):
        return int(bool(v)) if isinstance(v, bool) else None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, float):
        return None if math.isnan(v) else v
    if isinstance(v, int):
        return v
    return None


# ---------------------------------------------------------------------------
# Per-file statistics: parquet footers (lazy backfill) + sidecar capture
# ---------------------------------------------------------------------------


def _read_footer_zones(path: str) -> dict:
    """Raw per-row-group statistics of one parquet file, every flat
    column: {"rg_rows": [...], "cols": {name: [(min, max, nulls)|None per
    rg]}}. Values are pyarrow's logical-type conversions (date →
    datetime.date etc.); a row group whose chunk carries no usable
    min/max gets (None, None, nulls) so all-null detection still works."""
    md = pq.ParquetFile(path).metadata
    idx_of: Dict[str, int] = {}
    for j in range(md.num_columns):
        idx_of.setdefault(md.schema.column(j).path, j)
    rg_rows: List[int] = []
    cols: Dict[str, list] = {name: [] for name in idx_of}
    for i in range(md.num_row_groups):
        rg = md.row_group(i)
        rg_rows.append(rg.num_rows)
        for name, j in idx_of.items():
            cc = rg.column(j)
            st = cc.statistics
            if st is None:
                cols[name].append(None)
                continue
            nulls = st.null_count if st.has_null_count else None
            if st.has_min_max:
                cols[name].append((st.min, st.max, nulls))
            else:
                cols[name].append((None, None, nulls))
    return {"rg_rows": rg_rows, "cols": cols}


@functools.lru_cache(maxsize=4096)
def _footer_zones_cached(path: str, _size: int, _mtime_ns: int) -> dict:
    return _read_footer_zones(path)


def footer_zones(path: str) -> Optional[dict]:
    """Memoized footer statistics keyed by file identity — a rewritten
    file gets a fresh read (stale-eviction by construction). None when
    the file or its footer is unreadable (caller keeps the whole file)."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    try:
        return _footer_zones_cached(path, st.st_size, st.st_mtime_ns)
    except (OSError, ValueError, KeyError, pa.ArrowInvalid):
        return None


# -- sidecar value (de)serialization ----------------------------------------


def _enc_stat(v):
    if isinstance(v, np.generic):
        v = v.item()
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else {"t": "f", "v": repr(v)}
    if isinstance(v, _dt.datetime):
        return {"t": "dt", "v": v.isoformat()}
    if isinstance(v, _dt.date):
        return {"t": "d", "v": v.isoformat()}
    if isinstance(v, _dt.time):
        return {"t": "tm", "v": v.isoformat()}
    if isinstance(v, _dt.timedelta):
        return {"t": "td", "v": [v.days, v.seconds, v.microseconds]}
    return {"t": "x"}  # unencodable: decodes to None (abstain)


def _dec_stat(v):
    if not isinstance(v, dict):
        return v
    t = v.get("t")
    try:
        if t == "f":
            return float(v["v"])
        if t == "dt":
            return _dt.datetime.fromisoformat(v["v"])
        if t == "d":
            return _dt.date.fromisoformat(v["v"])
        if t == "tm":
            return _dt.time.fromisoformat(v["v"])
        if t == "td":
            d, s, us = v["v"]
            return _dt.timedelta(days=d, seconds=s, microseconds=us)
    except (ValueError, KeyError, TypeError):
        return None
    return None


@functools.lru_cache(maxsize=256)
def _sidecar_cached(path: str, _size: int, _mtime_ns: int) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
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


# ---------------------------------------------------------------------------
# Capture (at create time)
# ---------------------------------------------------------------------------


def zonemap_doc(dir_path: str, index, device=None) -> Optional[dict]:
    """The ``_zonemaps.json`` document of one index version directory, or
    None when nothing is to be captured (another index kind, no files).
    Covering and z-order covering indexes; a z-order index also gets
    per-row-group z-address spans under an encoder spec frozen over the
    directory's own data, its planes interleaved on ``device`` (None is
    cuda)."""
    kind = getattr(index, "kind", "")
    if kind not in ("CoveringIndex", "ZOrderCoveringIndex"):
        return None
    from hyperspace_tpu_torch.io import parquet as pio

    try:
        files = pio.list_format_files(dir_path, "parquet")
    except (OSError, KeyError):
        return None
    if not files:
        return None
    footers = {}
    for f in files:
        fz = footer_zones(f)
        if fz is not None:
            footers[f] = fz
    doc: dict = {"version": _SIDECAR_VERSION, "files": {}}
    for f, fz in footers.items():
        st = os.stat(f)
        doc["files"][os.path.basename(f)] = {
            "size": st.st_size,
            "mtime_ns": st.st_mtime_ns,
            "rg_rows": list(fz["rg_rows"]),
            "cols": {
                name: [
                    None
                    if e is None
                    else [_enc_stat(e[0]), _enc_stat(e[1]), e[2]]
                    for e in entries
                ]
                for name, entries in fz["cols"].items()
            },
        }
    if kind == "ZOrderCoveringIndex":
        from hyperspace_tpu_torch.session import resolve_device

        dev = resolve_device(device)
        try:
            _capture_zspans(doc, files, footers, list(index.indexed_columns), dev)
        # a fault of the data leaves the min/max sidecar usable; a kernel
        # that fails to build or launch fails the create
        except (OSError, ValueError, pa.ArrowException) as exc:
            _log.warning("z-span capture failed for %s: %s", dir_path, exc)
    return doc


def capture_index_dir(dir_path: str, index, device=None) -> bool:
    """Write :func:`zonemap_doc` as the ``_zonemaps.json`` sidecar of one
    freshly written index version directory, through a temporary file and
    an atomic replace. Returns True when a sidecar was written; a failure
    only costs the lazy-backfill path."""
    doc = zonemap_doc(dir_path, index, device)
    if doc is None:
        return False
    tmp = os.path.join(dir_path, f".{SIDECAR_NAME}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(dir_path, SIDECAR_NAME))
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    return True


def capture_safely(dir_path: str, index, device=None) -> None:
    """The lifecycle actions' capture entry: a zone-map sidecar is a
    precomputed optimization (the serve path backfills from footers
    without it), so a fault of the data (``OSError``, ``ValueError``,
    pyarrow's errors) never fails a build. A kernel build or launch error
    of the z-span capture does."""
    try:
        capture_index_dir(dir_path, index, device)
    except (OSError, ValueError, pa.ArrowException) as exc:
        _log.warning("zone-map capture failed for %s: %s", dir_path, exc)


#: z-address bits a column of the captured spans
_Z_BITS = 16


def _capture_zspans(doc, files, footers, zcols: List[str], device) -> None:
    """Per-row-group z-address spans for a z-order version dir, two passes
    bounded by the largest file: (1) fit a frozen range/dict encoder spec
    over the directory's data, (2) per file, interleave its planes on
    ``device`` and record each row group's packed (z_lo, z_hi). The
    reference's order of reads, which the spec and so the spans follow."""
    from hyperspace_tpu_torch.io import parquet as pio
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops.zorder import (
        ZOrderEncoder,
        order_u64_np,
        planes_to_numpy,
        planes_z_minmax,
    )

    k = len(zcols)
    mins: List[Optional[int]] = [None] * k
    maxs: List[Optional[int]] = [None] * k
    dicts: List[Optional[set]] = [None] * k
    # pass 1 (spec fit) reads a file at a time and discards it, pass 2
    # reads each again: peak memory stays bounded by the largest file's
    # indexed columns, not the whole index
    for f in files:
        batch = ColumnarBatch.from_arrow(pio.read_table([f], zcols))
        for j, c in enumerate(zcols):
            col = batch.column(c)
            if col.kind == "string":
                if dicts[j] is None:
                    dicts[j] = set()
                dicts[j].update(col.dictionary)
                continue
            e = order_u64_np(col)
            if not len(e):
                continue
            lo, hi = int(e.min()), int(e.max())
            mins[j] = lo if mins[j] is None else min(mins[j], lo)
            maxs[j] = hi if maxs[j] is None else max(maxs[j], hi)
    specs = []
    for j in range(k):
        if dicts[j] is not None:
            specs.append(("dict", sorted(dicts[j])))
        else:
            specs.append(("range", np.uint64(mins[j] or 0), np.uint64(maxs[j] or 0)))
    encoder = ZOrderEncoder(_Z_BITS, specs)
    nplanes = None
    for f in files:
        fz = footers.get(f)
        entry = doc["files"].get(os.path.basename(f))
        if fz is None or entry is None:
            continue
        batch = ColumnarBatch.from_arrow(pio.read_table([f], zcols))
        planes = planes_to_numpy(encoder.planes([batch.column(c) for c in zcols], device))
        nplanes = planes.shape[0]
        spans = []
        pos = 0
        for rows in fz["rg_rows"]:
            mm = planes_z_minmax(planes, pos, pos + rows)
            spans.append(None if mm is None else [format(mm[0], "x"), format(mm[1], "x")])
            pos += rows
        entry["rg_zspans"] = spans
    doc["zorder"] = {
        "columns": list(zcols),
        "bits": _Z_BITS,
        "nplanes": int(nplanes or 1),
        "specs": [
            ["dict", s[1]] if s[0] == "dict" else ["range", str(int(s[1])), str(int(s[2]))]
            for s in specs
        ],
    }


# ---------------------------------------------------------------------------
# Assembled zone data for one relation (serve side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColZones:
    domain: str  # "num" | "str"
    lo: np.ndarray  # float64 (down-rounded) or object, per row group
    hi: np.ndarray  # float64 (up-rounded) or object
    has: np.ndarray  # bool: bounds usable
    allnull: np.ndarray  # bool: the group holds only nulls


@dataclasses.dataclass
class ZoneData:
    """Query-independent zone maps for one file set, assembled once and
    kept in a small module LRU. Row groups are flattened across files."""

    files: Tuple[str, ...]
    rg_file: np.ndarray  # row group -> file index
    rg_index: np.ndarray  # row group ordinal within its file
    opaque: np.ndarray  # per FILE: stats unreadable, never narrow it
    cols: Dict[str, ColZones]
    zspans: list  # per row group: (z_lo, z_hi) python ints or None
    zspecs: Dict[str, dict]  # dir path -> zorder spec doc
    rg_spec: list  # per row group: dir path (zspecs key) or None
    sidecar_files: int
    footer_files: int

    @property
    def nbytes(self) -> int:
        n = len(self.rg_file)
        return 64 * n * max(len(self.cols), 1) + 128 * len(self.files)


def _file_stats_from_sidecar(path: str, side: Optional[dict]):
    """This file's decoded sidecar stats when present AND stat-fresh
    (size + mtime_ns match the file on disk), else None — a rewritten
    file silently falls back to its own footer."""
    if side is None:
        return None
    entry = side.get("files", {}).get(os.path.basename(path))
    if entry is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    if entry.get("size") != st.st_size or entry.get("mtime_ns") != st.st_mtime_ns:
        return None
    cols = {
        name: [
            None if e is None else (_dec_stat(e[0]), _dec_stat(e[1]), e[2])
            for e in entries
        ]
        for name, entries in entry.get("cols", {}).items()
    }
    out = {"rg_rows": list(entry.get("rg_rows", [])), "cols": cols}
    if entry.get("rg_zspans") is not None:
        out["rg_zspans"] = [
            None if s is None else (int(s[0], 16), int(s[1], 16))
            for s in entry["rg_zspans"]
        ]
    return out


def column_zones(cells, t: pa.DataType) -> "ColZones":
    """One column's :class:`ColZones` from per-group statistics cells.
    Each cell is the string ``"allnull"`` (the group holds only nulls), a
    ``(vmin, vmax)`` pair of raw statistics values, or None (no usable
    statistics: abstain, the group is always kept)."""
    n = len(cells)
    domain = "str" if _is_string_type(t) else "num"
    # string placeholders must be COMPARABLE (None would raise in the
    # object-array compares); ~has masks them out of every decision
    lo = (
        np.full(n, "", dtype=object)
        if domain == "str"
        else np.zeros(n, dtype=np.float64)
    )
    hi = (
        np.full(n, "", dtype=object)
        if domain == "str"
        else np.zeros(n, dtype=np.float64)
    )
    has = np.zeros(n, dtype=bool)
    allnull = np.zeros(n, dtype=bool)
    for gi, cell in enumerate(cells):
        if cell is None:
            continue
        if cell == "allnull":
            allnull[gi] = True
            continue
        ev_min = _stat_engine_value(cell[0], t)
        ev_max = _stat_engine_value(cell[1], t)
        if ev_min is None or ev_max is None:
            continue  # unusable cell: abstain for this group
        if domain == "str":
            lo[gi], hi[gi] = ev_min, ev_max
        else:
            lo[gi], hi[gi] = f64_down(ev_min), f64_up(ev_max)
        has[gi] = True
    return ColZones(domain, lo, hi, has, allnull)


#: lazy-backfill chunking: per-file statistics are folded into the
#: per-column cell lists this many files at a time, and the per-directory
#: sidecar dicts are dropped at every chunk boundary, so assembling a
#: huge relation holds one chunk of decoded statistics at a time.
_ASSEMBLE_CHUNK_FILES = 64


def assemble_zone_data(
    files: Tuple[str, ...], schema: Dict[str, pa.DataType]
) -> ZoneData:
    rg_file: List[int] = []
    rg_index: List[int] = []
    opaque = np.zeros(len(files), dtype=bool)
    zspans: list = []
    rg_spec: list = []
    zspecs: Dict[str, dict] = {}
    sidecar_n = footer_n = 0
    side_by_dir: Dict[str, Optional[dict]] = {}
    # per-column cell lists — the ONLY per-row-group state that survives
    # a chunk; each cell is None / "allnull" / a (vmin, vmax) pair
    cells_by_col: Dict[str, List] = {name: [] for name in schema}
    col_seen: Dict[str, bool] = {name: False for name in schema}

    def _fold(rows: Optional[int], rg_cols: Optional[dict]) -> None:
        for name in schema:
            entry = rg_cols.get(name) if rg_cols is not None else None
            if entry is None:
                cells_by_col[name].append(None)
                continue
            col_seen[name] = True
            vmin, vmax, nulls = entry
            if vmin is None and vmax is None:
                if nulls is not None and rows and nulls == rows:
                    cells_by_col[name].append("allnull")
                else:
                    cells_by_col[name].append(None)
                continue
            cells_by_col[name].append((vmin, vmax))

    for c0 in range(0, len(files), _ASSEMBLE_CHUNK_FILES):
        side_by_dir.clear()  # chunk boundary: drop the decoded sidecars
        for off, path in enumerate(files[c0 : c0 + _ASSEMBLE_CHUNK_FILES]):
            fi = c0 + off
            d = os.path.dirname(path)
            if d not in side_by_dir:
                side_by_dir[d] = _sidecar_for_dir(d)
            side = side_by_dir[d]
            stats = _file_stats_from_sidecar(path, side)
            if stats is not None:
                sidecar_n += 1
            else:
                stats = footer_zones(path)
                if stats is not None:
                    footer_n += 1
            if stats is None:
                opaque[fi] = True
                rg_file.append(fi)
                rg_index.append(0)
                _fold(None, None)
                zspans.append(None)
                rg_spec.append(None)
                continue
            spans = stats.get("rg_zspans")
            spec = side.get("zorder") if side else None
            if spec is not None and spans is not None:
                zspecs.setdefault(d, spec)
            for gi in range(len(stats["rg_rows"])):
                rg_file.append(fi)
                rg_index.append(gi)
                _fold(
                    stats["rg_rows"][gi],
                    {
                        name: entries[gi]
                        for name, entries in stats["cols"].items()
                        if gi < len(entries)
                    },
                )
                if spans is not None and spec is not None and gi < len(spans):
                    zspans.append(spans[gi])
                    rg_spec.append(d)
                else:
                    zspans.append(None)
                    rg_spec.append(None)
    cols: Dict[str, ColZones] = {}
    for name, t in schema.items():
        if col_seen[name]:
            cols[name] = column_zones(cells_by_col[name], t)
    return ZoneData(
        files=tuple(files),
        rg_file=np.asarray(rg_file, dtype=np.int64),
        rg_index=np.asarray(rg_index, dtype=np.int64),
        opaque=opaque,
        cols=cols,
        zspans=zspans,
        zspecs=zspecs,
        rg_spec=rg_spec,
        sidecar_files=sidecar_n,
        footer_files=footer_n,
    )


# Module-level bounded LRU for assembled zone data, keyed by the file
# fingerprint. Bounded in BYTES as well as entries (entries carry their
# zd.nbytes; _local_bytes is the ledger). Every access under _local_lock.
_local_lock = threading.Lock()
_local_cache: "OrderedDict[tuple, Tuple[ZoneData, int]]" = OrderedDict()
_local_bytes = 0
_LOCAL_CACHE_ENTRIES = 64
_LOCAL_CACHE_MAX_BYTES = 256 << 20


def _local_put(key, zd: ZoneData, nbytes: int) -> None:
    """Insert into the module LRU, evicting oldest-first until both the
    entry cap and the byte cap hold. Caller must NOT hold _local_lock."""
    global _local_bytes
    if nbytes > _LOCAL_CACHE_MAX_BYTES:
        return  # larger than the whole cache: not cacheable
    with _local_lock:
        old = _local_cache.pop(key, None)
        if old is not None:
            _local_bytes -= old[1]
        while _local_cache and (
            len(_local_cache) >= _LOCAL_CACHE_ENTRIES
            or _local_bytes + nbytes > _LOCAL_CACHE_MAX_BYTES
        ):
            _, (_zd, freed) = _local_cache.popitem(last=False)
            _local_bytes -= freed
        _local_cache[key] = (zd, nbytes)
        _local_bytes += nbytes


def zone_data_for(rel, cache=None) -> Optional[Tuple[ZoneData, bool]]:
    """(assembled zone data, was_cache_hit) for a relation's file set, from
    the serve ``cache`` (``("zonemap", fp)``), the module LRU or the
    sidecars and footers; None when the files cannot be fingerprinted
    (caller skips pruning)."""
    fp = file_fingerprint(rel.files)
    if fp is None:
        return None
    key = ("zonemap", fp)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit, True
    with _local_lock:
        hit = _local_cache.get(key)
        if hit is not None:
            _local_cache.move_to_end(key)
            return hit[0], True
    zd = assemble_zone_data(tuple(rel.files), rel.schema)
    if cache is not None:
        cache.put(key, zd, zd.nbytes)
    _local_put(key, zd, zd.nbytes)
    return zd, False


def invalidate_local_cache() -> None:
    """Drop the module-level assembled-map cache (the lru-cached footer and
    sidecar reads are keyed by file identity and never serve stale)."""
    global _local_bytes
    with _local_lock:
        _local_cache.clear()
        _local_bytes = 0


def invalidate_paths_under(root: str) -> int:
    """Drop only the LRU entries whose fingerprint names a file under
    ``root`` (the fleet fanout's scoped invalidation, ``serve/fleet.py``: a
    refresh of index A must not cost index B its warm assembled state);
    returns how many went. Entries are fingerprint-keyed, so this reclaims
    memory and never fixes staleness."""
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
            _zd, freed = _local_cache.pop(k)
            _local_bytes -= freed
        return len(victims)


# ---------------------------------------------------------------------------
# The pruning pass
# ---------------------------------------------------------------------------

#: the latest evaluated scan's pruning counts (files and row groups kept
#: and total, zone-map sources, cache hit, whether z-spans dropped a row
#: group); last-writer-wins diagnostics
last_prune_stats: Dict[str, Any] = {}


def zone_keep_mask(cz: ColZones, iv: ColInterval) -> np.ndarray:
    """Keep-mask over row groups for one column's interval: a group
    survives when its bounds are unusable (abstain) or overlap the
    interval; all-null groups never satisfy a comparison conjunct."""
    n = len(cz.has)
    if iv.empty:
        return np.zeros(n, dtype=bool)
    overlap = np.ones(n, dtype=bool)
    if iv.lo is not None:
        if cz.domain == "str":
            if isinstance(iv.lo, str):
                overlap &= (cz.hi > iv.lo) if iv.lo_strict else (cz.hi >= iv.lo)
        else:
            lof = f64_down(iv.lo)
            overlap &= (cz.hi > lof) if iv.lo_strict else (cz.hi >= lof)
    if iv.hi is not None:
        if cz.domain == "str":
            if isinstance(iv.hi, str):
                overlap &= (cz.lo < iv.hi) if iv.hi_strict else (cz.lo <= iv.hi)
        else:
            hif = f64_up(iv.hi)
            overlap &= (cz.lo < hif) if iv.hi_strict else (cz.lo <= hif)
    return (~cz.allnull) & (overlap | ~cz.has)


def _encode_box_bound(iv: ColInterval, kind: str, sorted_dict):
    """(enc_lo, enc_hi) uint64 box bounds of one column's interval for
    z-space pruning, rounded OUTWARD; None abstains (full range), "empty"
    prunes the whole spec group."""
    from hyperspace_tpu_torch.ops.zorder import order_u64_scalar

    if iv.empty:
        return "empty"

    def enc(v, up: bool):
        if sorted_dict is not None:
            if not isinstance(v, str):
                return None
            return bisect_left(sorted_dict, v) + 1
        if kind != "f" and isinstance(v, float):
            if math.isinf(v):
                return "inf_pos" if v > 0 else "inf_neg"
            # a low bound rounds up to the next integer and a high bound
            # down: tighter, and sound, as an integer column holds no
            # value between two integers
            v = math.ceil(v) if up is False else math.floor(v)
        try:
            return order_u64_scalar(v, kind)
        except (OverflowError, ValueError, TypeError):
            return None

    enc_lo = 0 if iv.lo is None else enc(iv.lo, up=False)
    enc_hi = (1 << 64) - 1 if iv.hi is None else enc(iv.hi, up=True)
    if enc_lo == "inf_neg":
        enc_lo = 0
    if enc_hi == "inf_pos":
        enc_hi = (1 << 64) - 1
    if enc_lo == "inf_pos" or enc_hi == "inf_neg":
        return "empty"  # e.g. col >= +inf on an integer column
    if enc_lo is None or enc_hi is None:
        return None
    enc_hi = max(int(enc_hi), 1)  # null slot 0: data encodings clamp to >= 1
    return int(enc_lo), int(enc_hi)


def _z_keep_mask(zd: ZoneData, intervals, schema) -> Optional[np.ndarray]:
    """Z-space keep-mask over row groups (None = no z metadata). Only
    groups with captured spans narrow; everything else stays kept. The
    words of the box are the data words' own float64 scaling, rounded
    outward, and that scaling is monotone, so no matching row's group is
    dropped at any magnitude."""
    from hyperspace_tpu_torch.ops.zorder import (
        pack_box_ranges,
        spec_word_bounds,
        z_box_ranges,
    )

    if not zd.zspecs:
        return None
    n = len(zd.rg_file)
    keep = np.ones(n, dtype=bool)
    lower_schema = {c.lower(): c for c in schema}
    ranges_by_spec: Dict[str, Optional[list]] = {}
    for spec_key, spec in zd.zspecs.items():
        bits = int(spec.get("bits", _Z_BITS))
        zcols = spec.get("columns", [])
        specs = spec.get("specs", [])
        k = len(zcols)
        if k == 0 or len(specs) != k:
            ranges_by_spec[spec_key] = None
            continue
        word_lo, word_hi = [], []
        empty = False
        abstain = False
        top = (1 << bits) - 1
        for j, cname in enumerate(zcols):
            sname = lower_schema.get(cname.lower())
            iv = intervals.get(sname) if sname else None
            if iv is None:
                word_lo.append(0)
                word_hi.append(top)
                continue
            t = schema[sname]
            if _is_string_type(t):
                kind = "s"
                sorted_dict = specs[j][1] if specs[j][0] == "dict" else None
                if sorted_dict is None:
                    abstain = True
                    break
            else:
                sorted_dict = None
                if pa.types.is_floating(t):
                    kind = "f"
                elif pa.types.is_boolean(t):
                    kind = "b"
                elif pa.types.is_unsigned_integer(t):
                    kind = "u"
                else:
                    kind = "i"
            eb = _encode_box_bound(iv, kind, sorted_dict)
            if eb == "empty":
                empty = True
                break
            if eb is None:
                abstain = True
                break
            sp = specs[j]
            sp_t = ("dict", sp[1]) if sp[0] == "dict" else ("range", int(sp[1]), int(sp[2]))
            wb = spec_word_bounds(sp_t, eb[0], eb[1], bits)
            if wb is None:
                abstain = True
                break
            word_lo.append(wb[0])
            word_hi.append(wb[1])
        if empty:
            ranges_by_spec[spec_key] = []
            continue
        if abstain:
            ranges_by_spec[spec_key] = None
            continue
        ranges = z_box_ranges(word_lo, word_hi, bits)
        ranges_by_spec[spec_key] = pack_box_ranges(
            ranges, bits, k, int(spec.get("nplanes", 1))
        )
    for gi in range(n):
        spec_key = zd.rg_spec[gi]
        span = zd.zspans[gi]
        if spec_key is None or span is None:
            continue
        ranges = ranges_by_spec.get(spec_key)
        if ranges is None:
            continue
        a, b = span
        if not any(a <= rhi and b >= rlo for rlo, rhi in ranges):
            keep[gi] = False
    return keep


def prune_scan_relation(scan, cond: E.Expr, cache=None):
    """The range-pruning pass over one index Scan: returns a Scan over
    the surviving files with ``file_row_groups`` narrowing (the same
    node when nothing prunes). Superset-safe by construction — see the
    module docstring; the executor re-applies the full mask."""
    from hyperspace_tpu_torch.io.parquet import PARQUET_FAMILY
    from hyperspace_tpu_torch.plan.nodes import Scan

    rel = scan.relation
    stats = {
        "files_total": len(rel.files),
        "files_kept": len(rel.files),
        "row_groups_total": 0,
        "row_groups_kept": 0,
        "zonemap_files_sidecar": 0,
        "zonemap_files_footer": 0,
        "zonemap_cache_hit": False,
        "z_pruned": False,
    }
    global last_prune_stats
    if (
        rel.index_info is None
        or rel.fmt not in PARQUET_FAMILY
        or not rel.files
        or rel.file_row_groups is not None
    ):
        return scan
    intervals = predicate_intervals(cond, rel.schema)
    if not intervals:
        return scan
    # from here on the pass EVALUATED this scan, so the stats must reflect
    # it even on abstain: a reader must never take a previous query's
    # stats for this one's
    last_prune_stats = stats
    got = zone_data_for(rel, cache)
    if got is None:
        return scan
    zd, was_hit = got
    stats["zonemap_cache_hit"] = was_hit
    stats["zonemap_files_sidecar"] = zd.sidecar_files
    stats["zonemap_files_footer"] = zd.footer_files
    n = len(zd.rg_file)
    stats["row_groups_total"] = n
    keep = np.ones(n, dtype=bool)
    for cname, iv in intervals.items():
        cz = zd.cols.get(cname)
        if cz is None:
            if iv.empty:
                # a contradictory conjunction matches nothing anywhere,
                # stats or not
                keep[:] = False
            continue
        keep &= zone_keep_mask(cz, iv)
    if rel.index_info[2] == "ZOCI":
        before = int(keep.sum())
        zk = _z_keep_mask(zd, intervals, rel.schema)
        if zk is not None:
            keep &= zk
            stats["z_pruned"] = int(keep.sum()) < before
    # opaque files (unreadable stats) are never narrowed
    keep |= zd.opaque[zd.rg_file]
    stats["row_groups_kept"] = int(keep.sum())
    # the calling query's root span gets exactly this evaluation's delta
    _obs_trace.accumulate("rows_pruned", n - stats["row_groups_kept"])
    if bool(keep.all()):
        stats["files_kept"] = len(rel.files)
        stats["row_groups_kept"] = n
        return scan
    kept_files: List[str] = []
    kept_groups: List[Optional[Tuple[int, ...]]] = []
    for fi, path in enumerate(rel.files):
        sel = keep[zd.rg_file == fi]
        if not sel.any():
            continue
        kept_files.append(path)
        if bool(sel.all()) or zd.opaque[fi]:
            kept_groups.append(None)
        else:
            idx = zd.rg_index[(zd.rg_file == fi) & keep]
            kept_groups.append(tuple(int(i) for i in idx))
    stats["files_kept"] = len(kept_files)
    row_groups = (
        tuple(kept_groups) if any(g is not None for g in kept_groups) else None
    )
    return Scan(
        dataclasses.replace(rel, files=tuple(kept_files), file_row_groups=row_groups)
    )
