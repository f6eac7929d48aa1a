"""Serve-server mode: an in-memory cache of immutable index data.

Counterpart of ``hyperspace_tpu/execution/serve_cache.py``. The reference
Hyperspace caches index *metadata* with a TTL
(``index/CachingIndexCollectionManager.scala:38-108``) and re-reads the
data from the lake on every query. A serve process can keep the hot index
data in host RAM between queries instead, which takes the parquet read
and decode off the warm serve path. This module is that cache.

Correctness model: entries are keyed by a **fingerprint of the exact file
set**: (path, size, mtime_ns) per file. Index data files are immutable
once written (every refresh or optimize writes a new ``v__=N`` version
directory), so a stale entry's key never matches again and no
invalidation protocol is needed. Eviction is LRU by byte size
(``hyperspace.serve.cache.maxBytes``).

Opt-in through ``hyperspace.serve.cache.enabled``; with it off the serve
paths run as before. What gets cached (``execution/executor.py``):

* ``("scan", fp)``: the per-column decode of a clean index scan (columns
  accrue across projections) with its lazily computed sorted-segment
  state for the binary-search narrowing of a cached filter;
* ``("joinside", fps, cols, keys)``: a ``PreparedJoinSide``
  (``execution/join_exec.py``): the concatenated batch, key reps,
  combined keys and per-bucket offsets. ``fps`` is a tuple of per-relation
  fingerprints: one for a clean index scan, two for a Hybrid Scan append
  ``Union`` (index files and appended source files);
* ``("bucketed", fp, cols)``: per-bucket batches of a bucketed index scan;
* ``("delta", fp, ...)``: the Hybrid Scan appended rows split by bucket
  (``executor._prepare_delta``);
* ``("zonemap", fp)``: assembled zone maps (``indexes/zonemaps.py``);
* ``("fusedplan", fp, ...)``: lowered fused filter→aggregate plans
  (``execution/pipeline_compiler.FusedAggPlan``);
* ``("aggstate", fp)``: assembled aggregate-plane partials
  (``indexes/aggindex.AggData``).

Every cached value holds host arrays (numpy, pyarrow), never tensors on
the card, so the byte governor counts host RAM; a query moves what it
needs to the session's device as the uncached route does.

:meth:`ServeCache.stats` exports live as the metrics registry's
``serve_cache`` view, and spill writes and restores record the stage spans
``spill_write`` / ``spill_restore`` (``obs/``).
"""

from __future__ import annotations

import hashlib
import mmap as _mmap
import os
import pickle
import struct
import sys
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.obs import metrics as _obs_metrics
from hyperspace_tpu_torch.obs import trace as _obs_trace
from hyperspace_tpu_torch.testing import faults
from hyperspace_tpu_torch.utils import files as file_utils


def file_fingerprint(files) -> Optional[Tuple]:
    """(path, size, mtime_ns) per file: the cache key component that makes
    stale entries unreachable. None when any file is missing (the caller
    skips the cache and lets the normal read path raise its own error)."""
    out = []
    try:
        for f in files:
            st = os.stat(f)
            out.append((f, st.st_size, st.st_mtime_ns))
    except OSError:
        return None
    return tuple(out)


#: CPython small-object overhead charged a cached string (an empty ``str``
#: is about 49 bytes resident)
_STR_OVERHEAD = 49

#: resident charge of a file-backed (memory-mapped) array or buffer: its
#: pages live in the kernel page cache and are reclaimable without a
#: write-back, so the governor charges only a bookkeeping token
_MMAP_TOKEN_NBYTES = 64

#: live memory-mapped regions (start address -> byte length), fed by
#: :func:`register_mapped_region` (spill restores, ``io/columnar.
#: open_mmap_table``). ``estimate_nbytes`` charges a buffer whose address
#: falls inside a region as file-backed. Guarded by ``_mmap_lock``; an
#: entry is removed by a weakref finalizer on the mapping's owner.
_mmap_regions: Dict[int, int] = {}
_mmap_lock = threading.Lock()


def _unregister_mapped_region(address: int) -> None:
    with _mmap_lock:
        _mmap_regions.pop(address, None)


def register_mapped_region(address: int, length: int, owner=None) -> None:
    """Declare ``[address, address+length)`` a file-backed mapping, so the
    sizing primitive charges views into it as near-zero resident.
    ``owner`` (the object keeping the mapping alive) gets a weakref
    finalizer that retires the entry when the mapping dies; an owner that
    refuses weakrefs leaves a stale entry, which is only consulted for
    addresses a live mapping handed out."""
    if length <= 0:
        return
    with _mmap_lock:
        _mmap_regions[int(address)] = int(length)
    if owner is not None:
        try:
            weakref.finalize(owner, _unregister_mapped_region, int(address))
        except TypeError:
            pass


def _address_in_mapped_region(addr: int) -> bool:
    if not _mmap_regions:
        return False
    with _mmap_lock:
        for start, length in _mmap_regions.items():
            if start <= addr < start + length:
                return True
    return False


def _buffer_file_backed(base) -> bool:
    """Is this backing buffer (an ndarray's ``base``) a file mapping? A
    direct mmap, a memoryview over one, or a pyarrow Buffer inside a
    registered region."""
    if isinstance(base, _mmap.mmap):
        return True
    if isinstance(base, memoryview):
        obj = base.obj
        if isinstance(obj, _mmap.mmap):
            return True
    addr = getattr(base, "address", None)  # pyarrow.Buffer
    if isinstance(addr, int):
        return _address_in_mapped_region(addr)
    return False


def _data_address(owner: np.ndarray) -> Optional[int]:
    try:
        addr = owner.__array_interface__["data"][0]
    except (AttributeError, KeyError, TypeError):
        return None
    return addr if isinstance(addr, int) else None


def _owned_nbytes(a: np.ndarray) -> int:
    """Resident bytes an ndarray pins. A zero-copy view (an arrow-backed
    decode, a slice of a larger cached array) keeps its whole owner alive,
    so the owner's extent is what a byte governor must charge: walk the
    ``base`` chain to the owning ndarray, then charge the backing buffer
    (``pyarrow.Buffer.size`` / ``memoryview.nbytes``) when it is larger
    still. File-backed arrays (``np.memmap``, views over an ``mmap``, a
    registered mapped region) charge only ``_MMAP_TOKEN_NBYTES``."""
    owner = a
    if isinstance(owner, np.memmap):
        return _MMAP_TOKEN_NBYTES
    while isinstance(owner.base, np.ndarray):
        owner = owner.base
        if isinstance(owner, np.memmap):
            return _MMAP_TOKEN_NBYTES
    extent = max(int(a.nbytes), int(owner.nbytes))
    base = owner.base
    if base is None:
        if _mmap_regions:
            addr = _data_address(owner)
            if addr is not None and _address_in_mapped_region(addr):
                return _MMAP_TOKEN_NBYTES
        return extent
    if _buffer_file_backed(base):
        return _MMAP_TOKEN_NBYTES
    if _mmap_regions:
        addr = _data_address(owner)
        if addr is not None and _address_in_mapped_region(addr):
            return _MMAP_TOKEN_NBYTES
    for attr in ("size", "nbytes"):  # pyarrow.Buffer / memoryview
        n = getattr(base, attr, None)
        if isinstance(n, int) and n > extent:
            return n
    return extent


def _arrow_resident_nbytes(value) -> Optional[int]:
    """Resident bytes of a pyarrow container, charging buffers inside a
    registered mapped region as tokens. None for a shape this does not
    know how to walk (the caller takes ``get_total_buffer_size``)."""
    try:
        if hasattr(value, "itercolumns"):  # Table
            chunks = [c for col in value.itercolumns() for c in col.chunks]
        elif hasattr(value, "chunks"):  # ChunkedArray
            chunks = list(value.chunks)
        elif hasattr(value, "buffers") and callable(value.buffers):
            chunks = [value]  # Array / RecordBatch-like
        else:
            return None
        seen = set()
        total = 0
        for ch in chunks:
            for buf in ch.buffers():
                if buf is None:
                    continue
                addr = buf.address
                if addr in seen:
                    continue
                seen.add(addr)
                total += _MMAP_TOKEN_NBYTES if _address_in_mapped_region(addr) else buf.size
        return total
    except Exception:  # noqa: BLE001 - sizing never raises; the caller takes the total size
        return None


def estimate_nbytes(value, _depth: int = 0) -> int:
    """Approximate resident bytes of a cached value: the one sizing ruler
    of the cache governor (``batch_nbytes``, ``ScanCacheEntry.
    budget_nbytes``). View-aware: numpy views charge their owner's full
    extent (``_owned_nbytes``), pyarrow containers their total buffer
    size, composite values (Column, ColumnarBatch, dict, sequence)
    recurse."""
    if value is None:
        return 0
    if isinstance(value, np.ndarray):
        return _owned_nbytes(value)
    if isinstance(value, (bool, int, float)):
        return 28
    if isinstance(value, (str, bytes, bytearray)):
        return len(value) + _STR_OVERHEAD
    if isinstance(value, Column):
        total = 0
        for a in (value.values, value.codes, value.validity):
            if a is not None:
                total += _owned_nbytes(a)
        if value.dictionary:
            total += sum(len(s) + _STR_OVERHEAD for s in value.dictionary)
        return total
    if isinstance(value, ColumnarBatch):
        return sum(estimate_nbytes(c, _depth + 1) for c in value.columns.values())
    gtbs = getattr(value, "get_total_buffer_size", None)
    if callable(gtbs):  # pyarrow Table / RecordBatch / (Chunked)Array
        if _mmap_regions:  # mapped buffers charge tokens, not heap bytes
            resident = _arrow_resident_nbytes(value)
            if resident is not None:
                return resident
        return int(gtbs())
    if type(value).__module__.partition(".")[0] == "pyarrow":
        n = getattr(value, "size", None)  # pyarrow.Buffer
        if isinstance(n, int):
            return n
    for attr in ("budget_nbytes", "nbytes"):
        n = getattr(value, attr, None)
        if isinstance(n, (int, float)):
            return int(n)
    if _depth >= 6:  # composite recursion guard; cached values are trees
        return 0
    if isinstance(value, dict):
        return 64 + sum(
            estimate_nbytes(k, _depth + 1) + estimate_nbytes(v, _depth + 1)
            for k, v in value.items()
        )
    if isinstance(value, (list, tuple, set, frozenset)):
        return 56 + sum(8 + estimate_nbytes(v, _depth + 1) for v in value)
    try:
        return int(sys.getsizeof(value))
    except TypeError:
        return 0


def batch_nbytes(batch: ColumnarBatch) -> int:
    """Approximate resident bytes of a batch (arrays and dictionaries),
    through :func:`estimate_nbytes`."""
    return estimate_nbytes(batch)


# -- spill tier wire format -----------------------------------------------------
# magic | u64 pickle_len | u64 nbuf | nbuf x (u64 offset, u64 length) |
# pickle bytes | 64-aligned out-of-band buffer segments. The pickle is
# protocol 5 with buffer_callback, so every contiguous numpy payload is
# written as a raw aligned segment that the restore hands back to
# ``pickle.loads(buffers=...)`` as a memoryview slice of the mmap: restored
# arrays are zero-copy read-only views of the spill file, which the
# mmap-aware sizing above charges as file-backed.
_SPILL_MAGIC = b"HSSP1\0"
_SPILL_ALIGN = 64
_SPILL_SUFFIX = ".spill"


def _spill_encode(value) -> bytes:
    bufs: list = []
    payload = pickle.dumps(value, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    header_len = len(_SPILL_MAGIC) + 16 + 16 * len(raws)
    pos = header_len + len(payload)
    metas = []
    for mv in raws:
        off = (pos + _SPILL_ALIGN - 1) & ~(_SPILL_ALIGN - 1)
        metas.append((off, mv.nbytes))
        pos = off + mv.nbytes
    parts = [_SPILL_MAGIC, struct.pack("<QQ", len(payload), len(raws))]
    for off, length in metas:
        parts.append(struct.pack("<QQ", off, length))
    parts.append(payload)
    pos = header_len + len(payload)
    for (off, length), mv in zip(metas, raws):
        parts.append(b"\0" * (off - pos))
        parts.append(mv)
        pos = off + length
    return b"".join(parts)


def _spill_decode(path: str):
    """Restore a spilled value zero-copy: mmap the file, register the
    mapping as file-backed, and feed the out-of-band segments to
    ``pickle.loads`` as memoryview slices (the arrays keep the mapping
    alive through their base chain). Raises ``ValueError`` on a torn or
    foreign file: the caller deletes it and treats the key as a miss.
    Spill files are only ever written by :func:`_spill_encode` of this
    process's caches."""
    with open(path, "rb") as f:
        mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    view = memoryview(mm)
    total = len(view)
    hdr = len(_SPILL_MAGIC)
    if total < hdr + 16 or bytes(view[:hdr]) != _SPILL_MAGIC:
        raise ValueError("not a spill file: %s" % path)
    plen, nbuf = struct.unpack_from("<QQ", view, hdr)
    p = hdr + 16
    if total < p + 16 * nbuf + plen:
        raise ValueError("truncated spill file: %s" % path)
    metas = []
    for _ in range(nbuf):
        off, length = struct.unpack_from("<QQ", view, p)
        p += 16
        if off + length > total:
            raise ValueError("truncated spill file: %s" % path)
        metas.append((off, length))
    payload = view[p:p + plen]
    base_addr = np.frombuffer(mm, dtype=np.uint8).__array_interface__["data"][0]
    register_mapped_region(base_addr, total, owner=mm)
    buffers = [view[off:off + length] for off, length in metas]
    return pickle.loads(payload, buffers=buffers)


def _spill_filename(key) -> str:
    return hashlib.sha256(repr(key).encode()).hexdigest() + _SPILL_SUFFIX


#: entry kinds a demotion writes to the spill tier: the decoded and
#: prepared data. The metadata kinds (zonemap, fusedplan, aggstate) are
#: evicted outright: they are cheap to derive again.
_SPILL_KINDS = frozenset(("scan", "bucketed", "joinside", "delta"))

#: every live ServeCache of this process: the spill reaper
#: (``metadata/recovery.reap_spill_orphans``) consults
#: :func:`live_spill_paths` so it never deletes a file a live cache still
#: indexes. Weak, so a replaced cache does not pin its bytes.
_LIVE_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def live_spill_paths() -> set:
    """Spill file paths that live caches of this process index: the
    reaper's do-not-delete set."""
    out: set = set()
    for cache in list(_LIVE_CACHES):
        out.update(cache.spill_paths())
    return out


def spill_root(conf) -> str:
    """``<hyperspace.system.path>/_hyperspace_spill``: the spill tier's
    directory."""
    from hyperspace_tpu_torch import constants as C

    system_path = conf.get_str(C.INDEX_SYSTEM_PATH, C.INDEX_SYSTEM_PATH_DEFAULT)
    return os.path.join(system_path, C.HYPERSPACE_SPILL_DIR)


def _delete_quietly(paths) -> None:
    for p in paths:
        try:
            file_utils.delete(p)
        except OSError:
            pass


class ServeCache:
    """Thread-safe LRU cache, byte-capped: the serve plane's memory
    governor. Values carry their own size (entries are (value, nbytes)).

    Lock discipline: ONE lock guards the entry map, the byte ledger, the
    spill index and every counter, and every public method holds it for
    its whole critical section, so ``resident_bytes`` never observes a
    half-applied put, an eviction never interleaves with a replace, and
    ``evict_kind`` snapshots its victims under the lock that guards
    concurrent ``get``/``put``. No I/O and no user code runs under the
    lock (values are stored, never inspected); spill writes and restores
    run outside it. A value handed out by ``get`` may outlive its entry:
    every cached value is immutable once published.

    The accounting invariant: ``resident_bytes`` equals the exact sum of
    the resident entries' sizes and never exceeds ``max_bytes``.
    """

    def __init__(self, max_bytes: int, spill_dir: Optional[str] = None,
                 spill_max_bytes: int = 0):
        self.max_bytes = int(max_bytes)
        # on-disk demotion tier: LRU-evicted values of the spill kinds are
        # pickled (protocol 5, out-of-band buffers) to fsync'd files under
        # spill_dir instead of being dropped; a later miss restores them
        # zero-copy through mmap. Off when spill_dir is unset or the cap 0.
        self.spill_dir = spill_dir
        self.spill_max_bytes = int(spill_max_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        # spill index: key -> (path, on-disk bytes), LRU by demotion; under
        # the same lock, so a key is never resident and spilled at once
        self._spill: OrderedDict = OrderedDict()
        self._spill_bytes = 0
        self.hits = 0
        self.misses = 0
        # resident-set telemetry: the ledger's high-water mark, LRU
        # evictions, inserts dropped by an armed cache_insert fault
        self.high_water_bytes = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.insert_failures = 0
        # spill-tier telemetry: demotions written, restores served, values
        # dropped (unpicklable, oversized, torn file), bytes written
        self.spill_demotes = 0
        self.spill_restores = 0
        self.spill_drops = 0
        self.spill_bytes_written = 0
        # live stats() view in the metrics registry (last-registered cache
        # wins), weakly bound so the registry never keeps a replaced cache
        # and its bytes alive
        _obs_metrics.registry.register_weak_view("serve_cache", self)
        _LIVE_CACHES.add(self)

    @property
    def spill_enabled(self) -> bool:
        return bool(self.spill_dir) and self.spill_max_bytes > 0

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry[0]
            spilled = self._spill.pop(key, None)
            if spilled is None:
                self.misses += 1
                return None
            self._spill_bytes -= spilled[1]
        # restore OUTSIDE the lock (file I/O and unpickle): a torn or
        # vanished file is a miss, and the caller derives the value again
        value, nbytes = self._restore_from_spill(spilled[0])
        if value is None:
            with self._lock:
                self.misses += 1
            return None
        self.put(key, value, nbytes)
        with self._lock:
            self.spill_restores += 1
            self.hits += 1
        return value

    def peek(self, key):
        """Read without touching the hit and miss counters or the LRU
        order: for publication paths (re-reading the freshest entry before
        a merge-put must not skew the query-level statistics)."""
        with self._lock:
            entry = self._entries.get(key)
            return None if entry is None else entry[0]

    def put(self, key, value, nbytes: int) -> None:
        # fault-injection seam: a failing insert never fails the query, the
        # value just stays uncached (counted). The detail, the key's kind,
        # is stringified only when the point is armed.
        if faults.degraded("cache_insert", key[:1] if key else ""):
            with self._lock:
                self.insert_failures += 1
            return
        if nbytes > self.max_bytes:
            return  # larger than the whole cache: not cacheable
        demote = []
        spill = self.spill_enabled
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            # evict BEFORE inserting: the ledger never passes the budget,
            # even transiently, so an unsynchronized ``resident_bytes`` read
            # never sees more than ``max_bytes``
            while self._bytes + nbytes > self.max_bytes and self._entries:
                vk, (vv, freed) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.evictions += 1
                self.evicted_bytes += freed
                if spill and isinstance(vk, tuple) and vk and vk[0] in _SPILL_KINDS:
                    demote.append((vk, vv))
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            if self._bytes > self.high_water_bytes:
                self.high_water_bytes = self._bytes
        # demotions run OUTSIDE the lock (pickle and an fsync'd write): the
        # victims are already out of the resident map, so a racing get of a
        # key mid-demotion misses and derives the value again
        for vk, vv in demote:
            self._spill_demote(vk, vv)

    def _spill_demote(self, key, value) -> None:
        """Write one evicted value to the spill tier (no cache lock held).
        A value that refuses to pickle or exceeds the tier's cap is dropped
        (counted); the tier is LRU by demotion, its oldest files deleted
        when the cap overflows."""
        t0 = time.perf_counter()
        try:
            blob = _spill_encode(value)
        except Exception:  # noqa: BLE001 - demotion is best-effort: drop what cannot pickle
            with self._lock:
                self.spill_drops += 1
            return
        if len(blob) > self.spill_max_bytes:
            with self._lock:
                self.spill_drops += 1
            return
        path = os.path.join(self.spill_dir, _spill_filename(key))
        try:
            os.makedirs(self.spill_dir, exist_ok=True)
            # crash seam: dying here leaves at most a .tmp_spool_ temp (the
            # atomic publish never exposes a torn final file), which the
            # spill reaper deletes; it is never served
            faults.crash("mid_spill_write", path)
            file_utils.atomic_overwrite_bytes(path, blob)
        except OSError:
            with self._lock:
                self.spill_drops += 1
            return
        _obs_trace.stage("spill_write", t0=t0, attrs={"bytes": len(blob)})
        reap = []
        with self._lock:
            old = self._spill.pop(key, None)
            if old is not None:
                self._spill_bytes -= old[1]
            while self._spill_bytes + len(blob) > self.spill_max_bytes and self._spill:
                _, (opath, onbytes) = self._spill.popitem(last=False)
                self._spill_bytes -= onbytes
                reap.append(opath)
            self._spill[key] = (path, len(blob))
            self._spill_bytes += len(blob)
            self.spill_demotes += 1
            self.spill_bytes_written += len(blob)
        _delete_quietly(reap)

    def _restore_from_spill(self, path: str):
        """Restore one spilled value (no cache lock held): ``(value,
        resident_nbytes)``, or ``(None, 0)`` for a torn or vanished file
        (counted as a drop, the file deleted). The restored arrays are mmap
        views of the spill file, so their resident charge is near zero. The
        file is unlinked after the restore; the live mapping keeps its
        pages readable, and the disk space returns when the value is
        dropped."""
        t0 = time.perf_counter()
        try:
            value = _spill_decode(path)
        except Exception:  # noqa: BLE001 - a spill-tier defect is a miss, never a query failure
            with self._lock:
                self.spill_drops += 1
            _delete_quietly([path])
            return None, 0
        nbytes = estimate_nbytes(value)
        _obs_trace.stage("spill_restore", t0=t0, attrs={"resident_bytes": nbytes})
        _delete_quietly([path])
        return value, nbytes

    def spill_paths(self) -> set:
        """Paths the spill index claims (one consistent snapshot): the
        orphan reaper's do-not-delete set."""
        with self._lock:
            return {path for path, _ in self._spill.values()}

    def clear(self) -> None:
        """Empty the cache and start a fresh telemetry epoch: the
        high-water mark resets with the contents (hits, misses and
        evictions keep counting). The spill tier empties too."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self.high_water_bytes = 0
            reap = [path for path, _ in self._spill.values()]
            self._spill.clear()
            self._spill_bytes = 0
        _delete_quietly(reap)

    def _drop_where(self, pred) -> int:
        """Drop every resident and spilled entry whose key satisfies
        ``pred``, the victim list built and drained under the one lock; a
        racing ``put`` lands before the snapshot (and goes) or after the
        drain (and stays). Returns the resident entries dropped."""
        with self._lock:
            victims = [k for k in self._entries if pred(k)]
            for k in victims:
                _, nbytes = self._entries.pop(k)
                self._bytes -= nbytes
            reap = []
            for k in [k for k in self._spill if pred(k)]:
                path, nbytes = self._spill.pop(k)
                self._spill_bytes -= nbytes
                reap.append(path)
        _delete_quietly(reap)
        return len(victims)

    def evict_kind(self, kind: str) -> int:
        """Drop every entry of one kind (keys are ``(kind, ...)`` tuples:
        "scan", "bucketed", "joinside", "delta", "zonemap", "fusedplan",
        "aggstate"), spilled ones included. Returns the number of resident
        entries dropped."""
        return self._drop_where(lambda k: isinstance(k, tuple) and k and k[0] == kind)

    def evict_paths_under(self, root: str) -> int:
        """Drop every entry whose fingerprint names a file under ``root``
        (an index directory), freeing a dead version's bytes at once. The
        walk finds every string in the key, so every key shape is covered."""
        prefix = root.replace("\\", "/").rstrip("/") + "/"

        def mentions(obj) -> bool:
            if isinstance(obj, str):
                return obj.replace("\\", "/").startswith(prefix)
            if isinstance(obj, tuple):
                return any(mentions(x) for x in obj)
            return False

        return self._drop_where(mentions)

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def bytes_by_kind(self) -> dict:
        """Resident bytes an entry kind."""
        with self._lock:
            out: dict = {}
            for k, (_v, nbytes) in self._entries.items():
                kind = k[0] if isinstance(k, tuple) and k else "other"
                out[kind] = out.get(kind, 0) + nbytes
            return out

    def stats(self) -> dict:
        """One consistent snapshot of the governor's counters (taken under
        the lock); ``snapshot_at_ms`` stamps when."""
        with self._lock:
            return {
                "snapshot_at_ms": int(time.time() * 1000),
                "resident_bytes": self._bytes,
                "high_water_bytes": self.high_water_bytes,
                "max_bytes": self.max_bytes,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "insert_failures": self.insert_failures,
                "spill_entries": len(self._spill),
                "spill_resident_bytes": self._spill_bytes,
                "spill_max_bytes": self.spill_max_bytes,
                "spill_demotes": self.spill_demotes,
                "spill_restores": self.spill_restores,
                "spill_drops": self.spill_drops,
                "spill_bytes": self.spill_bytes_written,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class ScanCacheEntry:
    """Per-column cached decode of one index scan, with lazily computed
    sorted-segment state.

    One entry a file set (key ``("scan", fp)``); columns are added as
    queries need them, so overlapping projections share one decoded copy
    a column. Index bucket files are key-sorted on disk; after an
    incremental refresh a bucket holds several files, each sorted but not
    merged, so the entry keeps per-file segment bounds and, a column,
    whether every segment is monotonic in key-rep order, detected from the
    data (never trusted from metadata).

    Concurrency: a published entry is never structurally mutated. Column
    additions go through :meth:`with_new_columns`, a copy sharing the
    existing Column objects, published by replacing the cache entry.
    ``column_state``'s memo is the one in-place write, and is safe: racing
    threads compute identical values and a dict assignment is atomic."""

    def __init__(self, segments):
        self.segments = tuple(segments)  # ((start, end), ...)
        self.columns: dict = {}  # name -> Column
        self._reps: dict = {}  # name -> (key_rep, all_segments_sorted)

    def with_new_columns(self, new_columns: dict) -> "ScanCacheEntry":
        """A copy of this entry with ``new_columns`` added (copy-on-write
        publication)."""
        out = ScanCacheEntry(self.segments)
        out.columns.update(self.columns)
        out.columns.update(new_columns)
        out._reps.update(self._reps)
        return out

    @property
    def num_rows(self) -> int:
        return self.segments[-1][1] if self.segments else 0

    def batch_for(self, cols) -> Optional[ColumnarBatch]:
        """A batch over ``cols``, or None when a column is not cached yet
        (the caller reads the missing ones and publishes a copy)."""
        if any(c not in self.columns for c in cols):
            return None
        return ColumnarBatch({c: self.columns[c] for c in cols})

    def column_state(self, name: str):
        """(key_rep, all_segments_sorted) of a column, memoized."""
        st = self._reps.get(name)
        if st is not None:
            return st
        rep = self.columns[name].key_rep()
        ok = True
        for s, e in self.segments:
            seg = rep[s:e]
            if len(seg) > 1 and not bool(np.all(seg[1:] >= seg[:-1])):
                ok = False
                break
        st = (rep, ok)
        self._reps[name] = st
        return st

    @property
    def budget_nbytes(self) -> int:
        """What the LRU accounting charges: every cached column plus its
        worst-case memoized key rep (8 bytes a row, ``column_state``).
        Sizes are fixed at ``put``, so the growth is charged up front;
        publishers re-put the ``with_new_columns`` copy with its charge."""
        total = 0
        rows = self.num_rows
        for c in self.columns.values():
            total += estimate_nbytes(c)
            total += 8 * rows
        return total
