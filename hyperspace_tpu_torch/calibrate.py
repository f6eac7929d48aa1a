"""Per-machine dispatch calibration: two thresholds measured on the card.

Counterpart of ``hyperspace_tpu/native/calibrate.py``, whose role beside
the reference's native loader this module takes beside ``kernels.py``.
The contract is the reference's: :class:`Thresholds`, :func:`thresholds`
(a cached measurement, else a fresh probe cached for later processes,
else the zeroed defaults), :func:`invalidate`, ``HS_CALIBRATE=0`` (no
probe: the defaults), ``_PROBE_VERSION`` (a bump re-probes), and a field
value of 0 meaning "no measurement — the caller keeps its constant". An
explicit override of the caller's module attribute wins over the probe
(``execution/pipeline_compiler._native_fused_pipeline_min_rows``).

What the port measures, keeping the reference's field names:

* ``native_fused_pipeline_min_rows`` — the scanned-row count from which
  the fused filter→aggregate pass (kernel B5f) beats the route the
  executor takes when the fused one declines (the Filter's range mask,
  kernel B3a, then the filtered batch's hash aggregate with B5), on every
  probed plan shape of a serve-shaped batch whose columns are on the card,
  at doubling sizes (the reference's probe ``:311-374``, with its
  workload's integer-aggregate twin beside it: :data:`_FUSED_SHAPES`);
* ``exchange_compact_min_rows`` — the row count at or above which the
  ``compact`` exchange beats ``flat`` (kernels B1, B8a and B8b) on the
  machine's mesh of CUDA devices (the reference's ``:376-420``); 0 with
  fewer than 2 devices, and never measured in a job of several processes
  (a lazily started probe there would issue collectives its peers do not).

The reference's eight other fields choose between its host, native and
device routes; the port has no native host kernels and always launches
on the card, so they are left out (ROADMAP A.10c).

On a machine with no CUDA device :func:`thresholds` returns the defaults
without timing anything. The cache is a JSON file under
``kernels.build_dir()`` (the ``build/`` directory beside the package),
keyed by the probe version, the CPU count, the card's name and capability
and the CUDA and torch versions; it is published by write-to-temp, fsync
and ``os.replace``, with the per-size times of the probe that wrote it
(:func:`probe_times`). A probe that fails costs only the defaults, with a
warning — apart from a kernel's fault (``kernels.KERNEL_FAULTS``), which
propagates (ROADMAP C.7).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_log = logging.getLogger("hyperspace_tpu_torch.calibrate")

# Bump when the probe methodology changes; stale cache files re-probe.
_PROBE_VERSION = 2

# Fused-route probe sizes (scanned rows). The route's fallback constant,
# 1 << 15, lies inside them.
_FUSED_PROBE_SIZES = [1 << 10, 1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17]

# The fused probe's plan shapes over one batch (the reference's workload: a
# two-term predicate passing about half the rows, one ~200-ary int64 group
# key): integer aggregates take B5f's one pass; the reference's float SUM
# takes its ordered route (B3b, the group pass, B5). One threshold serves
# every plan, so a size counts only where the fused pass wins on both.
_FUSED_SHAPES = {
    "one_pass": (("count", None, "n"), ("sum", "a", "s"), ("min", "a", "m")),
    "ordered": (("count", None, "n"), ("sum", "b", "s"), ("min", "a", "m")),
}

# A size counts as a win only where the fused pass takes at most this share
# of the declined route's time: a near tie is noise, not a crossover.
_WIN_MARGIN = 0.9

# Timed calls a route and size (best of).
_REPS = 7

# Exchange probe sizes (rows), the reference's device probe sizes.
_EXCHANGE_PROBE_SIZES = [1 << 18, 1 << 20, 1 << 22]

_CACHE_NAME = "_hs_calibration.json"


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Measured dispatch thresholds; 0 = no measurement (use fallback)."""

    native_fused_pipeline_min_rows: int = 0
    exchange_compact_min_rows: int = 0
    source: str = "defaults"


_FIELDS = ("native_fused_pipeline_min_rows", "exchange_compact_min_rows")

_DEFAULTS = Thresholds()
_cached: Optional[Thresholds] = None
# Re-entrancy guard: while a probe runs, a dispatch that consults
# thresholds() on the probing thread sees the defaults.
_probing = False
# One probe per process. RLock: the probe may re-enter thresholds() on its
# own thread through a dispatch.
_probe_lock = threading.RLock()


def _enabled() -> bool:
    return os.environ.get("HS_CALIBRATE", "1") != "0"


def _machine_key() -> dict:
    import torch

    cap = torch.cuda.get_device_capability(0)
    return {
        "version": _PROBE_VERSION,
        "cpus": os.cpu_count() or 1,
        "device": torch.cuda.get_device_name(0),
        "capability": f"{cap[0]}.{cap[1]}",
        "cuda": torch.version.cuda,
        "torch": torch.__version__,
    }


def cache_file() -> str:
    from hyperspace_tpu_torch import kernels

    return os.path.join(kernels.build_dir(), _CACHE_NAME)


def _sync() -> None:
    import torch

    torch.cuda.synchronize()


def _time_best(fn, reps: int = 3) -> float:
    """Best-of-reps wall time of ``fn`` ended by a device synchronise —
    the right statistic for a crossover probe (interference only slows a
    trial down)."""
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _fused_routes(batch, terms, group_by, aggs, schema, dev):
    """(fused, declined) callables over ``batch`` with the columns the
    fused pass reads moved to ``dev`` once, here; None outside the fused
    set. ``fused`` folds them (``AggState``: B5f) and finalizes;
    ``declined`` is the executor's route when the fused one declines: the
    Filter's mask on the same device columns (``executor._filter_mask``'s
    fused range mask, kernel B3a), read back, the host batch filtered by
    it, then ``aggregate_exec.execute_aggregate`` (factorize and B5), which
    moves the passing rows as it does on the serve path."""
    from hyperspace_tpu_torch.execution import pipeline_compiler as pc
    from hyperspace_tpu_torch.execution.aggregate_exec import execute_aggregate
    from hyperspace_tpu_torch.ops import filter as F

    plan = pc._lower_from_terms(terms, group_by, aggs, schema)
    chunk = None if plan is None else pc.AggState(plan, dev)._chunk(batch)
    if chunk is None:
        return None

    def fused():
        state = pc.AggState(plan, dev)
        state.accumulate(batch, chunk)
        return pc.finalize_partials(plan, state.partials())

    def declined():
        mask = F.range_mask(chunk.terms).cpu().numpy()
        return execute_aggregate(batch.filter(mask), list(group_by), list(aggs), schema, dev)

    return fused, declined


def probe_fused_pipeline_min(device=None) -> Tuple[int, List[Dict[str, float]]]:
    """(threshold, per-size times): the smallest probe size from which the
    fused pass beats the declined route (:func:`_fused_routes`) on every
    plan shape of :data:`_FUSED_SHAPES`, by the margin :data:`_WIN_MARGIN`,
    best of :data:`_REPS` calls; twice the largest size when a shape never
    wins. A shape stops being timed at its first win. The serve-shaped
    batch is the reference's: k int64 in [0, 200), a int64 in [0, 2^18),
    b float64 normal, terms 1000 <= a < 110000 and b > -1."""
    import pyarrow as pa
    import torch

    from hyperspace_tpu_torch.io.columnar import Column, ColumnarBatch
    from hyperspace_tpu_torch.plan.nodes import AggSpec

    dev = torch.device("cuda" if device is None else device)
    rng = np.random.default_rng(49)
    schema = {"k": pa.int64(), "a": pa.int64(), "b": pa.float64()}
    terms = (
        ("a", 1000, False, 110000, True, False),
        ("b", -1.0, True, None, False, False),
    )
    won: Dict[str, int] = {}
    times: List[Dict[str, float]] = []
    for n in _FUSED_PROBE_SIZES:
        batch = ColumnarBatch({
            "k": Column("numeric", pa.int64(), values=rng.integers(0, 200, n, dtype=np.int64)),
            "a": Column("numeric", pa.int64(), values=rng.integers(0, 1 << 18, n, dtype=np.int64)),
            "b": Column("numeric", pa.float64(), values=rng.normal(0.0, 1.0, n)),
        })
        for shape, specs in _FUSED_SHAPES.items():
            if shape in won:
                continue
            routes = _fused_routes(batch, terms, ["k"], [AggSpec(*a) for a in specs], schema, dev)
            if routes is None:
                return 0, times  # outside the fused set: the fallback constant decides
            fused, declined = routes
            fused()  # warm both routes out of the measurement
            declined()
            t_fused, t_declined = _time_best(fused, _REPS), _time_best(declined, _REPS)
            times.append({"shape": shape, "rows": n, "fused_s": t_fused,
                          "declined_s": t_declined})
            if t_fused <= _WIN_MARGIN * t_declined:
                won[shape] = n
        if len(won) == len(_FUSED_SHAPES):
            return max(won.values()), times
    return _FUSED_PROBE_SIZES[-1] * 2, times  # a shape loses in range: keep the route rare


def probe_exchange_compact_min(mesh=None) -> Tuple[int, List[Dict[str, float]]]:
    """(threshold, per-size times): the smallest probe size at which the
    ``compact`` exchange beats ``flat`` (B1, B8a, B8b) on ``mesh`` (default:
    one shard a CUDA device of this machine), or 0 when it never does. 0
    without a measurement: fewer than 2 CUDA devices and no ``mesh`` given,
    a CPU mesh (``auto`` takes ``host`` there), or a job of several
    processes (the reference's ``:393-398``: a probe there would issue
    collectives its peers never reach)."""
    import torch

    from hyperspace_tpu_torch.parallel import mesh as mesh_mod
    from hyperspace_tpu_torch.parallel import shuffle as shuffle_mod

    if mesh_mod.process_count() > 1:
        return 0, []
    if mesh is None:
        if torch.cuda.device_count() < 2:
            return 0, []
        mesh = mesh_mod.Mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    if mesh.platform != "cuda" or mesh.processes > 1:
        return 0, []
    rng = np.random.default_rng(50)
    times: List[Dict[str, float]] = []
    for n in _EXCHANGE_PROBE_SIZES:
        reps = rng.integers(-(2**62), 2**62, size=(1, n), dtype=np.int64)
        payloads = [reps[0], rng.normal(0.0, 1.0, n)]

        def run(strategy):
            shuffle_mod.bucket_shuffle(mesh, reps, payloads, 200, strategy=strategy)

        run(shuffle_mod.STRATEGY_FLAT)  # warm both routes out of the measurement
        run(shuffle_mod.STRATEGY_COMPACT)
        t_compact = _time_best(lambda: run(shuffle_mod.STRATEGY_COMPACT))
        t_flat = _time_best(lambda: run(shuffle_mod.STRATEGY_FLAT))
        times.append({"rows": n, "compact_s": t_compact, "flat_s": t_flat})
        if t_compact < t_flat:
            return n, times
    return 0, times


def _probe() -> Tuple[Thresholds, Dict[str, List[Dict[str, float]]]]:
    """(thresholds, per-size times) of a fresh probe on the card."""
    t0 = time.perf_counter()
    fused, fused_times = probe_fused_pipeline_min()
    compact, exchange_times = probe_exchange_compact_min()
    out = Thresholds(
        native_fused_pipeline_min_rows=fused,
        exchange_compact_min_rows=compact,
        source="calibrated",
    )
    _log.info("dispatch calibration probed in %.0fms: %s", (time.perf_counter() - t0) * 1e3, out)
    return out, {"fused": fused_times, "exchange": exchange_times}


def _cache_data() -> Optional[dict]:
    """The cache file's content when it is this machine's, else None."""
    try:
        with open(cache_file(), "r") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or data.get("machine") != _machine_key():
        return None
    return data


def probe_times() -> Dict[str, list]:
    """The per-size times of the probe that wrote this machine's cache
    (``{"fused": [...], "exchange": [...]}``), or ``{}``."""
    data = _cache_data()
    times = None if data is None else data.get("probe")
    return times if isinstance(times, dict) else {}


def _load_cache() -> Optional[Thresholds]:
    data = _cache_data()
    if data is None:
        return None
    t = data.get("thresholds")
    try:
        return Thresholds(**{k: int(t[k]) for k in _FIELDS}, source="calibrated")
    except (KeyError, TypeError, ValueError):
        return None


def _store_cache(t: Thresholds, times: Dict[str, list]) -> None:
    """Publish the calibration JSON (the thresholds and the probe's
    per-size times) with write-to-temp, fsync and atomic rename: a reader
    sees the old file or the new one, never a torn one. The temp name is
    pid-qualified, so concurrent writers never clobber each other's temp;
    losing the last-writer race is fine (both hold measurements for this
    machine key)."""
    path = cache_file()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(
                {"machine": _machine_key(), "thresholds": {k: getattr(t, k) for k in _FIELDS},
                 "probe": times},
                f,
                indent=2,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def thresholds() -> Thresholds:
    """The machine's dispatch thresholds: the cached measurement, else a
    fresh probe on the card (cached for later processes), else the zeroed
    defaults (callers keep their constants). No CUDA device: the
    defaults, with nothing timed."""
    global _cached, _probing
    if _cached is not None:
        return _cached
    if _probing or not _enabled():
        return _DEFAULTS
    import torch

    if not torch.cuda.is_available():
        return _DEFAULTS
    from hyperspace_tpu_torch.kernels import KERNEL_FAULTS

    # Lock-held I/O by design: the JSON cache read/write and the probe are
    # what the lock serialises (one probe a process); the lock-free
    # _cached fast path above keeps queries off this lock.
    with _probe_lock:  # hslint: disable=HS502
        if _cached is not None:  # another thread probed while we waited
            return _cached
        if _probing:
            return _DEFAULTS
        got = _load_cache()
        if got is None:
            _probing = True
            try:
                got, times = _probe()
            except KERNEL_FAULTS:
                raise  # a kernel's fault is never hidden (C.7)
            # catch-all is the contract: any other failed probe costs only
            # the fallback constants, never a query
            except Exception as exc:  # hslint: disable=HS402
                _log.warning("dispatch calibration failed; using defaults: %s", exc)
                got = _DEFAULTS
            else:
                _store_cache(got, times)
            finally:
                _probing = False
        _cached = got
        return _cached


def invalidate() -> None:
    """Forget the in-process memo (tests; a forced re-measure). Takes the
    probe lock: a rebind racing a mid-probe publish must not resurrect the
    dropped value (HS602, SHARED_STATE)."""
    global _cached
    with _probe_lock:
        _cached = None
