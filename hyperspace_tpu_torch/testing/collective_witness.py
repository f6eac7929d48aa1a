"""Runtime collective witness: record each process's collective program.

The HS8xx checkers (``analysis/spmd.py``) reason about a *static* model
of the multi-host plane: which call sites issue collectives, which
symmetry contract each declares (``COLLECTIVE_SITES`` in
``parallel/collectives.py``), and whether process-identity branches or
process-local loop bounds can make processes diverge. Like the lock
model, that model rots silently — a new code path can issue a collective
the analyzer cannot see, and a "symmetric" site can stop being
symmetric. This module closes the loop dynamically, the
``lock_witness.py`` recipe applied to collectives:

* :func:`install` wraps every callable named in ``COLLECTIVE_SITES`` by
  module-attribute replacement (in-module callers resolve the name
  through module globals at call time, so the wrapper is seen
  everywhere — the reason site paths must be module-level callables);
* while the multi-host dryrun runs, each wrapper appends one record to
  this process's ordered collective sequence: site, op, contract, wave
  index (per-site occurrence count) and a payload *signature* —
  dtype/ndim per array argument plus reprs of static scalars — chosen
  so symmetric sites produce identical signatures on every process
  while per-host payload SIZES may differ;
* :func:`dump` writes a per-process JSON artifact at
  ``<path>.p<process_index>.json`` via the shared atomic-write helper
  (``testing/artifacts.py``);
* ``hslint --witness <path>`` merges the per-process artifacts and
  cross-checks them (``analysis/spmd.py``): any cross-process sequence
  divergence, any witnessed-but-unregistered site, and any
  coordinator-gated site witnessed off the coordinator is a hard HS804
  error; a registered site never witnessed is a staleness warning.

Armed via ``HS_COLLECTIVE_WITNESS=<path prefix>`` in
``scripts/torch_dryrun_multihost.py`` (each worker installs before
``initialize_distributed`` so even the bootstrap is witnessed);
``tests/test_torch_witnesses.py`` runs the 2-process dryrun under it and
holds the two sequences to each other. Stdlib-only apart from a lazy ``torch.distributed``
read in :func:`snapshot`.
"""

from __future__ import annotations

import importlib
import threading
from typing import Dict, List, Tuple

_PKG = "hyperspace_tpu_torch"

_rec_lock = threading.Lock()
_records: List[dict] = []
_wave_counts: Dict[str, int] = {}

_installed: Dict[str, "_WitnessSite"] = {}  # site path -> wrapper
_module_patches: List[Tuple[object, str, object]] = []  # (module, attr, orig)


class _WitnessSite:
    """Recording wrapper around one registered collective site."""

    def __init__(self, inner, site: str, op: str, contract: str):
        self._inner = inner
        self.witness_site = site
        self._op = op
        self._contract = contract

    def __call__(self, *args, **kwargs):
        with _rec_lock:
            wave = _wave_counts.get(self.witness_site, 0)
            _wave_counts[self.witness_site] = wave + 1
            _records.append(
                {
                    "site": self.witness_site,
                    "op": self._op,
                    "contract": self._contract,
                    "wave": wave,
                    "sig": _signature(args, kwargs),
                }
            )
        return self._inner(*args, **kwargs)


def _signature(args: tuple, kwargs: dict) -> str:
    """A cheap cross-process-comparable payload signature: array
    arguments contribute dtype+rank (NOT extents — per-host-lane sites
    legitimately carry different row counts), static scalars/strings
    contribute their repr, containers recurse, everything else its type
    name. For ``symmetric-all`` sites the merge requires signatures to
    match position-by-position across processes."""
    parts = [_sig_one(a) for a in args]
    parts.extend(f"{k}={_sig_one(v)}" for k, v in sorted(kwargs.items()))
    return "(" + ", ".join(parts) + ")"


def _sig_one(v) -> str:
    if isinstance(v, (str, int, bool, float)) or v is None:
        return repr(v)
    if isinstance(v, (tuple, list)):
        return "[" + ", ".join(_sig_one(x) for x in v) + "]"
    if isinstance(v, dict):
        return (
            "{"
            + ", ".join(f"{k}: {_sig_one(x)}" for k, x in sorted(v.items()))
            + "}"
        )
    dtype = getattr(v, "dtype", None)
    ndim = getattr(v, "ndim", None)
    if dtype is not None and ndim is not None:
        return f"{dtype}[{ndim}d]"
    return type(v).__name__


def install() -> Dict[str, str]:
    """Wrap every COLLECTIVE_SITES callable; idempotent. Returns
    {site path -> contract} for the wrapped sites. Raises on a stale
    site path — the witness must never silently watch nothing."""
    from hyperspace_tpu_torch.parallel.collectives import COLLECTIVE_SITES

    wrapped: Dict[str, str] = {}
    for site, (op, contract, _why) in COLLECTIVE_SITES.items():
        wrapped[site] = contract
        if site in _installed:
            continue
        mod_name, _, attr = site.rpartition(".")
        module = importlib.import_module(mod_name)
        orig = getattr(module, attr)  # AttributeError on a stale path
        if isinstance(orig, _WitnessSite):
            _installed[site] = orig
            continue
        proxy = _WitnessSite(orig, site, op, contract)
        _module_patches.append((module, attr, orig))
        setattr(module, attr, proxy)
        _installed[site] = proxy
    return wrapped


def uninstall() -> None:
    """Restore the patched module attributes."""
    while _module_patches:
        module, attr, orig = _module_patches.pop()
        setattr(module, attr, orig)
    _installed.clear()


def reset() -> None:
    """Zero the recorded sequence (artifact isolation in tests)."""
    with _rec_lock:
        _records.clear()
        _wave_counts.clear()


def snapshot() -> dict:
    """The witness document for this process so far. The rank and the
    world size are read lazily from ``torch.distributed`` (process 0 of 1
    without a process group), so recording can start before, and even
    without, ``mesh.initialize_distributed``."""
    from hyperspace_tpu_torch.parallel.collectives import COLLECTIVE_SITES

    pid, nprocs = 0, 1
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            pid, nprocs = dist.get_rank(), dist.get_world_size()
    except Exception:  # hslint: disable=HS402
        # no process group yet: a single-process recording is still a
        # valid artifact (process 0 of 1)
        pass
    with _rec_lock:
        return {
            "version": 1,
            "package": _PKG,
            "process": int(pid),
            "process_count": int(nprocs),
            "registered": {
                site: contract
                for site, (_op, contract, _why) in COLLECTIVE_SITES.items()
            },
            "sequence": list(_records),
        }


def artifact_path(prefix: str, process: int) -> str:
    """The per-process artifact path for a witness prefix — ONE naming
    rule shared with the hslint merge side (``analysis/spmd.py``)."""
    return f"{prefix}.p{process}.json"


def dump(prefix: str) -> dict:
    """Write this process's artifact at ``artifact_path(prefix, pid)``
    via the shared atomic-write helper. Returns the document."""
    from hyperspace_tpu_torch.testing import artifacts

    doc = snapshot()
    artifacts.atomic_write_json(artifact_path(prefix, doc["process"]), doc)
    return doc
